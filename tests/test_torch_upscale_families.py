"""The port's Compact (SRVGGNetCompact), SPAN and RealPLKSR upscalers
(``hdrvae_torch/models/{srvgg,span,plksr}.py``) against the JAX package's.

Each family runs at the JAX tests' small configs from one official-schema
state dict made with numpy from a seed and loaded by both packages, in
the parity, mixed and fast tiers.  Bounds: parity and mixed within 1e-4 *
max(1, max|ref|) (float32 sums in other orders; the JAX mixed tier's HIGH
convs against the port's exact float32 ones), fast within 5e-2 * max(1,
max|ref|), the fast tier's gate (bf16 roundings at other places).  Also:
the JAX pytrees carried across (``*_state_dict_from_jax``), the Conv3XC
fold, the zoo's dispatch, names and refusals from .pth and .safetensors
files, and the two-pass ``hdr_upscale`` with the logit reversal.

The JAX package is imported inside the tests (:func:`_jax`), so the card
test at the end runs on the card's host, which has no JAX:

    python -m pytest -m cuda tests/test_torch_upscale_families.py \
        --noconftest -q
"""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from hdrvae_torch.api import nodes as tnodes
from hdrvae_torch.cli import main as tcli
from hdrvae_torch.core.config import Precision, TilingConfig, UpscaleConfig
from hdrvae_torch.io import exr as texr
from hdrvae_torch.models import params as tparams
from hdrvae_torch.models import plksr as tplk
from hdrvae_torch.models import span as tspan
from hdrvae_torch.models import srvgg as tsrvgg
from hdrvae_torch.models import zoo as tzoo
from hdrvae_torch.upscale import pipeline as tpipe

TIERS = ("parity", "mixed", "fast")
BOUND = {"parity": 1e-4, "mixed": 1e-4, "fast": 5e-2}


@functools.cache
def _jax():
    """The JAX package's side, imported on first use."""
    import jax
    import jax.numpy as jnp

    from hdrvae.api import nodes
    from hdrvae.cli import main as cli
    from hdrvae.core import config as jconfig
    from hdrvae.models import plksr, span, srvgg, zoo
    from hdrvae.upscale import pipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig,
                                 plksr=plksr, span=span, srvgg=srvgg,
                                 zoo=zoo, pipeline=pipeline, nodes=nodes,
                                 cli=cli)


def _precisions(tier):
    jp = getattr(_jax().config.Precision, tier)()
    return jp, getattr(Precision, tier)()


def _image(seed=3, shape=(2, 11, 13, 3)):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


def _assert_close(got, ref, tier):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    bound = BOUND[tier] * max(1.0, float(np.abs(ref).max()))
    assert err <= bound, (tier, err, bound)


def _compare(jparams, jcfg, japply, net, tapply, tier, x=None):
    """One forward of each package on the same numpy image."""
    x = _image() if x is None else x
    jp, tp = _precisions(tier)
    ref = japply(jparams, _jax().jnp.asarray(x), jcfg, precision=jp)
    got = tapply(net, torch.from_numpy(x), precision=tp)
    _assert_close(got.float().numpy(), ref, tier)


# ---------------------------------------------------------------------------
# Official-schema state dicts from a numpy seed
# ---------------------------------------------------------------------------


def _srvgg_sd(act, seed=1):
    cfg = tsrvgg.SRVGGConfig(act=act).with_small()
    return tsrvgg.init_srvgg(cfg, seed=seed, device="cpu").state_dict()


def _span_sd(norm=True, seed=2):
    cfg = tspan.SPANConfig(norm=norm).with_small()
    return tspan.official_state_dict(cfg, seed=seed)


PLKSR_VARIANTS = {
    "ea-pixelshuffle": dict(use_ea=True, upsampler="pixelshuffle"),
    "noea-pixelshuffle": dict(use_ea=False, upsampler="pixelshuffle"),
    "ea-dysample": dict(use_ea=True, upsampler="dysample"),
    "noea-dysample": dict(use_ea=False, upsampler="dysample"),
}


def _plksr_sd(variant, seed=4):
    cfg = dataclasses.replace(tplk.RealPLKSRConfig().with_small(),
                              **PLKSR_VARIANTS[variant])
    return tplk.init_realplksr(cfg, seed=seed, device="cpu").state_dict()


# ---------------------------------------------------------------------------
# Forwards against the JAX package, per tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("act", ["prelu", "relu", "leakyrelu"])
def test_srvgg_matches_jax(act, tier):
    """LeakyReLU(0.1) is not in a checkpoint's keys (both loaders read
    ReLU): both configs are set to it after loading."""
    js = _jax().srvgg
    sd = _srvgg_sd(act)
    params, jcfg = js.srvgg_from_state_dict(sd)
    net, cfg = tsrvgg.srvgg_from_state_dict(sd, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if act == "leakyrelu":
        jcfg = dataclasses.replace(jcfg, act=act)
        net.cfg = dataclasses.replace(cfg, act=act)
    assert net.cfg.act == act
    _compare(params, jcfg, js.srvgg_apply, net, tsrvgg.srvgg_apply, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("norm", [True, False])
def test_span_matches_jax(norm, tier):
    js = _jax().span
    sd = _span_sd(norm)
    params, jcfg = js.span_from_state_dict(sd)
    net, cfg = tspan.span_from_state_dict(sd, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.norm == norm
    _compare(params, jcfg, js.span_apply, net, tspan.span_apply, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("variant", sorted(PLKSR_VARIANTS))
def test_realplksr_matches_jax(variant, tier):
    jr = _jax().plksr
    sd = _plksr_sd(variant)
    params, jcfg = jr.realplksr_from_state_dict(sd)
    net, cfg = tplk.realplksr_from_state_dict(sd, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.use_ea, cfg.upsampler) == tuple(
        PLKSR_VARIANTS[variant].values())
    _compare(params, jcfg, jr.realplksr_apply, net, tplk.realplksr_apply,
             tier, x=_image(shape=(1, 9, 12, 3)))


def test_dysample_sampler_matches_jax():
    """The bilinear border sampler at positions past every edge and on
    whole pixels, against the JAX package's within 1e-6 (the same float32
    arithmetic; XLA may fuse it into FMAs)."""
    j = _jax()
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 5, 7, 3, 4)).astype(np.float32)
    ix = rng.uniform(-2.0, 9.0, (2, 10, 14, 3)).astype(np.float32)
    iy = rng.uniform(-2.0, 7.0, (2, 10, 14, 3)).astype(np.float32)
    ix[0, 0] = np.floor(ix[0, 0])
    got = tplk.bilinear_border_sample(*map(torch.from_numpy, (img, ix, iy)))
    sample = j.jax.vmap(j.jax.vmap(j.plksr._bilinear_border_sample,
                                   in_axes=(2, 2, 2), out_axes=2))
    ref = np.asarray(sample(img, ix, iy))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_dysample_init_pos_matches_jax():
    for scale, groups in ((4, 4), (2, 4), (3, 2)):
        assert np.array_equal(
            tplk.dysample_init_pos(scale, groups),
            _jax().plksr._dysample_init_pos(scale, groups))


# ---------------------------------------------------------------------------
# Weights carried across, and the Conv3XC fold
# ---------------------------------------------------------------------------


def _np_tree(params):
    return _jax().jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), params,
        is_leaf=lambda a: a is None)


@pytest.mark.parametrize("act", ["prelu", "relu"])
def test_srvgg_state_dict_from_jax(act):
    j = _jax()
    jcfg = j.srvgg.SRVGGConfig(num_feat=8, num_conv=2, act=act)
    params = j.srvgg.init_srvgg(j.jax.random.PRNGKey(0), jcfg)
    net, cfg = tsrvgg.srvgg_from_state_dict(
        tparams.srvgg_state_dict_from_jax(_np_tree(params)), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _compare(params, jcfg, j.srvgg.srvgg_apply, net, tsrvgg.srvgg_apply,
             "parity")


@pytest.mark.parametrize("norm", [True, False])
def test_span_state_dict_from_jax(norm):
    """The JAX pytree is already fused: it fills the port's fused convs."""
    j = _jax()
    jcfg = j.span.SPANConfig(num_feat=8, num_blocks=2, scale=2, norm=norm)
    params = j.span.init_span(j.jax.random.PRNGKey(1), jcfg)
    net, cfg = tspan.span_from_state_dict(
        tparams.span_state_dict_from_jax(_np_tree(params), norm=norm),
        device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _compare(params, jcfg, j.span.span_apply, net, tspan.span_apply,
             "parity")


@pytest.mark.parametrize("upsampler", ["pixelshuffle", "dysample"])
def test_realplksr_state_dict_from_jax(upsampler):
    """norm_groups 4, what a loader reads (the group count is not in a
    checkpoint's shapes)."""
    j = _jax()
    jcfg = dataclasses.replace(j.plksr.RealPLKSRConfig(scale=2).with_small(),
                               norm_groups=4, upsampler=upsampler)
    params = j.plksr.init_realplksr(j.jax.random.PRNGKey(2), jcfg)
    net, cfg = tplk.realplksr_from_state_dict(
        tparams.realplksr_state_dict_from_jax(_np_tree(params)),
        device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _compare(params, jcfg, j.plksr.realplksr_apply, net,
             tplk.realplksr_apply, "parity", x=_image(shape=(1, 9, 12, 3)))


@pytest.mark.parametrize("prefix", ["conv_1", "block_1.c2_r", "conv_2"])
def test_conv3xc_fold_matches_jax(prefix):
    """The fold is the JAX package's numpy algebra: bit-equal."""
    sd = _span_sd()
    w, b = tspan.fuse_conv3xc(sd, prefix)
    ref = _jax().span._fuse_conv3xc(sd, prefix)
    assert np.array_equal(np.transpose(w, (2, 3, 1, 0)), ref["kernel"])
    assert np.array_equal(b, ref["bias"])


# ---------------------------------------------------------------------------
# The zoo: dispatch, names, sizing and refusals
# ---------------------------------------------------------------------------

FAMILIES = {
    "Compact": (lambda: _srvgg_sd("prelu"), tsrvgg.SRVGGConfig),
    "SPAN": (lambda: _span_sd(), tspan.SPANConfig),
    "RealPLKSR": (lambda: _plksr_sd("ea-dysample"), tplk.RealPLKSRConfig),
}


def _save(sd, path):
    if path.suffix == ".safetensors":
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    else:
        torch.save(sd, path)


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zoo_dispatch_from_files(tmp_path, family, ext):
    j = _jax()
    make_sd, cfg_type = FAMILIES[family]
    path = tmp_path / f"model{ext}"
    _save(make_sd(), path)
    params, jcfg, jarch = j.zoo.load_upscale_model(str(path))
    net, cfg, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert arch == jarch == family
    assert isinstance(cfg, cfg_type)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    x = _image(shape=(1, 8, 10, 3))
    ref = j.zoo.upscaler_apply(params, j.jnp.asarray(x), jcfg,
                               precision=j.config.Precision.parity())
    got = tzoo.upscaler_apply(net, torch.from_numpy(x),
                              precision=Precision.parity())
    _assert_close(got.numpy(), ref, "parity")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zoo_sizing_and_reversal_match_jax(family):
    j = _jax()
    sd = FAMILIES[family][0]()
    loader = {"Compact": j.srvgg.srvgg_from_state_dict,
              "SPAN": j.span.span_from_state_dict,
              "RealPLKSR": j.plksr.realplksr_from_state_dict}[family]
    _, jcfg = loader(sd)
    cfg = {"Compact": tsrvgg.srvgg_from_state_dict,
           "SPAN": tspan.span_from_state_dict,
           "RealPLKSR": tplk.realplksr_from_state_dict}[family](
        sd, device="cpu")[1]
    for tier in TIERS:
        jp, tp = _precisions(tier)
        assert tzoo.working_set_bytes_per_pixel(cfg, tp) == \
            j.zoo.working_set_bytes_per_pixel(jcfg, jp)
    assert tpipe.get_reversal_fn(family).__name__ == \
        j.pipeline.get_reversal_fn(family).__name__ == "inverse_sigmoid"


def test_realplksr_rejects_original_plksr_schema(tmp_path):
    """An original-PLKSR checkpoint (no per-block GroupNorm) fails loudly
    in both packages, by name, and the zoo names it."""
    sd = {k: v for k, v in _plksr_sd("ea-pixelshuffle").items()
          if ".norm." not in k}
    assert not tplk.is_realplksr_state_dict(sd)
    assert not _jax().plksr.is_realplksr_state_dict(sd)
    with pytest.raises(ValueError, match="RealPLKSR"):
        tplk.realplksr_from_state_dict(sd, device="cpu")
    with pytest.raises(ValueError, match="RealPLKSR"):
        _jax().plksr.realplksr_from_state_dict(sd)
    path = tmp_path / "plksr.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="original PLKSR"):
        tzoo.load_upscale_model(str(path), device="cpu")
    with pytest.raises(ValueError, match="original PLKSR"):
        _jax().zoo.load_upscale_model(str(path))


@pytest.mark.parametrize("key,name", [
    ("before_RG.1.weight", "looks like DAT"),
    ("residual_layer.0.residual_layer.0.layer.0.fn.0.weight",
     "looks like OmniSR"),
    ("unet1.conv1.conv.0.weight", "looks like RealCUGAN"),
    ("something.else.weight", "unrecognized; first keys"),
])
def test_zoo_rejects_foreign_schema_with_named_guess(tmp_path, key, name):
    """A checkpoint of a family neither package implements is refused with
    the JAX package's named guess and list of families."""
    sd = {"conv_first.weight": torch.zeros(8, 3, 3, 3),
          "conv_first.bias": torch.zeros(8), key: torch.zeros(8)}
    path = tmp_path / "foreign.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match=name) as got:
        tzoo.load_upscale_model(str(path), device="cpu")
    with pytest.raises(ValueError, match=name) as ref:
        _jax().zoo.load_upscale_model(str(path))
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# hdr_upscale end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hdr_upscale_two_pass_matches_jax(tmp_path, family):
    """The two-pass upscale of a 24 x 40 HDR image (values > 1 and < 0),
    tile 16, overlap 4, parity tier, the family's logit reversal: mean
    (<= 1e-5) and p99.9 (<= 1e-3) of |difference|.  The reversal's slope
    1 / (y (1 - y)) (~5e5 at its clip) multiplies the float32 noise of the
    raw outputs: ~1e-6 of their scale, which SPAN's x255 input scaling
    takes to ~1e2 (p99.9 1.1e-4 and 1.9e-4 for SPAN and RealPLKSR here,
    the raw forwards held to 1e-4 of their scale above)."""
    j = _jax()
    path = tmp_path / "model.pth"
    torch.save(FAMILIES[family][0](), path)
    params, jcfg, arch = j.zoo.load_upscale_model(str(path))
    net, _, tarch = tzoo.load_upscale_model(str(path), device="cpu")
    assert tarch == arch == family
    img = (np.random.default_rng(11).standard_normal((1, 24, 40, 3)) * 1.5
           + 0.3).astype(np.float32)
    jucfg = j.config.UpscaleConfig(
        tiling=j.config.TilingConfig(tile=16, overlap=4))
    ref = j.pipeline.hdr_upscale(params, j.jnp.asarray(img), jcfg, jucfg,
                                 architecture=arch,
                                 precision=j.config.Precision.parity())
    got = tpipe.hdr_upscale(net, torch.from_numpy(img),
                            UpscaleConfig(tiling=TilingConfig(tile=16,
                                                              overlap=4)),
                            architecture=arch, precision=Precision.parity())
    assert got.image.shape == (1, 24 * net.cfg.scale, 40 * net.cfg.scale, 3)
    assert torch.isfinite(got.image).all()
    for name in ("unclamped", "clamped", "image"):
        d = np.abs(getattr(got, name).numpy()
                   - np.asarray(getattr(ref, name)))
        assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-3, \
            (name, d.mean(), np.percentile(d, 99.9))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_upscale_node_and_cli_match_jax(tmp_path, monkeypatch, capsys,
                                        family):
    """The upscale node and ``cli upscale`` take the family's checkpoint
    by file, with no flag of their own, and agree with the JAX package's
    node and CLI (mean <= 1e-5 and p99.9 <= 1e-3 of |difference|, as the
    two-pass upscale above)."""
    j = _jax()
    mdir = tmp_path / "upscale_models"
    mdir.mkdir()
    name = f"{family}.pth"
    torch.save(FAMILIES[family][0](), mdir / name)
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(tnodes.HDRUpscaleWithModel, "device", "cpu")
    img = (np.random.default_rng(6).standard_normal((1, 10, 12, 3))
           * 1.5).astype(np.float32)
    options = {"small_blur": False, "local_fix": False,
               "upscale_method": "bislerp"}
    (ref,) = j.nodes.HDRUpscaleWithModel().upscale(img, name, **options)
    (got,) = tnodes.HDRUpscaleWithModel().upscale(torch.from_numpy(img),
                                                   name, **options)
    assert got.shape == (1, 40, 48, 3)
    d = np.abs(got.numpy() - np.asarray(ref))
    assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-3, \
        (d.mean(), np.percentile(d, 99.9))

    src = str(tmp_path / "in.npy")
    np.save(src, np.abs(img[0]))
    args = ["upscale", "--image", src, "--model", str(mdir / name),
            "--tile", "8", "--overlap", "2", "--prefix", "up"]
    outs = {}
    for side, cli, extra in (("jax", j.cli, []),
                             ("port", tcli, ["--device", "cpu"])):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / side))
        assert cli.main(args + extra) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        outs[side] = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][0]["architecture"] == family
    d = np.abs(texr.read_exr(outs["port"][1]["filepath"])
               - texr.read_exr(outs["jax"][1]["filepath"]))
    assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-3, \
        (d.mean(), np.percentile(d, 99.9))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m "
                    "pytest -m cuda tests/test_torch_upscale_families.py "
                    "--noconftest")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_on_the_card(dev, family, tier):
    """Each family's forward on the card against its plain CPU forward
    (the same layers): parity within 1e-4, fast within 5e-2 of max(1,
    max|ref|)."""
    sd = FAMILIES[family][0]()
    loaders = {"Compact": (tsrvgg.srvgg_from_state_dict,
                           tsrvgg.srvgg_apply),
               "SPAN": (tspan.span_from_state_dict, tspan.span_apply),
               "RealPLKSR": (tplk.realplksr_from_state_dict,
                             tplk.realplksr_apply)}
    load, apply = loaders[family]
    cpu, _ = load(sd, device="cpu")
    card, _ = load(sd, device=dev)
    x = torch.from_numpy(_image(shape=(1, 24, 40, 3)))
    prec = getattr(Precision, tier)()
    ref = apply(cpu, x, precision=prec)
    got = apply(card, x.to(dev), precision=prec)
    torch.cuda.synchronize()
    _assert_close(got.float().cpu().numpy(), ref.float().numpy(), tier)
