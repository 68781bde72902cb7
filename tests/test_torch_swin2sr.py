"""The port's Swin2SR upscaler against the JAX package: K7's SwinV2 body
(plain version) against the JAX kernel in interpret mode and against the
JAX package's unfused block, the continuous position bias, every head of
the forward, the official and HuggingFace loaders, the zoo and
``hdr_upscale`` end to end.

Weights are made with numpy in the port and loaded into the JAX package
from the official state dict (carried back with
``swin2sr_state_dict_from_jax``); inputs are made with numpy from a seed.
Everything runs at ``with_small()`` widths on CPU tensors.  Tolerances:
the parity tier <= 1e-5 * max(1, max|ref|); the fast tier (bf16) <= 5e-2 *
max(1, max|ref|), the two packages rounding the same float32 sums, taken in
different orders, to bf16.  Images after the logit reversal are compared
by mean and p99.9.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import Precision as JPrecision
from hdrvae.core.config import TilingConfig as JTilingConfig
from hdrvae.core.config import UpscaleConfig as JUpscaleConfig
from hdrvae.kernels import swin_attention as jska
from hdrvae.models import swin2sr as js2
from hdrvae.models import zoo as jzoo
from hdrvae.upscale import pipeline as jpipe
from hdrvae_torch.core.config import Precision, TilingConfig, UpscaleConfig
from hdrvae_torch.kernels import swin_attention as tska
from hdrvae_torch.models import swin2sr as ts2
from hdrvae_torch.models import swinir as tswin
from hdrvae_torch.models import zoo as tzoo
from hdrvae_torch.models.params import swin2sr_state_dict_from_jax
from hdrvae_torch.upscale import pipeline as tpipe
from tests.torch_oracle import TorchSwin2SR

torch.set_num_threads(2)

JFAST = JPrecision(compute_dtype=jnp.bfloat16, storage_dtype=jnp.bfloat16,
                   mode="fast")
TIERS = {"parity": (JPrecision.parity(), Precision.parity()),
         "fast": (JFAST, Precision.fast())}
FUSED = {k: (dataclasses.replace(j, swin_attn="pallas"),
             dataclasses.replace(t, swin_attn="pallas"))
         for k, (j, t) in TIERS.items()}
UNFUSED_J = {k: dataclasses.replace(j, swin_attn="xla")
             for k, (j, _) in TIERS.items()}


def _np(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _interpret(fn):
    """Run a JAX call with the Swin kernels in interpret mode (the seam of
    ``tests/test_swin_kernel.py``)."""
    jska._INTERPRET = True
    try:
        return fn()
    finally:
        jska._INTERPRET = False


def _err(got, ref):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(ref, np.float32)).max())


def _budget(ref, tier):
    big = max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))
    return (1e-5 if tier == "parity" else 5e-2) * big


def _to_jax(a, tier):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if tier == "fast" else x


def _to_torch(a, tier):
    x = torch.from_numpy(a)
    return x.bfloat16() if tier == "fast" else x


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K7's v2 body
# ---------------------------------------------------------------------------


def _block_pair(seed, dim, heads, ws, hidden):
    """One SwinV2 block's weights from numpy, as a JAX pytree and as the
    port's ``Swin2Block``: LN affines, biases and the CPB MLP non-trivial,
    the logit scales log 10 and log 150 (past the clamp at log 100)."""
    r = iter(range(seed, seed + 100))
    lin = lambda i, o: (_np(next(r), (o, i), i ** -0.5),   # noqa: E731
                        _np(next(r), (o,), 0.1))
    qkv, proj, fc1, fc2 = (lin(dim, 3 * dim), lin(dim, dim),
                           lin(dim, hidden), lin(hidden, dim))
    q_bias, v_bias = _np(next(r), (dim,), 0.3), _np(next(r), (dim,), 0.3)
    n1, n2 = ((_np(next(r), (dim,), 0.2, 1.0), _np(next(r), (dim,), 0.1))
              for _ in range(2))
    logit = np.log(np.linspace(10.0, 150.0, heads)).astype(
        np.float32).reshape(heads, 1, 1)
    cpb1 = (_np(next(r), (512, 2)), _np(next(r), (512,), 0.5))
    cpb2 = _np(next(r), (heads, 512), 512 ** -0.5)
    jl = lambda wb: {"kernel": wb[0].T, "bias": wb[1]}     # noqa: E731
    jp = {"attn": {"qkv": {"kernel": qkv[0].T,
                           "bias": np.concatenate([q_bias, 0 * q_bias,
                                                   v_bias])},
                   "proj": jl(proj), "logit_scale": logit,
                   "cpb_fc1": jl(cpb1), "cpb_fc2": {"kernel": cpb2.T}},
          "norm1": {"scale": n1[0], "bias": n1[1]},
          "norm2": {"scale": n2[0], "bias": n2[1]},
          "mlp": {"fc1": jl(fc1), "fc2": jl(fc2)}}
    blk = ts2.Swin2Block(dim, heads, ws, hidden / dim)
    sd = {"attn.qkv.weight": qkv[0], "attn.q_bias": q_bias,
          "attn.v_bias": v_bias, "attn.logit_scale": logit,
          "attn.cpb_mlp.0.weight": cpb1[0], "attn.cpb_mlp.0.bias": cpb1[1],
          "attn.cpb_mlp.2.weight": cpb2,
          "attn.proj.weight": proj[0], "attn.proj.bias": proj[1],
          "norm1.weight": n1[0], "norm1.bias": n1[1],
          "norm2.weight": n2[0], "norm2.bias": n2[1],
          "mlp.fc1.weight": fc1[0], "mlp.fc1.bias": fc1[1],
          "mlp.fc2.weight": fc2[0], "mlp.fc2.bias": fc2[1]}
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jax.tree_util.tree_map(jnp.asarray, jp), blk.requires_grad_(False)


def _jax_scale(jp, heads):
    return jnp.exp(jnp.minimum(jp["attn"]["logit_scale"],
                               math.log(100.0))).reshape(heads)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("ws,shift", [(4, 0), (4, 2), (8, 0), (8, 4)])
def test_swin_block_v2_plain_vs_jax(ws, shift, with_extra, tier):
    """K7's v2 body, plain version, against the JAX kernel (interpret mode,
    ``post_norm`` with ``qk_scale``) on a 2 x 2 window grid, windows 4 and
    8, unshifted and shifted, with and without an ``extra`` residual; one
    head's logit scale is past the clamp."""
    dim, heads = 16, 2
    jp, blk = _block_pair(3, dim, heads, ws, 2 * dim)
    hw = 2 * ws
    img = _np(4, (1, hw, hw, dim), 1.0, 0.3)
    extra = _np(5, (1, hw, hw, dim), 0.1) if with_extra else None
    jprec, tprec = TIERS[tier]
    ref = _interpret(lambda: jska.swin_block_fused(
        _to_jax(img, tier), jp["attn"], jp["norm1"], jp["norm2"], jp["mlp"],
        heads, ws=ws, shift=shift, bias_hnn=js2._cpb_bias(jp["attn"], ws),
        bwin=jska.pick_bwin(hw // ws, ws * ws), precision=jprec,
        extra=None if extra is None else _to_jax(extra, tier),
        post_norm=True, qk_scale=_jax_scale(jp, heads)))
    w = ts2.block_weights_v2(blk, heads, ws, tprec.compute_dtype)
    assert w.post_norm and w.qk_scale[-1].item() == pytest.approx(100.0)
    got = tska.swin_block_fused(
        _to_torch(img, tier), w, ws=ws, shift=shift,
        extra=None if extra is None else _to_torch(extra, tier),
        precision=tprec)
    assert got.dtype == tprec.storage_dtype and got.shape == img.shape
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


@pytest.mark.parametrize("executor,tier", [("fused", "parity"),
                                           ("unfused", "parity"),
                                           ("unfused", "fast")])
@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_v2_window7_vs_jax_unfused(shift, executor, tier):
    """Window 7 (49 tokens, the JPEG-CAR family's), which the JAX gate
    refuses for its kernel: the port's fused block (K7's plain version) and
    its unfused layers against the JAX package's unfused SwinV2 block on a
    2 x 3 window grid.  The fused block in the fast tier is held to the
    JAX kernel above: it rounds the scaled q (up to 100 times the unit
    row) to bf16 where the unfused block rounds the unit row, and the
    softmax of scores scaled up to 100 amplifies that difference."""
    dim, heads, ws = 16, 2, 7
    with pytest.raises(AssertionError, match="unsupported"):
        jska.use_swin_kernel(FUSED["fast"][0], 14, 21, ws, 8)
    jp, blk = _block_pair(9, dim, heads, ws, 2 * dim)
    x = _np(10, (1, 14, 21, dim))
    ref = js2._swin2_block(_to_jax(x, tier), jp, heads, ws, shift,
                           UNFUSED_J[tier])
    prec = dataclasses.replace(TIERS[tier][1], swin_attn="pallas"
                               if executor == "fused" else "xla")
    got = ts2.swin2_block(_to_torch(x, tier), blk, heads, ws, shift, prec)
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


def test_cpb_bias_matches_jax():
    """The continuous position bias (values in [0, 16]; float32 sums over
    the MLP's 512 hidden units in another order): <= 1e-6 * max(1,
    max|ref|); its coords table exactly."""
    for ws in (4, 7, 8):
        jp, blk = _block_pair(12, 16, 2, ws, 32)
        ref = np.asarray(js2._cpb_bias(jp["attn"], ws))
        got = ts2.cpb_bias(blk.attn, ws).numpy()
        assert got.shape == ref.shape == (2, ws * ws, ws * ws)
        assert _err(got, ref) <= 1e-6 * max(1.0, np.abs(ref).max())
        np.testing.assert_array_equal(ts2.cpb_coords_table(ws).numpy(),
                                      js2._cpb_coords_table(ws))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _official_sd(net):
    """The network's state dict with the geometry buffers an official
    checkpoint carries in every block."""
    sd = dict(net.state_dict())
    geo = ts2.geometry_buffers(net.cfg.window_size)
    for k in list(sd):
        if k.endswith(".attn.logit_scale"):
            for name, buf in geo.items():
                sd[k[:-len("logit_scale")] + name] = buf.clone()
    return sd


def _pair(seed=0, **kw):
    """A seeded Swin2SR of the port, loaded into the JAX package from its
    official state dict and carried back with
    ``swin2sr_state_dict_from_jax``: the round trip is exact and both
    loaders infer the same config."""
    cfg = dataclasses.replace(ts2.Swin2SRConfig().with_small(), **kw)
    if cfg.upsampler == "":       # the loaders' JPEG-CAR default
        cfg = dataclasses.replace(cfg, img_range=255.0)
    if cfg.upsampler in ("pixelshuffledirect", ""):
        # these heads have no num_feat; both loaders report the width
        cfg = dataclasses.replace(cfg, num_feat=cfg.embed_dim)
    sd = _official_sd(ts2.init_swin2sr(cfg, seed=seed, device="cpu"))
    params, jcfg = js2.swin2sr_from_state_dict(sd)
    back = swin2sr_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg.window_size)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        assert torch.equal(v.to(sd[k].dtype), sd[k]), k
    net, tcfg = ts2.swin2sr_from_state_dict(back, device="cpu")
    assert tcfg == cfg
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return params, jcfg, net


# one RSTB of two blocks (unshifted, shifted) keeps the JAX side's eager
# dispatch short
ONE_LAYER = dict(depths=(2,), num_heads=(2,))
HEADS = [("pixelshuffle", 2), ("pixelshuffle_aux", 2),
         ("pixelshuffledirect", 2), ("nearest+conv", 4), ("", 1)]


@pytest.mark.parametrize("resi", ["1conv", "3conv"])
@pytest.mark.parametrize("upsampler,scale", HEADS)
def test_swin2sr_apply_parity(upsampler, scale, resi):
    """Every head with either RSTB conv, on a 10 x 13 input that is
    reflect-padded to window multiples and cropped back: <= 1e-5 *
    max(1, max|ref|)."""
    params, jcfg, net = _pair(1, upsampler=upsampler, scale=scale,
                              resi_connection=resi, **ONE_LAYER)
    x = _np(2, (1, 10, 13, 3), 0.3, 0.5)
    ref = np.asarray(js2.swin2sr_apply(params, jnp.asarray(x), jcfg,
                                       precision=JPrecision.parity()))
    got = ts2.swin2sr_apply(net, torch.from_numpy(x),
                            precision=Precision.parity())
    assert got.shape == ref.shape == (1, 10 * scale, 13 * scale, 3)
    assert _err(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_swin2sr_apply_fused_vs_jax(tier):
    """Every block forced through the fused block (K7's v2 plain version
    here, the JAX kernel in interpret mode there) on a 16 x 16 input (the
    JAX kernel needs an even window-grid width)."""
    params, jcfg, net = _pair(3, **ONE_LAYER)
    x = _np(4, (1, 16, 16, 3), 0.3, 0.5)
    ref = np.asarray(_interpret(lambda: js2.swin2sr_apply(
        params, jnp.asarray(x), jcfg, precision=FUSED[tier][0])))
    got = ts2.swin2sr_apply(net, torch.from_numpy(x),
                            precision=FUSED[tier][1])
    assert _err(got, ref) <= _budget(ref, tier)


def _oracle_sd(module):
    torch.manual_seed(0)
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return module.state_dict()


@pytest.mark.parametrize("kw", [
    {}, {"upsampler": "pixelshuffle_aux"},
    {"upsampler": "nearest+conv", "scale": 4},
    {"upsampler": "pixelshuffledirect", "patch_norm": False},
    {"upsampler": "", "scale": 1, "img_range": 255.0}])
def test_swin2sr_oracle_checkpoint(kw):
    """A state dict of the official-schema network (with its coords table
    and index buffers) loads to the same config and tensors and runs to
    the oracle's output."""
    cfg = dataclasses.replace(ts2.Swin2SRConfig().with_small(), **kw)
    oracle = TorchSwin2SR(cfg)
    sd = _oracle_sd(oracle)
    if cfg.upsampler in ("pixelshuffledirect", ""):
        cfg = dataclasses.replace(cfg, num_feat=cfg.embed_dim)
    net, tcfg = ts2.swin2sr_from_state_dict(sd, device="cpu")
    assert tcfg == cfg
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = _np(8, (1, 9, 11, 3), 0.3, 0.5)
    ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = ts2.swin2sr_apply(net, torch.from_numpy(x),
                            precision=Precision.parity())
    assert got.shape == ref.shape
    assert _err(got, ref) <= 1e-4 * max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _hf_sd(sd):
    """An official state dict renamed to the ``transformers`` schema (the
    'pixelshuffle' head), with the identity patch projection."""
    out = {"swin2sr.embeddings.patch_embeddings.projection.weight":
           torch.eye(16).reshape(16, 16, 1, 1),
           "swin2sr.embeddings.patch_embeddings.projection.bias":
           torch.zeros(16)}
    static = {"conv_first": "swin2sr.first_convolution",
              "patch_embed.norm": "swin2sr.embeddings.patch_embeddings."
                                  "layernorm",
              "norm": "swin2sr.layernorm",
              "conv_after_body": "swin2sr.conv_after_body",
              "conv_before_upsample.0": "upsample.conv_before_upsample",
              "conv_last": "upsample.final_convolution",
              "upsample.0": "upsample.upsample.convolution_0"}
    blk = {"attn.proj": "attention.output.dense",
           "attn.cpb_mlp.0": "attention.self.continuous_position_bias_mlp.0",
           "attn.cpb_mlp.2": "attention.self.continuous_position_bias_mlp.2",
           "norm1": "layernorm_before", "norm2": "layernorm_after",
           "mlp.fc1": "intermediate.dense", "mlp.fc2": "output.dense"}
    for k, v in sd.items():
        base, _, leaf = k.rpartition(".")
        if base in static:
            out[f"{static[base]}.{leaf}"] = v
            continue
        parts = k.split(".")
        li = int(parts[1])
        if parts[2] == "conv":
            out[f"swin2sr.encoder.stages.{li}.{'.'.join(parts[2:])}"] = v
            continue
        bi = int(parts[4])
        rest = ".".join(parts[5:])
        pfx = f"swin2sr.encoder.stages.{li}.layers.{bi}."
        rbase, _, rleaf = rest.rpartition(".")
        if rest == "attn.logit_scale":
            out[pfx + "attention.self.logit_scale"] = v
        elif rest == "attn.qkv.weight":
            for j, name in enumerate(("query", "key", "value")):
                out[pfx + f"attention.self.{name}.weight"] = v[16 * j:
                                                               16 * (j + 1)]
        elif rest in ("attn.q_bias", "attn.v_bias"):
            name = "query" if rest == "attn.q_bias" else "value"
            out[pfx + f"attention.self.{name}.bias"] = v
            if name == "query":
                out[pfx + "attention.self.key.bias"] = torch.zeros_like(v)
        elif rbase in blk:
            out[f"{pfx}{blk[rbase]}.{rleaf}"] = v
        else:
            raise AssertionError(k)
    return out


def test_hf_checkpoint_loads_in_both():
    """The ``transformers`` export converts to the official schema as the
    JAX converter does and loads to the same network (window 8 by
    default, or as given); a non-identity patch projection and an ``ape``
    checkpoint are refused."""
    cfg = dataclasses.replace(ts2.Swin2SRConfig().with_small(),
                              window_size=8)
    net = ts2.init_swin2sr(cfg, seed=6, device="cpu")
    hf = _hf_sd(net.state_dict())
    assert ts2.is_hf_swin2sr_state_dict(hf) and ts2.is_swin2sr_state_dict(hf)
    ours, theirs = ts2.hf_swin2sr_to_original(hf), \
        js2.hf_swin2sr_to_original(hf)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    got, tcfg = ts2.swin2sr_from_state_dict(hf, device="cpu")
    assert tcfg == cfg
    for k, v in got.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k
    assert ts2.hf_swin2sr_to_original(hf, window_size=4)[
        "layers.0.residual_group.blocks.0.attn.relative_coords_table"
    ].shape == (1, 7, 7, 2)
    bad = dict(hf)
    bad["swin2sr.embeddings.patch_embeddings.projection.weight"] = \
        2 * torch.eye(16).reshape(16, 16, 1, 1)
    with pytest.raises(ValueError, match="projection"):
        ts2.swin2sr_from_state_dict(bad, device="cpu")
    ape = dict(hf)
    ape["swin2sr.embeddings.position_embeddings"] = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="ape"):
        ts2.swin2sr_from_state_dict(ape, device="cpu")


def test_official_loader_window_and_refusals():
    """The window comes from the coords table, else the index, else 8; an
    ``ape`` or ``pixelshuffle_hf`` checkpoint and a SwinIR one are
    refused."""
    cfg = ts2.Swin2SRConfig().with_small()
    sd = _official_sd(ts2.init_swin2sr(cfg, seed=7, device="cpu"))
    assert ts2.swin2sr_from_state_dict(sd, device="cpu")[1].window_size == 4
    no_table = {k: v for k, v in sd.items()
                if not k.endswith("relative_coords_table")}
    assert ts2.swin2sr_from_state_dict(
        no_table, device="cpu")[1].window_size == 4
    bare = {k: v for k, v in no_table.items()
            if not k.endswith("relative_position_index")}
    assert ts2.swin2sr_from_state_dict(bare, device="cpu")[1].window_size == 8
    assert js2.swin2sr_from_state_dict(bare)[1].window_size == 8
    for key, match in (("absolute_pos_embed", "ape"),
                       ("conv_first_hf.weight", "pixelshuffle_hf")):
        with pytest.raises(ValueError, match=match):
            ts2.swin2sr_from_state_dict({**sd, key: torch.zeros(1)},
                                        device="cpu")
    swinir_sd = tswin.init_swinir(tswin.SwinIRConfig().with_small(),
                                  device="cpu").state_dict()
    assert not ts2.is_swin2sr_state_dict(swinir_sd)
    with pytest.raises(ValueError, match="Swin2SR"):
        ts2.swin2sr_from_state_dict(swinir_sd, device="cpu")
    assert not tswin.is_swinir_state_dict(sd)


def test_jpeg_car_defaults():
    """The scale-1 '' head (JPEG-CAR): img_range 255 unless given, window
    7 from its buffers, and from the HF export's default."""
    cfg = dataclasses.replace(ts2.Swin2SRConfig().with_small(), upsampler="",
                              scale=1, window_size=7)
    sd = _official_sd(ts2.init_swin2sr(cfg, seed=8, device="cpu"))
    _, tcfg = ts2.swin2sr_from_state_dict(sd, device="cpu")
    _, jcfg = js2.swin2sr_from_state_dict(sd)
    assert (tcfg.img_range, tcfg.window_size, tcfg.scale) == (255.0, 7, 1)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert ts2.swin2sr_from_state_dict(sd, img_range=1.0,
                                       device="cpu")[1].img_range == 1.0
    hf = {"swin2sr.first_convolution.weight": sd["conv_first.weight"],
          "final_convolution.weight": sd["conv_last.weight"]}
    assert ts2.hf_swin2sr_to_original(hf)[
        "layers.0.residual_group.blocks.0.attn.relative_coords_table"
    ].shape == (1, 13, 13, 2)


def test_state_dict_from_jax_round_trip():
    """The JAX package's own init carried to the official schema (the
    qkv bias cut into q_bias / v_bias) loads to the JAX config with the
    same tensors; a pytree whose qkv bias has a k part is refused.  (The
    forwards on carried weights are compared in the tests above.)"""
    jcfg = dataclasses.replace(js2.Swin2SRConfig().with_small(), **ONE_LAYER)
    params = jax.tree_util.tree_map(
        np.asarray, js2.init_swin2sr(jax.random.PRNGKey(2), jcfg))
    sd = swin2sr_state_dict_from_jax(params, jcfg.window_size)
    net, cfg = ts2.swin2sr_from_state_dict(sd, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    attn = params["layers"][0]["blocks"][1]["attn"]
    got = net.layers[0].residual_group.blocks[1].attn
    np.testing.assert_array_equal(got.qkv.weight.numpy(),
                                  attn["qkv"]["kernel"].T)
    np.testing.assert_array_equal(ts2.qkv_bias(got).numpy(),
                                  attn["qkv"]["bias"])
    np.testing.assert_array_equal(got.cpb_mlp[2].weight.numpy(),
                                  attn["cpb_fc2"]["kernel"].T)
    blk = params["layers"][0]["blocks"][0]["attn"]["qkv"]
    blk["bias"] = blk["bias"] + 1.0
    with pytest.raises(ValueError, match="k part"):
        swin2sr_state_dict_from_jax(params, jcfg.window_size)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_zoo_detects_swin2sr(tmp_path, fmt):
    """``load_upscale_model`` names a Swin2SR checkpoint (.pth in BasicSR's
    wrapper, or .safetensors) Swin2SR, behind HAT and ahead of SwinIR whose
    spine it shares, as the JAX zoo does."""
    cfg = ts2.Swin2SRConfig().with_small()
    sd = _official_sd(ts2.init_swin2sr(cfg, seed=4, device="cpu"))
    path = tmp_path / f"swin2sr.{fmt}"
    if fmt == "pth":
        torch.save({"params_ema": sd}, path)
    else:
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    model, zcfg, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert (arch, zcfg) == ("Swin2SR", cfg) and isinstance(model, ts2.Swin2SR)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    _, jcfg, jarch = jzoo.load_upscale_model(str(path))
    assert jarch == "Swin2SR"
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert tswin.is_swinir_state_dict(sd) is False
    # a HAT key in the same dict: HAT is detected first
    hat = {**sd, "layers.0.residual_group.overlap_attn.qkv.weight":
           torch.zeros(1)}
    torch.save(hat, tmp_path / "hat.pth")
    with pytest.raises(ValueError, match="HAT"):
        tzoo.load_upscale_model(str(tmp_path / "hat.pth"), device="cpu")


def test_zoo_sizing_matches_jax():
    jcfg, cfg = js2.Swin2SRConfig(), ts2.Swin2SRConfig()
    for jp, tp in ((JPrecision.fast(), Precision.fast()),
                   (JPrecision.parity(), Precision.parity())):
        assert tzoo.working_set_bytes_per_pixel(cfg, tp) == \
            jzoo.working_set_bytes_per_pixel(jcfg, jp)


# ---------------------------------------------------------------------------
# hdr_upscale end to end
# ---------------------------------------------------------------------------


def test_hdr_upscale_parity():
    """The two-pass upscale of a 24 x 40 HDR image (values > 1 and < 0),
    tile 16, overlap 4, parity tier on both sides, Swin2SR's logit
    reversal: mean and p99.9 of |difference|."""
    params, jcfg, net = _pair(6)
    img = _np(11, (1, 24, 40, 3), 1.5, 0.3)
    jucfg = JUpscaleConfig(tiling=JTilingConfig(tile=16, overlap=4))
    ucfg = UpscaleConfig(tiling=TilingConfig(tile=16, overlap=4))
    ref = jpipe.hdr_upscale(params, jnp.asarray(img), jcfg, jucfg,
                            architecture="Swin2SR",
                            precision=JPrecision.parity())
    got = tpipe.hdr_upscale(net, torch.from_numpy(img), ucfg,
                            architecture="Swin2SR",
                            precision=Precision.parity())
    assert tpipe.get_reversal_fn("Swin2SR") is not \
        tpipe.get_reversal_fn("SwinIR")
    assert got.image.shape == (1, 48, 80, 3)
    assert torch.isfinite(got.image).all()
    for name in ("unclamped", "clamped", "image"):
        d = np.abs(getattr(got, name).numpy()
                   - np.asarray(getattr(ref, name)))
        assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-4, \
            (name, d.mean(), np.percentile(d, 99.9))
