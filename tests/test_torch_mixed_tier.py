"""The mixed tier's configuration as the JAX package defines it:
``Precision.fast_head_levels`` (``head_precision``, ``for_level``), the
``upstack`` executor switch, and ``load_decoder``.

The JAX package's ``init_decoder(PRNGKey(0), cfg)`` parameters are carried
across with ``state_dict_from_jax``; latents are made with numpy from a
seed.  Everything runs at ``with_small()`` (z = 4, ch = 16, 2 levels) on
CPU tensors, where the port's kernel wrappers run their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.models import decoder as jdec
from hdrvae.models.params import decoder_params_to_state_dict
from hdrvae.models.params import infer_decoder_config as jinfer
from hdrvae.models.params import load_decoder as jload_decoder
from hdrvae.models.params import load_safetensors
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.decode import staged
from hdrvae_torch.models import decoder as tdec
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        load_decoder, state_dict_from_jax)
from hdrvae_torch.models.rrdbnet import (RRDBNetConfig, init_rrdbnet,
                                         rrdbnet_apply, rrdbnet_layers)
from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply

torch.set_num_threads(2)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port decoder) with the same weights."""
    jcfg = JDecoderConfig().with_small()
    params = jdec.init_decoder(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return jcfg, params, dec


def _latent(seed=1, hw=8, zc=4):
    return (np.random.default_rng(seed).standard_normal((1, hw, hw, zc))
            * 2.0).astype(np.float32)


def _fields(p):
    """A Precision's fields, the JAX dtypes mapped to torch's."""
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)
         if f.name != "param_dtype"}
    for key in ("compute_dtype", "storage_dtype"):
        d[key] = _DTYPES.get(d[key], d[key])
    return d


TIERS = {"fast": (JPrecision.fast, Precision.fast),
         "parity": (JPrecision.parity, Precision.parity),
         "mixed": (JPrecision.mixed, Precision.mixed)}


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("tier", list(TIERS))
def test_head_precision_and_for_level_match_jax(tier, k):
    jmake, tmake = TIERS[tier]
    jp = (jmake(fast_head_levels=k) if tier == "mixed"
          else dataclasses.replace(jmake(), fast_head_levels=k))
    tp = (tmake(fast_head_levels=k) if tier == "mixed"
          else dataclasses.replace(tmake(), fast_head_levels=k))
    assert _fields(tp) == _fields(jp)
    assert _fields(tp.head_precision()) == _fields(jp.head_precision())
    for level in range(4):
        assert _fields(tp.for_level(level)) == _fields(jp.for_level(level))


def test_upstack_values():
    for name in ("auto", "xla", "pallas"):
        assert Precision(upstack=name).upstack == name
    with pytest.raises(ValueError, match="upstack"):
        Precision(upstack="triton")
    with pytest.raises(ValueError, match="upstack"):
        dataclasses.replace(Precision.fast(), upstack="fused")


@pytest.mark.parametrize("k", [1, 2])
def test_fast_head_levels_decode_matches_jax(pair, k):
    """Precision.mixed(fast_head_levels=k): conv_in, the mid and the up
    levels >= k in bf16, the rest in mixed, on the layers.  Both sides round
    to bf16 at the same points of the head and compute in float32 between
    them; float32 sum-order noise flips none of those roundings here
    (measured <= 2.2e-6 on the pre map; one flip would move it by ~2^-8 of
    its scale), so the float32 tiers' bar of 1e-5 holds.  The head really
    ran in bf16: the decode is ~1e-2 away from the all-mixed one."""
    jcfg, params, dec = pair
    z = _latent(k)
    ref = jdec.decoder_apply(params, jnp.asarray(z), jcfg,
                             precision=JPrecision.mixed(fast_head_levels=k))
    got = tdec.decoder_apply(dec, torch.from_numpy(z),
                             precision=Precision.mixed(fast_head_levels=k))
    assert got.pre_conv_out.dtype == torch.float32
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.pre_conv_out.numpy(),
                               np.asarray(ref.pre_conv_out), atol=1e-5, rtol=0)
    mixed = tdec.decoder_apply(dec, torch.from_numpy(z),
                               precision=Precision.mixed())
    assert (got.pre_conv_out - mixed.pre_conv_out).abs().max().item() > 1e-3


def test_fast_head_levels_head_launch_route(pair, monkeypatch):
    """The head's mid attention in a fast_head_levels decode goes to the
    bf16 wrapper, never to the 3-pass or the float32 one."""
    from hdrvae_torch.kernels import attention as tattn
    _, _, dec = pair
    calls = []
    for name in ("flash_attention_bf16", "flash_attention_3pass",
                 "flash_attention_f32"):
        real = getattr(tattn, name)

        def rec(q, k, v, name=name, real=real):
            calls.append(name)
            return real(q, k, v)
        monkeypatch.setattr(tattn, name, rec)
    tdec.decoder_apply(dec, torch.from_numpy(_latent()),
                       precision=Precision.mixed(fast_head_levels=1))
    assert calls == ["flash_attention_bf16"]
    calls.clear()
    tdec.decoder_apply(dec, torch.from_numpy(_latent()),
                       precision=Precision.mixed())
    assert calls == ["flash_attention_3pass"]


def test_upstack_xla_fast_matches_jax_layers(pair):
    """upstack="xla" runs the fast tier on the layers: the JAX package's
    fast XLA layers, bf16 at the same points (bit-equal here; held to
    one bf16 ulp of the map's scale)."""
    jcfg, params, dec = pair
    z = _latent(3)
    ref = jdec.decoder_apply(params, jnp.asarray(z), jcfg,
                             precision=dataclasses.replace(JPrecision.fast(),
                                                           upstack="xla"))
    got = tdec.decoder_apply(dec, torch.from_numpy(z),
                             precision=dataclasses.replace(Precision.fast(),
                                                           upstack="xla"))
    assert got.pre_conv_out.dtype == torch.bfloat16
    rp = np.asarray(ref.pre_conv_out.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(rp).max())) - 7)
    assert np.abs(got.pre_conv_out.float().numpy() - rp).max() <= ulp
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb),
                               atol=ulp, rtol=0)


def test_upstack_routes(pair, monkeypatch):
    """"auto" and "pallas" take the fused chain in the fast tier, "xla"
    the layers; "auto" keeps the layers in parity and mixed."""
    from hdrvae_torch.models import fused_tail
    _, _, dec = pair
    calls = []
    real = fused_tail.forward

    def rec(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fused_tail, "forward", rec)
    z = torch.from_numpy(_latent())
    want = {("fast", "auto"): 1, ("fast", "pallas"): 1, ("fast", "xla"): 0,
            ("mixed", "auto"): 0, ("parity", "xla"): 0}
    for (tier, upstack), n in want.items():
        calls.clear()
        prec = dataclasses.replace(TIERS[tier][1](), upstack=upstack)
        tdec.decoder_apply(dec, z, precision=prec)
        assert len(calls) == n, (tier, upstack)


@pytest.mark.parametrize("tier", ["mixed", "parity"])
def test_upstack_pallas_outside_fast_raises(pair, tier):
    _, _, dec = pair
    prec = dataclasses.replace(TIERS[tier][1](), upstack="pallas")
    with pytest.raises(ValueError, match="pallas"):
        tdec.decoder_apply(dec, torch.from_numpy(_latent()), precision=prec)
    with pytest.raises(ValueError, match="pallas"):
        tdec.decoder_apply(dec, torch.from_numpy(_latent()),
                           precision=Precision(mode="mixed",
                                               fast_head_levels=1,
                                               upstack="pallas"))


@pytest.fixture(scope="module")
def rrdb():
    return init_rrdbnet(RRDBNetConfig().with_small(), seed=0, device="cpu")


def test_rrdbnet_upstack(rrdb):
    """ESRGAN honours upstack as the decoder does: "pallas" runs the K6
    chain (its plain version on a CPU tensor), "xla" and "auto" on a CPU
    tensor the layers; "pallas" outside the fast tier raises."""
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 12, 16, 3)).astype(np.float32))
    fast = Precision.fast()
    chain = rrdbnet_fused_apply(rrdb, x, precision=fast)
    layers = rrdbnet_layers(rrdb, x, precision=fast)
    got = rrdbnet_apply(rrdb, x, precision=dataclasses.replace(
        fast, upstack="pallas"))
    assert torch.equal(got, chain)
    for upstack in ("xla", "auto"):
        got = rrdbnet_apply(rrdb, x, precision=dataclasses.replace(
            fast, upstack=upstack))
        assert torch.equal(got, layers)
    with pytest.raises(ValueError, match="pallas"):
        rrdbnet_apply(rrdb, x, precision=dataclasses.replace(
            Precision.parity(), upstack="pallas"))


def test_fast_head_levels_not_routed_staged(pair, monkeypatch):
    """As tests/test_staged.py: with the staged threshold at 1 a mixed
    decode with fast_head_levels stays whole-image (the staged executor
    runs the whole decoder in mixed): the same result, bit for bit, as
    with the threshold unset, and finite; the plain mixed decode takes the
    staged route."""
    _, _, dec = pair
    z = torch.from_numpy(_latent(5, hw=16))
    prec = Precision.mixed(fast_head_levels=1)
    whole = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), prec)
    calls = []
    real = staged.staged_hdr_decode

    def rec(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(staged, "staged_hdr_decode", rec)
    monkeypatch.setattr(tpipe, "_STAGED_MIN_PIXELS_OVERRIDE", 1)
    res = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), prec)
    assert calls == [] and torch.isfinite(res.image).all()
    assert torch.equal(res.image, whole.image)
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.mixed())
    assert calls == [1]


def test_staged_refuses_fast_head_levels(pair):
    _, _, dec = pair
    with pytest.raises(ValueError, match="fast_head_levels"):
        staged.staged_hdr_decode(dec, torch.from_numpy(_latent()),
                                 HDRDecodeConfig(),
                                 Precision.mixed(fast_head_levels=1))


def _write_checkpoint(path, jcfg, params, extra=True):
    """The JAX decoder as an ldm checkpoint under ``decoder.``, with an
    encoder key and a quant conv beside it as in a whole-VAE file."""
    from safetensors.numpy import save_file
    sd = {"decoder." + k: np.ascontiguousarray(v, np.float32)
          for k, v in decoder_params_to_state_dict(params, jcfg).items()}
    if extra:
        rng = np.random.default_rng(9)
        sd["encoder.conv_in.weight"] = rng.standard_normal(
            (16, 3, 3, 3)).astype(np.float32)
        sd["quant_conv.weight"] = rng.standard_normal(
            (8, 8, 1, 1)).astype(np.float32)
    save_file(sd, str(path))
    return sd


def test_load_decoder_round_trip(pair, tmp_path):
    """load_decoder of a seeded decoder written to a .safetensors file
    holds exactly its weights (prefix stripped, the encoder's keys left
    out) and infers the JAX package's topology from them (z = 4 takes the
    SD family's latent constants, the group count the largest power of two
    up to 32 that divides every width); its parity decode matches the JAX
    package's load_decoder on the same file within 1e-5."""
    jcfg, params, dec = pair
    path = tmp_path / "vae.safetensors"
    sd = _write_checkpoint(path, jcfg, params)
    got = load_decoder(str(path), device="cpu")
    jinferred = jinfer(load_safetensors(str(path)))
    assert dataclasses.asdict(got.cfg) == {
        k: v for k, v in dataclasses.asdict(jinferred).items()
        if k in dataclasses.asdict(got.cfg)}
    assert set(got.state_dict()) == set(dec.state_dict())
    for key, val in got.state_dict().items():
        assert torch.equal(val, dec.state_dict()[key]), key
        np.testing.assert_array_equal(val.numpy(), sd["decoder." + key])
    z = _latent(6)
    ref = jdec.decoder_apply(jload_decoder(str(path)), jnp.asarray(z),
                             jinferred, precision=JPrecision.parity())
    out = tdec.decoder_apply(got, torch.from_numpy(z),
                             precision=Precision.parity())
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.pre_conv_out.numpy(),
                               np.asarray(ref.pre_conv_out), atol=1e-5,
                               rtol=0)


def test_load_decoder_linear_attention_and_given_config(pair, tmp_path):
    """The mid attention's projections stored as linears [O, I] (diffusers)
    load as the 1x1 convs; an explicit cfg is taken as it is."""
    jcfg, params, dec = pair
    from safetensors.numpy import save_file
    sd = {k: np.ascontiguousarray(v, np.float32)
          for k, v in decoder_params_to_state_dict(params, jcfg).items()}
    for name in ("q", "k", "v", "proj_out"):
        key = f"mid.attn_1.{name}.weight"
        sd[key] = np.ascontiguousarray(sd[key][:, :, 0, 0])
    path = tmp_path / "linear.safetensors"
    save_file(sd, str(path))
    got = load_decoder(str(path), DecoderConfig().with_small(),
                       device="cpu")
    for key, val in dec.state_dict().items():
        assert torch.equal(got.state_dict()[key], val), key


def test_load_decoder_defaults_to_the_card(pair, tmp_path):
    """Like every loader of the port, load_decoder defaults to the card
    and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, params, _ = pair
    path = tmp_path / "vae.safetensors"
    _write_checkpoint(path, jcfg, params, extra=False)
    with pytest.raises((RuntimeError, AssertionError)):
        load_decoder(str(path))
