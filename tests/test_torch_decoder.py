"""The port's decoder against the JAX package's, on the same weights.

The JAX package's ``init_decoder(PRNGKey(0), cfg)`` parameters are carried
across with ``state_dict_from_jax`` into the port's ``Decoder``; latents are
made with numpy from a seed.  Everything runs at ``with_small()`` (z = 4,
ch = 16, 2 levels) on CPU tensors, where the port's kernel wrappers run
their plain versions.
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
from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.models import decoder as tdec
from hdrvae_torch.models import fused_tail
from hdrvae_torch.models.decoder import Decoder
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        infer_decoder_config, init_decoder,
                                        state_dict_from_jax)

torch.set_num_threads(2)

_JAX_TIERS = {"parity": JPrecision.parity(), "mixed": JPrecision.mixed(),
              "fast": JPrecision.fast()}
_PORT_TIERS = {"parity": Precision.parity(), "mixed": Precision.mixed(),
               "fast": Precision.fast()}


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port decoder) with the same weights."""
    jcfg = JDecoderConfig().with_small()
    params = jdec.init_decoder(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(state_dict_from_jax(params_np, cfg), cfg,
                                  device="cpu")
    return jcfg, params, dec


def _latent(seed=1, hw=8, zc=4):
    return (np.random.default_rng(seed).standard_normal((1, hw, hw, zc))
            * 2.0).astype(np.float32)


def _np32(x):
    return np.asarray(x, np.float32)


def test_fused_chain_matches_jax_layers(pair):
    """The port's fused chain with norm_out fed the chain's moments, vs the
    JAX package's XLA layers (decoder_head + decoder_tail), both in a
    float32-storage fast tier: the same function, so the JAX chain's own
    bar of 2e-5 holds."""
    jcfg, params, dec = pair
    z = _latent()
    jprec = JPrecision(compute_dtype=jnp.float32, storage_dtype=jnp.float32,
                       mode="fast")
    x = jdec.decoder_head(params, jnp.asarray(z), jcfg, precision=jprec)
    ref = jdec.decoder_tail(params, x, jcfg, precision=jprec)

    prec = Precision(compute_dtype=torch.float32,
                     storage_dtype=torch.float32, mode="fast")
    pre, moments = fused_tail.forward(dec, torch.from_numpy(z),
                                      precision=prec)
    got = tdec.decoder_tail(dec, pre, precision=prec, moments=moments)
    np.testing.assert_allclose(got.rgb.numpy(), _np32(ref.rgb), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got.pre_conv_out.numpy(),
                               _np32(ref.pre_conv_out), atol=2e-5, rtol=0)


@pytest.mark.parametrize("tier", ["parity", "mixed"])
def test_decoder_apply_float32_tiers(pair, tier):
    """Parity and mixed: float32 activations on both sides (on the CPU the
    JAX mixed tier's HIGH dots run in float32 too); <= 1e-5, the bar of
    tests/test_decoder.py."""
    jcfg, params, dec = pair
    z = _latent(2)
    ref = jdec.decoder_apply(params, jnp.asarray(z), jcfg,
                             precision=_JAX_TIERS[tier])
    got = tdec.decoder_apply(dec, torch.from_numpy(z),
                             precision=_PORT_TIERS[tier])
    assert got.pre_conv_out.dtype == torch.float32
    np.testing.assert_allclose(got.rgb.numpy(), _np32(ref.rgb), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.pre_conv_out.numpy(),
                               _np32(ref.pre_conv_out), atol=1e-5, rtol=0)


def test_decoder_apply_fast_tier(pair):
    """Fast: the port's fused chain against the JAX XLA layers, both in
    bf16.  The chain adds each residual in float32 before the bf16 store,
    the layers after it, so roundings differ by design; the bound is the
    JAX package's own for its chain (tests/test_conv_kernels.py): 2% of the
    pre map's scale, 0.02 on rgb."""
    jcfg, params, dec = pair
    z = _latent(3)
    ref = jdec.decoder_apply(params, jnp.asarray(z), jcfg,
                             precision=_JAX_TIERS["fast"])
    got = tdec.decoder_apply(dec, torch.from_numpy(z),
                             precision=_PORT_TIERS["fast"])
    assert got.pre_conv_out.dtype == torch.bfloat16
    rp = _np32(ref.pre_conv_out.astype(jnp.float32))
    gp = got.pre_conv_out.float().numpy()
    assert np.abs(gp - rp).max() <= 0.02 * max(np.abs(rp).max(), 1.0)
    assert np.abs(got.rgb.numpy() - _np32(ref.rgb)).max() <= 0.02


@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_batch_is_per_sample(pair, tier):
    """A batch of two decodes each sample as if alone (GroupNorm moments
    and attention are per sample)."""
    _, _, dec = pair
    z = np.concatenate([_latent(4), _latent(5)])
    prec = _PORT_TIERS[tier]
    both = tdec.decoder_apply(dec, torch.from_numpy(z), precision=prec)
    one = tdec.decoder_apply(dec, torch.from_numpy(z[1:]), precision=prec)
    np.testing.assert_allclose(both.rgb[1:].numpy(), one.rgb.numpy(),
                               atol=1e-6, rtol=0)


def test_state_dict_from_jax_matches_reference(pair):
    """Key for key and value for value the JAX package's
    decoder_params_to_state_dict."""
    jcfg, params, _ = pair
    ref = decoder_params_to_state_dict(params, jcfg)
    got = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              DecoderConfig().with_small())
    assert list(got) == list(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), val)


def test_decoder_module_names_are_ldm_keys(pair):
    """load_state_dict takes the ldm dict as it is: the module's keys are
    exactly the ldm keys."""
    jcfg, params, _ = pair
    ref = decoder_params_to_state_dict(params, jcfg)
    with torch.device("meta"):
        keys = set(Decoder(DecoderConfig().with_small()).state_dict())
    assert keys == set(ref)


def test_infer_full_width_config():
    """The full Flux.1 decoder's shapes give back DecoderConfig()."""
    with torch.device("meta"):
        sd = Decoder(DecoderConfig()).state_dict()
    assert infer_decoder_config(sd) == DecoderConfig()
    prefixed = {"decoder." + k: v for k, v in sd.items()}
    assert infer_decoder_config(prefixed) == DecoderConfig()
    n = sum(v.numel() for v in sd.values())
    assert 49_000_000 < n < 50_000_000


def test_infer_small_config_matches_jax(pair):
    """Conventions included (SD-family latent constants for z = 4, the
    largest power-of-two group count up to 32): the JAX package's
    inference, field for field."""
    from hdrvae.models.params import infer_decoder_config as jinfer
    jcfg, params, _ = pair
    sd = decoder_params_to_state_dict(params, jcfg)
    got, ref = (dataclasses.asdict(infer_decoder_config(sd)),
                dataclasses.asdict(jinfer(sd)))
    assert got == {k: ref[k] for k in got}


def test_init_decoder_is_seeded():
    cfg = DecoderConfig().with_small()
    a, b, c = (init_decoder(cfg, s, device="cpu").state_dict()
               for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert torch.all(a["norm_out.weight"] == 1)
