"""The port's HDR decode, EXR writer and import boundary against the JAX
package.

``hdr_decode`` runs in the parity tier on both sides with the same weights
(carried across by ``state_dict_from_jax``) and the same numpy latent.  The
conservative mode and the standard image are compared by max-abs; the
exposure/adaptive/mathematical modes push the result through a logit and an
EV multiply that amplify float32 ulp noise by thousands near saturation, so
they are compared by the mean and the 99.9th percentile of |difference|.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.decode import pipeline as jpipe
from hdrvae.io import exr_py
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      Precision)
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.io import exr as texr
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return jcfg, params, dec, _latent(2)


# (seed, normalization the decode classifies): seed 2 clamps at both ends
# (SIGMOID: the logit inverse), seed 0 does not reach 1.0 (CUSTOM: the
# identity inverse)
LATENTS = {"sigmoid": 2, "custom": 0}


def _latent(seed):
    return (np.random.default_rng(seed).standard_normal((1, 8, 8, 4))
            * 2.0).astype(np.float32)


def _decode_both(pair, z=None, **cfg_kw):
    jcfg, params, dec, z0 = pair
    z = z0 if z is None else z
    ref = jpipe.hdr_decode(params, jnp.asarray(z), jcfg,
                           JHDRDecodeConfig(**cfg_kw), JPrecision.parity())
    got = tpipe.hdr_decode(dec, torch.from_numpy(z), HDRDecodeConfig(**cfg_kw),
                           Precision.parity())
    return ref, got


def _check_summaries(ref, got):
    rs, gs = jpipe.decode_summary(ref), tpipe.decode_summary(got)
    assert set(rs) == set(gs)
    for key in rs:
        if isinstance(rs[key], dict):
            assert set(rs[key]) == set(gs[key]), key
    assert gs["used_fallback"] == rs["used_fallback"]
    assert gs["normalization"] == rs["normalization"]
    return rs, gs


@pytest.mark.parametrize("kind", sorted(LATENTS))
@pytest.mark.parametrize("mode", ["conservative", "exposure",
                                  "adaptive_recovery",
                                  "mathematical_recovery"])
def test_hdr_decode_modes_match_jax(pair, mode, kind):
    ref, got = _decode_both(pair, _latent(LATENTS[kind]), hdr_mode=mode)
    rs, gs = _check_summaries(ref, got)
    assert not gs["used_fallback"]
    assert gs["normalization"] == kind.upper()
    # the standard decode: float32 parity, <= 1e-4
    np.testing.assert_allclose(got.standard.numpy(),
                               np.asarray(ref.standard), atol=1e-4, rtol=0)
    d = np.abs(got.image.numpy() - np.asarray(ref.image))
    if mode == "conservative":
        assert d.max() <= 1e-4
    else:
        # the logit/EV modes: mean <= 1e-4 and p99.9 <= 1e-3 of |diff|
        assert d.mean() <= 1e-4
        assert np.percentile(d, 99.9) <= 1e-3
    assert gs["output"]["hdr_pixels"] == rs["output"]["hdr_pixels"]


@pytest.mark.parametrize("collapse", ["maxpool", "first3"])
def test_hdr_decode_fallback_matches_jax(pair, collapse):
    """With no expansion the conservative result has no HDR pixel and no
    value over 1.1, so both packages take the raw-features fallback tier;
    the image is then the collapsed (or first three) pre-conv_out
    channels: <= 1e-4."""
    ref, got = _decode_both(pair, hdr_mode="conservative",
                            conservative_expansion_factor=0.0,
                            fallback_collapse=collapse,
                            conservative_ev_multiplier=2.0)
    rs, gs = _check_summaries(ref, got)
    assert gs["used_fallback"] and rs["used_fallback"]
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image),
                               atol=1e-4, rtol=0)


def test_full_analysis_and_nchw_latent(pair):
    """NCHW latents are detected and transposed; the full analysis record
    has the JAX package's keys and values."""
    jcfg, params, dec, z = pair
    cfg_kw = dict(hdr_mode="conservative", full_analysis=True,
                  keep_standard=False)
    ref = jpipe.hdr_decode(params, jnp.asarray(z), jcfg,
                           JHDRDecodeConfig(**cfg_kw), JPrecision.parity())
    got = tpipe.hdr_decode(dec, torch.from_numpy(z).permute(0, 3, 1, 2),
                           HDRDecodeConfig(**cfg_kw), Precision.parity())
    assert got.standard is None
    rs, gs = _check_summaries(ref, got)
    for key in ("conv_only", "conv_weight", "conv_bias"):
        for stat in ("min", "max", "mean", "std"):
            assert gs[key][stat] == pytest.approx(rs[key][stat], abs=1e-5)


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("compression", ["none", "zip"])
def test_exr_bytes_match_reference_writer(tmp_path, pixel_type,
                                          compression):
    rng = np.random.default_rng(11)
    img = (rng.standard_normal((37, 29, 3)) * 4.0).astype(np.float32)
    img[:5] = 0.25          # compressible rows exercise the zip path
    a, b = tmp_path / "port.exr", tmp_path / "ref.exr"
    texr.write_exr(str(a), torch.from_numpy(img), pixel_type=pixel_type,
                   compression=compression)
    exr_py.write_exr(str(b), img, pixel_type=pixel_type,
                     compression=compression, workers=1)
    assert a.read_bytes() == b.read_bytes()
    back = texr.read_exr(str(a))
    expect = img.astype(np.float16).astype(np.float32) \
        if pixel_type == "half" else img
    np.testing.assert_array_equal(back, expect)
    np.testing.assert_array_equal(exr_py.read_exr(str(a)), back)


def test_exr_single_channel_roundtrip(tmp_path):
    img = np.random.default_rng(12).standard_normal((20, 16)).astype(
        np.float32)
    path = tmp_path / "y.exr"
    texr.write_exr(str(path), img, pixel_type="float", compression="zip")
    np.testing.assert_array_equal(texr.read_exr(str(path))[..., 0], img)


# ---------------------------------------------------------------------------
# The port never imports JAX
# ---------------------------------------------------------------------------


def test_port_never_imports_jax():
    """A fresh interpreter imports the whole slice and runs a tiny decode
    and EXR write without JAX ever entering sys.modules."""
    code = (
        "import sys, tempfile, os, torch\n"
        "import hdrvae_torch\n"
        "from hdrvae_torch.core import config, color, stats\n"
        "from hdrvae_torch.models import layers, decoder, params, "
        "fused_tail, swin2sr, zoo\n"
        "from hdrvae_torch.kernels import _build, attention, conv3x3, "
        "epilogue\n"
        "from hdrvae_torch.decode import formatting, analysis, modes, "
        "pipeline\n"
        "from hdrvae_torch.io import exr\n"
        "cfg = config.DecoderConfig().with_small()\n"
        "dec = params.init_decoder(cfg, 0, device='cpu')\n"
        "z = torch.zeros(1, 4, 4, 4)\n"
        "r = pipeline.hdr_decode(dec, z, precision=config.Precision.fast())\n"
        "pipeline.decode_summary(r)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    exr.write_exr(os.path.join(d, 'a.exr'), r.image[0])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'hdrvae' or m.startswith('hdrvae.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
