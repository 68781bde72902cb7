"""The port's staged mixed-tier decode (``decode/staged.py``) against the
JAX package's and against the port's own whole-image mixed decode.

The staged executor re-sequences the decode into row-slab passes with the
GroupNorm sums accumulated explicitly; each pixel's conv arithmetic is the
whole-image decode's, so the two agree to summation-order noise.  The
cases port ``tests/test_staged.py`` (with_small() at several latents,
ragged slab plans, every mode with both fallback collapses, a full-width
decoder, three levels, the refusals, ``keep_standard=False`` and the
auto-route of ``hdr_decode``), plus the slab planner against JAX's over a
sweep and the in-place rewrite of level 0.  Latents are made with numpy
from a seed; weights cross over with ``state_dict_from_jax``.

Yardsticks, as the JAX suite's: the standard image and the conservative
mode by max-abs; the exposure / adaptive / mathematical modes push the
result through a logit and an EV multiply whose slope near saturation
turns float32 noise into ~1e-4, so where the decoder's weights are not
the small fixture's they take the mean of |difference|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.decode import staged as jstaged
from hdrvae.models.decoder import decoder_head as jhead
from hdrvae.models.decoder import decoder_tail as jtail
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.decode import staged
from hdrvae_torch.models.decoder import decoder_head, decoder_tail
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        init_decoder, state_dict_from_jax)

torch.set_num_threads(2)

MIXED = Precision.mixed()


@pytest.fixture(scope="module")
def small():
    """The JAX decoder at with_small() and the port's with its weights."""
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return jcfg, params, dec


def _latent(zc, h, w, seed=1, batch=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, h, w, zc)).astype(np.float32))


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _pre_close(a, b):
    for k in ("min", "max", "mean", "std"):
        np.testing.assert_allclose(float(a.stats["pre"][k]),
                                   float(b.stats["pre"][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20), (20, 12)])
def test_staged_matches_jax_and_whole(small, hw):
    """with_small(), slab target 8: the port's staged decode against JAX's
    staged decode and the port's whole-image mixed decode, image and
    standard <= 2e-5, the pre-map statistics <= 1e-4 relative, the same
    fallback tier."""
    jcfg, params, dec = small
    z = _latent(4, *hw)
    ref = jstaged.staged_hdr_decode(params, jnp.asarray(z.numpy()), jcfg,
                                    JHDRDecodeConfig(), JPrecision.mixed(),
                                    slab_rows=8)
    got = staged.staged_hdr_decode(dec, z, HDRDecodeConfig(), MIXED,
                                   slab_rows=8)
    whole = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    assert got.image.shape == (1, 2 * hw[0], 2 * hw[1], 3)
    for other in (ref, whole):
        assert _max_abs(got.image, other.image) <= 2e-5
        assert _max_abs(got.standard, other.standard) <= 2e-5
        assert bool(got.used_fallback) == bool(other.used_fallback)
    _pre_close(got, whole)
    for k in ("min", "max", "mean", "std"):
        np.testing.assert_allclose(float(got.stats["pre"][k]),
                                   float(ref.stats["pre"][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("slab_rows", [4, 6, 10, 64])
def test_staged_ragged_slabs(small, slab_rows):
    """Slab targets that do not divide the 36 output rows still tile the
    height (divisor search) and agree with the whole image, <= 2e-5."""
    _, _, dec = small
    z = _latent(4, 18, 10)
    whole = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    got = staged.staged_hdr_decode(dec, z, HDRDecodeConfig(), MIXED,
                                   slab_rows=slab_rows)
    assert _max_abs(got.image, whole.image) <= 2e-5


@pytest.mark.parametrize("collapse", ["maxpool", "first3"])
@pytest.mark.parametrize("mode", ["conservative", "exposure",
                                  "adaptive_recovery",
                                  "mathematical_recovery"])
def test_staged_modes_and_fallback(small, mode, collapse):
    """Every mode with both fallback collapses, EV multiplier 1.5, and
    with no expansion the raw-features tier: staged against whole-image
    <= 2e-5, the same tier taken."""
    _, _, dec = small
    z = _latent(4, 16, 16, seed=3)
    for expansion in (1.0, 0.0):
        hcfg = HDRDecodeConfig(hdr_mode=mode, fallback_collapse=collapse,
                               conservative_ev_multiplier=1.5,
                               conservative_expansion_factor=expansion)
        whole = tpipe.hdr_decode(dec, z, hcfg, MIXED)
        got = staged.staged_hdr_decode(dec, z, hcfg, MIXED, slab_rows=8)
        assert bool(got.used_fallback) == bool(whole.used_fallback)
        assert _max_abs(got.image, whole.image) <= 2e-5


def test_staged_full_width_decoder():
    """The full DecoderConfig (z 16, ch 128, four levels, 32 groups) at a
    6 x 8 latent: the production widths and group arithmetic on the
    staged path.  Standard and conservative images <= 5e-5; the
    mathematical mode's mean |difference| <= 1e-5."""
    cfg = DecoderConfig()
    dec = init_decoder(cfg, 7, device="cpu")
    z = _latent(16, 6, 8, seed=11)
    for mode in ("conservative", "mathematical_recovery"):
        hcfg = HDRDecodeConfig(hdr_mode=mode)
        whole = tpipe.hdr_decode(dec, z, hcfg, MIXED)
        got = staged.staged_hdr_decode(dec, z, hcfg, MIXED, slab_rows=8)
        assert got.image.shape == (1, 48, 64, 3)
        assert _max_abs(got.standard, whole.standard) <= 5e-5
        assert bool(got.used_fallback) == bool(whole.used_fallback)
        d = (got.image - whole.image).abs()
        if mode == "conservative":
            assert d.max().item() <= 5e-5
        else:
            assert d.mean().item() <= 1e-5


def test_staged_three_level_config():
    """num_levels = 3: the head holds no up level (conv_in + mid), level
    2's blocks run whole-image at the latent's resolution before the first
    staged junction.  Standard and conservative images <= 2e-5 against
    the whole image."""
    cfg = dataclasses.replace(DecoderConfig().with_small(), ch_mult=(1, 2, 2))
    dec = init_decoder(cfg, 9, device="cpu")
    z = _latent(4, 10, 14, seed=33)
    hcfg = HDRDecodeConfig(hdr_mode="conservative")
    whole = tpipe.hdr_decode(dec, z, hcfg, MIXED)
    got = staged.staged_hdr_decode(dec, z, hcfg, MIXED, slab_rows=8)
    assert _max_abs(got.image, whole.image) <= 2e-5
    assert _max_abs(got.standard, whole.standard) <= 2e-5


@pytest.mark.parametrize("even", [False, True])
def test_plan_rows_matches_jax(even):
    """The slab planner gives JAX's plan, ragged ones included, over every
    height to 160 and the slab targets the decode uses."""
    for h in range(2 if even else 1, 161, 2 if even else 1):
        for target in (1, 2, 3, 4, 6, 8, 10, 16, 37, 64, 128):
            assert staged._plan_rows(h, target, even) == \
                jstaged._plan_rows(h, target, even), (h, target, even)


def test_staged_ragged_plan(small):
    """Heights whose divisors are all far from the target take the ragged
    plan (clamped last window, its overlap rows left out of the sums, a
    fresh buffer for level 0's blocks) and still match the whole image:
    <= 2e-5, the pre-map statistics <= 1e-4 relative."""
    assert staged._plan_rows(37, 16) == (16, 3, True)
    s, _, ragged = staged._plan_rows(74, 16, even=True)
    assert ragged and s % 2 == 0
    assert staged._plan_rows(32, 8) == (8, 4, False)
    _, _, dec = small
    z = _latent(4, 37, 9, seed=21)
    whole = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    got = staged.staged_hdr_decode(dec, z, HDRDecodeConfig(), MIXED,
                                   slab_rows=16)
    assert _max_abs(got.image, whole.image) <= 2e-5
    assert _max_abs(got.standard, whole.standard) <= 2e-5
    _pre_close(got, whole)


@pytest.mark.parametrize("case", ["fast", "parity", "batch", "3d",
                                  "levels"])
def test_staged_rejects_unsupported(small, case):
    """The refusals and their messages, as JAX's."""
    _, _, dec = small
    z = _latent(4, 16, 16)
    prec, match = MIXED, {"fast": "mixed", "parity": "mixed",
                          "batch": "batch-1", "3d": "4D",
                          "levels": "num_levels"}[case]
    if case in ("fast", "parity"):
        prec = getattr(Precision, case)()
    elif case == "batch":
        z = _latent(4, 16, 16, batch=2)
    elif case == "3d":
        z = z[0]
    elif case == "levels":
        cfg = dataclasses.replace(DecoderConfig().with_small(), ch_mult=(1,))
        dec = init_decoder(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        staged.staged_hdr_decode(dec, z, precision=prec)


def test_staged_keep_standard_false(small):
    _, _, dec = small
    res = staged.staged_hdr_decode(dec, _latent(4, 16, 16),
                                   HDRDecodeConfig(keep_standard=False),
                                   MIXED)
    assert res.standard is None


def test_staged_full_analysis_keys(small):
    """full_analysis on the staged path reports the conv_out weights' part
    only (the pre map is never whole), as JAX's staged decode."""
    jcfg, params, dec = small
    z = _latent(4, 16, 16)
    ref = jstaged.staged_hdr_decode(
        params, jnp.asarray(z.numpy()), jcfg,
        JHDRDecodeConfig(full_analysis=True), JPrecision.mixed())
    got = staged.staged_hdr_decode(dec, z,
                                   HDRDecodeConfig(full_analysis=True), MIXED)
    assert set(got.stats) == set(ref.stats)
    for key in ("conv_weight", "conv_bias"):
        for stat in ("min", "max", "mean", "std"):
            assert float(got.stats[key][stat]) == pytest.approx(
                float(ref.stats[key][stat]), abs=1e-6)


def test_hdr_decode_auto_routes_staged(small, monkeypatch):
    """hdr_decode sends a batch-1 mixed decode through the staged executor
    from the threshold on (here lowered by the test hook), with the same
    result; the real threshold keeps a 2048^2 frame whole-image."""
    _, _, dec = small
    z = _latent(4, 16, 16)
    baseline = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    calls = []
    real = staged.staged_hdr_decode
    monkeypatch.setattr(staged, "staged_hdr_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tpipe, "_STAGED_MIN_PIXELS_OVERRIDE", 32 * 32)
    routed = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    assert calls == [1]
    assert _max_abs(routed.image, baseline.image) <= 2e-5
    monkeypatch.setattr(tpipe, "_STAGED_MIN_PIXELS_OVERRIDE", 32 * 32 + 1)
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), MIXED)
    assert calls == [1]
    assert staged.STAGED_MIN_PIXELS > 2048 * 2048


@pytest.mark.parametrize("case", ["fast", "parity", "batch"])
def test_hdr_decode_keeps_whole_image(small, monkeypatch, case):
    """Only batch-1 mixed decodes take the staged route: the fast and
    parity tiers and a batch of two stay whole-image above the
    threshold."""
    _, _, dec = small
    z = _latent(4, 8, 8, batch=2 if case == "batch" else 1)
    prec = MIXED if case == "batch" else getattr(Precision, case)()
    calls = []
    monkeypatch.setattr(staged, "staged_hdr_decode",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tpipe, "_STAGED_MIN_PIXELS_OVERRIDE", 1)
    res = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), prec)
    assert calls == [] and res.image.shape == (z.shape[0], 16, 16, 3)


def test_level0_rewrites_one_buffer(small):
    """Level 0's blocks after block 0 rewrite the front's buffer in place
    (the same storage comes back) when the plan is exact."""
    _, _, dec = small
    z = _latent(4, 16, 16)
    buf, m = staged.staged_front(dec, z, MIXED, slab_rows=8)
    ptr = buf.data_ptr()
    out, _ = staged.staged_level0(dec, buf, m, MIXED, slab_rows=8)
    assert out.data_ptr() == ptr


@pytest.mark.parametrize("tail_levels", [0, 1, 2])
def test_head_tail_split_matches_jax(small, tail_levels):
    """decoder_head(tail_levels=k) + decoder_tail(tail_levels=k), the
    split the staged front runs, against JAX's at parity, <= 1e-5."""
    jcfg, params, dec = small
    z = _latent(4, 8, 8, seed=5)
    par = Precision.parity()
    ref = jtail(params, jhead(params, jnp.asarray(z.numpy()), jcfg,
                              precision=JPrecision.parity(),
                              tail_levels=tail_levels),
                jcfg, precision=JPrecision.parity(), tail_levels=tail_levels)
    x = decoder_head(dec, z, precision=par, tail_levels=tail_levels)
    side = 8 * 2 ** (dec.cfg.num_levels - max(tail_levels, 1))
    assert x.shape[1:3] == (side, side)
    got = decoder_tail(dec, x, precision=par, tail_levels=tail_levels)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staged_randomized_property(seed):
    """Random topologies (2-4 levels, widths, groups, blocks), shapes and
    slab targets, exact and ragged plans: staged against whole-image, the
    standard image <= 5e-5, the conservative image <= 5e-5 and the EV
    modes' mean |difference| <= 1e-5."""
    rng = np.random.default_rng(100 + seed)
    levels = int(rng.integers(2, 5))
    cfg = dataclasses.replace(
        DecoderConfig(), z_channels=4, ch=int(rng.choice([8, 16])),
        ch_mult=tuple(int(m) for m in sorted(rng.choice([1, 2, 4],
                                                        size=levels))),
        num_res_blocks=int(rng.integers(1, 3)),
        num_groups=int(rng.choice([2, 4])))
    dec = init_decoder(cfg, 200 + seed, device="cpu")
    z = _latent(4, int(rng.integers(6, 24)), int(rng.integers(6, 24)),
                seed=300 + seed)
    mode = str(rng.choice(["conservative", "mathematical_recovery",
                           "exposure"]))
    hcfg = HDRDecodeConfig(hdr_mode=mode)
    whole = tpipe.hdr_decode(dec, z, hcfg, MIXED)
    got = staged.staged_hdr_decode(dec, z, hcfg, MIXED,
                                   slab_rows=int(rng.choice([4, 8, 16, 64])))
    assert _max_abs(got.standard, whole.standard) <= 5e-5
    d = (got.image - whole.image).abs()
    if mode == "conservative":
        assert d.max().item() <= 5e-5
    else:
        assert d.mean().item() <= 1e-5
