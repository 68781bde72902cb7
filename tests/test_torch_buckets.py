"""The port's shape-bucketed decode against the JAX package: the bucket
policy (``decode/buckets.py``), ``PadMask``'s masked GroupNorm moments, K3's
``key_valid`` mode in its three plain versions, ``decoder_apply(tape=)`` and
``hdr_decode(shape_bucket=, pad_to=)``.

The JAX package's ``init_decoder(PRNGKey(0), cfg)`` parameters are carried
across with ``state_dict_from_jax``; inputs are made with numpy from a seed
and handed to both.  Everything runs at ``with_small()`` (z = 4, ch = 16, 2
levels, 4 groups) on CPU tensors, where the port's kernel wrappers run their
plain versions; the JAX attention kernel runs in interpret mode, as the JAX
package's own tests run it.  The CUDA kernels' masked mode is held to the
same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
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
from hdrvae.decode import buckets as jbuckets
from hdrvae.decode import pipeline as jpipe
from hdrvae.kernels import attention as jattn
from hdrvae.models import decoder as jdec
from hdrvae.models import layers as jlayers
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode import buckets as tbuckets
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.decode import staged
from hdrvae_torch.kernels import attention as tattn
from hdrvae_torch.models import decoder as tdec
from hdrvae_torch.models import fused_tail
from hdrvae_torch.models.layers import PadMask
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)

torch.set_num_threads(2)

# the padded latent of the decoder and pipeline tests and its valid region
PAD_HW, VALID_HW = (16, 16), (10, 12)
TIERS = {
    "parity": (JPrecision.parity(), Precision.parity()),
    "mixed": (JPrecision.mixed(), Precision.mixed()),
    # the fast tier on the layers: the route a taped decode takes
    "fast": (dataclasses.replace(JPrecision.fast(), upstack="xla"),
             dataclasses.replace(Precision.fast(), upstack="xla")),
}


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _ulp(ref):
    """One bf16 ulp of the largest |value| of ``ref``."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


# ---------------------------------------------------------------------------
# BucketPolicy / plan_buckets
# ---------------------------------------------------------------------------

# (sizes, max_buckets, multiple): the cases of tests/test_buckets.py, then
# four seeded random workloads
PLANS = {
    "clusters, 2": ([(16, 16)] * 10 + [(64, 64)] * 10, 2, 8),
    "clusters, 1": ([(16, 16)] * 10 + [(64, 64)] * 10, 1, 8),
    "weighted, 3": ([(16, 16)] * 100 + [(24, 24)] * 100 + [(64, 64)], 3, 8),
    "weighted, 2": ([(16, 16)] * 100 + [(24, 24)] * 100 + [(64, 64)], 2, 8),
}
for _seed, (_n, _k, _m) in enumerate([(40, 4, 8), (25, 3, 16), (60, 5, 8),
                                      (12, 2, 4)]):
    _r = np.random.default_rng(100 + _seed)
    PLANS[f"random {_seed}"] = (
        [tuple(int(v) for v in _r.integers(9, 260, 2)) for _ in range(_n)],
        _k, _m)
EXPECTED_EDGES = {"clusters, 2": (16, 64), "clusters, 1": (64,),
                  "weighted, 3": (16, 24, 64), "weighted, 2": (24, 64)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_buckets_matches_jax(case):
    sizes, k, m = PLANS[case]
    got = tbuckets.plan_buckets(sizes, max_buckets=k, multiple=m)
    ref = jbuckets.plan_buckets(sizes, max_buckets=k, multiple=m)
    assert got.edges == ref.edges
    assert got.overflow_multiple == ref.overflow_multiple == 8 * m
    assert got.max_compiled_shapes == ref.max_compiled_shapes
    if case in EXPECTED_EDGES:
        assert got.edges == EXPECTED_EDGES[case]
    for n in range(1, 2 * max(got.edges) + 3):
        assert got.snap(n) == ref.snap(n)
    for h, w in sizes:
        assert got.snap_hw(h, w) == ref.snap_hw(h, w)


def test_snap_and_overflow():
    """tests/test_buckets.py::test_snap_and_overflow on the port."""
    p = tbuckets.BucketPolicy(edges=(16, 32, 64), overflow_multiple=64)
    assert [p.snap(n) for n in (9, 16, 33, 65)] == [16, 16, 64, 128]
    assert p.snap_hw(20, 50) == (32, 64)
    assert p.max_compiled_shapes == 9


@pytest.mark.parametrize("edges", [(), (32, 16), (16, 16, 32)])
def test_bad_edges_raise_as_jax(edges):
    with pytest.raises(ValueError):
        jbuckets.BucketPolicy(edges=edges)
    with pytest.raises(ValueError, match="ascending"):
        tbuckets.BucketPolicy(edges=edges)


def test_plan_without_sizes_raises_as_jax():
    with pytest.raises(ValueError):
        jbuckets.plan_buckets([])
    with pytest.raises(ValueError, match="no sizes"):
        tbuckets.plan_buckets([])


# ---------------------------------------------------------------------------
# PadMask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("tier", ["parity", "fast", "mixed"])
def test_padmask_moments_match_jax(tier, f):
    """The masked moments at the tape's entry resolution (f = 1) and at
    twice it (f = 2): divided by the valid count, two-pass in parity and
    one-pass otherwise, as JAX ``PadMask.reduce_stats``.  Float32 sums in
    another order: <= 1e-6 of the moments' scale (the variances here are
    ~4, where one float32 ulp is 4.8e-7)."""
    g, c = 4, 16
    x = _np(7, (2, 8 * f, 12 * f, c), 2.0) + 0.5
    jm = jlayers.PadMask(8, 12, 5, 9)
    ref = jm.reduce_stats(jnp.asarray(x), jlayers._group_onehot(c, g),
                          c // g, TIERS[tier][0])
    got = PadMask(8, 12, 5, 9).reduce_stats(torch.from_numpy(x), g,
                                            two_pass=tier == "parity")
    for r, t in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(t.numpy(), r,
                                   atol=1e-6 * max(1.0, np.abs(r).max()),
                                   rtol=0)


def test_padmask_masks_match_jax():
    jm, tm = jlayers.PadMask(8, 12, 5, 9), PadMask(8, 12, 5, 9)
    x = _np(8, (1, 16, 24, 3))
    np.testing.assert_array_equal(
        tm.mask_output(torch.from_numpy(x)).numpy(),
        np.asarray(jm.mask_output(jnp.asarray(x))))
    kv = tm.key_valid(torch.from_numpy(x))
    assert kv.dtype == torch.bool and tuple(kv.shape) == (16, 24)
    np.testing.assert_array_equal(kv.numpy(),
                                  np.asarray(jm.key_valid(jnp.asarray(x))))
    with pytest.raises(AssertionError):
        tm.key_valid(torch.zeros(1, 16, 20, 3))   # no multiple of base_w


# ---------------------------------------------------------------------------
# K3 key_valid: the three plain versions
# ---------------------------------------------------------------------------

ATTN_HW, ATTN_C, ATTN_LIVE = (16, 16), 128, (11, 13)


def _live_mask(hw=ATTN_HW, live=ATTN_LIVE):
    rows = np.arange(hw[0])[:, None] < live[0]
    cols = np.arange(hw[1])[None, :] < live[1]
    return rows & cols


def _live_only(q, k, v, mask):
    """Attention over only the live keys, in float64 (as
    tests/test_kernels.py::test_key_valid_mask computes its truth)."""
    n, c = mask.size, q.shape[-1]
    idx = np.nonzero(mask.reshape(-1))[0]
    qf = q.reshape(n, c).astype(np.float64)
    kf = k.reshape(n, c).astype(np.float64)[idx]
    vf = v.reshape(n, c).astype(np.float64)[idx]
    s = (qf * c ** -0.5) @ kf.T
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return ((p / p.sum(axis=1, keepdims=True)) @ vf).reshape(q.shape)


@pytest.fixture(scope="module")
def masked_attn():
    """q, k, v (float32, and bf16-rounded for the fast mode), the mask and
    the JAX kernel in interpret mode in each precision."""
    hw, c = ATTN_HW, ATTN_C
    q, k, v = (_np(s, (1, *hw, c)) for s in (20, 21, 22))
    qb, kb, vb = (_f32(jnp.asarray(t).astype(jnp.bfloat16))
                  for t in (q, k, v))
    mask = _live_mask()

    def jax_kernel(a, b, d, precise, dtype=jnp.float32):
        return np.asarray(jattn.spatial_attention_pallas(
            *(jnp.asarray(t, dtype) for t in (a, b, d)), precise=precise,
            block_q=128, block_k=128, interpret=True,
            key_valid=jnp.asarray(mask)))
    ref = {"f32": jax_kernel(q, k, v, jax.lax.Precision.HIGHEST),
           "3pass": jax_kernel(q, k, v, jax.lax.Precision.HIGH),
           "bf16": jax_kernel(qb, kb, vb, False, jnp.bfloat16)}
    return {"f32": (q, k, v), "bf16": (qb, kb, vb)}, mask, ref


# (mode, plain version, inputs, tolerance against the JAX kernel, against
# the live-keys-only truth): exact float32 on both sides 1e-5 (the existing
# parity bar); the 3-pass plain version against JAX HIGH 4e-6 (its
# tests/test_torch_attention_3pass.py bar), against exact arithmetic 1e-4
# (the 3-pass budget); the bf16 inputs: JAX's DEFAULT dot rounds p to bf16
# for P v, 2^-8 of max|v| (tests/test_torch_kernels.py's bar), and the
# plain version is exact float32 on them, 2e-5 (tests/test_kernels.py)
MODES = {
    "f32": ("spatial_attention_reference", "f32", 1e-5, 2e-5),
    "3pass": ("spatial_attention_3pass_reference", "f32", 4e-6, 1e-4),
    "bf16": ("spatial_attention_reference", "bf16", None, 2e-5),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_masked_plain_versions_match_jax(masked_attn, mode):
    inputs, mask, ref = masked_attn
    plain, kind, tol_jax, tol_truth = MODES[mode]
    q, k, v = inputs[kind]
    got = getattr(tattn, plain)(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(mask)).numpy()
    if tol_jax is None:
        tol_jax = 2.0 ** -8 * np.abs(v).max()
    np.testing.assert_allclose(got, ref[mode], atol=tol_jax, rtol=0)
    np.testing.assert_allclose(got, _live_only(q, k, v, mask),
                               atol=tol_truth, rtol=0)


@pytest.mark.parametrize("tier,wrapper", [("parity", "flash_attention_f32"),
                                          ("mixed", "flash_attention_3pass"),
                                          ("fast", "flash_attention_bf16")])
def test_spatial_attention_passes_the_mask(masked_attn, monkeypatch, tier,
                                           wrapper):
    """spatial_attention hands key_valid to the tier's wrapper, which on
    CPU tensors runs its plain version with it (and counts no launch)."""
    inputs, mask, _ = masked_attn
    seen = []
    real = getattr(tattn, wrapper)
    monkeypatch.setattr(tattn, wrapper, lambda *a, **kw: seen.append(
        kw["key_valid"]) or real(*a, **kw))
    q, k, v = map(torch.from_numpy, inputs["f32"])
    before = (real.launches, real.launches_masked)
    got = tattn.spatial_attention(q, k, v, precision=TIERS[tier][1],
                                  key_valid=torch.from_numpy(mask))
    assert len(seen) == 1 and torch.equal(seen[0], torch.from_numpy(mask))
    assert (real.launches, real.launches_masked) == before
    truth = _live_only(*(t.to(got.dtype if tier != "fast"
                              else torch.bfloat16).float().numpy()
                         for t in (q, k, v)), mask)
    np.testing.assert_allclose(got.numpy(), truth, atol=1e-4, rtol=0)


@pytest.mark.parametrize("plain", ["spatial_attention_reference",
                                   "spatial_attention_3pass_reference"])
def test_first_keys_dead_no_nan(plain):
    """A mask whose first 64 keys are dead (the first key tile of every
    CUDA mode): finite, and the attention over the live keys alone."""
    q, k, v = (_np(s, (1, 16, 16, 64)) for s in (30, 31, 32))
    mask = np.ones((16, 16), bool)
    mask[:4] = False
    got = getattr(tattn, plain)(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _live_only(q, k, v, mask), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# decoder_apply(tape=) and hdr_decode(shape_bucket=, pad_to=)
# ---------------------------------------------------------------------------


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


def _latent(seed=3, hw=VALID_HW, positive=False):
    z = _np(seed, (1, *hw, 4), 2.0)
    return np.abs(z) + 0.2 if positive else z


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_decoder_apply_tape_matches_jax(pair, tier):
    """The whole padded output (pad region included) of a taped decode:
    parity and mixed <= 1e-5 (tests/test_torch_decoder.py's float32 bar),
    the fast layers within one bf16 ulp of the map's scale (its
    upstack="xla" bar)."""
    jcfg, params, dec = pair
    z = np.pad(_latent(), ((0, 0), (0, PAD_HW[0] - VALID_HW[0]),
                           (0, PAD_HW[1] - VALID_HW[1]), (0, 0)))
    jprec, prec = TIERS[tier]
    ref = jdec.decoder_apply(params, jnp.asarray(z), jcfg, precision=jprec,
                             tape=jlayers.PadMask(*PAD_HW, *VALID_HW))
    got = tdec.decoder_apply(dec, torch.from_numpy(z), precision=prec,
                             tape=PadMask(*PAD_HW, *VALID_HW))
    rp, gp = _f32(ref.pre_conv_out), got.pre_conv_out.float().numpy()
    tol = _ulp(rp) if tier == "fast" else 1e-5
    assert got.rgb.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(gp, rp, atol=tol, rtol=0)
    np.testing.assert_allclose(got.rgb.numpy(), _f32(ref.rgb), atol=tol,
                               rtol=0)


BUCKETINGS = {"shape_bucket=8": dict(shape_bucket=8),
              "pad_to=(16, 16)": dict(pad_to=PAD_HW)}


@pytest.fixture(scope="module")
def jax_bucketed(pair):
    """JAX hdr_decode of the seed-3 latent per tier and bucketing, the
    conservative mode with the full analysis."""
    jcfg, params, _ = pair
    z = jnp.asarray(_latent())
    hcfg = JHDRDecodeConfig(hdr_mode="conservative", full_analysis=True)
    return {(tier, name): jpipe.hdr_decode(params, z, jcfg, hcfg, jprec,
                                           **kw)
            for tier, (jprec, _) in TIERS.items()
            for name, kw in BUCKETINGS.items()}


@pytest.mark.parametrize("bucketing", sorted(BUCKETINGS))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_hdr_decode_bucketed_matches_jax(pair, jax_bucketed, tier,
                                         bucketing):
    """Image, standard and the stats record against JAX's hdr_decode with
    the same arguments.  Parity and mixed: <= 1e-4 (the pipeline tests'
    bar), stats <= 1e-4 relative.  Fast: the JAX package jits its bucketed
    forward, where XLA moves the bf16 roundings; its fast budget, 0.02 on
    rgb (tests/test_torch_decoder.py) and on the image relative to its
    scale, stats 2e-2 relative."""
    _, _, dec = pair
    ref = jax_bucketed[(tier, bucketing)]
    got = tpipe.hdr_decode(
        dec, torch.from_numpy(_latent()),
        HDRDecodeConfig(hdr_mode="conservative", full_analysis=True),
        TIERS[tier][1], **BUCKETINGS[bucketing])
    assert got.image.shape == (1, 20, 24, 3) == ref.image.shape
    img = np.asarray(ref.image)
    tol, rel = (0.02, 2e-2) if tier == "fast" else (1e-4, 1e-4)
    np.testing.assert_allclose(got.standard.numpy(), np.asarray(ref.standard),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(got.image.numpy(), img,
                               atol=tol * max(1.0, np.abs(img).max()), rtol=0)
    rs, gs = jpipe.decode_summary(ref), tpipe.decode_summary(got)
    assert gs["used_fallback"] == rs["used_fallback"]
    assert gs["normalization"] == rs["normalization"]
    for key in ("input", "pre", "post", "output", "conv_only"):
        assert set(gs[key]) == set(rs[key]), key
        for stat, want in rs[key].items():
            assert gs[key][stat] == pytest.approx(want, rel=rel, abs=1e-5), \
                (key, stat)


@pytest.mark.parametrize("bucketing", sorted(BUCKETINGS))
def test_bucketed_equals_unbucketed(pair, bucketing):
    """In parity the port's bucketed decode is its unbucketed decode to
    float noise: image and standard <= 1e-4."""
    _, _, dec = pair
    z = torch.from_numpy(_latent())
    hcfg = HDRDecodeConfig(hdr_mode="conservative")
    got = tpipe.hdr_decode(dec, z, hcfg, Precision.parity(),
                           **BUCKETINGS[bucketing])
    ref = tpipe.hdr_decode(dec, z, hcfg, Precision.parity())
    assert (got.image - ref.image).abs().max() <= 1e-4
    assert (got.standard - ref.standard).abs().max() <= 1e-4


def test_pad_to_rejects_shrink(pair):
    """tests/test_buckets.py::test_pad_to_rejects_shrink on the port."""
    _, _, dec = pair
    z = torch.zeros(1, 16, 16, 4)
    with pytest.raises(ValueError, match="smaller than latent"):
        tpipe.hdr_decode(dec, z, HDRDecodeConfig(), pad_to=(8, 8))
    with pytest.raises(ValueError, match="smaller than latent"):
        tpipe.hdr_decode(dec, z, HDRDecodeConfig(), pad_to=(16, 8))


def test_sizes_sharing_a_bucket_crop_correctly(pair, monkeypatch):
    """tests/test_buckets.py::test_bucket_shares_one_decoder_compilation
    on the port: three sizes padded to one (18, 18) bucket decode at the
    (18, 18) shape, each cropped to its own size and equal to its
    unbucketed decode (<= 1e-4, parity)."""
    _, _, dec = pair
    hcfg = HDRDecodeConfig()
    sizes = ((10, 12), (11, 13), (9, 15))
    zs = [torch.from_numpy(_latent(40 + i, hw)) for i, hw in enumerate(sizes)]
    refs = [tpipe.hdr_decode(dec, z, hcfg, Precision.parity()) for z in zs]
    shapes = []
    real = tdec.decoder_apply
    monkeypatch.setattr(tpipe, "decoder_apply", lambda d, z, **kw: (
        shapes.append(tuple(z.shape[1:3])) or real(d, z, **kw)))
    for (h, w), z, ref in zip(sizes, zs, refs):
        got = tpipe.hdr_decode(dec, z, hcfg, Precision.parity(),
                               pad_to=(18, 18))
        assert got.image.shape[1:3] == (2 * h, 2 * w)
        assert (got.image - ref.image).abs().max() <= 1e-4
    assert shapes == [(18, 18)] * 3


def test_bucketed_input_stats_exclude_pad(pair):
    """tests/test_buckets.py::test_bucketed_input_stats_exclude_pad on the
    port: stats["input"] describes the unpadded latent."""
    _, _, dec = pair
    z = torch.from_numpy(_latent(positive=True))
    got = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.parity(),
                           pad_to=PAD_HW)
    ref = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.parity())
    gs, rs = (tpipe.decode_summary(r)["input"] for r in (got, ref))
    assert gs["min"] == rs["min"] > 0.0
    assert gs["max"] == rs["max"]
    assert gs["negative_pixels"] == rs["negative_pixels"] == 0


def _spy_tapes(monkeypatch):
    """Record the tape of every decoder_apply call of hdr_decode."""
    tapes = []
    real = tdec.decoder_apply

    def rec(d, z, **kw):
        tapes.append(kw.get("tape"))
        return real(d, z, **kw)
    monkeypatch.setattr(tpipe, "decoder_apply", rec)
    return tapes


def test_pad_to_at_the_latent_takes_the_masked_route(pair, monkeypatch):
    """pad_to equal to the latent still decodes with a full-valid PadMask
    (one decoder shape a bucket); a shape_bucket the latent already fills
    does not pad."""
    _, _, dec = pair
    tapes = _spy_tapes(monkeypatch)
    z = torch.from_numpy(_latent(hw=(16, 8)))
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.parity(),
                     pad_to=(16, 8))
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.parity(),
                     shape_bucket=8)
    assert isinstance(tapes[0], PadMask) and tapes[1] is None
    t = tapes[0]
    assert (t.base_h, t.base_w, t.valid_h, t.valid_w) == (16, 8, 16, 8)


def test_fast_bucketed_stays_off_the_chain(pair, monkeypatch):
    """Fast "auto" with a bucket runs the layers and never the fused chain
    (as the JAX package keeps taped decodes off its Pallas chain); "pallas"
    with a bucket raises."""
    _, _, dec = pair
    calls = []
    real = fused_tail.forward
    monkeypatch.setattr(fused_tail, "forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    z = torch.from_numpy(_latent())
    res = tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.fast(),
                           pad_to=PAD_HW)
    assert calls == [] and torch.isfinite(res.image).all()
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.fast())
    assert calls == [1]
    pallas = dataclasses.replace(Precision.fast(), upstack="pallas")
    with pytest.raises(ValueError, match="pallas"):
        tpipe.hdr_decode(dec, z, HDRDecodeConfig(), pallas, shape_bucket=8)


def test_mixed_bucketed_never_staged(pair, monkeypatch):
    """A bucketed mixed decode above the staged threshold stays
    whole-image, as in the JAX package; unbucketed it goes staged."""
    _, _, dec = pair
    calls = []
    real = staged.staged_hdr_decode
    monkeypatch.setattr(staged, "staged_hdr_decode",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tpipe, "_STAGED_MIN_PIXELS_OVERRIDE", 1)
    z = torch.from_numpy(_latent(hw=(16, 16)))
    for kw in (dict(pad_to=(16, 16)), dict(shape_bucket=8),
               dict(shape_bucket=16, pad_to=(24, 16))):
        tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.mixed(), **kw)
    assert calls == []
    tpipe.hdr_decode(dec, z, HDRDecodeConfig(), Precision.mixed())
    assert calls == [1]
