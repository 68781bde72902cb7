"""The mixed tier's attention arithmetic: K3's 3-pass (bf16x3) mode.

The JAX kernel runs the mixed tier's dots as ``_dot3``: each float32
operand split into bf16 hi + lo, hi.hi + hi.lo + lo.hi summed in float32.
On this CPU-only suite the port's 3-pass wrapper runs its plain version
(the CUDA kernel is held to the same plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``); the JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.kernels import attention as jattn
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import attention as tattn
from hdrvae_torch.kernels.f32_dot import split_bf16

torch.set_num_threads(2)

# (h, w, block): 8x8 = one 64-token block; 10x10 = 100 tokens with 64-token
# blocks (the JAX side pads and masks keys through its flag channel); 16x16
# = two 128-token blocks (an online softmax across blocks)
SHAPES = [(8, 8, 64), (10, 10, 64), (16, 16, 128)]
C = 64
# plain 3-pass against the JAX kernel: the same bf16 products, float32 sums
# in another order, and the JAX side splits p against a running row max;
# measured 1.7e-6 to 2.6e-6, while exact float32 sits at 5.4e-6 to 8.6e-6
HIGH_BAR = 4e-6
BUDGET = 1e-4    # the 3-pass attention budget against exact arithmetic


def _qkv(h, w, c=C, qscale=1.0):
    q, k, v = (np.random.default_rng(s).standard_normal((1, h, w, c))
               .astype(np.float32) for s in (0, 1, 2))
    return q * np.float32(qscale), k, v


def _jax_high(q, k, v, block):
    return np.asarray(jattn.spatial_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        precise=jax.lax.Precision.HIGH, block_q=block, block_k=block,
        interpret=True))


def _float64(q, k, v):
    b, h, w, c = q.shape
    qd, kd, vd = (np.asarray(t, np.float64).reshape(b, h * w, c)
                  for t in (q, k, v))
    s = qd * c ** -0.5 @ kd.transpose(0, 2, 1)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True) @ vd).reshape(q.shape)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("h,w,block", SHAPES)
def test_plain_matches_jax_high(h, w, block):
    q, k, v = _qkv(h, w)
    got = tattn.spatial_attention_3pass_reference(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32 and got.shape == (1, h, w, C)
    np.testing.assert_allclose(got.numpy(), _jax_high(q, k, v, block),
                               atol=HIGH_BAR, rtol=0)


@pytest.mark.parametrize("h,w,block", SHAPES)
def test_exact_path_misses_the_high_bar(h, w, block):
    """Exact float32 is not what the JAX mixed tier computes: on the same
    inputs it misses the bar the 3-pass arithmetic meets, so the bar tells
    the two apart."""
    q, k, v = _qkv(h, w)
    exact = tattn.spatial_attention_reference(_t(q), _t(k), _t(v))
    assert np.abs(exact.numpy() - _jax_high(q, k, v, block)).max() > HIGH_BAR


@pytest.mark.parametrize("h,w,block", SHAPES)
def test_mixed_tier_matches_jax_high(h, w, block):
    """spatial_attention in the mixed tier is the 3-pass arithmetic."""
    q, k, v = _qkv(h, w)
    got = tattn.spatial_attention(_t(q), _t(k), _t(v),
                                  precision=Precision.mixed())
    np.testing.assert_allclose(got.numpy(), _jax_high(q, k, v, block),
                               atol=HIGH_BAR, rtol=0)


@pytest.mark.parametrize("h,w,c,qscale", [(8, 8, 64, 1.0), (10, 10, 64, 1.0),
                                          (16, 16, 128, 1.0), (8, 8, 64, 4.0)])
def test_plain_within_budget_of_float64(h, w, c, qscale):
    q, k, v = _qkv(h, w, c, qscale)
    got = tattn.spatial_attention_3pass_reference(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _float64(q, k, v), atol=BUDGET,
                               rtol=0)


def _dot3_without(term: str, which: int):
    """_dot3 with one correction term ("hl" or "lh") dropped from its
    ``which``-th call (0: the scores, 1: P v)."""
    calls = []

    def dot(a, b):
        (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
        ah, al, bh, bl = (t.float() for t in (ah, al, bh, bl))
        parts = {"hh": ah @ bh, "hl": ah @ bl, "lh": al @ bh}
        if len(calls) == which:
            del parts[term]
        calls.append(which)
        return sum(parts.values())
    return dot


@pytest.mark.parametrize("which", [0, 1], ids=["scores", "pv"])
@pytest.mark.parametrize("term", ["hl", "lh"])
@pytest.mark.parametrize("h,w,c", [(8, 8, 64), (16, 16, 128)])
def test_dropping_a_correction_term_breaks_the_budget(monkeypatch, h, w, c,
                                                      term, which):
    """Either cross term carries ~2^-9 of each product: without it the
    attention leaves the 3-pass budget (measured 7e-4 to 3e-3 here)."""
    q, k, v = _qkv(h, w, c)
    monkeypatch.setattr(tattn, "_dot3", _dot3_without(term, which))
    got = tattn.spatial_attention_3pass_reference(_t(q), _t(k), _t(v))
    assert np.abs(got.numpy() - _float64(q, k, v)).max() > BUDGET


def test_scale_is_applied_before_the_split():
    """q is scaled in float32 and then split, as _flash_kernel does: the
    plain version equals _dot3 of the scaled q, not C^-1/2 times _dot3 of
    q.  At C = 128 the scale 2^-3.5 is no power of two (at C = 64 or 256 it
    is, and the two orders are bit-equal)."""
    c = 128
    q, k, v = _qkv(8, 8, c)
    qt = _t(q).reshape(1, 64, c)
    kt = _t(k).reshape(1, 64, c).transpose(1, 2)
    before = tattn._dot3(qt * c ** -0.5, kt)
    after = tattn._dot3(qt, kt) * c ** -0.5
    assert not torch.equal(before, after)
    p = tattn.exp_f32(before - before.amax(dim=-1, keepdim=True))
    want = tattn._dot3(p, _t(v).reshape(1, 64, c)) / p.sum(-1, keepdim=True)
    got = tattn.spatial_attention_3pass_reference(_t(q), _t(k), _t(v))
    assert torch.equal(got.reshape(1, 64, c), want)


def _record(monkeypatch):
    """Replace the three kernel wrappers with recorders of (name, dtype)."""
    calls = []
    for name in ("flash_attention_bf16", "flash_attention_3pass",
                 "flash_attention_f32"):
        def fake(q, k, v, name=name):
            calls.append((name, q.dtype))
            return q.float()
        monkeypatch.setattr(tattn, name, fake)
    return calls


@pytest.mark.parametrize("precision,want", [
    (Precision.fast(), ("flash_attention_bf16", torch.bfloat16)),
    (Precision.mixed(), ("flash_attention_3pass", torch.float32)),
    (Precision.parity(), ("flash_attention_f32", torch.float32)),
    (Precision(mode="fast"), ("flash_attention_f32", torch.float32)),
    (Precision.mixed(2).head_precision(),
     ("flash_attention_bf16", torch.bfloat16)),
    (Precision.mixed(2).for_level(1),
     ("flash_attention_3pass", torch.float32)),
], ids=["fast", "mixed", "parity", "fast-f32", "mixed-head", "mixed-level1"])
def test_dispatch_per_tier(monkeypatch, precision, want):
    calls = _record(monkeypatch)
    q = torch.zeros(1, 4, 4, 64)
    tattn.spatial_attention(q, q, q, precision=precision)
    assert calls == [want]


def test_cpu_tensor_runs_the_plain_version():
    """On a CPU tensor the 3-pass wrapper runs its plain version and never
    counts a launch."""
    q, k, v = (_t(a) for a in _qkv(8, 8))
    before = tattn.flash_attention_3pass.launches
    got = tattn.flash_attention_3pass(q, k, v)
    assert tattn.flash_attention_3pass.launches == before == 0
    assert torch.equal(got, tattn.spatial_attention_3pass_reference(q, k, v))


# The 3-pass kernel's operands are split once a launch (split_qkv) instead
# of inside each dot: its plain version must give _dot3's own parts, and
# the attention on those parts must equal the plain 3-pass attention.


def _with_ties(shape, seed):
    """float32 values ~ N(0, 1), a quarter of them placed on a bf16 tie
    (half a bf16 ulp above a bf16 value), a quarter one float32 ulp to
    either side of one: where hi = bf16(x) rounds to even or not."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    bits = x.view(np.uint32) & np.uint32(0xFFFF0000)
    tie = bits | np.uint32(0x8000)
    off = tie.astype(np.int64) + rng.choice([-1, 1], shape)
    pick = rng.integers(0, 4, shape)
    out = np.where(pick == 0, tie, np.where(pick == 1, off.astype(np.uint32),
                                            x.view(np.uint32)))
    return out.astype(np.uint32).view(np.float32).reshape(shape)


def _jax_split(x, b):
    """(hi, lo) of ``x`` as _dot3 (hdrvae/kernels/attention.py) makes them:
    the bf16 operands of its DEFAULT passes, recorded."""
    seen = []
    real = jax.lax.dot_general

    def record(a, bb, *args, **kwargs):
        seen.append((np.asarray(a), np.asarray(bb)))
        return real(a, bb, *args, **kwargs)

    jax.lax.dot_general = record
    try:
        jattn._dot3(x, b, (((1,), (1,)), ((), ())))
    finally:
        jax.lax.dot_general = real
    (ah, bh), (ah2, bl), (al, bh2) = seen
    assert np.array_equal(ah, ah2) and np.array_equal(bh, bh2)
    return (ah, al), (bh, bl)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_qkv_is_dot3s_split(c, seed):
    """split_qkv's plain version gives the bf16 parts _dot3 makes, bit for
    bit: q's after its float32 scale by C^-1/2 (no power of two at C = 128
    or 512), k's and v's as they are, on values at and beside bf16 ties."""
    h, w = 4, 6
    q, k, v = (_with_ties((1, h, w, c), seed + s) for s in (0, 10, 20))
    parts = tattn.split_qkv_reference(_t(q), _t(k), _t(v))
    assert parts.shape == (3, 2, 1, h, w, c) and parts.dtype == torch.bfloat16
    got = parts.float().reshape(3, 2, h * w, c).numpy()
    qs = jnp.asarray(q.reshape(h * w, c)) * c ** -0.5
    (qh, ql), (kh, kl) = _jax_split(qs, jnp.asarray(k.reshape(h * w, c)))
    (vh, vl), _ = _jax_split(jnp.asarray(v.reshape(h * w, c)), qs)
    for i, want in enumerate((qh, ql, kh, kl, vh, vl)):
        assert np.array_equal(_bits(got[i // 2, i % 2]),
                              _bits(np.asarray(want, np.float32))), i


def test_split_qkv_splits_after_the_scale():
    """At C = 128 q's parts are those of q * C^-1/2, which differ from the
    scaled parts of q."""
    c = 128
    q, k, v = (_t(a) for a in _qkv(4, 4, c))
    parts = tattn.split_qkv_reference(q, k, v)
    hi, lo = split_bf16(q * c ** -0.5)
    assert torch.equal(parts[0, 0], hi) and torch.equal(parts[0, 1], lo)
    hi2, lo2 = split_bf16(q)
    assert not torch.equal(parts[0, 0].float() + parts[0, 1].float(),
                           (hi2.float() + lo2.float()) * c ** -0.5)


@pytest.mark.parametrize("mask", [False, True], ids=["all", "key_valid"])
@pytest.mark.parametrize("h,w,c", [(8, 8, 64), (10, 10, 128), (7, 9, 512)])
def test_attention_on_parts_equals_the_plain_3pass(h, w, c, mask):
    """The attention on split_qkv's parts (what the kernel computes from
    them) equals spatial_attention_3pass_reference on q, k, v bit for bit:
    splitting once a launch changes nothing."""
    q, k, v = (_t(a) for a in _qkv(h, w, c))
    kv = None
    if mask:
        kv = torch.from_numpy(np.random.default_rng(5).random((h, w)) > 0.3)
    got = tattn.spatial_attention_3pass_parts(tattn.split_qkv(q, k, v), kv)
    want = tattn.spatial_attention_3pass_reference(q, k, v, kv)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,block", SHAPES)
def test_attention_on_parts_matches_jax_high(h, w, block):
    q, k, v = _qkv(h, w)
    parts = tattn.split_qkv(_t(q), _t(k), _t(v))
    got = tattn.spatial_attention_3pass_parts(parts)
    np.testing.assert_allclose(got.numpy(), _jax_high(q, k, v, block),
                               atol=HIGH_BAR, rtol=0)


def test_cpu_split_runs_the_plain_version():
    q, k, v = (_t(a) for a in _qkv(8, 8))
    before = tattn.split_qkv.launches
    got = tattn.split_qkv(q, k, v)
    assert tattn.split_qkv.launches == before == 0
    assert torch.equal(got, tattn.split_qkv_reference(q, k, v))
