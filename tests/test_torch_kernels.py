"""The port's kernel modules against the JAX package's Pallas kernels.

On this CPU-only suite each port wrapper runs its plain PyTorch version
(the CUDA kernels are checked against those same plain versions on the card
by ``chip_smoke.py``), and the JAX side runs the Pallas kernel the way the
JAX package's own tests do: K1/K2 under ``pltpu.force_tpu_interpret_mode``,
K3 with ``interpret=True``.  Inputs are made with numpy from a seed and
handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrvae.kernels import attention as jattn
from hdrvae.kernels import conv3x3 as jconv
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import attention as tattn
from hdrvae_torch.kernels import conv3x3 as tconv

torch.set_num_threads(2)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# K3: spatial attention
# ---------------------------------------------------------------------------


class TestAttention:
    # (h, w, block): 8x8 = one 64-token block; 10x10 = 100 tokens with
    # 64-token blocks, a ragged N that pads and masks keys on the JAX side
    @pytest.mark.parametrize("h,w,block", [(8, 8, 64), (10, 10, 64),
                                           (16, 16, 128)])
    @pytest.mark.parametrize("tier,precise,tol", [
        # HIGHEST is exact float32 on both sides: <= 1e-5 (tpu_checks budget)
        ("parity", jax.lax.Precision.HIGHEST, 1e-5),
        # the JAX mixed tier's 3-pass bf16x3 (_dot3) against the port's
        # exact float32: <= 1e-4, the 3-pass budget
        ("mixed", jax.lax.Precision.HIGH, 1e-4),
    ])
    def test_matches_pallas(self, h, w, block, tier, precise, tol):
        c = 64
        q, k, v = (_np(s, (1, h, w, c)) for s in (0, 1, 2))
        ref = np.asarray(jattn.spatial_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), precise=precise,
            block_q=block, block_k=block, interpret=True))
        got = tattn.spatial_attention(_t(q), _t(k), _t(v),
                                      precision=Precision(mode=tier))
        assert got.dtype == torch.float32 and got.shape == (1, h, w, c)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)

    def test_fast_tier_bf16_inputs(self):
        """Fast tier: bf16 q/k/v.  The plain version computes in float32 on
        the bf16 values; the Pallas DEFAULT dot also rounds p to bf16 for
        P v, which moves the output by up to ~2^-8 of |v| (bf16 epsilon)."""
        c, h, w = 64, 8, 8
        q, k, v = (np.asarray(jnp.asarray(_np(s, (1, h, w, c)))
                              .astype(jnp.bfloat16).astype(jnp.float32))
                   for s in (3, 4, 5))
        ref = np.asarray(jattn.spatial_attention_pallas(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), precise=False, interpret=True))
        bf = torch.bfloat16
        got = tattn.spatial_attention(_t(q, bf), _t(k, bf), _t(v, bf),
                                      precision=Precision.fast())
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=2 ** -8 * np.abs(v).max(), rtol=0)


# ---------------------------------------------------------------------------
# K1: fused conv3x3
# ---------------------------------------------------------------------------


def _k1_inputs(cin=16, cout=16, h=8, w=16):
    """x, kernel, bias, gamma, beta."""
    return (_np(10, (1, h, w, cin)), _np(11, (3, 3, cin, cout), 0.2),
            _np(12, (cout,)), _np(13, (cin,), 0.5), _np(14, (cin,), 0.5))


def _stats_close(got, ref, y):
    """Statistics: sumsq <= 1e-5 relative; the signed sum <= 1e-5 of the
    group's sum of |y| (a signed sum may cancel to near zero, where a
    relative bound on it alone says nothing about the kernel)."""
    g = ref[0].shape[-1]
    b, h, w, c = y.shape
    abs_sum = np.abs(y).reshape(b, h * w, g, c // g).sum(axis=(1, 3))
    np.testing.assert_array_less(np.abs(got[0] - ref[0]),
                                 1e-5 * abs_sum + 1e-30)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=0)


class TestFusedConv:
    @pytest.mark.parametrize("variant", ["plain", "prologue", "add", "proj",
                                         "stats"])
    def test_f32_matches_pallas(self, variant):
        """float32: the same function, summation order only (<= 1e-5)."""
        x, kern, bias, gamma, beta = _k1_inputs()
        pro = variant in ("prologue", "stats")
        kw = dict(num_groups=4, emit_stats=variant == "stats")
        jkw, tkw = dict(kw), dict(kw)
        if pro:
            jkw.update(gamma=jnp.asarray(gamma), beta=jnp.asarray(beta))
            tkw.update(gamma=_t(gamma), beta=_t(beta))
        if variant == "add":
            rin = _np(15, (1, 8, 16, 16))
        if variant == "proj":     # a 32-channel residual through [32, 16]
            rin, rk = _np(17, (1, 8, 16, 32)), _np(16, (32, 16), 0.3)
            jkw["res_kernel"], tkw["res_kernel"] = jnp.asarray(rk), _t(rk)
        if variant in ("add", "proj"):
            jkw["residual"], tkw["residual"] = jnp.asarray(rin[0]), _t(rin)
        with pltpu.force_tpu_interpret_mode():
            ref = jconv.fused_conv3x3(jnp.asarray(x[0]), jnp.asarray(kern),
                                      jnp.asarray(bias), block_rows=4, **jkw)
        got = tconv.fused_conv3x3(_t(x), _t(kern), _t(bias), **tkw)
        if variant == "stats":
            (ry, rs), (gy, gs) = ref, got
            ry = np.asarray(ry)[None]
            np.testing.assert_allclose(gy.numpy(), ry, atol=1e-5, rtol=0)
            _stats_close((gs[0].numpy(), gs[1].numpy()),
                         (np.asarray(rs[0])[None], np.asarray(rs[1])[None]),
                         ry)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref)[None],
                                       atol=1e-5, rtol=0)

    def test_bf16_matches_pallas(self):
        """bf16 activations and weights, float32 accumulation, bf16 store:
        both sides round the same float32 value to bf16, so they differ
        only where summation order flips a rounding, by one bf16 ulp
        (2^-8 relative)."""
        x, kern, bias, gamma, beta = _k1_inputs()
        bf = jnp.bfloat16
        with pltpu.force_tpu_interpret_mode():
            ry, rs = jconv.fused_conv3x3(
                jnp.asarray(x[0], bf), jnp.asarray(kern, bf),
                jnp.asarray(bias), gamma=jnp.asarray(gamma),
                beta=jnp.asarray(beta), residual=jnp.asarray(x[0], bf),
                emit_stats=True, num_groups=4, block_rows=4)
        tb = torch.bfloat16
        gy, gs = tconv.fused_conv3x3(
            _t(x, tb), _t(kern, tb), _t(bias), gamma=_t(gamma),
            beta=_t(beta), residual=_t(x, tb), emit_stats=True,
            num_groups=4)
        assert gy.dtype == torch.bfloat16
        ry = np.asarray(ry.astype(jnp.float32))[None]
        np.testing.assert_allclose(gy.float().numpy(), ry, rtol=2 ** -8,
                                   atol=1e-6)
        # statistics of the stored bf16 y: within the ulp flips above
        np.testing.assert_allclose(gs[1].numpy(), np.asarray(rs[1])[None],
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# K2: fused nearest-2x upsample + conv3x3
# ---------------------------------------------------------------------------


class TestUpsampleConv:
    @pytest.mark.parametrize("h,w,cin,cout", [(8, 16, 16, 16),
                                              (4, 8, 16, 32)])
    def test_f32_matches_pallas(self, h, w, cin, cout):
        """float32: the Pallas phase decomposition sums the taps in a
        different order than conv-on-upsampled; <= 1e-5."""
        x = _np(20, (1, h, w, cin))
        kern = _np(21, (3, 3, cin, cout), 0.2)
        bias = _np(22, (cout,))
        with pltpu.force_tpu_interpret_mode():
            ry, rs = jconv.upsample_conv3x3(
                jnp.asarray(x[0]), jnp.asarray(kern), jnp.asarray(bias),
                emit_stats=True, num_groups=4, block_rows=4)
        gy, gs = tconv.upsample_conv3x3(_t(x), _t(kern), _t(bias),
                                        emit_stats=True, num_groups=4)
        ry = np.asarray(ry)[None]
        assert gy.shape == (1, 2 * h, 2 * w, cout)
        np.testing.assert_allclose(gy.numpy(), ry, atol=1e-5, rtol=0)
        _stats_close((gs[0].numpy(), gs[1].numpy()),
                     (np.asarray(rs[0])[None], np.asarray(rs[1])[None]), ry)

    def test_phase_kernels_match_pallas(self):
        """The phase-weight collapse is the JAX package's, bit for bit in
        float32 and after the bf16 rounding."""
        kern = _np(23, (3, 3, 16, 16), 0.2)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            ref = np.asarray(jconv.phase_kernels(jnp.asarray(kern, jdt))
                             .astype(jnp.float32))
            got = tconv.phase_kernels(_t(kern, tdt)).float().numpy()
            np.testing.assert_array_equal(got, ref)


def test_cpu_tensors_never_launch():
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay 0."""
    before = (tconv.fused_conv3x3.launches, tconv.upsample_conv3x3.launches,
              tattn.flash_attention_bf16.launches,
              tattn.flash_attention_f32.launches)
    x = torch.zeros(1, 8, 16, 16)
    k = torch.zeros(3, 3, 16, 64)
    b = torch.zeros(64)
    tconv.fused_conv3x3(x, k, b, emit_stats=True, num_groups=4)
    tconv.upsample_conv3x3(x, k, b, emit_stats=True, num_groups=4)
    q = torch.zeros(1, 4, 4, 64)
    tattn.flash_attention_bf16(q.bfloat16(), q.bfloat16(), q.bfloat16())
    tattn.flash_attention_f32(q, q, q)
    after = (tconv.fused_conv3x3.launches, tconv.upsample_conv3x3.launches,
             tattn.flash_attention_bf16.launches,
             tattn.flash_attention_f32.launches)
    assert before == after == (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# K4: fused collapse + statistics
# ---------------------------------------------------------------------------


class TestCollapseAndStats:
    # C = 128 (the Flux pre map: 42/42/42, channels 126-127 dropped) with
    # M = 35 rows; C = 12 (thirds); C = 16 (thirds of 15, channel 15
    # dropped); M = 9 rows is no multiple of any block
    @pytest.mark.parametrize("shape", [(1, 5, 7, 128), (1, 3, 3, 12),
                                       (2, 4, 5, 16)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, shape, dtype):
        """The port's K4 path (its plain version here) against the Pallas
        kernel in interpret mode: the collapse is a max, exact; min and max
        exact; mean and std <= 1e-5 relative (reduction order only)."""
        from hdrvae.kernels.epilogue import collapse_and_stats_pallas
        from hdrvae_torch.kernels import epilogue as tepi
        pre = _np(30, shape, 2.0) + 0.5
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jpre = jnp.asarray(pre, jdt)
        pre = np.asarray(jpre.astype(jnp.float32))   # the stored values
        col, stats = collapse_and_stats_pallas(jpre, interpret=True)
        got_col, got = tepi.collapse_and_stats(_t(pre, tdt), use_fused=True)
        assert got_col.dtype == tdt and got_col.shape == shape[:3] + (3,)
        np.testing.assert_array_equal(got_col.float().numpy(),
                                      np.asarray(col.astype(jnp.float32)))
        for key in ("min", "max"):
            assert float(got[key]) == float(stats[key]), key
        for key in ("mean", "std"):
            np.testing.assert_allclose(float(got[key]), float(stats[key]),
                                       rtol=1e-5, err_msg=key)

    def test_bounds_match_pallas(self):
        from hdrvae.kernels.epilogue import _collapse_bounds
        from hdrvae_torch.decode.formatting import collapse_bounds
        for c in (3, 12, 16, 128, 129, 384):
            assert (0, *collapse_bounds(c)) == _collapse_bounds(c)

    def test_default_path_unchanged(self):
        """use_fused=False and the fused wrapper on a CPU tensor both run
        the plain reductions; the launch counter stays 0."""
        from hdrvae_torch.kernels import epilogue as tepi
        pre = _t(_np(31, (1, 4, 6, 128)))
        before = tepi.collapse_and_stats_fused.launches
        a = tepi.collapse_and_stats(pre)
        b = tepi.collapse_and_stats(pre, use_fused=True)
        assert torch.equal(a[0], b[0])
        for key in a[1]:
            assert torch.equal(a[1][key], b[1][key])
        assert tepi.collapse_and_stats_fused.launches == before == 0
