"""The fast tier's streaming top level against the JAX package.

K5 ``upconv_gn_conv3x3`` and K2's ``stats_only`` mode run their plain
PyTorch versions here (the CUDA kernels are held to those same plain
versions on the card by ``chip_smoke.py``); the JAX side runs the Pallas
kernels under ``pltpu.force_tpu_interpret_mode``, as
``tests/test_conv_kernels.py`` does.  The folded shortcut, the low-memory
``upstack_apply`` and the fast ``hdr_decode`` through it are held to the
whole-image chain and to the JAX decoder's layers.  Inputs are made with
numpy from a seed; weights cross over with ``state_dict_from_jax``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.kernels import conv3x3 as jconv
from hdrvae.models.decoder import decoder_head as jhead
from hdrvae.models.decoder import decoder_tail as jtail
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.kernels import conv3x3 as tconv
from hdrvae_torch.models import fused_tail
from hdrvae_torch.models.decoder import decoder_tail
from hdrvae_torch.models.layers import conv2d, nearest_upsample_2x
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        init_decoder, state_dict_from_jax)

torch.set_num_threads(2)

# the fast tier with float32 storage: the chain's arithmetic without its
# bf16 roundings, so the comparisons below are of the algorithm
F32_FAST = Precision(compute_dtype=torch.float32,
                     storage_dtype=torch.float32, mode="fast")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _sums_close(got, ref, y, rtol):
    """(sum, sumsq) [G] of the groups of one sample y [H, W, C]: sumsq
    relative; the signed sum relative to the group's sum of |y| (a signed
    sum may cancel)."""
    g = ref[0].shape[-1]
    h, w, c = y.shape
    abs_sum = np.abs(y).reshape(h * w, g, c // g).sum(axis=(0, 2))
    np.testing.assert_array_less(np.abs(got[0] - ref[0]),
                                 rtol * abs_sum + 1e-30)
    np.testing.assert_allclose(got[1], ref[1], rtol=rtol, atol=0)


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


# ---------------------------------------------------------------------------
# K5: upconv_gn_conv3x3
# ---------------------------------------------------------------------------


def _k5_inputs(h, w, c=8):
    """x, up_kernel, up_bias, gamma, beta, kernel, bias."""
    return (_np(40, (1, h, w, c)), _np(41, (3, 3, c, c), 0.2),
            _np(42, (c,)), _np(43, (c,), 0.5), _np(44, (c,), 0.5),
            _np(45, (3, 3, c, c), 0.2), _np(46, (c,)))


# (h, w, JAX block_rows, block_cols) of the low-resolution x: 8 x 16 gives
# a 16 x 32 output, whole 8 x 16 tiles of the CUDA kernel; 6 x 24 gives a
# 12 x 48 one, whose rows end in a part tile
K5_SHAPES = [(8, 16, 4, 8), (6, 24, 3, 8)]


class TestUpconvGnConv:
    @pytest.mark.parametrize("h,w,br,wb", K5_SHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, h, w, br, wb, dtype):
        """The plain version against the Pallas kernel (x in JAX's
        double-row-padded layout, its padded output cropped).

        float32: the same function up to summation order, y <= 1e-5 and
        the sums <= 1e-5 relative.  bf16: both round z = upconv + up_bias
        to bf16 and the band to bf16, but JAX sums the taps into bf16
        phase kernels first (one bf16 ulp of a sum) where the plain
        version takes the nine taps exactly; so z or a band value can sit
        one bf16 ulp (2^-8 relative) apart, and conv1's 9 * Cm products of
        such values, plus the one-ulp flip of y's own rounding, stay
        within 1e-2 * max|y| (seen: 5.2e-3 * max|y|); sumsq within 1e-3."""
        args = _k5_inputs(h, w)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        big = (0, 1, 5)   # the activations and conv kernels take the dtype
        jargs = [jnp.asarray(a[0] if i == 0 else a, jdt if i in big
                             else jnp.float32) for i, a in enumerate(args)]
        jargs[0] = jnp.pad(jargs[0], ((2, 2), (jconv._MG, jconv._MG),
                                      (0, 0)))
        with pltpu.force_tpu_interpret_mode():
            ry, rs = jconv.upconv_gn_conv3x3(
                *jargs, emit_stats=True, num_groups=4, block_rows=br,
                block_cols=wb)
        ry = np.asarray(ry.astype(jnp.float32))[1:-1, jconv._MG:-jconv._MG]
        gy, gs = tconv.upconv_gn_conv3x3(
            *(_t(a, tdt if i in big else torch.float32)
              for i, a in enumerate(args)), num_groups=4)
        assert gy.dtype == tdt and gy.shape == (1, 2 * h, 2 * w, 8)
        got = gy.float().numpy()[0]
        sums = (gs[0].numpy()[0], gs[1].numpy()[0])
        ref_sums = (np.asarray(rs[0]), np.asarray(rs[1]))
        if dtype == "float32":
            np.testing.assert_allclose(got, ry, atol=1e-5, rtol=0)
            _sums_close(sums, ref_sums, ry, 1e-5)
        else:
            assert np.abs(got - ry).max() <= 1e-2 * np.abs(ry).max()
            np.testing.assert_allclose(sums[1], ref_sums[1], rtol=1e-3)

    def test_band_is_zero_outside_the_image(self):
        """The SAME zeros of conv1 are zeros of the normalized band, never
        silu(beta): with a conv1 that only reads its corner taps, border
        pixels see exactly what the rounded recipe gives."""
        x, upk, upb, gamma, beta, kern, bias = (_t(a) for a in
                                                _k5_inputs(4, 4))
        beta = beta + 3.0          # silu(beta) far from 0
        y = tconv.upconv_gn_conv3x3(x, upk, upb, gamma, beta, kern, bias,
                                    emit_stats=False)
        z = tconv.upsample_conv3x3(x, upk, upb)
        a = z * gamma + beta
        band = torch.nn.functional.pad(
            (a * torch.sigmoid(a)).permute(0, 3, 1, 2), (1, 1, 1, 1))
        ref = torch.nn.functional.conv2d(band, kern.permute(3, 2, 0, 1))
        ref = ref.permute(0, 2, 3, 1) + bias
        np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# K2: stats_only
# ---------------------------------------------------------------------------


class TestStatsOnly:
    @pytest.mark.parametrize("h,w,cin,cout", [(8, 16, 16, 16),
                                              (4, 8, 16, 32)])
    def test_matches_pallas(self, h, w, cin, cout):
        """float32: the sums of the never-stored output against the Pallas
        kernel's stats_only pass, <= 1e-5 relative."""
        x = _np(50, (1, h, w, cin))
        kern, bias = _np(51, (3, 3, cin, cout), 0.2), _np(52, (cout,))
        with pltpu.force_tpu_interpret_mode():
            rs = jconv.upsample_conv3x3(
                jnp.asarray(x[0]), jnp.asarray(kern), jnp.asarray(bias),
                emit_stats=True, stats_only=True, num_groups=4,
                block_rows=4)
        gs = tconv.upsample_conv3x3(_t(x), _t(kern), _t(bias),
                                    emit_stats=True, stats_only=True,
                                    num_groups=4)
        y = tconv.upsample_conv3x3(_t(x), _t(kern), _t(bias)).numpy()
        _sums_close((gs[0].numpy()[0], gs[1].numpy()[0]),
                    (np.asarray(rs[0]), np.asarray(rs[1])), y[0], 1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_equals_the_sums_with_y(self, dtype):
        """stats_only returns exactly the sums the same call emits beside
        y (the kernel's contract, bit for bit)."""
        x = _t(_np(53, (1, 6, 10, 16)), dtype)
        kern = _t(_np(54, (3, 3, 16, 32), 0.2), dtype)
        bias = _t(_np(55, (32,)))
        _, full = tconv.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                         num_groups=4)
        only = tconv.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                      stats_only=True, num_groups=4)
        assert torch.equal(full[0], only[0]) and torch.equal(full[1],
                                                             only[1])

    def test_needs_emit_stats(self):
        x = torch.zeros(1, 4, 4, 16)
        with pytest.raises(ValueError, match="stats_only"):
            tconv.upsample_conv3x3(x, torch.zeros(3, 3, 16, 16),
                                   torch.zeros(16), stats_only=True)


# ---------------------------------------------------------------------------
# The streaming top level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(8, 8), (6, 10)])
def test_folded_shortcut_algebra(small, h, w):
    """nin_shortcut(conv_up(nearest2x(x))) as one upsample conv with the
    1x1 folded into its weights and bias: the same linear map, float32
    <= 1e-5."""
    _, _, dec = small
    up = dec.up[1].upsample.conv
    nin = dec.up[0].block[0].nin_shortcut
    x = _t(_np(60, (1, h, w, up.in_channels), 2.0))
    got = fused_tail._folded_shortcut(x, up.weight.permute(2, 3, 1, 0),
                                      up.bias, nin, F32_FAST)
    par = Precision.parity()
    ref = conv2d(conv2d(nearest_upsample_2x(x), up, precision=par), nin,
                 precision=par)
    assert got.shape == ref.shape == (1, 2 * h, 2 * w, nin.out_channels)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_junction_weights_are_pallas_phase_kernels(small, dtype):
    """The phase kernels K5 takes, kept on level 0's block 0, are the JAX
    package's phase_kernels of the upsample conv in the compute dtype, bit
    for bit; conv1 is its HWIO kernel in that dtype, and a second call
    returns the kept weights."""
    _, _, dec = small
    up, blk = dec.up[1].upsample.conv, dec.up[0].block[0]
    tdt = getattr(torch, dtype)
    jw = fused_tail.junction_weights(up, blk, tdt)
    hwio = up.weight.permute(2, 3, 1, 0).to(tdt)
    ref = jconv.phase_kernels(jnp.asarray(hwio.float().numpy(),
                                          getattr(jnp, dtype)))
    assert jw.phase.dtype == tdt and jw.phase.is_contiguous()
    np.testing.assert_array_equal(jw.phase.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(jw.up_kernel, hwio)
    assert torch.equal(jw.kernel, blk.conv1.weight.permute(2, 3, 1, 0)
                       .to(tdt))
    assert fused_tail.junction_weights(up, blk, tdt) is jw


def test_junction_weights_follow_load_state_dict(small):
    """A load_state_dict that changes the upsample conv or conv1 in place
    drops the kept weights: the next call prepares them from the new
    parameters."""
    _, _, dec = small
    dec = copy.deepcopy(dec)
    up, blk = dec.up[1].upsample.conv, dec.up[0].block[0]
    old = fused_tail.junction_weights(up, blk, torch.bfloat16)
    sd = {k: v.clone() for k, v in dec.state_dict().items()}
    sd["up.1.upsample.conv.weight"] *= 2.0
    sd["up.0.block.0.conv1.bias"] += 1.0
    dec.load_state_dict(sd)
    new = fused_tail.junction_weights(up, blk, torch.bfloat16)
    assert new is not old
    assert torch.equal(new.phase, tconv.phase_kernels(
        up.weight.permute(2, 3, 1, 0).to(torch.bfloat16)))
    assert torch.equal(new.bias, old.bias + 1.0)


@pytest.mark.parametrize("h,w", [(8, 8), (6, 10)])
def test_lowmem_upstack_matches_whole(small, h, w):
    """float32 storage: the streamed top level (K2 stats_only moments, K5
    conv1, folded shortcut, conv2 over its residual) against the
    whole-image chain, <= 1e-5 and the moments <= 1e-6, the bound JAX's
    test_lowmem_residual_fold holds its own to; the caller's x is never
    written."""
    _, _, dec = small
    x = _t(_np(61, (1, h, w, dec.cfg.block_in), 2.0))
    x0 = x.clone()
    m = fused_tail._entry_moments(x, dec.cfg.num_groups)
    a, ma = fused_tail.upstack_apply(dec, x, m, precision=F32_FAST,
                                     lowmem=False)
    b, mb = fused_tail.upstack_apply(dec, x, m, precision=F32_FAST,
                                     lowmem=True)
    assert torch.equal(x, x0)
    assert a.shape == b.shape == (1, 2 * h, 2 * w, dec.cfg.ch)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)
    for p, q in zip(ma, mb):
        np.testing.assert_allclose(q.numpy(), p.numpy(), atol=1e-6, rtol=0)


def test_lowmem_matches_jax_layers(small, monkeypatch):
    """float32 storage: the port's chain with the streamed top level (the
    route hdr_decode takes above LOWMEM_MIN_PIXELS) + decoder_tail
    against JAX's decoder_head + decoder_tail layers in the same tier,
    rgb and pre_conv_out <= 2e-5."""
    jcfg, params, dec = small
    z = _np(62, (1, 8, 8, 4), 2.0)
    jprec = JPrecision(compute_dtype=jnp.float32, storage_dtype=jnp.float32,
                       mode="fast")
    ref = jtail(params, jhead(params, jnp.asarray(z), jcfg, precision=jprec,
                              tail_levels=0),
                jcfg, precision=jprec, tail_levels=0)
    monkeypatch.setattr(fused_tail, "LOWMEM_MIN_PIXELS", 1)
    calls = []
    real = fused_tail.upconv_gn_conv3x3
    monkeypatch.setattr(fused_tail, "upconv_gn_conv3x3",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pre, moments = fused_tail.forward(dec, _t(z), precision=F32_FAST)
    got = decoder_tail(dec, pre, precision=F32_FAST, moments=moments)
    assert calls == [1]
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.pre_conv_out.numpy(),
                               np.asarray(ref.pre_conv_out), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_fast_decode_lowmem_matches_whole(small, monkeypatch, hw):
    """The fast tier's hdr_decode (bf16) with LOWMEM_MIN_PIXELS lowered
    below the frame against the same decode with the whole-image top
    level: rgb <= 5e-2, the chain's bf16 budget.  On CPU tensors no
    kernel launches."""
    _, _, dec = small
    z = _t(_np(63, (1, *hw, 4), 2.0))
    launches = (tconv.upconv_gn_conv3x3.launches,
                tconv.upsample_conv3x3.stats_only_launches)
    whole = tpipe.hdr_decode(dec, z, precision=Precision.fast())
    monkeypatch.setattr(fused_tail, "LOWMEM_MIN_PIXELS", 1)
    low = tpipe.hdr_decode(dec, z, precision=Precision.fast())
    assert low.standard.shape == (1, 2 * hw[0], 2 * hw[1], 3)
    assert torch.isfinite(low.image).all()
    assert (low.standard - whole.standard).abs().max().item() <= 5e-2
    assert launches == (tconv.upconv_gn_conv3x3.launches,
                        tconv.upsample_conv3x3.stats_only_launches) == (0, 0)


@pytest.mark.parametrize("offset,streams", [(0, True), (1, False)])
def test_upstack_chooses_by_output_pixels(small, monkeypatch, offset,
                                          streams):
    """lowmem=None streams the top level from LOWMEM_MIN_PIXELS output
    pixels on (as JAX's upstack_apply); the real constant keeps a 2048^2
    frame whole-image."""
    _, _, dec = small
    x = _t(_np(64, (1, 4, 6, dec.cfg.block_in)))
    m = fused_tail._entry_moments(x, dec.cfg.num_groups)
    f = 2 ** (dec.cfg.num_levels - 1)
    calls = []
    real = fused_tail.upconv_gn_conv3x3
    monkeypatch.setattr(fused_tail, "upconv_gn_conv3x3",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(fused_tail, "LOWMEM_MIN_PIXELS",
                        4 * f * 6 * f + offset)
    fused_tail.upstack_apply(dec, x, m, precision=F32_FAST)
    assert bool(calls) == streams
    monkeypatch.undo()
    assert fused_tail.LOWMEM_MIN_PIXELS > 2048 * 2048


def test_lowmem_needs_a_nin_shortcut():
    """Without a nin_shortcut on level 0's block 0 (equal widths) there is
    no shortcut to fold: lowmem=True keeps the whole-image top level, as
    JAX's _levels_apply does."""
    cfg = dataclasses.replace(DecoderConfig().with_small(), ch_mult=(1, 1))
    dec = init_decoder(cfg, 3, device="cpu")
    assert not hasattr(dec.up[0].block[0], "nin_shortcut")
    x = _t(_np(65, (1, 6, 6, cfg.block_in)))
    m = fused_tail._entry_moments(x, cfg.num_groups)
    a, ma = fused_tail.upstack_apply(dec, x, m, precision=F32_FAST,
                                     lowmem=False)
    b, mb = fused_tail.upstack_apply(dec, x, m, precision=F32_FAST,
                                     lowmem=True)
    assert torch.equal(a, b) and all(torch.equal(p, q)
                                     for p, q in zip(ma, mb))


def test_fused_conv_out_takes_the_residual_storage():
    """fused_conv3x3(out=residual): y lands in the residual's storage with
    the values of the call that allocates y (each output element reads
    only its own residual element)."""
    x = _t(_np(66, (1, 8, 16, 16)))
    kern, bias = _t(_np(67, (3, 3, 16, 16), 0.2)), _t(_np(68, (16,)))
    gamma, beta = _t(_np(69, (16,), 0.5)), _t(_np(70, (16,), 0.5))
    res = _t(_np(71, (1, 8, 16, 16)))
    kw = dict(gamma=gamma, beta=beta, emit_stats=True, num_groups=4)
    y0, s0 = tconv.fused_conv3x3(x, kern, bias, residual=res.clone(), **kw)
    y1, s1 = tconv.fused_conv3x3(x, kern, bias, residual=res, out=res, **kw)
    assert y1.data_ptr() == res.data_ptr()
    assert torch.equal(y0, y1) and torch.equal(s0[0], s1[0])
