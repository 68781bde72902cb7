"""Staged single-card decode of large frames in the mixed tier, as
``hdrvae/decode/staged.py``.

The mixed tier keeps float32 activations, so its whole-image decode of a
large frame holds several full-resolution float32 maps at once: the
upsampled 256-channel map entering level 0 and the GroupNorm temporaries
of level 0's blocks.  Past ``STAGED_MIN_PIXELS`` output pixels that no
longer fits on one 80 GB card.  This executor computes the same function
without materializing any full-resolution float32 map larger than one
128-channel buffer:

  1. HEAD (whole image): conv_in + mid (with the global attention) + the
     up levels above level 2, then level 2's ResNet blocks, all at <= 1/16
     of the output area, where float32 is cheap.
  2. JUNCTION INTO LEVEL 1 (row slabs): level 2's upsample conv and level
     1's block 0 stream from the level-2 output in three passes (the
     upsampled map's statistics, then conv1's, then the full block),
     because each GroupNorm needs whole-image statistics before the next
     conv can run.  Only block 0's output is stored.  Level 1's other
     blocks run as a statistics pass and a full pass into a fresh buffer.
  3. JUNCTION INTO LEVEL 0: the same three passes from the level-1 output;
     level 0's other blocks (128 -> 128, identity residual) then rewrite
     that one full-resolution buffer in place, slab by slab, keeping a
     2-row stash of the rows a slab overwrites that the next one still
     reads.
  4. TAIL: norm_out + SiLU + conv_out, the max-pool collapse and the
     pre-map statistics, streamed per slab into the [H, W, 3] outputs,
     then the HDR epilogue.

Every buffer carries ``_G`` zero guard rows at each end, which are the
SAME padding at the image border; each pass computes exactly the rows it
owns, its 3x3 convs VALID along the rows (the halo rows give the context)
and SAME along the columns.  So each pixel's conv arithmetic is the
whole-image decode's; only the order in which the GroupNorm sums are taken
differs.  Each slab's conv is ``F.conv2d`` in exact float32 (TF32 off).
The JAX package's loops over slabs become Python loops here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hdrvae_torch.core.config import (HDRDecodeConfig, Precision,
                                      fp32_contractions)
from hdrvae_torch.decode.formatting import collapse_channels_maxpool
from hdrvae_torch.decode.pipeline import (HDRDecodeResult, _to_nhwc,
                                          result_from_parts)
from hdrvae_torch.models.decoder import (Decoder, ResnetBlock, decoder_head,
                                         resnet_block)
from hdrvae_torch.models.layers import (Moments, conv2d, gn_affine,
                                        nearest_upsample_2x)

_G = 2   # guard rows at each end of a buffer (>= the largest pass halo)

# Output pixels from which hdr_decode routes a batch-1 mixed decode here:
# where the whole-image mixed decode's peak, linear in pixels, passes 90 %
# of the card's memory.  On an NVIDIA H100 80GB HBM3 (700 W power limit;
# 79.18 GiB total) the whole-image mixed 2048^2 decode peaked at 19.225
# GiB, 4921.6 B a pixel (tools/profile_decode_torch.py --staged; at 4096^2
# it ran out of memory), and 0.9 * 79.18 GiB / 4921.6 B = 15.5M pixels
# (~3940^2).  2048^2 (4.2M) stays whole-image.
STAGED_MIN_PIXELS = 15_500_000

SlabFn = Callable[[torch.Tensor, int], torch.Tensor]


def _plan_rows(h: int, target: int, even: bool = False
               ) -> Tuple[int, int, bool]:
    """(slab_rows, n_slabs, ragged) for a pass over ``h`` rows.

    Prefers an exact divisor near ``target`` (every slab owns whole rows).
    When the nearest divisor is degenerate (< target / 4, e.g. h = 8 x a
    prime), falls back to RAGGED slabs: ``target``-row windows whose last
    start is clamped to ``h - slab_rows``; its overlap rows recompute the
    same values and are left out of the statistics.  ``even`` forces an
    even slab size (the junction passes halve the output start to index
    the low-resolution source)."""
    step = 2 if even else 1
    target = max(step, min((target // step) * step, h - h % step))
    best = None
    for s in range(step, h + 1, step):
        if h % s == 0 and (best is None
                           or abs(s - target) < abs(best - target)):
            best = s
    if best is not None and 4 * best >= target:
        return best, h // best, False
    return target, -(-h // target), True


def _finalize(ssum: torch.Tensor, ssq: torch.Tensor, n: int) -> Moments:
    """(sum, sumsq) [G] -> one-pass moments (mean [G], var [G]); their
    ``gn_affine`` is the [C] (gamma, beta) of the unbatched slabs."""
    mean = ssum / n
    return mean, torch.clamp(ssq / n - torch.square(mean), min=0.0)


def _silu_affine(x: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """silu(x * gamma + beta): the same operations as the whole-image
    ``layers.group_norm_silu``."""
    y = x * gamma + beta
    return y.mul_(torch.sigmoid(y))


def _zero_outside(y: torch.Tensor, start_row: int, height: int
                  ) -> torch.Tensor:
    """Zero the rows of ``y`` (a fresh tensor, changed in place) whose
    global index ``start_row + r`` lies outside [0, height): in the whole
    image those rows do not exist and the next conv sees SAME zeros, where
    a slab window would see silu(beta) or values made from guard rows."""
    top = max(0, -start_row)
    bottom = max(0, height - start_row)
    if top:
        y[:top] = 0
    if bottom < y.shape[0]:
        y[bottom:] = 0
    return y


def _conv_hv(x: torch.Tensor, conv: nn.Conv2d,
             precision: Precision) -> torch.Tensor:
    """3x3 conv of an unbatched [R, W, C] window, VALID along the rows
    (the halo rows give the context) and SAME along the columns: R - 2
    rows out, rounded as ``layers.conv2d`` rounds."""
    cdt = precision.compute_dtype
    w = conv.weight.to(cdt).float()
    xin = x.to(cdt).float().permute(2, 0, 1)[None]
    with fp32_contractions(precision):
        y = F.conv2d(xin, w, padding=(0, 1))
    y = y[0].permute(1, 2, 0) + conv.bias.float()
    return y.to(precision.storage_dtype)


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d,
             precision: Precision) -> torch.Tensor:
    return conv2d(x[None], conv, precision=precision)[0]


def _nearest2x(x: torch.Tensor) -> torch.Tensor:
    return nearest_upsample_2x(x[None])[0]


def _gstats(y: torch.Tensor, groups: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group (sum, sumsq) [G] of an unbatched [R, W, C] map."""
    g = y.float().reshape(-1, groups, y.shape[-1] // groups)
    return g.sum(dim=(0, 2)), torch.square(g).sum(dim=(0, 2))


def _guard(x: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [H + 2 _G, W, C] with zero guard rows."""
    return F.pad(x, (0, 0, 0, 0, _G, _G))


def _slab_start(i: int, s: int, h: int) -> int:
    """Global start row of slab i; only a ragged plan's last slab
    clamps."""
    return min(i * s, h - s)


def _stats_pass(src: torch.Tensor, n_slabs: int, in_s: int, out_s: int,
                halo: int, fn: SlabFn, groups: int, h_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq) of ``fn(window, lo)`` over all slabs, ``lo`` being the
    slab's first output row; rows an earlier slab already produced (a
    ragged plan's overlap) are left out."""
    f = out_s // in_s
    s1 = s2 = 0
    for i in range(n_slabs):
        lo = _slab_start(i, out_s, h_out)
        a = _G + lo // f - halo
        y = fn(src[a:a + in_s + 2 * halo], lo)
        p, q = _gstats(y[max(0, i * out_s - lo):], groups)
        s1, s2 = s1 + p, s2 + q
    return s1, s2


def _map_pass(src: torch.Tensor, dst: torch.Tensor, n_slabs: int,
              in_s: int, out_s: int, halo: int, fn: SlabFn, groups: int,
              h_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``fn(window, lo)`` into the guarded ``dst`` slab by slab and
    return the output's (sum, sumsq).  A ragged last slab rewrites its
    overlap rows with the same values and leaves them out of the sums."""
    f = out_s // in_s
    s1 = s2 = 0
    for i in range(n_slabs):
        lo = _slab_start(i, out_s, h_out)
        a = _G + lo // f - halo
        y = fn(src[a:a + in_s + 2 * halo], lo)
        dst[_G + lo:_G + lo + out_s] = y
        p, q = _gstats(y[max(0, i * out_s - lo):], groups)
        s1, s2 = s1 + p, s2 + q
    return s1, s2


def _inplace_pass(buf: torch.Tensor, n_slabs: int, s: int, fn: SlabFn,
                  groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rewrite the guarded ``buf`` with ``fn`` (same width, halo 2), one
    slab of ``s`` rows at a time, in place: the one full-resolution buffer
    of level 0 is read and overwritten, and no second one exists.  Slab i
    overwrites rows [lo, lo + s) that slab i + 1's window still reads as
    its two top halo rows, so each step first keeps those two old rows
    (the stash, initially the zero guard rows above the image)."""
    w, c = buf.shape[1], buf.shape[2]
    stash = buf.new_zeros((2, w, c))
    s1 = s2 = 0
    for i in range(n_slabs):
        lo = i * s
        win = torch.cat([stash, buf[_G + lo:_G + lo + s + 2]])
        stash = win[s:s + 2]      # old rows [lo + s - 2, lo + s)
        y = fn(win, lo)
        buf[_G + lo:_G + lo + s] = y
        p, q = _gstats(y, groups)
        s1, s2 = s1 + p, s2 + q
    return s1, s2


def _block_conv1_fn(blk: ResnetBlock, g1, b1, precision: Precision,
                    height: int) -> SlabFn:
    """window [s + 2, W, Cin] -> conv1 output rows [s, W, Cmid]."""
    def fn(win, lo):
        a = _zero_outside(_silu_affine(win, g1, b1), lo - 1, height)
        return _conv_hv(a, blk.conv1, precision)
    return fn


def _block_full_fn(blk: ResnetBlock, g1, b1, g2, b2, precision: Precision,
                   height: int) -> SlabFn:
    """window [s + 4, W, Cin] -> block output rows [s, W, Cout]."""
    def fn(win, lo):
        a = _zero_outside(_silu_affine(win, g1, b1), lo - 2, height)
        h = _conv_hv(a, blk.conv1, precision)
        a = _zero_outside(_silu_affine(h, g2, b2), lo - 1, height)
        h = _conv_hv(a, blk.conv2, precision)
        x_own = win[2:-2]
        if hasattr(blk, "nin_shortcut"):
            x_own = _conv1x1(x_own, blk.nin_shortcut, precision)
        return x_own + h
    return fn


def _up_fn(up_conv: nn.Conv2d, precision: Precision) -> SlabFn:
    """low window [s2 + 2, W1, C] -> upsample-conv rows [2 s2, W, C].  The
    upsampled guard rows are true zeros: the SAME padding the whole-image
    upsample conv sees."""
    def fn(win, lo):
        return _conv_hv(_nearest2x(win)[1:-1], up_conv, precision)
    return fn


def _up_conv1_fn(up_conv: nn.Conv2d, b0: ResnetBlock, gu, bu,
                 precision: Precision, height: int) -> SlabFn:
    """low window [s2 + 2, W1, C] -> block 0's conv1 rows [2 s2, ...]."""
    def fn(win, lo):
        u = _conv_hv(_nearest2x(win), up_conv, precision)
        a = _zero_outside(_silu_affine(u, gu, bu), lo - 1, height)
        return _conv_hv(a, b0.conv1, precision)
    return fn


def _up_block_fn(up_conv: nn.Conv2d, b0: ResnetBlock, gu, bu, g2, b2,
                 precision: Precision, height: int) -> SlabFn:
    """low window [s2 + 4, W1, C] -> block 0's output rows [2 s2, ...]."""
    def fn(win, lo):
        u4 = _conv_hv(_nearest2x(win)[1:-1], up_conv, precision)
        a = _zero_outside(_silu_affine(u4, gu, bu), lo - 2, height)
        h = _conv_hv(a, b0.conv1, precision)
        a = _zero_outside(_silu_affine(h, g2, b2), lo - 1, height)
        h = _conv_hv(a, b0.conv2, precision)
        x_own = u4[2:-2]
        if hasattr(b0, "nin_shortcut"):
            x_own = _conv1x1(x_own, b0.nin_shortcut, precision)
        return x_own + h
    return fn


def _staged_sameres_block(cur: torch.Tensor, blk: ResnetBlock,
                          moments: Moments, h: int, w: int, g: int,
                          precision: Precision, slab_rows: int,
                          inplace: bool) -> Tuple[torch.Tensor, Moments]:
    """One ResNet block over a guarded buffer: conv1's statistics pass,
    then a full pass into a fresh buffer or, with ``inplace`` and a block
    that keeps the width, rewriting ``cur`` itself.  A ragged plan takes
    the fresh buffer: the stash needs contiguous slab starts."""
    s, n, ragged = _plan_rows(h, slab_rows)
    g1, b1 = gn_affine(moments, blk.norm1)
    fn_s = _block_conv1_fn(blk, g1, b1, precision, h)
    ssum, ssq = _stats_pass(cur, n, s, s, 1, fn_s, g, h)
    c1 = blk.conv1.out_channels
    g2, b2 = gn_affine(_finalize(ssum, ssq, h * w * (c1 // g)), blk.norm2)
    fn_f = _block_full_fn(blk, g1, b1, g2, b2, precision, h)
    cout = blk.conv2.out_channels
    if inplace and not ragged:
        if cout != cur.shape[-1]:
            raise ValueError("in-place blocks must keep the channel width")
        ssum, ssq = _inplace_pass(cur, n, s, fn_f, g)
    else:
        dst = cur.new_zeros((h + 2 * _G, w, cout))
        ssum, ssq = _map_pass(cur, dst, n, s, s, 2, fn_f, g, h)
        cur = dst
    return cur, _finalize(ssum, ssq, h * w * (cout // g))


def _staged_junction(cur: torch.Tensor, up_conv: nn.Conv2d, b0: ResnetBlock,
                     h_in: int, w_in: int, g: int, precision: Precision,
                     slab_rows: int) -> Tuple[torch.Tensor, Moments]:
    """A level's 2x upsample conv and the next level's block 0, streamed
    from the low-resolution guarded buffer in three passes (upsample
    statistics, conv1 statistics, full): the upsampled map is never
    stored.  Returns the guarded block-0 output at 2x and its moments."""
    hh, ww = 2 * h_in, 2 * w_in
    s0, n0, _ = _plan_rows(hh, 2 * max(1, slab_rows // 2), even=True)
    s2l = s0 // 2
    c_up = up_conv.out_channels

    ssum, ssq = _stats_pass(cur, n0, s2l, s0, 1, _up_fn(up_conv, precision),
                            g, hh)
    gu, bu = gn_affine(_finalize(ssum, ssq, hh * ww * (c_up // g)), b0.norm1)

    ssum, ssq = _stats_pass(cur, n0, s2l, s0, 1,
                            _up_conv1_fn(up_conv, b0, gu, bu, precision, hh),
                            g, hh)
    c1 = b0.conv1.out_channels
    g2, b2 = gn_affine(_finalize(ssum, ssq, hh * ww * (c1 // g)), b0.norm2)

    cout = b0.conv2.out_channels
    buf = cur.new_zeros((hh + 2 * _G, ww, cout))
    ssum, ssq = _map_pass(
        cur, buf, n0, s2l, s0, 2,
        _up_block_fn(up_conv, b0, gu, bu, g2, b2, precision, hh), g, hh)
    return buf, _finalize(ssum, ssq, hh * ww * (cout // g))


@torch.no_grad()
def staged_front(decoder: Decoder, latent: torch.Tensor,
                 precision: Precision, slab_rows: int = 128
                 ) -> Tuple[torch.Tensor, Moments]:
    """Steps 1-3 up to level 0's block 0: the head, level 1, and the
    junction into level 0.  Returns the guarded level-0 block-0 output
    [H + 2 _G, W, C] and its moments."""
    cfg = decoder.cfg
    g, levels = cfg.num_groups, cfg.num_levels
    # the head stops before level 2's upsample: that junction streams
    u = decoder_head(decoder, latent, precision=precision,
                     tail_levels=min(3, levels))
    if levels >= 3:
        for blk in decoder.up[2].block:
            u = resnet_block(u, blk, num_groups=g, precision=precision)
    u = u[0]

    lvl1 = decoder.up[1]
    if levels >= 3:
        h2, w2 = u.shape[0], u.shape[1]
        cur, moments = _staged_junction(_guard(u), decoder.up[2].upsample.conv,
                                        lvl1.block[0], h2, w2, g, precision,
                                        slab_rows)
        del u
        h1, w1 = 2 * h2, 2 * w2
        rest1 = list(lvl1.block)[1:]
    else:
        h1, w1 = u.shape[0], u.shape[1]
        ssum, ssq = _gstats(u, g)
        moments = _finalize(ssum, ssq, h1 * w1 * (u.shape[-1] // g))
        cur = _guard(u)
        del u
        rest1 = list(lvl1.block)
    for blk in rest1:
        cur, moments = _staged_sameres_block(cur, blk, moments, h1, w1, g,
                                             precision, slab_rows,
                                             inplace=False)
    return _staged_junction(cur, lvl1.upsample.conv, decoder.up[0].block[0],
                            h1, w1, g, precision, slab_rows)


@torch.no_grad()
def staged_level0(decoder: Decoder, buf: torch.Tensor, moments: Moments,
                  precision: Precision, slab_rows: int = 128
                  ) -> Tuple[torch.Tensor, Moments]:
    """Level 0's blocks after block 0, each a statistics pass and a pass
    that rewrites ``buf`` in place (a fresh buffer for a ragged height)."""
    cfg = decoder.cfg
    h, w = buf.shape[0] - 2 * _G, buf.shape[1]
    for blk in list(decoder.up[0].block)[1:]:
        buf, moments = _staged_sameres_block(buf, blk, moments, h, w,
                                             cfg.num_groups, precision,
                                             slab_rows, inplace=True)
    return buf, moments


@torch.no_grad()
def staged_tail(decoder: Decoder, buf: torch.Tensor, moments: Moments,
                latent: torch.Tensor, cfg: HDRDecodeConfig,
                precision: Precision, slab_rows: int = 128
                ) -> HDRDecodeResult:
    """Step 4: norm_out + SiLU + conv_out, the max-pool collapse and the
    pre-map statistics (min, max, mean, std with ddof = 1) per slab, then
    the HDR epilogue on the [1, H, W, 3] outputs."""
    dcfg = decoder.cfg
    hh, ww, c = buf.shape[0] - 2 * _G, buf.shape[1], buf.shape[2]
    s0, n0, _ = _plan_rows(hh, slab_rows)
    go, bo = gn_affine(moments, decoder.norm_out)
    want_first3 = cfg.fallback_collapse == "first3"
    rgb = buf.new_zeros((hh, ww, 3))
    pre_c = buf.new_zeros((hh, ww, 3))
    pre3 = buf.new_zeros((hh, ww, 3)) if want_first3 else None
    # the scalar sums in float64: one sum over up to ~10^10 values
    s1 = s2 = torch.zeros((), dtype=torch.float64, device=buf.device)
    mn = torch.full((), float("inf"), device=buf.device)
    mx = torch.full((), float("-inf"), device=buf.device)
    for i in range(n0):
        lo = _slab_start(i, s0, hh)
        win = buf[_G + lo - 1:_G + lo + s0 + 1]
        pre_win = _zero_outside(_silu_affine(win, go, bo), lo - 1, hh)
        y = _conv_hv(pre_win, decoder.conv_out, precision)
        y = y * dcfg.output_scale + dcfg.output_shift
        if dcfg.output_clamp:
            y = torch.clamp(y, 0.0, 1.0)
        rgb[lo:lo + s0] = y
        pre_own = pre_win[1:-1]
        pre_c[lo:lo + s0] = collapse_channels_maxpool(pre_own)
        if want_first3:
            pre3[lo:lo + s0] = pre_own[..., :3]
        # a ragged last slab rewrites rows above with the same values but
        # must not count them twice in the sums (min and max are idempotent)
        fresh = pre_own[max(0, i * s0 - lo):]
        s1 = s1 + fresh.sum(dtype=torch.float64)
        s2 = s2 + torch.square(fresh).sum(dtype=torch.float64)
        mn = torch.minimum(mn, pre_own.min())
        mx = torch.maximum(mx, pre_own.max())
    n_pre = float(hh) * ww * c
    mean = s1 / n_pre
    var = torch.clamp(s2 / n_pre - torch.square(mean), min=0.0)
    var = var * n_pre / max(n_pre - 1.0, 1.0)        # ddof = 1
    pre_stats = {"min": mn, "max": mx, "mean": mean.float(),
                 "std": torch.sqrt(var).float()}

    # full_analysis records the weights' part only: the pre map is never
    # whole in memory to run conv_out over it alone
    return result_from_parts(decoder, rgb[None], pre_c[None], pre_stats,
                             latent, cfg, pre3[None] if want_first3 else None)


@torch.no_grad()
def staged_hdr_decode(decoder: Decoder, latent: torch.Tensor,
                      cfg: HDRDecodeConfig = HDRDecodeConfig(),
                      precision: Precision = Precision.mixed(), *,
                      slab_rows: int = 128) -> HDRDecodeResult:
    """Mixed-tier decode of a latent whose whole-image float32
    activations exceed the card (module docstring); the result contract of
    :func:`hdrvae_torch.decode.pipeline.hdr_decode`.

    Requirements: batch 1, ``precision.mode == "mixed"`` (parity's two-pass
    variance does not decompose into one streamed accumulation; the fast
    tier streams its top level in ``models/fused_tail.py`` instead) with
    ``fast_head_levels == 0``, and ``num_levels >= 2``.
    """
    if precision.mode != "mixed":
        raise ValueError(
            f"staged decode serves the mixed (contract) tier; got mode="
            f"{precision.mode!r}.  Fast mode uses the streaming top level "
            "instead (models/fused_tail.py lowmem).")
    if precision.fast_head_levels != 0:
        raise ValueError("staged decode runs the whole decoder in the "
                         "mixed tier (fast_head_levels must be 0)")
    latent = _to_nhwc(latent, decoder.cfg.z_channels)
    if latent.shape[0] != 1:
        raise ValueError("staged decode is batch-1 (a 4K-class frame is "
                         "already an HBM-scale workload)")
    if decoder.cfg.num_levels < 2:
        raise ValueError("staged decode needs num_levels >= 2")
    buf, moments = staged_front(decoder, latent, precision, slab_rows)
    buf, moments = staged_level0(decoder, buf, moments, precision, slab_rows)
    return staged_tail(decoder, buf, moments, latent, cfg, precision,
                       slab_rows)
