"""The decoder's mid and up stack as a chain of fused kernels: the fast
tier's path, as ``hdrvae/models/pallas_tail.py``.

Every ResNet conv is one :func:`fused_conv3x3` (K1) that applies the
previous GroupNorm's affine + SiLU as its prologue, adds the residual (or
the nin_shortcut projection) in its epilogue and emits the per-group
(sum, sumsq) of its output: the moments the next GroupNorm needs.  Each
upsample + conv is one :func:`upsample_conv3x3` (K2), and the mid
attention is the bf16 flash kernel (K3).  Between kernels only [B, G]
moment arithmetic remains; the chain entry and the attention output are
reduced once by a plain one-pass reduction (``layers.group_moments``).

Above ``LOWMEM_MIN_PIXELS`` output pixels the top level streams its
upsampled map (the largest map of the decode, [B, H, W, 256]) instead of
storing it: K2's stats_only pass, K5 ``upconv_gn_conv3x3`` for level 0's
first conv, and a folded shortcut (:func:`top_level_apply`).

Under slab sharding (``sharding/mesh.py``) the chain runs in two parts:
:func:`chain_head`, the whole image down to the tail levels, on every rank,
then :func:`upstack_slab_apply`, the tail levels on this rank's row slab.
A statistics scope tells the kernels which rows to count: the whole map
(:class:`StatScope`), or a slab's owned rows (:class:`SlabStatScope`: K1
and K2 with ``owned_rows``, the [B, G] sums all-reduced over the ranks).

Numerics are the fast tier's: float32 statistics through the one-pass
E[x^2] - mean^2 over the stored activations, float32 accumulation, storage
in ``precision.storage_dtype``.  Activations are [B, H, W, C] and moments
are per sample, [B, G].  On CPU tensors the kernel wrappers run their
plain versions, so the chain is testable without a card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from hdrvae_torch.core.config import (DecoderConfig, Precision,
                                      fp32_contractions)
from hdrvae_torch.kernels.attention import spatial_attention
from hdrvae_torch.kernels.conv3x3 import (OwnedRows, Sums, fused_conv3x3,
                                          phase_kernels, upconv_gn_conv3x3,
                                          upsample_conv3x3)
from hdrvae_torch.models.decoder import AttnBlock, Decoder, ResnetBlock
from hdrvae_torch.models.layers import (Moments, conv2d, gn_affine,
                                        group_moments)

# Output pixels from which upstack_apply streams the top level: where the
# whole-image fast decode's peak, linear in pixels, passes 90 % of the
# card's memory.  On an NVIDIA H100 80GB HBM3 (700 W power limit; 79.18
# GiB total) the whole-image fast 4096^2 decode peaked at 20.232 GiB,
# 1294.8 B a pixel (tools/profile_decode_torch.py --lowmem), and 0.9 *
# 79.18 GiB / 1294.8 B = 59.1M pixels (~7690^2).  2048^2 (4.2M) stays
# whole-image.
LOWMEM_MIN_PIXELS = 59_000_000


def _entry_moments(x: torch.Tensor, num_groups: int) -> Moments:
    """One-pass GroupNorm moments of a chain input."""
    return group_moments(x.float(), num_groups, two_pass=False)


def _finalize(sums: Sums, n: int) -> Moments:
    ssum, ssq = sums
    mean = ssum / n
    return mean, torch.clamp(ssq / n - torch.square(mean), min=0.0)


class StatScope:
    """Whole-image statistics: the kernels' (sum, sumsq) cover the map, and
    :meth:`finalize` divides by its element count."""

    def __init__(self):
        self.f = 1   # the current layer's resolution multiple of the entry

    def owned_rows(self) -> OwnedRows:
        return None

    def finalize(self, sums: Sums, h: int, w: int, gsz: int) -> Moments:
        return _finalize(sums, h * w * gsz)


class SlabStatScope(StatScope):
    """Whole-image statistics under slab sharding, as JAX's
    ``_SlabStatScope``: every K1 / K2 launch counts only the rows this rank
    owns (``bounds``, [lo, hi) of the slab's rows at the chain entry's
    resolution, scaled by ``f`` to the layer's), :meth:`finalize`
    all-reduces the [B, G] sums over ``mesh`` (a ``sharding.mesh.Mesh``)
    and divides by the whole image's element count (``entry_h``: the
    image's rows at the entry)."""

    def __init__(self, mesh, bounds: Tuple[int, int], entry_h: int):
        super().__init__()
        self.mesh = mesh
        self.bounds = (int(bounds[0]), int(bounds[1]))
        self.entry_h = entry_h

    def owned_rows(self) -> OwnedRows:
        return self.bounds[0] * self.f, self.bounds[1] * self.f

    def finalize(self, sums: Sums, h: int, w: int, gsz: int) -> Moments:
        both = self.mesh.all_reduce(torch.stack(sums))
        return _finalize((both[0], both[1]), self.entry_h * self.f * w * gsz)


def _hwio(conv, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> the kernels' HWIO layout in ``dtype``."""
    return conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()


class JunctionWeights(NamedTuple):
    """K5's weights in the kernel's layout (:func:`junction_weights`)."""
    up_kernel: torch.Tensor   # the upsample conv, HWIO, compute dtype
    phase: torch.Tensor       # phase_kernels(up_kernel): the kernel's
    up_bias: torch.Tensor     # float32
    kernel: torch.Tensor      # block 0's conv1, HWIO, compute dtype
    bias: torch.Tensor        # float32


def junction_weights(up_conv: nn.Conv2d, blk: ResnetBlock,
                     cdt: torch.dtype) -> JunctionWeights:
    """K5's weights of the streamed junction (``up_conv``, then ``blk``'s
    conv1), prepared once per compute dtype and kept on ``blk``.  The kept
    weights hold while the two convs' parameters do: a change in place
    (``load_state_dict``) or a move to another device drops them, and they
    are prepared anew."""
    params = (up_conv.weight, up_conv.bias, blk.conv1.weight, blk.conv1.bias)
    stamp = tuple((str(p.device), p.data_ptr(), p._version) for p in params)
    kept = blk.__dict__.get("_junction_weights")
    if kept is None or kept[0] != stamp:
        kept = blk.__dict__["_junction_weights"] = (stamp, {})
    if cdt not in kept[1]:
        up_kernel = _hwio(up_conv, cdt)
        kept[1][cdt] = JunctionWeights(
            up_kernel, phase_kernels(up_kernel).contiguous(),
            up_conv.bias.to(torch.float32, copy=True), _hwio(blk.conv1, cdt),
            blk.conv1.bias.to(torch.float32, copy=True))
    return kept[1][cdt]


def _folded_shortcut(x: torch.Tensor, up_kernel: torch.Tensor,
                     up_bias: torch.Tensor, nin: nn.Conv2d,
                     precision: Precision) -> torch.Tensor:
    """``nin(conv_up(nearest2x(x)) + up_bias)`` from the low-resolution x
    as one upsample conv: both maps are linear, so the 1x1 projection Wp
    folds into the upsample's weights, ``w_fold = up_kernel @ Wp`` and
    ``b_fold = up_bias @ Wp + b_p``, summed in float32 and then cast."""
    wp = nin.weight[:, :, 0, 0].t().float()          # [Cm, Cout]
    with fp32_contractions(Precision.parity()):
        w_fold = torch.einsum("ijab,bc->ijac", up_kernel.float(), wp)
        b_fold = up_bias.float() @ wp + nin.bias.float()
    return upsample_conv3x3(
        x, w_fold.to(precision.compute_dtype).contiguous(), b_fold,
        out_dtype=precision.storage_dtype)


def _resnet_block(x: torch.Tensor, blk: ResnetBlock, moments: Moments,
                  cfg: DecoderConfig, precision: Precision, *,
                  owned: bool = False, stream_upsample=None,
                  scope: Optional[StatScope] = None
                  ) -> Tuple[torch.Tensor, Moments]:
    """One ResNet block as two fused convs; returns the block output and
    its GroupNorm moments (counted over ``scope``'s rows; the whole map by
    default).

    ``owned``: x is the chain's own map, so an identity residual's storage
    may take the block's output (K1 writes each output element over the
    residual element it has just read).

    ``stream_upsample`` = the level's upsample conv: x is the
    LOW-resolution map feeding it and ``moments`` are the absent upsampled
    map's (K2's stats_only pass).  conv1 runs as K5 (the upsampled map
    lives only as per-tile bands on chip) on weights kept on the block
    (:func:`junction_weights`), and the shortcut
    ``nin_shortcut(conv_up(nearest2x(x)))`` is one folded upsample conv of
    x (K2), whose only reader is conv2's residual add, so conv2 writes its
    output there."""
    g = cfg.num_groups
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    scope = scope or StatScope()
    b, h, w, _ = x.shape
    g1, b1 = gn_affine(moments, blk.norm1)
    if stream_upsample is not None:
        # K5 has no owned-row mode: the streamed top level is whole-image
        assert scope.owned_rows() is None
        jw = junction_weights(stream_upsample, blk, cdt)
        h, w = 2 * h, 2 * w
        h1, s1 = upconv_gn_conv3x3(
            x, jw.up_kernel, jw.up_bias, g1, b1, jw.kernel, jw.bias,
            emit_stats=True, num_groups=g, out_dtype=sdt, store_dtype=sdt,
            phase=jw.phase)
    else:
        h1, s1 = fused_conv3x3(
            x, _hwio(blk.conv1, cdt), blk.conv1.bias.float(), gamma=g1,
            beta=b1, emit_stats=True, num_groups=g, out_dtype=sdt,
            owned_rows=scope.owned_rows())
    c1 = h1.shape[-1]
    g2, b2 = gn_affine(scope.finalize(s1, h, w, c1 // g), blk.norm2)

    bias2 = blk.conv2.bias.float()
    res_kernel = None
    residual = x
    if stream_upsample is not None:
        residual = _folded_shortcut(
            x, stream_upsample.weight.permute(2, 3, 1, 0),
            stream_upsample.bias, blk.nin_shortcut, precision)
        owned = True
    elif hasattr(blk, "nin_shortcut"):
        # the 1x1 projection runs in the second conv's epilogue; its bias
        # folds into the conv bias
        res_kernel = (blk.nin_shortcut.weight[:, :, 0, 0].t()
                      .to(cdt).contiguous())
        bias2 = bias2 + blk.nin_shortcut.bias.float()
    donate = owned and res_kernel is None and residual.dtype == sdt
    y, s2 = fused_conv3x3(
        h1, _hwio(blk.conv2, cdt), bias2, gamma=g2, beta=b2,
        residual=residual, res_kernel=res_kernel, emit_stats=True,
        num_groups=g, out_dtype=sdt, out=residual if donate else None,
        owned_rows=scope.owned_rows())
    c2 = y.shape[-1]
    return y, scope.finalize(s2, h, w, c2 // g)


def _upsample(x: torch.Tensor, conv: nn.Conv2d, cfg: DecoderConfig,
              precision: Precision, scope: StatScope
              ) -> Tuple[torch.Tensor, Moments]:
    """Nearest 2x upsample fused into its conv (K2); statistics at the
    doubled resolution, over ``scope``'s rows there."""
    scope.f *= 2
    x, sums = upsample_conv3x3(
        x, _hwio(conv, precision.compute_dtype), conv.bias.float(),
        emit_stats=True, num_groups=cfg.num_groups,
        out_dtype=precision.storage_dtype, owned_rows=scope.owned_rows())
    _, h, w, c = x.shape
    return x, scope.finalize(sums, h, w, c // cfg.num_groups)


def _levels_apply(dec: Decoder, x: torch.Tensor, moments: Moments,
                  precision: Precision, scope: StatScope, *, hi: int,
                  lo: int = 0, owned: bool = False,
                  last_upsample: bool = True
                  ) -> Tuple[torch.Tensor, Moments]:
    """Up levels ``hi - 1 .. lo``, highest first, each above level 0
    followed by its upsample (K2), level ``lo``'s only with
    ``last_upsample``, as JAX's ``_levels_apply``.  ``owned``: x is the
    chain's own map (an identity residual may take a block's output)."""
    cfg = dec.cfg
    for level in reversed(range(lo, hi)):
        up = dec.up[level]
        for blk in up.block:
            x, moments = _resnet_block(x, blk, moments, cfg, precision,
                                       owned=owned, scope=scope)
            owned = True
        if level > 0 and (level > lo or last_upsample):
            x, moments = _upsample(x, up.upsample.conv, cfg, precision,
                                   scope)
    return x, moments


def upper_levels_apply(dec: Decoder, x: torch.Tensor, moments: Moments, *,
                       precision: Precision = Precision.fast()
                       ) -> Tuple[torch.Tensor, Moments]:
    """Up levels num_levels - 1 .. 1, highest first, and the upsamples
    between them, stopping before level 1's upsample (the top level's
    junction, :func:`top_level_apply`).  x is the mid output; the caller's
    x is never written."""
    return _levels_apply(dec, x, moments, precision, StatScope(),
                         hi=dec.cfg.num_levels, lo=1, last_upsample=False)


def top_level_apply(dec: Decoder, x: torch.Tensor, moments: Moments, *,
                    precision: Precision = Precision.fast(),
                    lowmem: bool = False, owned: bool = False
                    ) -> Tuple[torch.Tensor, Moments]:
    """Level 1's upsample and level 0's blocks: the full-resolution part
    of the chain, on the output of :func:`upper_levels_apply`.

    ``lowmem`` streams the upsampled map instead of storing it, when
    level 0's block 0 has a nin_shortcut (as in Flux.1: 256 -> 128): K2's
    stats_only pass gives its GroupNorm moments, K5 runs block 0's conv1
    from the low-resolution map, and the shortcut is one folded upsample
    conv (``_resnet_block``).  ``owned``: x is the chain's own map."""
    cfg = dec.cfg
    stream = None
    if cfg.num_levels > 1:
        conv = dec.up[1].upsample.conv
        if lowmem and hasattr(dec.up[0].block[0], "nin_shortcut"):
            _, h, w, _ = x.shape
            sums = upsample_conv3x3(
                x, _hwio(conv, precision.compute_dtype), conv.bias.float(),
                emit_stats=True, num_groups=cfg.num_groups,
                out_dtype=precision.storage_dtype, stats_only=True)
            moments = _finalize(
                sums, 4 * h * w * (conv.out_channels // cfg.num_groups))
            stream = conv
        else:
            x, moments = _upsample(x, conv, cfg, precision, StatScope())
            owned = True
    for j, blk in enumerate(dec.up[0].block):
        x, moments = _resnet_block(
            x, blk, moments, cfg, precision, owned=owned,
            stream_upsample=stream if j == 0 else None)
        owned = True
    return x, moments


def upstack_apply(dec: Decoder, x: torch.Tensor, moments: Moments, *,
                  precision: Precision = Precision.fast(),
                  lowmem: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, Moments]:
    """Every up level, highest first, on x [B, H, W, block_in] (the mid
    output) with its GroupNorm ``moments``.  Returns the pre-norm_out map
    [B, 8H, 8W, ch] and its moments, for ``norm_out``.

    ``lowmem``: stream the top level's upsampled map
    (:func:`top_level_apply`); None chooses it when the output has at
    least ``LOWMEM_MIN_PIXELS`` pixels."""
    cfg = dec.cfg
    if lowmem is None:
        f = 2 ** (cfg.num_levels - 1)
        lowmem = (x.shape[1] * f) * (x.shape[2] * f) >= LOWMEM_MIN_PIXELS
    x, moments = upper_levels_apply(dec, x, moments, precision=precision)
    return top_level_apply(dec, x, moments, precision=precision,
                           lowmem=lowmem, owned=cfg.num_levels > 1)


def _attn_block(x: torch.Tensor, attn: AttnBlock, moments: Moments,
                cfg: DecoderConfig, precision: Precision) -> torch.Tensor:
    """Mid-block attention with the 1x1 q/k/v/proj convolutions as plain
    matmuls (float32 products of compute-dtype operands) and the flash
    kernel between them; the pre-attention GroupNorm (no SiLU) is applied
    from the emitted moments."""
    b, h, w, c = x.shape
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    gamma, beta = gn_affine(moments, attn.norm)
    hn = (x.float() * gamma[:, None, None, :]
          + beta[:, None, None, :]).to(sdt)
    flat = hn.reshape(b, h * w, c).to(cdt).float()

    def proj(conv, inp):
        wt = conv.weight[:, :, 0, 0].t().to(cdt).float()
        return inp @ wt + conv.bias.float()

    q = proj(attn.q, flat).to(sdt).reshape(b, h, w, c)
    k = proj(attn.k, flat).to(sdt).reshape(b, h, w, c)
    v = proj(attn.v, flat).to(sdt).reshape(b, h, w, c)
    a = spatial_attention(q, k, v, precision=precision)
    af = a.reshape(b, h * w, c).to(cdt).float()
    o = proj(attn.proj_out, af)
    return (x.float() + o.reshape(b, h, w, c)).to(sdt)


def midstack_apply(dec: Decoder, x: torch.Tensor, *,
                   precision: Precision = Precision.fast()
                   ) -> Tuple[torch.Tensor, Moments]:
    """The mid section (block_1, attn_1, block_2) on the conv_in output;
    returns the mid output and its GroupNorm moments."""
    cfg = dec.cfg
    moments = _entry_moments(x, cfg.num_groups)
    x, moments = _resnet_block(x, dec.mid.block_1, moments, cfg, precision)
    if cfg.attn_mid:
        x = _attn_block(x, dec.mid.attn_1, moments, cfg, precision)
        moments = _entry_moments(x, cfg.num_groups)
    return _resnet_block(x, dec.mid.block_2, moments, cfg, precision,
                         owned=True)


def _conv_in(dec: Decoder, z: torch.Tensor,
             precision: Precision) -> torch.Tensor:
    """The latent prescale and conv_in, on the layers' conv."""
    cfg = dec.cfg
    return conv2d(z / cfg.scale_factor + cfg.shift_factor, dec.conv_in,
                  precision=precision)


@torch.no_grad()
def chain_head(dec: Decoder, z: torch.Tensor, *, tail_levels: int,
               precision: Precision = Precision.fast()
               ) -> Tuple[torch.Tensor, Moments]:
    """The slab decode's whole-image head as the chain, as JAX's
    ``pallas_head``: conv_in, the mid, and the up levels above
    ``tail_levels`` (1 or more) with their upsamples.  Returns the head
    output [B, H, W, C] (the tail's entry) and its whole-image moments."""
    x = _conv_in(dec, z, precision)
    x, moments = midstack_apply(dec, x, precision=precision)
    return _levels_apply(dec, x, moments, precision, StatScope(),
                         hi=dec.cfg.num_levels, lo=tail_levels, owned=True)


@torch.no_grad()
def upstack_slab_apply(dec: Decoder, x: torch.Tensor, moments: Moments,
                       scope: SlabStatScope, *, tail_levels: int,
                       precision: Precision = Precision.fast()
                       ) -> Tuple[torch.Tensor, Moments]:
    """Up levels ``tail_levels - 1 .. 0`` on one row slab x of a
    :func:`chain_head` output, with whole-image statistics from ``scope``
    (K1 / K2 with ``owned_rows``, the sums all-reduced), as JAX's
    ``upstack_slab_apply``.  ``moments`` are the head output's whole-image
    moments.  Returns the slab's pre-norm_out map and the whole image's
    moments of it, for ``norm_out``.  The top level is never streamed (K5
    has no owned-row mode); x is never written."""
    return _levels_apply(dec, x, moments, precision, scope, hi=tail_levels)


@torch.no_grad()
def forward(dec: Decoder, z: torch.Tensor, *,
            precision: Precision = Precision.fast()
            ) -> Tuple[torch.Tensor, Moments]:
    """Latent [B, h, w, zc] -> (pre-norm_out map [B, H, W, ch], its
    GroupNorm moments): the latent prescale and conv_in on the layers'
    conv, then the mid and every up level as the fused chain (the top
    level streamed from ``LOWMEM_MIN_PIXELS`` output pixels)."""
    x = _conv_in(dec, z, precision)
    x, moments = midstack_apply(dec, x, precision=precision)
    return upstack_apply(dec, x, moments, precision=precision)
