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

Numerics are the fast tier's: float32 statistics through the one-pass
E[x^2] - mean^2 over the stored activations, float32 accumulation, storage
in ``precision.storage_dtype``.  Activations are [B, H, W, C] and moments
are per sample, [B, G].  On CPU tensors the kernel wrappers run their
plain versions, so the chain is testable without a card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.kernels.attention import spatial_attention
from hdrvae_torch.kernels.conv3x3 import (Sums, fused_conv3x3,
                                          upsample_conv3x3)
from hdrvae_torch.models.decoder import AttnBlock, Decoder, ResnetBlock
from hdrvae_torch.models.layers import (Moments, conv2d, gn_affine,
                                        group_moments)


def _entry_moments(x: torch.Tensor, num_groups: int) -> Moments:
    """One-pass GroupNorm moments of a chain input."""
    return group_moments(x.float(), num_groups, two_pass=False)


def _finalize(sums: Sums, n: int) -> Moments:
    ssum, ssq = sums
    mean = ssum / n
    return mean, torch.clamp(ssq / n - torch.square(mean), min=0.0)


def _hwio(conv, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> the kernels' HWIO layout in ``dtype``."""
    return conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()


def _resnet_block(x: torch.Tensor, blk: ResnetBlock, moments: Moments,
                  cfg: DecoderConfig, precision: Precision
                  ) -> Tuple[torch.Tensor, Moments]:
    """One ResNet block as two fused convs; returns the block output and
    its GroupNorm moments."""
    g = cfg.num_groups
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    b, h, w, _ = x.shape
    g1, b1 = gn_affine(moments, blk.norm1)
    h1, s1 = fused_conv3x3(
        x, _hwio(blk.conv1, cdt), blk.conv1.bias.float(), gamma=g1,
        beta=b1, emit_stats=True, num_groups=g, out_dtype=sdt)
    c1 = h1.shape[-1]
    g2, b2 = gn_affine(_finalize(s1, h * w * (c1 // g)), blk.norm2)

    bias2 = blk.conv2.bias.float()
    res_kernel = None
    if hasattr(blk, "nin_shortcut"):
        # the 1x1 projection runs in the second conv's epilogue; its bias
        # folds into the conv bias
        res_kernel = (blk.nin_shortcut.weight[:, :, 0, 0].t()
                      .to(cdt).contiguous())
        bias2 = bias2 + blk.nin_shortcut.bias.float()
    y, s2 = fused_conv3x3(
        h1, _hwio(blk.conv2, cdt), bias2, gamma=g2, beta=b2, residual=x,
        res_kernel=res_kernel, emit_stats=True, num_groups=g,
        out_dtype=sdt)
    c2 = y.shape[-1]
    return y, _finalize(s2, h * w * (c2 // g))


def upstack_apply(dec: Decoder, x: torch.Tensor, moments: Moments, *,
                  precision: Precision = Precision.fast()
                  ) -> Tuple[torch.Tensor, Moments]:
    """Every up level, highest first, on x [B, H, W, block_in] (the mid
    output) with its GroupNorm ``moments``.  Returns the pre-norm_out map
    [B, 8H, 8W, ch] and its moments, for ``norm_out``."""
    cfg = dec.cfg
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    for level in reversed(range(cfg.num_levels)):
        up = dec.up[level]
        for blk in up.block:
            x, moments = _resnet_block(x, blk, moments, cfg, precision)
        if level != 0:
            # nearest 2x upsample fused into the conv; statistics at the
            # doubled resolution
            conv = up.upsample.conv
            x, sums = upsample_conv3x3(
                x, _hwio(conv, cdt), conv.bias.float(), emit_stats=True,
                num_groups=cfg.num_groups, out_dtype=sdt)
            _, h, w, c = x.shape
            moments = _finalize(sums, h * w * (c // cfg.num_groups))
    return x, moments


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
    return _resnet_block(x, dec.mid.block_2, moments, cfg, precision)


@torch.no_grad()
def forward(dec: Decoder, z: torch.Tensor, *,
            precision: Precision = Precision.fast()
            ) -> Tuple[torch.Tensor, Moments]:
    """Latent [B, h, w, zc] -> (pre-norm_out map [B, H, W, ch], its
    GroupNorm moments): the latent prescale and conv_in on the layers'
    conv, then the mid and every up level as the fused chain."""
    cfg = dec.cfg
    x = conv2d(z / cfg.scale_factor + cfg.shift_factor, dec.conv_in,
               precision=precision)
    x, moments = midstack_apply(dec, x, precision=precision)
    return upstack_apply(dec, x, moments, precision=precision)
