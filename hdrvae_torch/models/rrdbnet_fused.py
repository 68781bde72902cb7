"""RRDBNet's forward as a chain of dense-conv kernels (K6), as
``hdrvae/models/rrdbnet_pallas.py``: the fast tier's path on the card.

Every conv is one :func:`dense_conv3x3`: the dense blocks' concats are
never formed (the kernel walks its inputs as K steps), and LeakyReLU and
the scaled residual adds run in the conv epilogue.  Two steps stay torch
ops outside the kernel, as in the JAX package: the RRDB-level
``x + 0.2 * h`` and the nearest-2x upsamples before ``conv_up*``.

The chain takes any width, depth and unshuffle: the kernel masks ragged
shapes and takes any channel count (the JAX chain's W % 8 and unshuffle 1
gate is a TPU layout limit, not carried over).  Numerics: float32
accumulation, the epilogue in float32 before the storage cast, activations
stored in ``precision.storage_dtype``; ``conv_last`` stores float32.  On
CPU tensors the kernel wrapper runs its plain version, so the chain is
testable without a card.
"""

from __future__ import annotations

import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels.dense_conv import dense_conv3x3
from hdrvae_torch.models.layers import nearest_upsample_2x
from hdrvae_torch.models.rrdbnet import (RESIDUAL_SCALE, RRDB, DenseBlock,
                                         RRDBNet, unshuffle_input)


def _w(conv: nn.Conv2d, cdt: torch.dtype):
    """OIHW weight -> HWIO in the compute dtype, and the float32 bias."""
    return (conv.weight.permute(2, 3, 1, 0).to(cdt).contiguous(),
            conv.bias.float())


def _dense_block(x: torch.Tensor, blk: DenseBlock, cdt: torch.dtype,
                 sdt: torch.dtype) -> torch.Tensor:
    """ResidualDenseBlock_5C: five dense convs, concat-free."""
    feats = [x]
    for i in range(1, 5):
        k, b = _w(getattr(blk, f"conv{i}"), cdt)
        feats.append(dense_conv3x3(feats, k, b, act="lrelu", out_dtype=sdt))
    k, b = _w(blk.conv5, cdt)
    return dense_conv3x3(feats, k, b, residual=x, res_scale=RESIDUAL_SCALE,
                         out_dtype=sdt)


def _rrdb(x: torch.Tensor, blk: RRDB, cdt: torch.dtype,
          sdt: torch.dtype) -> torch.Tensor:
    h = _dense_block(x, blk.rdb1, cdt, sdt)
    h = _dense_block(h, blk.rdb2, cdt, sdt)
    h = _dense_block(h, blk.rdb3, cdt, sdt)
    return (x.float() + RESIDUAL_SCALE * h.float()).to(sdt)


@torch.no_grad()
def rrdbnet_fused_apply(net: RRDBNet, x: torch.Tensor, *,
                        precision: Precision = Precision.fast()
                        ) -> torch.Tensor:
    """[B, H, W, C] -> [B, scale*H, scale*W, C] float32 through the K6
    chain."""
    cfg = net.cfg
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    h0, w0 = x.shape[1], x.shape[2]
    if cfg.unshuffle > 1:
        x = unshuffle_input(x, cfg.unshuffle)
    x = x.to(cdt).contiguous()
    k, b = _w(net.conv_first, cdt)
    fea = dense_conv3x3([x], k, b, out_dtype=sdt)
    trunk = fea
    for blk in net.body:
        trunk = _rrdb(trunk, blk, cdt, sdt)
    k, b = _w(net.conv_body, cdt)
    fea = dense_conv3x3([trunk], k, b, residual=fea, res_scale=1.0,
                        out_dtype=sdt)
    for i in range(cfg.num_upsamples):
        k, b = _w(getattr(net, f"conv_up{i + 1}"), cdt)
        fea = dense_conv3x3([nearest_upsample_2x(fea).contiguous()], k, b,
                            act="lrelu", out_dtype=sdt)
    k, b = _w(net.conv_hr, cdt)
    fea = dense_conv3x3([fea], k, b, act="lrelu", out_dtype=sdt)
    k, b = _w(net.conv_last, cdt)
    out = dense_conv3x3([fea], k, b, out_dtype=torch.float32)
    if cfg.unshuffle > 1:   # crop the pre-pad region
        out = out[:, :h0 * cfg.scale, :w0 * cfg.scale]
    return out
