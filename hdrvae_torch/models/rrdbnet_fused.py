"""RRDBNet's forward as a chain of dense-conv kernels (K6), as
``hdrvae/models/rrdbnet_pallas.py``: the fast tier's path on the card.

Every conv is one :func:`dense_conv3x3`: the dense blocks' concats are
never formed (the kernel walks its inputs as K chunks), and LeakyReLU and
the scaled residual adds run in the conv epilogue.  Each conv's weights are
prepared in the kernel's layout once per compute dtype and device
(:func:`conv_weights`), not on every call, and again only when the
parameters change.  Two steps stay torch
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

from typing import Sequence

import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels.dense_conv import (DenseWeights, dense_conv3x3,
                                             prepare_weights)
from hdrvae_torch.models.layers import nearest_upsample_2x
from hdrvae_torch.models.rrdbnet import (RESIDUAL_SCALE, RRDB, DenseBlock,
                                         RRDBNet, unshuffle_input)


def conv_weights(conv: nn.Conv2d, cdt: torch.dtype,
                 cins: Sequence[int]) -> DenseWeights:
    """K6's weights of one conv for inputs of widths ``cins``, prepared
    once per compute dtype and kept on the module: OIHW -> HWIO in ``cdt``
    -> the kernel's layout, the bias float32.  The kept weights hold while
    the conv's parameters do: a change in place (``load_state_dict``) or a
    move to another device drops them, and they are prepared anew."""
    stamp = tuple((str(p.device), p.data_ptr(), p._version)
                  for p in (conv.weight, conv.bias) if p is not None)
    kept = conv.__dict__.get("_dense_weights")
    if kept is None or kept[0] != stamp:
        kept = conv.__dict__["_dense_weights"] = (stamp, {})
    cache = kept[1]
    key = (cdt, tuple(cins))
    if key not in cache:
        cache[key] = prepare_weights(
            conv.weight.permute(2, 3, 1, 0).to(cdt).contiguous(), conv.bias,
            cins)
    return cache[key]


def _conv(feats, conv: nn.Conv2d, cdt: torch.dtype, **kw) -> torch.Tensor:
    """One K6 launch over ``feats`` with ``conv``'s prepared weights."""
    return dense_conv3x3(feats, conv_weights(conv, cdt,
                                             [f.shape[-1] for f in feats]),
                         **kw)


def _dense_block(x: torch.Tensor, blk: DenseBlock, cdt: torch.dtype,
                 sdt: torch.dtype) -> torch.Tensor:
    """ResidualDenseBlock_5C: five dense convs, concat-free."""
    feats = [x]
    for i in range(1, 5):
        feats.append(_conv(feats, getattr(blk, f"conv{i}"), cdt, act="lrelu",
                           out_dtype=sdt))
    return _conv(feats, blk.conv5, cdt, residual=x,
                 res_scale=RESIDUAL_SCALE, out_dtype=sdt)


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
    fea = _conv([x], net.conv_first, cdt, out_dtype=sdt)
    trunk = fea
    for blk in net.body:
        trunk = _rrdb(trunk, blk, cdt, sdt)
    fea = _conv([trunk], net.conv_body, cdt, residual=fea, res_scale=1.0,
                out_dtype=sdt)
    for i in range(cfg.num_upsamples):
        fea = _conv([nearest_upsample_2x(fea).contiguous()],
                    getattr(net, f"conv_up{i + 1}"), cdt, act="lrelu",
                    out_dtype=sdt)
    fea = _conv([fea], net.conv_hr, cdt, act="lrelu", out_dtype=sdt)
    out = _conv([fea], net.conv_last, cdt, out_dtype=torch.float32)
    if cfg.unshuffle > 1:   # crop the pre-pad region
        out = out[:, :h0 * cfg.scale, :w0 * cfg.scale]
    return out
