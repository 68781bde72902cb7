"""The HDR-preserving MAX-pool channel collapse, as
``hdrvae/decode/formatting.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def collapse_bounds(c: int) -> Tuple[int, int, int]:
    """Ends of the three channel groups of a C >= 3 map (the first starts
    at 0, each next one where the previous ends): 42/84/126 for C = 128,
    thirds of C otherwise."""
    if c == 128:
        return 42, 84, 126
    step = c // 3
    return step, 2 * step, 3 * step


def collapse_channels_maxpool(x: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [..., 3]: channel-wise MAX over three channel groups.

    - C == 3: identity.  C == 1: broadcast.  C == 2: pad with channel 0.
    - C == 128 (Flux): R = max(ch 0:42), G = max(ch 42:84),
      B = max(ch 84:126); channels 126-127 are dropped, as the reference
      drops them.
    - otherwise: groups of C // 3 channels.
    """
    c = x.shape[-1]
    if c == 3:
        return x
    if c == 1:
        return torch.cat([x, x, x], dim=-1)
    if c == 2:
        return torch.cat([x, x[..., :1]], dim=-1)
    bounds = (0, *collapse_bounds(c))
    parts = [x[..., bounds[i]:bounds[i + 1]].amax(dim=-1) for i in range(3)]
    return torch.stack(parts, dim=-1)


def _channels_last(shape) -> bool:
    """Layout guess for a 4D shape where neither the second nor the last
    axis is 3, by layered tie-breaks, as the JAX package's:

      1. exactly one of the two is 128 -> that axis is channels (the Flux
         pre-conv_out width);
      2. an equal spatial pair: [B, C, S, S] -> NCHW, [B, S, S, C] -> NHWC;
      3. otherwise the smaller of the two candidate axes is channels, a tie
         read as NCHW.
    """
    c_first, c_last = shape[1], shape[-1]
    if (c_first == 128) != (c_last == 128):
        return c_last == 128
    if shape[2] == shape[3] and shape[1] != shape[2]:
        return False                      # [B, C, S, S]
    if shape[1] == shape[2] and shape[2] != shape[3]:
        return True                       # [B, S, S, C]
    return c_last < c_first


def to_nhwc_rgb(x: torch.Tensor) -> torch.Tensor:
    """Any decode output, 3D or 4D, NHWC or NCHW, as [B, H, W, 3] float32:
    a last axis of 3 is NHWC, a second axis of 3 NCHW; otherwise the layout
    is :func:`_channels_last`'s guess and wide channel axes are collapsed
    by :func:`collapse_channels_maxpool`."""
    if x.dim() == 3:
        x = x[None]
    if x.dim() != 4:
        raise ValueError(f"expected 3D/4D image tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[-1] == 3:
        out = x
    elif x.shape[1] == 3:
        out = x.permute(0, 2, 3, 1)
    elif x.shape[-1] in (1, 2):
        out = collapse_channels_maxpool(x)
    elif not _channels_last(tuple(x.shape)):
        out = collapse_channels_maxpool(x.permute(0, 2, 3, 1))
    else:
        out = collapse_channels_maxpool(x)
    return out.float()
