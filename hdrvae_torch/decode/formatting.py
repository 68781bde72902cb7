"""The HDR-preserving MAX-pool channel collapse, as
``hdrvae/decode/formatting.py``."""

from __future__ import annotations

import torch


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
    if c == 128:
        bounds = (0, 42, 84, 126)
    else:
        step = c // 3
        bounds = (0, step, 2 * step, 3 * step)
    parts = [x[..., bounds[i]:bounds[i + 1]].amax(dim=-1) for i in range(3)]
    return torch.stack(parts, dim=-1)
