"""The epilogue's pass over the pre-conv_out map, as
``hdrvae/kernels/epilogue.py``'s default path: the MAX-pool collapse plus
the raw statistics, as plain tensor reductions.  The fused single-pass
kernel of the JAX package (``collapse_and_stats_pallas``) is not ported
yet."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hdrvae_torch.core.stats import tensor_stats
from hdrvae_torch.decode.formatting import collapse_channels_maxpool


def collapse_and_stats(pre: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """pre [B, H, W, C] -> (collapsed [B, H, W, 3], min/max/mean/std of
    pre with ddof=1)."""
    return collapse_channels_maxpool(pre), tensor_stats(pre)
