"""The epilogue's pass over the pre-conv_out map, as
``hdrvae/kernels/epilogue.py``: the MAX-pool collapse plus the raw
statistics, either as plain tensor reductions (the default) or as one
fused streamed pass (K4, ``csrc/epilogue.cu``), selected by
``HDRDecodeConfig.use_fused_epilogue``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hdrvae_torch.core.stats import tensor_stats
from hdrvae_torch.decode.formatting import (collapse_bounds,
                                            collapse_channels_maxpool)
from hdrvae_torch.kernels import _build

Stats = Dict[str, torch.Tensor]

# the most blocks of epilogue.cu's persistent grid (its float64 partials);
# it launches as many as fit on the card (8 of 256 threads an SM)
_MAX_BLOCKS = 2048


def collapse_and_stats_reference(pre: torch.Tensor
                                 ) -> Tuple[torch.Tensor, Stats]:
    """Plain version of :func:`collapse_and_stats_fused`: the collapse and
    min/max/mean/std (ddof = 1) as separate reductions."""
    return collapse_channels_maxpool(pre), tensor_stats(pre)


def collapse_and_stats_fused(pre: torch.Tensor
                             ) -> Tuple[torch.Tensor, Stats]:
    """pre [B, H, W, C] (C >= 3) -> (collapsed [B, H, W, 3] in pre's dtype,
    min/max/mean/std of pre as 0-d float32 tensors) in one read of the map
    (K4).

    Launches ``csrc/epilogue.cu`` for a CUDA ``pre`` (float32 or bf16, read
    at its stored dtype); runs :func:`collapse_and_stats_reference` for a
    CPU ``pre``.
    """
    if pre.device.type == "cpu":
        return collapse_and_stats_reference(pre)
    if not pre.is_cuda:
        raise ValueError(f"collapse_and_stats_fused: unsupported device "
                         f"{pre.device}")
    if pre.dim() != 4 or pre.shape[-1] < 3:
        raise ValueError(f"pre must be [B, H, W, C] with C >= 3, got "
                         f"{tuple(pre.shape)}")
    if pre.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"collapse_and_stats_fused: the CUDA kernel reads "
                         f"float32 or bf16, got {pre.dtype}")
    pre = pre.contiguous()
    b, h, w, c = pre.shape
    m = b * h * w
    collapsed = torch.empty(b, h, w, 3, device=pre.device, dtype=pre.dtype)
    partial = torch.empty(_MAX_BLOCKS, 5, device=pre.device,
                          dtype=torch.float64)
    out = torch.empty(4, device=pre.device, dtype=torch.float32)
    _build.check(_build.library().hdrvae_collapse_and_stats(
        pre.data_ptr(), collapsed.data_ptr(), partial.data_ptr(),
        out.data_ptr(), m, c, *collapse_bounds(c),
        int(pre.dtype == torch.bfloat16), _MAX_BLOCKS,
        torch.cuda.current_stream(pre.device).cuda_stream),
        "hdrvae_collapse_and_stats")
    collapse_and_stats_fused.launches += 1
    _build.nan_check("collapse_and_stats_fused", collapsed, out)
    return collapsed, {"min": out[0], "max": out[1], "mean": out[2],
                       "std": out[3]}


collapse_and_stats_fused.launches = 0


def collapse_and_stats(pre: torch.Tensor, *, use_fused: bool = False
                       ) -> Tuple[torch.Tensor, Stats]:
    """pre [B, H, W, C] -> (collapsed [B, H, W, 3], min/max/mean/std of
    pre with ddof = 1): the fused pass (K4) with ``use_fused`` and C >= 3,
    else the plain reductions."""
    if use_fused and pre.dim() == 4 and pre.shape[-1] >= 3:
        return collapse_and_stats_fused(pre)
    return collapse_and_stats_reference(pre)
