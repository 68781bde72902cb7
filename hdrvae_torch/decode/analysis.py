"""conv_out transformation analysis on device tensors, as
``hdrvae/decode/analysis.py``."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from hdrvae_torch.core.stats import tensor_stats
from hdrvae_torch.decode.modes import NORM_CUSTOM, NORM_SIGMOID, NORM_TANH

NORM_NAMES = {NORM_SIGMOID: "SIGMOID", NORM_TANH: "TANH",
              NORM_CUSTOM: "CUSTOM"}


class ConvOutAnalysis(NamedTuple):
    pre_stats: Dict[str, torch.Tensor]    # raw pre-conv_out min/max/mean/std
    post_stats: Dict[str, torch.Tensor]   # final image stats
    norm_kind: torch.Tensor               # 0-d int32: SIGMOID/TANH/CUSTOM


def classify_normalization(post_stats: Dict[str, torch.Tensor],
                           tol: float = 1e-3) -> torch.Tensor:
    """Post range ~[0, 1] -> SIGMOID; ~[-1, 1] -> TANH; else CUSTOM."""
    def near(x, t):
        return torch.abs(x - t) < tol

    is_sigmoid = near(post_stats["max"], 1.0) & near(post_stats["min"], 0.0)
    is_tanh = near(post_stats["max"], 1.0) & near(post_stats["min"], -1.0)
    kind = torch.where(is_sigmoid, NORM_SIGMOID,
                       torch.where(is_tanh, NORM_TANH, NORM_CUSTOM))
    return kind.to(torch.int32)


def analyze_conv_out(rgb: torch.Tensor,
                     pre_conv_out: torch.Tensor) -> ConvOutAnalysis:
    """The conv_out transformation from one forward's outputs: the pre
    map's and the image's statistics and the normalization they show, all
    device tensors (``core.stats.stats_to_host`` fetches them)."""
    pre_stats = tensor_stats(pre_conv_out)
    post_stats = tensor_stats(rgb)
    return ConvOutAnalysis(pre_stats=pre_stats, post_stats=post_stats,
                           norm_kind=classify_normalization(post_stats))
