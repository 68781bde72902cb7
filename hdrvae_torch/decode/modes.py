"""The four HDR expansion modes as tensor functions with no host branch
on data, as ``hdrvae/decode/modes.py``: data-dependent gates are
``torch.where`` selects on 0-d tensors, so a decode needs no device sync
before its one summary fetch."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from hdrvae_torch.core.config import HDRDecodeConfig

NORM_SIGMOID = 0
NORM_TANH = 1
NORM_CUSTOM = 2


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """logit with an eps saturation clamp, as log(c / (1 - c))."""
    clamped = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(clamped / (1.0 - clamped))


def inverse_tanh(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """atanh with an eps saturation clamp."""
    return torch.atanh(torch.clamp(x, -1.0 + eps, 1.0 - eps))


def select_inverse(x: torch.Tensor, norm_kind: torch.Tensor,
                   cfg: HDRDecodeConfig = HDRDecodeConfig()) -> torch.Tensor:
    """The inverse activation selected by ``norm_kind`` (a 0-d tensor);
    CUSTOM passes the input through."""
    inv_sig = inverse_sigmoid(x, cfg.sigmoid_eps)
    inv_tanh = inverse_tanh(x, cfg.tanh_eps)
    return torch.where(norm_kind == NORM_SIGMOID, inv_sig,
                       torch.where(norm_kind == NORM_TANH, inv_tanh, x))


class RecoveryMaps(NamedTuple):
    has_hdr_data: torch.Tensor          # 0-d bool: collapsed pre max > 1+tol
    map_recovered: torch.Tensor         # [B,H,W,3] rescaled inverse map
    map_recovered_aligned: torch.Tensor  # [B,H,W,3] midtone-aligned EV map


def build_recovery_maps(standard_result: torch.Tensor,
                        pre_collapsed: torch.Tensor,
                        pre_stats: Dict[str, torch.Tensor],
                        norm_kind: torch.Tensor,
                        cfg: HDRDecodeConfig = HDRDecodeConfig()
                        ) -> RecoveryMaps:
    """The shared pre-computation of the exposure/adaptive/mathematical
    modes: with HDR data in the collapsed pre map, the inverse-activated
    standard result min-max normalized, rescaled into the raw pre range and
    midtone-aligned; without, the collapsed map and a neutral 1.0."""
    has_hdr = pre_collapsed.max() > (1.0 + cfg.hdr_tol)
    recovered = select_inverse(standard_result, norm_kind, cfg)
    rec_min, rec_max = recovered.min(), recovered.max()
    rec_norm = (recovered - rec_min) / (rec_max - rec_min)
    original_range = pre_stats["max"] - pre_stats["min"]
    rescaled = rec_norm * original_range + pre_stats["min"]
    aligned = rescaled - pre_stats["mean"] + 1.0
    map_recovered = torch.where(has_hdr, rescaled, pre_collapsed)
    map_aligned = torch.where(has_hdr, aligned,
                              torch.ones_like(pre_collapsed))
    return RecoveryMaps(has_hdr, map_recovered, map_aligned)


def conservative(ldr_linear: torch.Tensor, pre_collapsed: torch.Tensor,
                 expansion_factor: float) -> torch.Tensor:
    """Expand only where the pre-conv_out features exceed 1.0:
    ``base + (pre - 1) * factor * base`` on the highlight mask."""
    expansion = (pre_collapsed - 1.0) * expansion_factor * ldr_linear
    return torch.where(pre_collapsed > 1.0, ldr_linear + expansion,
                       ldr_linear)


def exposure(ldr_linear: torch.Tensor, map_recovered: torch.Tensor,
             cfg: HDRDecodeConfig = HDRDecodeConfig()) -> torch.Tensor:
    """EV map from the recovered features as a multiplier:
    ``2 ** log2(clamp(map, floor))`` == ``clamp(map, floor)``."""
    return ldr_linear * torch.clamp(map_recovered, min=cfg.ev_floor)


def adaptive_recovery(ldr_linear: torch.Tensor,
                      map_recovered_aligned: torch.Tensor,
                      pre_stats: Dict[str, torch.Tensor],
                      cfg: HDRDecodeConfig = HDRDecodeConfig()
                      ) -> torch.Tensor:
    """Highlight-compressed recovery: aligned values above 1.0 are
    compressed by ``(pre_max - 1) / (aligned_max - 1)`` when the aligned map
    overshoots the raw max."""
    aligned_max = map_recovered_aligned.max()
    needs_compression = (aligned_max > 1.0) & (aligned_max > pre_stats["max"])
    factor = torch.where(needs_compression,
                         (pre_stats["max"] - 1.0) / (aligned_max - 1.0),
                         torch.ones_like(aligned_max))
    highlight_mask = (map_recovered_aligned > 1.0).to(ldr_linear.dtype)
    compressed = (map_recovered_aligned - 1.0) * factor + 1.0
    map_compressed = (map_recovered_aligned * (1.0 - highlight_mask)
                      + compressed * highlight_mask)
    return ldr_linear * torch.clamp(map_compressed, min=cfg.ev_floor)


def mathematical_recovery(ldr_linear: torch.Tensor,
                          map_recovered_aligned: torch.Tensor,
                          cfg: HDRDecodeConfig = HDRDecodeConfig()
                          ) -> torch.Tensor:
    """Full L-ratio recovery: ``ldr * clamp(aligned, floor)``."""
    return ldr_linear * torch.clamp(map_recovered_aligned, min=cfg.ev_floor)


def apply_mode(mode: str, ldr_linear: torch.Tensor,
               pre_collapsed: torch.Tensor, maps: RecoveryMaps,
               pre_stats: Dict[str, torch.Tensor],
               cfg: HDRDecodeConfig = HDRDecodeConfig()) -> torch.Tensor:
    """Dispatch on the (configured, not data-dependent) mode string."""
    if mode == "conservative":
        # the inner expansion factor, not the user's EV multiplier (which
        # scales the final image)
        return conservative(ldr_linear, pre_collapsed,
                            cfg.conservative_expansion_factor)
    if mode == "exposure":
        return exposure(ldr_linear, maps.map_recovered, cfg)
    if mode == "adaptive_recovery":
        return adaptive_recovery(ldr_linear, maps.map_recovered_aligned,
                                 pre_stats, cfg)
    if mode == "mathematical_recovery":
        return mathematical_recovery(ldr_linear, maps.map_recovered_aligned,
                                     cfg)
    raise ValueError(f"unknown hdr mode: {mode}")
