"""The HDR decode pipeline, as ``hdrvae/decode/pipeline.py``:

  one decoder forward -> (rgb, pre_conv_out)
  -> analysis (stats + sigmoid/tanh classification)
  -> MAX-pool collapse + sRGB->linear + mode math
  -> acceptance select (intelligent result vs raw-features tier)
  -> EV multiplier

The batch runs natively through the decoder and the epilogue statistics
span the whole batch.  Every statistic stays on the device until
:func:`decode_summary` fetches them once.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from hdrvae_torch.core.color import srgb_to_linear
from hdrvae_torch.core.config import HDRDecodeConfig, Precision
from hdrvae_torch.core.stats import hdr_stats, stats_to_host, tensor_stats
from hdrvae_torch.decode.analysis import (NORM_NAMES, ConvOutAnalysis,
                                          classify_normalization)
from hdrvae_torch.decode.modes import apply_mode, build_recovery_maps
from hdrvae_torch.kernels.epilogue import collapse_and_stats
from hdrvae_torch.models.decoder import Decoder, decoder_apply
from hdrvae_torch.models.layers import conv2d


class HDRDecodeResult(NamedTuple):
    image: torch.Tensor                   # [B, H, W, 3] float32 linear HDR
    standard: Optional[torch.Tensor]      # plain decode (None when
                                          # cfg.keep_standard=False)
    stats: Dict[str, Any]                 # nested device stats
    used_fallback: torch.Tensor           # 0-d bool: raw-features tier used


def hdr_epilogue_from_parts(rgb: torch.Tensor, pre_collapsed: torch.Tensor,
                            pre_stats: Dict[str, torch.Tensor],
                            cfg: HDRDecodeConfig,
                            pre_first3: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       ConvOutAnalysis]:
    """Mode math + acceptance select from pre-computed parts.

    ``pre_first3`` carries the first 3 raw pre-conv_out channels for the
    ``fallback_collapse="first3"`` tier.
    """
    if cfg.fallback_collapse not in ("maxpool", "first3"):
        raise ValueError(
            f"unknown fallback_collapse {cfg.fallback_collapse!r}")
    if cfg.fallback_collapse == "first3" and pre_first3 is None:
        raise ValueError("fallback_collapse='first3' needs the raw pre-map "
                         "channels; the caller did not carry them")
    mode = cfg.canonical_mode()
    post_stats = tensor_stats(rgb)
    analysis = ConvOutAnalysis(pre_stats=pre_stats, post_stats=post_stats,
                               norm_kind=classify_normalization(post_stats))

    ldr_linear = srgb_to_linear(rgb)
    maps = build_recovery_maps(rgb, pre_collapsed, analysis.pre_stats,
                               analysis.norm_kind, cfg)
    intelligent = apply_mode(mode, ldr_linear, pre_collapsed, maps,
                             analysis.pre_stats, cfg)

    # Accept the intelligent result iff it has HDR pixels or exceeds the
    # threshold; otherwise the raw pre-conv_out features (the bypass tier).
    accept = (intelligent > 1.0).any() | (intelligent.max()
                                          > cfg.accept_max_threshold)
    fallback = (pre_first3 if cfg.fallback_collapse == "first3"
                else pre_collapsed)
    image = torch.where(accept, intelligent, fallback)
    image = image * cfg.conservative_ev_multiplier
    return image.float(), ~accept, analysis


def hdr_epilogue(rgb: torch.Tensor, pre_conv_out: torch.Tensor,
                 cfg: HDRDecodeConfig) -> Tuple[torch.Tensor, torch.Tensor,
                                                ConvOutAnalysis]:
    """Analysis + mode math + acceptance select on decoder outputs; the
    collapse and the pre-map statistics run as the fused K4 pass when
    ``cfg.use_fused_epilogue`` is set."""
    pre_collapsed, pre_stats = collapse_and_stats(
        pre_conv_out, use_fused=cfg.use_fused_epilogue)
    pre_first3 = (pre_conv_out[..., :3].float()
                  if cfg.fallback_collapse == "first3" else None)
    return hdr_epilogue_from_parts(rgb, pre_collapsed.float(), pre_stats,
                                   cfg, pre_first3)


def _to_nhwc(latent: torch.Tensor, zc: int) -> torch.Tensor:
    """Accept NHWC, or NCHW (torch-layout callers) detected by the
    channel axis."""
    if latent.dim() != 4:
        raise ValueError(f"latent must be 4D, got shape "
                         f"{tuple(latent.shape)}")
    if latent.shape[-1] == zc:
        return latent
    if latent.shape[1] == zc:
        return latent.permute(0, 2, 3, 1).contiguous()
    raise ValueError(f"latent shape {tuple(latent.shape)} has no "
                     f"{zc}-channel axis (expected NHWC or NCHW with "
                     f"z_channels={zc})")


@torch.no_grad()
def hdr_decode(decoder: Decoder, latent: torch.Tensor,
               cfg: HDRDecodeConfig = HDRDecodeConfig(),
               precision: Precision = Precision()) -> HDRDecodeResult:
    """Decode a latent to a linear HDR image.

    ``latent`` is [B, h, w, z_channels] NHWC (or [B, z, h, w] NCHW) on the
    decoder's device.  Returns an :class:`HDRDecodeResult` whose ``stats``
    are still device tensors.
    """
    latent = _to_nhwc(latent, decoder.cfg.z_channels)
    out = decoder_apply(decoder, latent, precision=precision)
    image, used_fallback, analysis = hdr_epilogue(out.rgb, out.pre_conv_out,
                                                  cfg)
    stats = {
        "input": hdr_stats(latent),
        "pre": analysis.pre_stats,
        "post": analysis.post_stats,
        "norm_kind": analysis.norm_kind,
        "output": hdr_stats(image),
    }
    if cfg.full_analysis:
        # conv_out re-applied to the captured features alone, and the
        # layer's weight/bias statistics
        conv_only = conv2d(out.pre_conv_out, decoder.conv_out,
                           precision=precision)
        stats["conv_only"] = tensor_stats(conv_only)
        stats["conv_weight"] = tensor_stats(
            decoder.conv_out.weight.permute(2, 3, 1, 0))
        stats["conv_bias"] = tensor_stats(decoder.conv_out.bias)
    standard = out.rgb if cfg.keep_standard else None
    return HDRDecodeResult(image=image, standard=standard, stats=stats,
                           used_fallback=used_fallback)


def decode_summary(result: HDRDecodeResult) -> Dict[str, Any]:
    """One host fetch: the stats as Python scalars, the fallback flag and
    the normalization name."""
    summary = stats_to_host(result.stats)
    summary["used_fallback"] = bool(result.used_fallback)
    summary["normalization"] = NORM_NAMES[int(summary.pop("norm_kind"))]
    return summary
