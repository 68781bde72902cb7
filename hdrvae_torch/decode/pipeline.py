"""The HDR decode pipeline, as ``hdrvae/decode/pipeline.py``:

  one decoder forward -> (rgb, pre_conv_out)
  -> analysis (stats + sigmoid/tanh classification)
  -> MAX-pool collapse + sRGB->linear + mode math
  -> acceptance select (intelligent result vs raw-features tier)
  -> EV multiplier

The batch runs natively through the decoder and the epilogue statistics
span the whole batch.  Every statistic stays on the device until
:func:`decode_summary` fetches them once.

Shape buckets (``hdr_decode(shape_bucket=, pad_to=)``): the latent is
zero-padded to its bucket, decoded with a ``layers.PadMask`` that keeps the
pad region out of every statistic, softmax and conv halo, and the outputs
are cropped before the epilogue, so a bucketed decode equals the unpadded
one to float noise.  ``decode.buckets.BucketPolicy`` picks the buckets.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from hdrvae_torch.core.color import srgb_to_linear
from hdrvae_torch.core.config import HDRDecodeConfig, Precision
from hdrvae_torch.core.stats import (hdr_stats, pack_stats, tensor_stats,
                                     unpack_stats)
from hdrvae_torch.decode.analysis import (NORM_NAMES, ConvOutAnalysis,
                                          classify_normalization)
from hdrvae_torch.decode.modes import apply_mode, build_recovery_maps
from hdrvae_torch.kernels.epilogue import collapse_and_stats
from hdrvae_torch.models.decoder import Decoder, DecodeOutput, decoder_apply
from hdrvae_torch.models.layers import PadMask, conv2d

# Test hook: replaces decode.staged.STAGED_MIN_PIXELS as hdr_decode's
# threshold for the staged route (None: the real constant).
_STAGED_MIN_PIXELS_OVERRIDE = None


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
    """Analysis + mode math + acceptance select on decoder outputs."""
    pre_collapsed, pre_stats, pre_first3 = _epilogue_parts(pre_conv_out, cfg)
    return hdr_epilogue_from_parts(rgb, pre_collapsed, pre_stats, cfg,
                                   pre_first3)


def _epilogue_parts(pre_conv_out: torch.Tensor, cfg: HDRDecodeConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                               Optional[torch.Tensor]]:
    """The whole-image pre map's parts that :func:`hdr_epilogue_from_parts`
    takes: the collapsed map (float32), its statistics (the fused K4 pass
    when ``cfg.use_fused_epilogue`` is set), and the first three channels
    when the ``first3`` fallback needs them."""
    pre_collapsed, pre_stats = collapse_and_stats(
        pre_conv_out, use_fused=cfg.use_fused_epilogue)
    pre_first3 = (pre_conv_out[..., :3].float()
                  if cfg.fallback_collapse == "first3" else None)
    return pre_collapsed.float(), pre_stats, pre_first3


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


def result_from_parts(decoder: Decoder, rgb: torch.Tensor,
                      pre_collapsed: torch.Tensor,
                      pre_stats: Dict[str, torch.Tensor],
                      latent: torch.Tensor, cfg: HDRDecodeConfig,
                      pre_first3: Optional[torch.Tensor] = None
                      ) -> HDRDecodeResult:
    """The epilogue (:func:`hdr_epilogue_from_parts`) and the stats record
    of a decode whose pre map was collapsed and reduced by its executor
    (staged, slab-sharded), so only the weights' part of
    ``full_analysis`` is recorded.  ``latent`` is the unpadded latent."""
    image, used_fallback, analysis = hdr_epilogue_from_parts(
        rgb, pre_collapsed, pre_stats, cfg, pre_first3)
    stats = {
        "input": hdr_stats(latent),
        "pre": analysis.pre_stats,
        "post": analysis.post_stats,
        "norm_kind": analysis.norm_kind,
        "output": hdr_stats(image),
    }
    if cfg.full_analysis:
        stats["conv_weight"] = tensor_stats(
            decoder.conv_out.weight.permute(2, 3, 1, 0))
        stats["conv_bias"] = tensor_stats(decoder.conv_out.bias)
    return HDRDecodeResult(image=image,
                           standard=rgb if cfg.keep_standard else None,
                           stats=stats, used_fallback=used_fallback)


def _epilogue_and_stats(decoder: Decoder, out: DecodeOutput,
                        latent: torch.Tensor, cfg: HDRDecodeConfig,
                        precision: Precision) -> HDRDecodeResult:
    """The epilogue and the stats record of a decoder output.  ``latent``
    is the unpadded latent, so ``stats["input"]`` never counts pad
    pixels."""
    pre_collapsed, pre_stats, pre_first3 = _epilogue_parts(
        out.pre_conv_out, cfg)
    result = result_from_parts(decoder, out.rgb, pre_collapsed, pre_stats,
                               latent, cfg, pre_first3)
    if cfg.full_analysis:
        # conv_out re-applied to the captured features alone
        conv_only = conv2d(out.pre_conv_out, decoder.conv_out,
                           precision=precision)
        result.stats["conv_only"] = tensor_stats(conv_only)
    return result


def _bucket_target(hw: Tuple[int, int], shape_bucket: int,
                   pad_to: Optional[Tuple[int, int]]
                   ) -> Optional[Tuple[int, int]]:
    """The padded (h, w) a bucketed decode runs at, or None for the
    unbucketed decode.  ``pad_to`` is taken even when it equals the latent
    (a full-valid mask: one decoder shape a bucket); ``shape_bucket`` pads
    only a latent that is no multiple of it."""
    h, w = hw
    if pad_to is not None:
        if pad_to[0] < h or pad_to[1] < w:
            raise ValueError(f"pad_to {tuple(pad_to)} smaller than latent "
                             f"{(h, w)}")
        return int(pad_to[0]), int(pad_to[1])
    if shape_bucket > 0 and (h % shape_bucket or w % shape_bucket):
        return -(-h // shape_bucket) * shape_bucket, \
            -(-w // shape_bucket) * shape_bucket
    return None


@torch.no_grad()
def hdr_decode(decoder: Decoder, latent: torch.Tensor,
               cfg: HDRDecodeConfig = HDRDecodeConfig(),
               precision: Precision = Precision(), *,
               shape_bucket: int = 0,
               pad_to: Optional[Tuple[int, int]] = None) -> HDRDecodeResult:
    """Decode a latent to a linear HDR image.

    ``latent`` is [B, h, w, z_channels] NHWC (or [B, z, h, w] NCHW) on the
    decoder's device.  Returns an :class:`HDRDecodeResult` whose ``stats``
    are still device tensors.

    Shape buckets: with ``pad_to`` (e.g. ``BucketPolicy.snap_hw(h, w)``;
    smaller than the latent raises ``ValueError``) or ``shape_bucket > 0``
    (pad h and w up to its multiples), the latent is zero-padded, decoded
    with a ``PadMask`` on the layers, and rgb and the pre map are cropped
    to ``(h, w) * spatial_scale`` before the epilogue.  The result equals
    the unbucketed decode to float noise.

    Large frames: a batch-1 mixed decode of at least
    ``decode.staged.STAGED_MIN_PIXELS`` output pixels goes through the
    staged executor (the same function in bounded memory) unless it sets
    ``fast_head_levels`` (the staged executor runs the whole decoder in the
    mixed tier) or buckets (a bucketed decode stays whole-image, as in the
    JAX package); a fast decode streams its top level from
    ``models.fused_tail.LOWMEM_MIN_PIXELS``.
    """
    latent = _to_nhwc(latent, decoder.cfg.z_channels)
    dcfg = decoder.cfg
    if (precision.mode == "mixed" and precision.fast_head_levels == 0
            and latent.shape[0] == 1 and shape_bucket == 0
            and pad_to is None and dcfg.num_levels >= 2):
        from hdrvae_torch.decode import staged as _staged
        s = dcfg.spatial_scale
        threshold = (_STAGED_MIN_PIXELS_OVERRIDE
                     or _staged.STAGED_MIN_PIXELS)
        if (latent.shape[1] * s) * (latent.shape[2] * s) >= threshold:
            return _staged.staged_hdr_decode(decoder, latent, cfg, precision)
    h, w = latent.shape[1], latent.shape[2]
    target = _bucket_target((h, w), shape_bucket, pad_to)
    if target is None:
        out = decoder_apply(decoder, latent, precision=precision)
    else:
        padded = torch.nn.functional.pad(
            latent, (0, 0, 0, target[1] - w, 0, target[0] - h))
        out = decoder_apply(decoder, padded, precision=precision,
                            tape=PadMask(target[0], target[1], h, w))
        s = dcfg.spatial_scale
        out = DecodeOutput(rgb=out.rgb[:, :h * s, :w * s],
                           pre_conv_out=out.pre_conv_out[:, :h * s, :w * s])
    return _epilogue_and_stats(decoder, out, latent, cfg, precision)


def pack_summary(result: HDRDecodeResult):
    """The summary's device part: every statistic and the fallback flag
    packed into one float64 tensor on the result's device, and its layout
    (``core.stats.pack_stats``).  :func:`summary_from_host` finishes it
    from the fetched tensor."""
    return pack_stats({**result.stats,
                       "used_fallback": result.used_fallback})


def summary_from_host(flat: torch.Tensor, layout) -> Dict[str, Any]:
    """The summary record from :func:`pack_summary`'s tensor, on the host:
    the stats as Python scalars, the fallback flag as a bool and the
    normalization's name."""
    summary = unpack_stats(flat, layout)
    summary["used_fallback"] = bool(summary["used_fallback"])
    summary["normalization"] = NORM_NAMES[summary.pop("norm_kind")]
    return summary


def decode_summary(result: HDRDecodeResult) -> Dict[str, Any]:
    """One host fetch: the stats as Python scalars, the fallback flag and
    the normalization name, in one device-to-host copy."""
    flat, layout = pack_summary(result)
    return summary_from_host(flat.cpu(), layout)
