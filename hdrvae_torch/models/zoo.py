"""Upscale model loading and the unified forward, as
``hdrvae/models/zoo.py``.

The port runs every family the JAX package recognizes: the ESRGAN family
(RRDBNet, both public key schemas: ESRGAN old-arch and RealESRGAN
new-arch), SwinIR, Swin2SR (the official schema and the ``transformers``
export), HAT, RealPLKSR (PixelShuffle or DySample head), SPAN (Conv3XC
fused at load) and Compact (SRVGGNetCompact).  Detection follows the JAX
package's order; a checkpoint of another family is refused with a
ValueError that names it where its keys say what it is.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.hat import (HAT, HATConfig, hat_apply,
                                     hat_from_state_dict, is_hat_state_dict)
from hdrvae_torch.models.plksr import (RealPLKSR, RealPLKSRConfig,
                                       is_realplksr_state_dict,
                                       realplksr_apply,
                                       realplksr_from_state_dict)
from hdrvae_torch.models.rrdbnet import (RRDBNet, RRDBNetConfig,
                                         detect_architecture, rrdbnet_apply,
                                         rrdbnet_from_state_dict)
from hdrvae_torch.models.span import (SPAN, SPANConfig, is_span_state_dict,
                                      span_apply, span_from_state_dict)
from hdrvae_torch.models.srvgg import (SRVGG, SRVGGConfig,
                                       is_srvgg_state_dict, srvgg_apply,
                                       srvgg_from_state_dict)
from hdrvae_torch.models.swin2sr import (Swin2SR, Swin2SRConfig,
                                         geometry_buffers,
                                         is_swin2sr_state_dict, swin2sr_apply,
                                         swin2sr_from_state_dict)
from hdrvae_torch.models.swinir import (SwinIR, SwinIRConfig,
                                        is_swinir_state_dict, swinir_apply,
                                        swinir_from_state_dict)

ModelConfig = Union[RRDBNetConfig, SwinIRConfig, Swin2SRConfig, HATConfig,
                    SRVGGConfig, SPANConfig, RealPLKSRConfig]
UpscaleModel = Union[RRDBNet, SwinIR, Swin2SR, HAT, SRVGG, SPAN, RealPLKSR]


def _load_state_dict(path: str) -> Mapping[str, Any]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # BasicSR wrappers
    if isinstance(sd, dict) and "params_ema" in sd:
        sd = sd["params_ema"]
    elif isinstance(sd, dict) and "params" in sd:
        sd = sd["params"]
    return sd


def _is_span(sd: Mapping[str, Any]) -> bool:
    """SPAN's official layout, or the fused one a loaded :class:`SPAN`
    holds (``*.eval_conv`` alone)."""
    return is_span_state_dict(sd) or (
        "block_1.c1_r.eval_conv.weight" in sd and "conv_cat.weight" in sd)


# (detector, loader, architecture name) in the JAX package's order: HAT
# and Swin2SR before SwinIR (both share its residual_group.blocks spine).
# The name picks the reversal of hdr_upscale; Swin2SR, RealPLKSR, SPAN and
# Compact are not in the reference's atanh list: the logit reversal.
_FAMILIES = (
    (is_hat_state_dict, hat_from_state_dict, "HAT"),
    (is_swin2sr_state_dict, swin2sr_from_state_dict, "Swin2SR"),
    (is_swinir_state_dict, swinir_from_state_dict, "SwinIR"),
    (is_realplksr_state_dict, realplksr_from_state_dict, "RealPLKSR"),
    (_is_span, span_from_state_dict, "SPAN"),
    (is_srvgg_state_dict, srvgg_from_state_dict, "Compact"),
)

# Key fingerprints of families the JAX package does not implement, so the
# refusal names what the user has.
_FOREIGN_FINGERPRINTS = (
    ("before_RG.1.weight", "looks like DAT"),
    ("residual_layer.0.residual_layer.0.layer.0.fn.0.weight",
     "looks like OmniSR"),
    ("unet1.conv1.conv.0.weight", "looks like RealCUGAN"),
    ("feats.1.lk.conv.weight", "original PLKSR (only RealPLKSR is "
                               "implemented)"),
)


def _guess_architecture(sd: Mapping[str, Any]) -> str:
    for key, name in _FOREIGN_FINGERPRINTS:
        if key in sd:
            return name
    return f"unrecognized; first keys: {', '.join(sorted(sd)[:3])}"


def load_upscale_model(path: str, *, device: torch.device | str = "cuda"
                       ) -> Tuple[UpscaleModel, ModelConfig, str]:
    """Load an upscaler checkpoint (.pth or .safetensors, BasicSR
    ``params_ema`` / ``params`` wrappers unwrapped) onto ``device``.
    Returns (model, config, architecture name); the name picks the
    reversal of :func:`hdrvae_torch.upscale.pipeline.hdr_upscale`."""
    return upscaler_from_state_dict(_load_state_dict(path), device=device)


def upscaler_from_state_dict(sd: Mapping[str, Any], *,
                             device: torch.device | str = "cuda"
                             ) -> Tuple[UpscaleModel, ModelConfig, str]:
    """:func:`load_upscale_model` of a state dict in memory: its family
    detected from its keys.  A loaded module's own ``state_dict()`` loads
    back as the same family (``cli convert upscaler`` writes it)."""
    for detect, load, arch in _FAMILIES:
        if detect(sd):
            try:
                net, cfg = load(sd, device=device)
            except KeyError as e:
                raise ValueError(f"incomplete {arch} checkpoint: missing "
                                 f"{e}") from None
            return net, cfg, arch
    if "body.0.rdb1.conv1.weight" in sd or \
            "model.1.sub.0.RDB1.conv1.0.weight" in sd:
        arch = ("ESRGAN" if detect_architecture(sd) == "esrgan-old"
                else "RealESRGAN")
        net, cfg = rrdbnet_from_state_dict(sd, device=device)
        return net, cfg, arch
    raise ValueError(
        f"unsupported upscaler checkpoint schema ({_guess_architecture(sd)})"
        "; supported architectures: ESRGAN/RealESRGAN (RRDBNet), SwinIR, "
        "Swin2SR, HAT, Compact (SRVGGNetCompact), SPAN, RealPLKSR")


def upscaler_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A loaded upscaler's weights as a state dict that
    :func:`upscaler_from_state_dict` loads back as the same family and
    configuration: the module's own ``state_dict()`` (SPAN's fused
    Conv3XC), with Swin2SR's geometry buffers of its first block, which
    carry the window size, as an official checkpoint has them.  (Loaders
    read a RealPLKSR's GroupNorm groups as 4, which no shape records.)"""
    sd = dict(model.state_dict())
    if isinstance(model, Swin2SR):
        for name, buf in geometry_buffers(model.cfg.window_size).items():
            sd[f"layers.0.residual_group.blocks.0.attn.{name}"] = buf
    return sd


def upscaler_apply(model: nn.Module, x: torch.Tensor, *,
                   precision: Precision = Precision()) -> torch.Tensor:
    """Unified NHWC [B, H, W, C] -> [B, sH, sW, C] forward."""
    if isinstance(model, HAT):
        return hat_apply(model, x, precision=precision)
    if isinstance(model, SwinIR):
        return swinir_apply(model, x, precision=precision)
    if isinstance(model, Swin2SR):
        return swin2sr_apply(model, x, precision=precision)
    if isinstance(model, SPAN):
        return span_apply(model, x, precision=precision)
    if isinstance(model, RealPLKSR):
        return realplksr_apply(model, x, precision=precision)
    if isinstance(model, SRVGG):
        return srvgg_apply(model, x, precision=precision)
    if isinstance(model, RRDBNet):
        return rrdbnet_apply(model, x, precision=precision)
    raise TypeError(f"unknown upscale model {type(model).__name__}")


def working_set_bytes_per_pixel(cfg: ModelConfig,
                                precision: Precision) -> float:
    """Rough activation bytes per input pixel, for the tile-size planner
    (the JAX package's rows)."""
    elsize = torch.empty((), dtype=precision.storage_dtype).element_size()
    out_bytes = cfg.scale ** 2 * 3 * 4
    if isinstance(cfg, HATConfig):
        # qkv + MLP hidden as SwinIR, plus OCAB's unfolded k / v,
        # (overlap window / window)^2 = 2.25x the tokens at overlap 0.5
        ratio = (cfg.overlap_win_size / cfg.window_size) ** 2
        width = cfg.embed_dim * (3 + cfg.mlp_ratio + 2 * ratio)
        return float(width * 2 * elsize + out_bytes)
    if isinstance(cfg, (SwinIRConfig, Swin2SRConfig)):
        # qkv (3x dim) + MLP hidden, live beside the token stream
        width = cfg.embed_dim * (3 + cfg.mlp_ratio)
        return float(width * 2 * elsize + out_bytes)
    if isinstance(cfg, SRVGGConfig):
        # a plain conv stack: two num_feat activations live at a time
        return float(cfg.num_feat * 2 * elsize + out_bytes)
    if isinstance(cfg, SPANConfig):
        # the conv stack plus the 4x num_feat concat before conv_cat
        return float(cfg.num_feat * 6 * elsize + out_bytes)
    if isinstance(cfg, RealPLKSRConfig):
        # DCCM's 2x dim hidden beside the block's skip
        return float(cfg.dim * 3 * elsize + out_bytes)
    # RRDBNet: the densest RRDB concat (nf + 4 * gc channels) live twice
    return float((cfg.nf + 4 * cfg.gc) * 2 * elsize + out_bytes)
