"""Upscale model loading and the unified forward, as
``hdrvae/models/zoo.py``.

The port runs the ESRGAN family (RRDBNet, both public key schemas: ESRGAN
old-arch and RealESRGAN new-arch).  The other families the JAX package
recognizes (SwinIR, HAT, Swin2SR, Compact, SPAN, RealPLKSR) are detected by
their keys and refused with ``NotImplementedError`` naming the family: the
port never runs another model in their place.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.rrdbnet import (RRDBNet, RRDBNetConfig,
                                         detect_architecture, rrdbnet_apply,
                                         rrdbnet_from_state_dict)

ModelConfig = RRDBNetConfig


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


def _family(sd: Mapping[str, Any]) -> str | None:
    """The name of a recognized family the port does not run yet, from its
    key fingerprint (the JAX package's detectors, in its order)."""
    keys = list(sd)
    swin_spine = any(k.startswith("layers.") and ".residual_group.blocks."
                     in k for k in keys)
    if any(".conv_block.cab." in k or ".overlap_attn." in k for k in keys):
        return "HAT"
    if "swin2sr.first_convolution.weight" in sd or (
            swin_spine and any(k.endswith(".attn.logit_scale")
                               for k in keys)):
        return "Swin2SR"
    if swin_spine:
        return "SwinIR"
    if "feats.0.weight" in sd and "feats.1.lk.conv.weight" in sd:
        return "RealPLKSR"
    if "block_1.c1_r.sk.weight" in sd and "conv_cat.weight" in sd:
        return "SPAN"
    if "body.0.weight" in sd and not any(
            k.startswith(("conv_first", "model.", "layers.", "conv_body"))
            for k in keys) and len(tuple(sd["body.0.weight"].shape)) == 4:
        return "Compact"
    return None


def load_upscale_model(path: str, *, device: torch.device | str = "cpu"
                       ) -> Tuple[RRDBNet, ModelConfig, str]:
    """Load an upscaler checkpoint (.pth or .safetensors, BasicSR
    ``params_ema`` / ``params`` wrappers unwrapped) onto ``device``.
    Returns (model, config, architecture name); the name picks the
    reversal of :func:`hdrvae_torch.upscale.pipeline.hdr_upscale`."""
    sd = _load_state_dict(path)
    family = _family(sd)
    if family is not None:
        raise NotImplementedError(
            f"{family} checkpoint: this family is not yet ported to "
            "hdrvae_torch (the JAX package hdrvae runs it); the port runs "
            "ESRGAN/RealESRGAN (RRDBNet)")
    if "body.0.rdb1.conv1.weight" in sd or \
            "model.1.sub.0.RDB1.conv1.0.weight" in sd:
        arch = ("ESRGAN" if detect_architecture(sd) == "esrgan-old"
                else "RealESRGAN")
        net, cfg = rrdbnet_from_state_dict(sd, device=device)
        return net, cfg, arch
    raise ValueError(f"unsupported upscaler checkpoint schema (first keys: "
                     f"{', '.join(sorted(sd)[:3])}); the port runs "
                     "ESRGAN/RealESRGAN (RRDBNet)")


def upscaler_apply(model: RRDBNet, x: torch.Tensor, *,
                   precision: Precision = Precision()) -> torch.Tensor:
    """Unified NHWC [B, H, W, C] -> [B, sH, sW, C] forward."""
    if isinstance(model, RRDBNet):
        return rrdbnet_apply(model, x, precision=precision)
    raise TypeError(f"unknown upscale model {type(model).__name__}")


def working_set_bytes_per_pixel(cfg: ModelConfig,
                                precision: Precision) -> float:
    """Rough activation bytes per input pixel, for the tile-size planner:
    the densest RRDB concat (nf + 4 * gc channels) live twice, plus the
    float32 output."""
    elsize = torch.empty((), dtype=precision.storage_dtype).element_size()
    out_bytes = cfg.scale ** 2 * 3 * 4
    return float((cfg.nf + 4 * cfg.gc) * 2 * elsize + out_bytes)
