"""Upscale model loading and the unified forward, as
``hdrvae/models/zoo.py``.

The port runs the ESRGAN family (RRDBNet, both public key schemas: ESRGAN
old-arch and RealESRGAN new-arch), SwinIR, Swin2SR (the official schema
and the ``transformers`` export) and HAT.  The other families the JAX
package recognizes (Compact, SPAN, RealPLKSR) are detected by their keys
and refused with ``NotImplementedError`` naming the family: the port never
runs another model in their place.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple, Union

import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.hat import (HAT, HATConfig, hat_apply,
                                     hat_from_state_dict, is_hat_state_dict)
from hdrvae_torch.models.rrdbnet import (RRDBNet, RRDBNetConfig,
                                         detect_architecture, rrdbnet_apply,
                                         rrdbnet_from_state_dict)
from hdrvae_torch.models.swin2sr import (Swin2SR, Swin2SRConfig,
                                         is_swin2sr_state_dict, swin2sr_apply,
                                         swin2sr_from_state_dict)
from hdrvae_torch.models.swinir import (SwinIR, SwinIRConfig,
                                        is_swinir_state_dict, swinir_apply,
                                        swinir_from_state_dict)

ModelConfig = Union[RRDBNetConfig, SwinIRConfig, Swin2SRConfig, HATConfig]
UpscaleModel = Union[RRDBNet, SwinIR, Swin2SR, HAT]

_PORTED = "ESRGAN/RealESRGAN (RRDBNet), SwinIR, Swin2SR and HAT"


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


def _unported_family(sd: Mapping[str, Any]) -> str | None:
    """The name of a recognized family the port does not run yet, from its
    key fingerprint (the JAX package's detectors, in its order; the
    families the port runs are detected before these)."""
    if "feats.0.weight" in sd and "feats.1.lk.conv.weight" in sd:
        return "RealPLKSR"
    if "block_1.c1_r.sk.weight" in sd and "conv_cat.weight" in sd:
        return "SPAN"
    if "body.0.weight" in sd and not any(
            k.startswith(("conv_first", "model.", "layers.", "conv_body"))
            for k in sd) and len(tuple(sd["body.0.weight"].shape)) == 4:
        return "Compact"
    return None


def load_upscale_model(path: str, *, device: torch.device | str = "cuda"
                       ) -> Tuple[UpscaleModel, ModelConfig, str]:
    """Load an upscaler checkpoint (.pth or .safetensors, BasicSR
    ``params_ema`` / ``params`` wrappers unwrapped) onto ``device``.
    Returns (model, config, architecture name); the name picks the
    reversal of :func:`hdrvae_torch.upscale.pipeline.hdr_upscale`."""
    sd = _load_state_dict(path)
    # HAT first, then Swin2SR: both share SwinIR's residual_group.blocks
    # spine, so the SwinIR detector comes last of the three
    if is_hat_state_dict(sd):
        net, cfg = hat_from_state_dict(sd, device=device)
        return net, cfg, "HAT"
    if is_swin2sr_state_dict(sd):
        net, cfg = swin2sr_from_state_dict(sd, device=device)
        # not in the reference's atanh list: the logit reversal
        return net, cfg, "Swin2SR"
    if is_swinir_state_dict(sd):
        net, cfg = swinir_from_state_dict(sd, device=device)
        return net, cfg, "SwinIR"
    family = _unported_family(sd)
    if family is not None:
        raise NotImplementedError(
            f"{family} checkpoint: this family is not yet ported to "
            "hdrvae_torch (the JAX package hdrvae runs it); the port runs "
            f"{_PORTED}")
    if "body.0.rdb1.conv1.weight" in sd or \
            "model.1.sub.0.RDB1.conv1.0.weight" in sd:
        arch = ("ESRGAN" if detect_architecture(sd) == "esrgan-old"
                else "RealESRGAN")
        net, cfg = rrdbnet_from_state_dict(sd, device=device)
        return net, cfg, arch
    raise ValueError(f"unsupported upscaler checkpoint schema (first keys: "
                     f"{', '.join(sorted(sd)[:3])}); the port runs "
                     f"{_PORTED}")


def upscaler_apply(model: nn.Module, x: torch.Tensor, *,
                   precision: Precision = Precision()) -> torch.Tensor:
    """Unified NHWC [B, H, W, C] -> [B, sH, sW, C] forward."""
    if isinstance(model, HAT):
        return hat_apply(model, x, precision=precision)
    if isinstance(model, SwinIR):
        return swinir_apply(model, x, precision=precision)
    if isinstance(model, Swin2SR):
        return swin2sr_apply(model, x, precision=precision)
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
    # RRDBNet: the densest RRDB concat (nf + 4 * gc channels) live twice
    return float((cfg.nf + 4 * cfg.gc) * 2 * elsize + out_bytes)
