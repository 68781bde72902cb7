"""Decoder weights: topology inference, seeded initialization, and the
JAX parameter pytree as an ldm state dict; as ``hdrvae/models/params.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from hdrvae_torch.core.config import DecoderConfig
from hdrvae_torch.models.decoder import Decoder


def _strip_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Keys relative to the decoder root."""
    out = {}
    for k, v in sd.items():
        for prefix in ("first_stage_model.decoder.", "vae.decoder.",
                       "decoder."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def infer_decoder_config(state_dict: Mapping[str, Any]) -> DecoderConfig:
    """The decoder topology of an ldm-layout state dict, from shapes only.

    Latent scale/shift are not recoverable from weights: z_channels == 16
    selects the Flux.1 constants, z_channels == 4 the SD family's
    (0.18215 / 0).  The GroupNorm group count is 32, halved until it
    divides every feature width.
    """
    sd = _strip_prefix(state_dict)
    try:
        block_in, z_channels = tuple(sd["conv_in.weight"].shape)[:2]
        out_channels, pre_out = tuple(sd["conv_out.weight"].shape)[:2]
    except KeyError as e:
        raise ValueError(f"not an AutoencoderKL decoder state dict "
                         f"(missing {e})") from None
    up_levels = set()
    block_counts: Dict[int, int] = {}
    for k in sd:
        if not k.startswith("up."):
            continue
        parts = k.split(".")
        level = int(parts[1])
        up_levels.add(level)
        if parts[2] == "attn":
            raise ValueError(
                "decoder has per-level attention blocks (VQ-style "
                "topology) — not supported; only the AutoencoderKL "
                "family (Flux.1 / SD / SDXL) is")
        if parts[2] == "block":
            block_counts[level] = max(block_counts.get(level, -1),
                                      int(parts[3]))
    if not up_levels:
        raise ValueError("decoder state dict has no up.{level} stages")
    num_levels = max(up_levels) + 1
    if up_levels != set(range(num_levels)):
        raise ValueError(f"non-contiguous up levels: {sorted(up_levels)}")
    num_res_blocks = block_counts[0]
    if any(c != num_res_blocks for c in block_counts.values()):
        raise ValueError(f"ragged block counts per level: {block_counts}")

    widths = [int(sd[f"up.{lvl}.block.0.conv2.weight"].shape[0])
              for lvl in range(num_levels)]
    ch = widths[0]
    if any(w % ch for w in widths):
        raise ValueError(f"level widths {widths} are not multiples of the "
                         f"base width {ch}")
    ch_mult = tuple(w // ch for w in widths)
    if ch * ch_mult[-1] != block_in:
        raise ValueError(f"conv_in width {block_in} != ch*ch_mult[-1] = "
                         f"{ch * ch_mult[-1]}")
    if pre_out != ch * ch_mult[0]:
        raise ValueError(f"conv_out input width {pre_out} != ch*ch_mult[0]"
                         f" = {ch * ch_mult[0]}")

    num_groups = 32
    all_widths = set(widths) | {block_in}
    while num_groups > 1 and any(w % num_groups for w in all_widths):
        num_groups //= 2

    base = DecoderConfig()
    if z_channels == 16:
        scale, shift = base.scale_factor, base.shift_factor
    elif z_channels == 4:
        scale, shift = 0.18215, 0.0
    else:
        scale, shift = 1.0, 0.0
    return dataclasses.replace(
        base, z_channels=int(z_channels), ch=ch, ch_mult=ch_mult,
        num_res_blocks=int(num_res_blocks), out_channels=int(out_channels),
        attn_mid="mid.attn_1.norm.weight" in sd, num_groups=num_groups,
        scale_factor=scale, shift_factor=shift)


def decoder_from_state_dict(state_dict: Mapping[str, Any],
                            cfg: DecoderConfig | None = None, *,
                            device: torch.device | str = "cpu") -> Decoder:
    """A :class:`Decoder` on ``device`` holding an ldm state dict (numpy
    arrays or tensors; ``cfg=None`` infers the topology).  Gradients are
    off: nothing in the decode needs them."""
    if cfg is None:
        cfg = infer_decoder_config(state_dict)
    sd = {k: torch.as_tensor(np.asarray(v, np.float32))
          if not isinstance(v, torch.Tensor) else v.float()
          for k, v in _strip_prefix(state_dict).items()}
    with torch.device("meta"):
        dec = Decoder(cfg)
    dec = dec.to_empty(device=device)
    dec.load_state_dict(sd)
    return dec.requires_grad_(False).eval()


def init_decoder(cfg: DecoderConfig = DecoderConfig(), seed: int = 0, *,
                 device: torch.device | str = "cpu") -> Decoder:
    """A randomly initialized decoder, its weights drawn with numpy from
    ``seed``: convs from PyTorch's default U(+-sqrt(1/fan_in)), GroupNorm
    scale 1 and bias 0."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = Decoder(cfg).state_dict()
    sd = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if ".norm" in name or name.startswith("norm"):
            fill = 1.0 if name.endswith(".weight") else 0.0
            sd[name] = np.full(shape, fill, np.float32)
            continue
        module = name.rsplit(".", 1)[0]
        wshape = tuple(shapes[module + ".weight"].shape)
        bound = float(np.sqrt(1.0 / (wshape[1] * wshape[2] * wshape[3])))
        sd[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return decoder_from_state_dict(sd, cfg, device=device)


def state_dict_from_jax(params_np: Mapping[str, Any],
                        cfg: DecoderConfig = DecoderConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's decoder pytree (numpy leaves) as an ldm state dict
    of float32 tensors: HWIO conv kernels to OIHW, GroupNorm scale/bias to
    weight/bias.  The same mapping as the JAX package's
    ``decoder_params_to_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(name: str, p):
        w = np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(p["bias"], np.float32))

    def put_norm(name: str, p):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(p["scale"], np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(p["bias"], np.float32))

    def put_resnet(name: str, p):
        put_norm(f"{name}.norm1", p["norm1"])
        put_conv(f"{name}.conv1", p["conv1"])
        put_norm(f"{name}.norm2", p["norm2"])
        put_conv(f"{name}.conv2", p["conv2"])
        if "nin_shortcut" in p:
            put_conv(f"{name}.nin_shortcut", p["nin_shortcut"])

    put_conv("conv_in", params_np["conv_in"])
    put_resnet("mid.block_1", params_np["mid"]["block_1"])
    put_resnet("mid.block_2", params_np["mid"]["block_2"])
    if cfg.attn_mid:
        attn = params_np["mid"]["attn_1"]
        put_norm("mid.attn_1.norm", attn["norm"])
        for nm in ("q", "k", "v", "proj_out"):
            put_conv(f"mid.attn_1.{nm}", attn[nm])
    for level in range(cfg.num_levels):
        up = params_np["up"][level]
        for j, blk in enumerate(up["block"]):
            put_resnet(f"up.{level}.block.{j}", blk)
        if level != 0:
            put_conv(f"up.{level}.upsample.conv", up["upsample"])
    put_norm("norm_out", params_np["norm_out"])
    put_conv("conv_out", params_np["conv_out"])
    return sd
