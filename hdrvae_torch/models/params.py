"""Decoder weights: topology inference, seeded initialization, and the
JAX parameter pytree as an ldm state dict; as ``hdrvae/models/params.py``.
Also the JAX package's RRDBNet, SwinIR, Swin2SR, HAT, Compact, SPAN and
RealPLKSR pytrees as the state dicts of their PyTorch schemas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from hdrvae_torch.core.config import DecoderConfig
from hdrvae_torch.models.decoder import Decoder
from hdrvae_torch.models.swin2sr import geometry_buffers


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
                            device: torch.device | str = "cuda") -> Decoder:
    """A :class:`Decoder` on ``device`` holding an ldm state dict (numpy
    arrays or tensors; ``cfg=None`` infers the topology).  Gradients are
    off: nothing in the decode needs them."""
    if cfg is None:
        cfg = infer_decoder_config(state_dict)
    sd = {k: torch.as_tensor(np.asarray(v, np.float32))
          if not isinstance(v, torch.Tensor) else v.float()
          for k, v in _strip_prefix(state_dict).items()}
    for name in ("q", "k", "v", "proj_out"):
        # the mid attention's projections as linears [O, I] (diffusers)
        key = f"mid.attn_1.{name}.weight"
        if key in sd and sd[key].dim() == 2:
            sd[key] = sd[key][:, :, None, None]
    with torch.device("meta"):
        dec = Decoder(cfg)
    dec = dec.to_empty(device=device)
    dec.load_state_dict(sd)
    return dec.requires_grad_(False).eval()


def load_decoder(path: str, cfg: DecoderConfig | None = None, *,
                 device: torch.device | str = "cuda") -> Decoder:
    """The AutoencoderKL decoder of a safetensors checkpoint file (Flux.1's
    ``ae.safetensors``, an SD / SDXL VAE) on ``device``, as the JAX
    package's ``load_decoder``: ``cfg=None`` infers the topology, the
    ``decoder.`` (or ``first_stage_model.decoder.`` / ``vae.decoder.``)
    prefix is stripped, and keys outside the decoder (the encoder, the
    quant convs) are left out."""
    from safetensors.torch import load_file
    sd = load_file(path)
    if cfg is None:
        cfg = infer_decoder_config(sd)
    return decoder_from_state_dict(decoder_weights(sd, cfg), cfg,
                                   device=device)


def decoder_weights(state_dict: Mapping[str, Any],
                    cfg: DecoderConfig) -> Dict[str, Any]:
    """The decoder's entries of a checkpoint's state dict: the prefix
    stripped, keys outside the decoder (the encoder, the quant convs) left
    out."""
    with torch.device("meta"):
        keys = set(Decoder(cfg).state_dict())
    return {k: v for k, v in _strip_prefix(state_dict).items() if k in keys}


def init_decoder(cfg: DecoderConfig = DecoderConfig(), seed: int = 0, *,
                 device: torch.device | str = "cuda") -> Decoder:
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


def _put_conv(sd: Dict[str, torch.Tensor], name: str, p) -> None:
    """A JAX conv ({"kernel": HWIO, "bias"}) as OIHW weight + bias."""
    w = np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))
    sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
    sd[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def state_dict_from_jax(params_np: Mapping[str, Any],
                        cfg: DecoderConfig = DecoderConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's decoder pytree (numpy leaves) as an ldm state dict
    of float32 tensors: HWIO conv kernels to OIHW, GroupNorm scale/bias to
    weight/bias.  The same mapping as the JAX package's
    ``decoder_params_to_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(name: str, p):
        _put_conv(sd, name, p)

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


def rrdbnet_state_dict_from_jax(params_np: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's RRDBNet pytree (numpy HWIO leaves) as a
    new-schema ESRGAN state dict of float32 OIHW tensors (``conv_first``,
    ``body.N.rdbJ.convK``, ``conv_body``, ``conv_upI``, ``conv_hr``,
    ``conv_last``), which ``rrdbnet_from_state_dict`` loads."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params_np.items():
        if name != "body":
            _put_conv(sd, name, p)
    for i, block in enumerate(params_np["body"]):
        for rdb, convs in block.items():
            for conv, p in convs.items():
                _put_conv(sd, f"body.{i}.{rdb}.{conv}", p)
    return sd


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _put_linear(sd: Dict[str, torch.Tensor], name: str, p) -> None:
    """A JAX linear ({"kernel": [in, out], "bias"}) as torch's [out, in]
    weight + bias."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_norm(sd: Dict[str, torch.Tensor], name: str, p) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_swin_attention(sd: Dict[str, torch.Tensor], prefix: str,
                        p) -> None:
    """qkv, proj and the relative-position bias table under ``prefix``."""
    _put_linear(sd, prefix + "qkv", p["qkv"])
    _put_linear(sd, prefix + "proj", p["proj"])
    sd[prefix + "relative_position_bias_table"] = _t(
        p["relative_position_bias_table"])


def _put_block(sd: Dict[str, torch.Tensor], prefix: str, blk) -> None:
    """norm1, norm2 and mlp of a Swin block / HAB / OCAB under ``prefix``."""
    _put_norm(sd, prefix + "norm1", blk["norm1"])
    _put_norm(sd, prefix + "norm2", blk["norm2"])
    _put_linear(sd, prefix + "mlp.fc1", blk["mlp"]["fc1"])
    _put_linear(sd, prefix + "mlp.fc2", blk["mlp"]["fc2"])


def _put_swin_trunk(sd: Dict[str, torch.Tensor], params_np) -> None:
    """The keys SwinIR and HAT share: conv_first, patch norm, norm,
    conv_after_body and a pixelshuffle stack (``upsample.{2i}``)."""
    _put_conv(sd, "conv_first", params_np["conv_first"])
    if "patch_norm" in params_np:
        _put_norm(sd, "patch_embed.norm", params_np["patch_norm"])
    _put_norm(sd, "norm", params_np["norm"])
    _put_conv(sd, "conv_after_body", params_np["conv_after_body"])
    for i, p in enumerate(params_np.get("upsample", ())):
        _put_conv(sd, f"upsample.{2 * i}", p)
    if "conv_before_upsample" in params_np:
        _put_conv(sd, "conv_before_upsample.0",
                  params_np["conv_before_upsample"])
    for name in ("conv_up1", "conv_up2", "conv_hr", "conv_last"):
        if name in params_np:
            _put_conv(sd, name, params_np[name])


def swinir_state_dict_from_jax(params_np: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's SwinIR pytree (numpy leaves) as the official
    SwinIR state dict: linear kernels [in, out] to [out, in], conv kernels
    HWIO to OIHW, bias tables as they are; ``swinir_from_state_dict``
    loads it."""
    sd: Dict[str, torch.Tensor] = {}
    _put_swin_trunk(sd, params_np)
    for li, layer in enumerate(params_np["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            prefix = f"layers.{li}.residual_group.blocks.{bi}."
            _put_swin_attention(sd, prefix + "attn.", blk["attn"])
            _put_block(sd, prefix, blk)
        _put_rstb_conv(sd, li, layer)
    return sd


def _put_rstb_conv(sd: Dict[str, torch.Tensor], li: int, layer) -> None:
    """An RSTB's '1conv' (``layers.{li}.conv``) or '3conv' bottleneck
    (``layers.{li}.conv.{0,2,4}``)."""
    if "conv" in layer:
        _put_conv(sd, f"layers.{li}.conv", layer["conv"])
    else:
        for j in range(3):
            _put_conv(sd, f"layers.{li}.conv.{2 * j}", layer[f"conv{j}"])


def swin2sr_state_dict_from_jax(params_np: Mapping[str, Any],
                                window_size: int
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's Swin2SR pytree (numpy leaves) as the official
    Swin2SR state dict, converted as :func:`swinir_state_dict_from_jax`:
    the qkv kernel to ``attn.qkv.weight`` with its bias cut into
    ``attn.q_bias`` and ``attn.v_bias`` (the k third must be zero), the
    CPB MLP to ``attn.cpb_mlp.{0,2}``, ``logit_scale`` as it is, and the
    aux head's ``conv_bicubic``, ``conv_aux`` and ``conv_after_aux.0``;
    ``swin2sr_from_state_dict`` loads it.  The pytree does not hold the
    window: each block also gets the geometry buffers of an official
    checkpoint at ``window_size``, from which the loader reads it."""
    geometry = geometry_buffers(window_size)
    sd: Dict[str, torch.Tensor] = {}
    _put_swin_trunk(sd, params_np)
    for name in ("conv_bicubic", "conv_aux"):
        if name in params_np:
            _put_conv(sd, name, params_np[name])
    if "conv_after_aux" in params_np:
        _put_conv(sd, "conv_after_aux.0", params_np["conv_after_aux"])
    for li, layer in enumerate(params_np["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            prefix = f"layers.{li}.residual_group.blocks.{bi}."
            attn = blk["attn"]
            bias = np.asarray(attn["qkv"]["bias"], np.float32)
            c = bias.shape[0] // 3
            if np.any(bias[c:2 * c] != 0):
                raise ValueError(f"{prefix}attn: a SwinV2 qkv bias has no k "
                                 "part, but this one's is not zero")
            sd[prefix + "attn.qkv.weight"] = _t(
                np.asarray(attn["qkv"]["kernel"], np.float32).T)
            sd[prefix + "attn.q_bias"] = _t(bias[:c])
            sd[prefix + "attn.v_bias"] = _t(bias[2 * c:])
            _put_linear(sd, prefix + "attn.proj", attn["proj"])
            sd[prefix + "attn.logit_scale"] = _t(attn["logit_scale"])
            _put_linear(sd, prefix + "attn.cpb_mlp.0", attn["cpb_fc1"])
            sd[prefix + "attn.cpb_mlp.2.weight"] = _t(
                np.asarray(attn["cpb_fc2"]["kernel"], np.float32).T)
            for name, buf in geometry.items():
                sd[prefix + "attn." + name] = buf.clone()
            _put_block(sd, prefix, blk)
        _put_rstb_conv(sd, li, layer)
    return sd


def hat_state_dict_from_jax(params_np: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's HAT pytree (numpy leaves) as the official HAT
    state dict, converted as :func:`swinir_state_dict_from_jax`; the CAB's
    convs go to ``conv_block.cab.{0,2}`` and its channel attention to
    ``cab.3.attention.{1,3}``; ``hat_from_state_dict`` loads it."""
    sd: Dict[str, torch.Tensor] = {}
    _put_swin_trunk(sd, params_np)
    for li, layer in enumerate(params_np["layers"]):
        group = f"layers.{li}.residual_group."
        for bi, blk in enumerate(layer["blocks"]):
            prefix = f"{group}blocks.{bi}."
            _put_swin_attention(sd, prefix + "attn.", blk["attn"])
            _put_block(sd, prefix, blk)
            cab = blk["conv_block"]
            _put_conv(sd, prefix + "conv_block.cab.0", cab["conv1"])
            _put_conv(sd, prefix + "conv_block.cab.2", cab["conv2"])
            _put_conv(sd, prefix + "conv_block.cab.3.attention.1",
                      cab["attn"]["down"])
            _put_conv(sd, prefix + "conv_block.cab.3.attention.3",
                      cab["attn"]["up"])
        ocab = layer["overlap_attn"]
        _put_swin_attention(sd, group + "overlap_attn.", ocab)
        _put_block(sd, group + "overlap_attn.", ocab)
        _put_conv(sd, f"layers.{li}.conv", layer["conv"])
    return sd


def srvgg_state_dict_from_jax(params_np: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's Compact pytree (numpy leaves) as the official
    state dict: ``conv{i}`` to ``body.{2i}``, the PReLU slopes ``act{i}``
    to ``body.{2i + 1}.weight``, ``conv_last`` to the last ``body`` entry;
    ``srvgg_from_state_dict`` loads it."""
    sd: Dict[str, torch.Tensor] = {}
    n = sum(1 for k in params_np if k.startswith("conv") and k[4:].isdigit())
    for i in range(n):
        _put_conv(sd, f"body.{2 * i}", params_np[f"conv{i}"])
        if f"act{i}" in params_np:
            sd[f"body.{2 * i + 1}.weight"] = _t(params_np[f"act{i}"])
    _put_conv(sd, f"body.{2 * n}", params_np["conv_last"])
    return sd


def span_state_dict_from_jax(params_np: Mapping[str, Any], *,
                             norm: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX package's SPAN pytree (numpy leaves, Conv3XC already fused)
    as the port's fused layout: each fused conv to ``<name>.eval_conv``,
    ``conv_cat`` and ``upsampler.0`` as they are, a ``no_norm`` entry
    without the input normalization; ``span_from_state_dict`` loads it."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params_np.items():
        if name.startswith("block_"):
            for conv, q in p.items():
                _put_conv(sd, f"{name}.{conv}.eval_conv", q)
        elif name in ("conv_1", "conv_2"):
            _put_conv(sd, f"{name}.eval_conv", p)
        else:
            _put_conv(sd, "upsampler.0" if name == "upsampler" else name, p)
    if not norm:
        sd["no_norm"] = torch.zeros(1)
    return sd


def realplksr_state_dict_from_jax(params_np: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's RealPLKSR pytree (numpy leaves) as the official
    state dict: ``conv_first`` to ``feats.0``, block i to ``feats.{i+1}``
    (``channel_mixer.{0,2}``, ``lk.conv``, ``attn.f.0``, ``refine``,
    ``norm``), ``conv_last`` to ``feats.{n+2}``, a DySample head to
    ``to_img.*`` (the scope conv without its zero bias);
    ``realplksr_from_state_dict`` loads it."""
    sd: Dict[str, torch.Tensor] = {}
    blocks = params_np["blocks"]
    _put_conv(sd, "feats.0", params_np["conv_first"])
    names = {"mix0": "channel_mixer.0", "mix1": "channel_mixer.2",
             "lk": "lk.conv", "ea": "attn.f.0", "refine": "refine"}
    for i, blk in enumerate(blocks):
        for key, name in names.items():
            if key in blk:
                _put_conv(sd, f"feats.{i + 1}.{name}", blk[key])
        _put_norm(sd, f"feats.{i + 1}.norm", blk["norm"])
    _put_conv(sd, f"feats.{len(blocks) + 2}", params_np["conv_last"])
    head = params_np.get("to_img")
    if head is not None:
        _put_conv(sd, "to_img.offset", head["offset"])
        if head.get("scope") is not None:
            _put_conv(sd, "to_img.scope", head["scope"])
            del sd["to_img.scope.bias"]
        _put_conv(sd, "to_img.end_conv", head["end_conv"])
        sd["to_img.init_pos"] = _t(head["init_pos"]).reshape(1, -1, 1, 1)
    return sd
