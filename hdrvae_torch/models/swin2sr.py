"""Swin2SR super-resolution on PyTorch, NHWC at the boundaries, as
``hdrvae/models/swin2sr.py``.

SwinIR's skeleton (conv_first -> patch LayerNorm -> RSTB stack -> LayerNorm
-> conv_after_body + the shallow feature -> head) with SwinV2 blocks:

- cosine attention: q and k rows L2-normalized per head, the similarity
  times a learned per-head ``logit_scale`` (exp, clamped at 100);
- a continuous position bias: a two-layer MLP maps log-spaced relative
  coordinates to per-head biases, through 16 * sigmoid (no bias table);
- qkv without a Linear bias: ``q_bias`` and ``v_bias`` (k's is zero);
- res-post-norm: LayerNorm on the attention and MLP branch OUTPUTS.

Five heads: ``pixelshuffle`` (classical SR), ``pixelshuffle_aux``
(compressed-input SR: a bicubic skip of the input through
``conv_bicubic`` joins the pixel-shuffle path, an auxiliary image bounced
through ``conv_aux`` / ``conv_after_aux``), ``pixelshuffledirect``
(lightweight), ``nearest+conv`` (real-world x4) and ``""`` (the JPEG-CAR
restoration family, scale 1, ``img_range`` 255, window 7).

:class:`Swin2SR` is an ``nn.Module`` whose parameter names are the official
checkpoint keys (the coords table and index buffers are recomputed
statics); :func:`swin2sr_apply` runs it.  Each block runs as K7's v2 body
(``kernels/swin_attention.py``) on a CUDA tensor in the fast tier, else as
the unfused layers, as SwinIR does.  The HuggingFace ``transformers``
export loads through :func:`hf_swin2sr_to_original`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels.swin_attention import (BlockWeights, prepare_block,
                                                 use_swin_kernel)
from hdrvae_torch.models.layers import conv2d, nearest_upsample_2x
from hdrvae_torch.models.swinir import (_BLOCK_RE, RSTB, Mlp, PatchEmbed,
                                        _conv, _rstb_conv, _shape,
                                        _shuffle_stack,
                                        finish_output, fused_block,
                                        gather_bias, init_weights, layer_norm,
                                        linear, load_module, lrelu, matmul,
                                        mlp, prepare_input,
                                        relative_position_index,
                                        shift_attn_mask, shuffle_head,
                                        shuffle_scale, window_merge,
                                        window_partition)
from hdrvae_torch.upscale.resize import bicubic_torch

_log = logging.getLogger(__name__)

UPSAMPLERS = ("pixelshuffle", "pixelshuffle_aux", "pixelshuffledirect",
              "nearest+conv", "")

CPB_HIDDEN = 512           # the SwinV2 position MLP's width
LOGIT_MAX = math.log(100.0)


@dataclasses.dataclass(frozen=True)
class Swin2SRConfig:
    in_channels: int = 3
    out_channels: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upsampler: str = "pixelshuffle"
    resi_connection: str = "1conv"
    patch_norm: bool = True
    num_feat: int = 64          # upsampler intermediate width
    scale: int = 4
    img_range: float = 1.0

    def with_small(self) -> "Swin2SRConfig":
        """A tiny config for tests (fast on one CPU core)."""
        return dataclasses.replace(
            self, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
            window_size=4, num_feat=8, scale=2)


# ---------------------------------------------------------------------------
# Modules (official key schema)
# ---------------------------------------------------------------------------


class WindowAttentionV2(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.zeros(heads, 1, 1))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False))
        self.proj = nn.Linear(dim, dim)


class Swin2Block(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttentionV2(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


class Swin2SR(nn.Module):
    """The network's weights under the official names; :func:`swin2sr_apply`
    runs it."""

    def __init__(self, cfg: Swin2SRConfig = Swin2SRConfig()):
        super().__init__()
        if cfg.upsampler not in UPSAMPLERS:
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        if cfg.upsampler == "nearest+conv" and cfg.scale != 4:
            raise ValueError("Swin2SR's nearest+conv head is x4 only")
        self.cfg = cfg
        dim, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = _conv(cfg.in_channels, dim)
        self.patch_embed = PatchEmbed(dim, cfg.patch_norm)
        self.layers = nn.ModuleList(RSTB(cfg, li, Swin2Block)
                                    for li in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = _conv(dim, dim)
        up = cfg.upsampler
        if up in ("pixelshuffle", "pixelshuffle_aux", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(_conv(dim, nf),
                                                      nn.LeakyReLU())
        if up == "pixelshuffle_aux":
            self.conv_bicubic = _conv(cfg.in_channels, nf)
            self.conv_aux = _conv(nf, cfg.out_channels)
            self.conv_after_aux = nn.Sequential(_conv(3, nf), nn.LeakyReLU())
        if up in ("pixelshuffle", "pixelshuffle_aux"):
            self.upsample = _shuffle_stack(nf, cfg.scale)
            self.conv_last = _conv(nf, cfg.out_channels)
        elif up == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                _conv(dim, cfg.out_channels * cfg.scale ** 2),
                nn.PixelShuffle(cfg.scale))
        elif up == "nearest+conv":
            self.conv_up1 = _conv(nf, nf)
            self.conv_up2 = _conv(nf, nf)
            self.conv_hr = _conv(nf, nf)
            self.conv_last = _conv(nf, cfg.out_channels)
        elif up == "":
            self.conv_last = _conv(dim, cfg.out_channels)


# ---------------------------------------------------------------------------
# SwinV2 attention
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cpb_coords_np(ws: int) -> np.ndarray:
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    t = t / (ws - 1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


def cpb_coords_table(ws: int) -> torch.Tensor:
    """[(2ws-1)^2, 2] log-spaced relative coordinates in [-1, 1]: SwinV2's
    sign(t) log2(|8 t| + 1) / log2(8), t normalized by ws - 1 (the
    checkpoint's own window; pretrained window 0)."""
    return torch.from_numpy(_cpb_coords_np(ws))


def geometry_buffers(ws: int) -> Dict[str, torch.Tensor]:
    """The statics an official checkpoint carries in every block's
    ``attn.``: the coords table [1, 2ws-1, 2ws-1, 2] and the relative
    position index [ws*ws, ws*ws] (the loader reads the window from
    them)."""
    return {"relative_coords_table":
            cpb_coords_table(ws).reshape(1, 2 * ws - 1, 2 * ws - 1, 2),
            "relative_position_index": relative_position_index(ws)}


def _cached(attn: WindowAttentionV2, key, make):
    cache = attn.__dict__.setdefault("_derived", {})
    if key not in cache:
        with torch.no_grad():
            cache[key] = make()
    return cache[key]


def cpb_bias(attn: WindowAttentionV2, ws: int) -> torch.Tensor:
    """The continuous position bias [heads, N, N]: 16 sigmoid(cpb_mlp(coords))
    gathered by the v1 relative-position index, in float32 with TF32 off,
    computed once per block and device and kept on the module."""
    def make():
        dev = attn.proj.weight.device
        t = cpb_coords_table(ws).to(dev)
        fc1, fc2 = attn.cpb_mlp[0], attn.cpb_mlp[2]
        with fp32_contractions(Precision.parity()):
            h1 = torch.relu(t @ fc1.weight.float().t() + fc1.bias.float())
            tbl = h1 @ fc2.weight.float().t()           # [(2ws-1)^2, heads]
        return 16.0 * torch.sigmoid(gather_bias(tbl,
                                                relative_position_index(ws)))
    return _cached(attn, ("cpb", str(attn.proj.weight.device)), make)


def qk_scale(attn: WindowAttentionV2) -> torch.Tensor:
    """exp(min(logit_scale, log 100)), float32 [heads, 1, 1]."""
    return torch.exp(torch.clamp(attn.logit_scale.float(), max=LOGIT_MAX))


def qkv_bias(attn: WindowAttentionV2) -> torch.Tensor:
    """[q_bias, 0, v_bias]: SwinV2 has no k bias."""
    return torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                      attn.v_bias])


def window_attention_v2(x: torch.Tensor, attn: WindowAttentionV2,
                        heads: int, ws: int, mask: Optional[torch.Tensor],
                        precision: Precision) -> torch.Tensor:
    """Cosine window attention on windows x [nWB, N, C]: qkv (in the
    storage dtype), q / k normalized in float32, scores in float32 times
    the clamped logit scale, + CPB bias (+ shift mask), float32 softmax,
    values, proj (``swin2sr._window_attention_v2``)."""
    nwb, n, c = x.shape
    hd = c // heads
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    with fp32_contractions(precision):
        qkv = x.to(cdt).float() @ attn.qkv.weight.to(cdt).float().t()
    qkv = (qkv + qkv_bias(attn).float()).to(sdt)
    qkv = qkv.reshape(nwb, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qf, kf, v = qkv[0].float(), qkv[1].float(), qkv[2]
    qf = qf / torch.linalg.vector_norm(qf, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    kf = kf / torch.linalg.vector_norm(kf, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    s = matmul(qf, kf.transpose(-1, -2), precision) * qk_scale(attn)[None]
    s = s + cpb_bias(attn, ws)[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(nwb // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(nwb, heads, n, n)
    p = torch.softmax(s, dim=-1)
    out = matmul(p, v, precision).permute(0, 2, 1, 3).reshape(nwb, n, c)
    return linear(out.to(sdt), attn.proj, precision)


def block_weights_v2(blk: Swin2Block, heads: int, ws: int,
                     dtype: torch.dtype) -> BlockWeights:
    """K7's v2 weights of a SwinV2 block (CPB bias, q scales, the qkv bias
    with its zero k third), prepared once per compute dtype and device and
    kept on the module: the network is read-only."""
    attn = blk.attn
    return _cached(attn, (dtype, str(blk.norm1.weight.device)),
                   lambda: prepare_block(
                       attn, blk.norm1, blk.norm2, blk.mlp, heads,
                       cpb_bias(attn, ws), dtype, qkv_bias=qkv_bias(attn),
                       post_norm=True, qk_scale=qk_scale(attn)))


def swin2_block(x: torch.Tensor, blk: Swin2Block, heads: int, ws: int,
                shift: int, precision: Precision) -> torch.Tensor:
    """One SwinV2 block (res-post-norm) on an NHWC grid (H, W multiples of
    ws): K7's v2 body where the gate allows, else the unfused layers."""
    b, h, w, c = x.shape
    if use_swin_kernel(precision, x, h, w, ws, c // heads):
        # no pre-norm: the rolled x is the kernel's input and residual
        return fused_block(x, block_weights_v2(blk, heads, ws,
                                               precision.compute_dtype),
                           ws, shift, precision)
    y = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x
    mask = shift_attn_mask(h, w, ws, shift, x.device) if shift else None
    y = window_merge(window_attention_v2(window_partition(y, ws), blk.attn,
                                         heads, ws, mask, precision),
                     ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + layer_norm(y, blk.norm1)
    return x + layer_norm(mlp(x, blk.mlp, precision), blk.norm2)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@torch.no_grad()
def swin2sr_apply(net: Swin2SR, x: torch.Tensor, *,
                  precision: Precision = Precision()) -> torch.Tensor:
    """Upscale NHWC [B, H, W, C] -> [B, scale*H, scale*W, C]: the official
    forward with reflect padding to window multiples and a crop."""
    cfg = net.cfg
    ws, s = cfg.window_size, cfg.scale
    h0, w0 = x.shape[1], x.shape[2]
    # float32: the aux head's bicubic skip and the '' head's residual
    x_in = prepare_input(x, ws, cfg.in_channels, cfg.img_range, Precision())
    x = x_in.to(precision.storage_dtype)
    feat = conv2d(x, net.conv_first, precision=precision)
    tok = feat
    if cfg.patch_norm:
        tok = layer_norm(tok, net.patch_embed.norm)
    for li, layer in enumerate(net.layers):
        y = tok
        for bi, blk in enumerate(layer.residual_group.blocks):
            y = swin2_block(y, blk, cfg.num_heads[li], ws,
                            0 if bi % 2 == 0 else ws // 2, precision)
        tok = _rstb_conv(y, layer.conv, precision) + tok
    tok = layer_norm(tok, net.norm)
    feat = feat + conv2d(tok, net.conv_after_body, precision=precision)

    def conv(t, c):
        return conv2d(t, c, precision=precision)

    up = cfg.upsampler
    if up in ("pixelshuffle", "pixelshuffle_aux", "nearest+conv"):
        # LeakyReLU of torch's default slope 0.01 (SwinIR has a ReLU here)
        y = lrelu(conv(feat, net.conv_before_upsample[0]), 0.01)
    if up == "pixelshuffle":
        y = conv(shuffle_head(y, net.upsample, precision), net.conv_last)
    elif up == "pixelshuffle_aux":
        bic = conv(bicubic_torch(x_in, h0 * s, w0 * s), net.conv_bicubic)
        y = lrelu(conv(conv(y, net.conv_aux), net.conv_after_aux[0]), 0.01)
        y = shuffle_head(y, net.upsample, precision)
        y = y[:, :h0 * s, :w0 * s].float() + bic.float()
        y = conv(y.to(precision.storage_dtype), net.conv_last)
    elif up == "pixelshuffledirect":
        y = shuffle_head(feat, net.upsample, precision)
    elif up == "nearest+conv":
        # the up / hr convs take the network's own LeakyReLU of slope 0.2
        y = lrelu(conv(nearest_upsample_2x(y), net.conv_up1), 0.2)
        y = lrelu(conv(nearest_upsample_2x(y), net.conv_up2), 0.2)
        y = conv(lrelu(conv(y, net.conv_hr), 0.2), net.conv_last)
    else:   # restoration head (scale 1): conv_last over the body + input
        y = x_in + conv(feat, net.conv_last).float()
    return finish_output(y, h0, w0, s, cfg.in_channels, cfg.img_range)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _draw_v2(name: str, shape, rng) -> Optional[np.ndarray]:
    """Non-trivial SwinV2 attention parameters for a seeded init: logit
    scales exp(U(log 5, log 150)) (some past the clamp at 100), q and v
    biases N(0, 0.02), and a CPB MLP wide enough that 16 sigmoid(.) spans
    its range."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "logit_scale":
        return rng.uniform(np.log(5.0), np.log(150.0), shape)
    if leaf in ("q_bias", "v_bias"):
        return rng.standard_normal(shape) * 0.02
    if ".cpb_mlp.0." in name:
        return rng.standard_normal(shape) * (1.0 if leaf == "weight" else 0.5)
    if ".cpb_mlp.2." in name:
        return rng.standard_normal(shape) * CPB_HIDDEN ** -0.5
    return None


def init_swin2sr(cfg: Swin2SRConfig = Swin2SRConfig(), seed: int = 0, *,
                 device: torch.device | str = "cuda") -> Swin2SR:
    """A randomly initialized Swin2SR (``models.swinir.init_weights``, with
    the SwinV2 attention parameters of :func:`_draw_v2`)."""
    return init_weights(Swin2SR, cfg, seed, device, draw=_draw_v2)


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def is_hf_swin2sr_state_dict(sd: Mapping[str, Any]) -> bool:
    """The ``transformers`` export (``swin2sr.``-prefixed keys)."""
    return "swin2sr.first_convolution.weight" in sd


def is_swin2sr_state_dict(sd: Mapping[str, Any]) -> bool:
    """SwinIR's residual_group.blocks spine with SwinV2 attention
    (``attn.logit_scale``), or the ``transformers`` export."""
    if is_hf_swin2sr_state_dict(sd):
        return True
    return any(_BLOCK_RE.match(k) for k in sd) and any(
        k.endswith(".attn.logit_scale") for k in sd)


def _check_identity_projection(w: np.ndarray, b: Optional[np.ndarray],
                               key: str) -> None:
    """The HF port adds 1x1 'projection' convs to the patch embedding that
    the original network does not have; converted checkpoints carry them as
    the identity.  Any other one cannot be mapped, and is refused rather
    than dropped."""
    c = w.shape[0]
    ident = np.eye(c, dtype=np.float32).reshape(c, c, 1, 1)
    if w.shape != (c, c, 1, 1) or not np.allclose(w, ident, atol=1e-5) \
            or (b is not None and not np.allclose(b, 0.0, atol=1e-5)):
        raise ValueError(
            f"HF Swin2SR checkpoint has a non-identity patch 'projection' "
            f"conv ({key}); the original Swin2SR network has no such layer, "
            "so this checkpoint cannot be mapped onto it")


_HF_STATIC = {
    "swin2sr.first_convolution": "conv_first",
    "swin2sr.embeddings.patch_embeddings.layernorm": "patch_embed.norm",
    "swin2sr.layernorm": "norm",
    "swin2sr.conv_after_body": "conv_after_body",
    # heads (only the keys of the checkpoint's head are present)
    "upsample.conv_before_upsample": "conv_before_upsample.0",
    "upsample.final_convolution": "conv_last",
    "upsample.conv": "upsample.0",                  # pixelshuffledirect
    "upsample.conv_up1": "conv_up1",
    "upsample.conv_up2": "conv_up2",
    "upsample.conv_hr": "conv_hr",
    "upsample.conv_bicubic": "conv_bicubic",
    "upsample.conv_aux": "conv_aux",
    "upsample.conv_after_aux.0": "conv_after_aux.0",
    "upsample.upsample.convolution": "upsample.0",  # the x3 chain
    "final_convolution": "conv_last",               # '' restoration head
}
_HF_BLOCK = {
    "attention.output.dense": "attn.proj",
    "attention.self.logit_scale": "attn.logit_scale",
    "attention.self.continuous_position_bias_mlp.0": "attn.cpb_mlp.0",
    "attention.self.continuous_position_bias_mlp.2": "attn.cpb_mlp.2",
    "layernorm_before": "norm1",
    "layernorm_after": "norm2",
    "intermediate.dense": "mlp.fc1",
    "output.dense": "mlp.fc2",
}
_HF_STAGE = re.compile(r"^swin2sr\.encoder\.stages\.(\d+)\.(.+)$")
_HF_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")
_HF_UP = re.compile(r"^upsample\.upsample\.convolution_(\d+)\.(weight|bias)$")


def hf_swin2sr_to_original(sd: Mapping[str, Any],
                           window_size: Optional[int] = None
                           ) -> Dict[str, np.ndarray]:
    """A ``transformers`` Swin2SRForImageSuperResolution state dict in the
    official key schema (numpy float32), as the JAX converter.  The HF
    export carries no geometry buffers: the window is 8 (every public SR
    family) or, for the JPEG-CAR head, 7, unless ``window_size`` is given;
    a coords-table entry of that window is emitted for the loader."""
    if not is_hf_swin2sr_state_dict(sd):
        raise ValueError("not an HF-transformers Swin2SR state dict")
    if "swin2sr.embeddings.position_embeddings" in sd:
        raise ValueError("Swin2SR checkpoints with ape=True (absolute "
                         "position embedding) are not supported")
    out: Dict[str, np.ndarray] = {}
    qkv_parts: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        base, _, leaf = key.rpartition(".")
        if base.endswith(("patch_embeddings.projection",
                          "patch_embed.projection")):
            if leaf == "weight":
                bias = sd.get(base + ".bias")
                _check_identity_projection(
                    _np(val), None if bias is None else _np(bias), key)
            continue
        if base in _HF_STATIC:
            out[f"{_HF_STATIC[base]}.{leaf}"] = _np(val)
            continue
        m = _HF_UP.match(key)
        if m:   # the 2^k pixel-shuffle chain: convolution_i -> upsample.2i
            out[f"upsample.{2 * int(m.group(1))}.{m.group(2)}"] = _np(val)
            continue
        m = _HF_STAGE.match(key)
        if not m:
            raise ValueError(f"unrecognized HF Swin2SR key: {key}")
        li, rest = int(m.group(1)), m.group(2)
        if rest.startswith("conv."):             # the 3conv residual
            out[f"layers.{li}.{rest}"] = _np(val)
            continue
        mb = _HF_LAYER.match(rest)
        if not mb:
            raise ValueError(f"unrecognized HF Swin2SR key: {key}")
        pfx = f"layers.{li}.residual_group.blocks.{int(mb.group(1))}."
        brest = mb.group(2)
        bbase, _, bleaf = brest.rpartition(".")
        if bbase in ("attention.self.query", "attention.self.key",
                     "attention.self.value"):
            qkv_parts.setdefault(pfx, {})[
                f"{bbase.rsplit('.', 1)[1]}.{bleaf}"] = _np(val)
        elif bbase in _HF_BLOCK:
            out[f"{pfx}{_HF_BLOCK[bbase]}.{bleaf}"] = _np(val)
        elif brest in _HF_BLOCK:                 # leaf-less (logit_scale)
            out[f"{pfx}{_HF_BLOCK[brest]}"] = _np(val)
        else:
            raise ValueError(f"unrecognized HF Swin2SR key: {key}")
    for pfx, parts in qkv_parts.items():
        out[pfx + "attn.qkv.weight"] = np.concatenate(
            [parts["query.weight"], parts["key.weight"],
             parts["value.weight"]], axis=0)
        out[pfx + "attn.q_bias"] = parts["query.bias"]
        out[pfx + "attn.v_bias"] = parts["value.bias"]
    if window_size is None:
        restoration = "conv_last.weight" in out and not any(
            k in out for k in ("conv_before_upsample.0.weight",
                               "upsample.0.weight", "conv_up1.weight"))
        window_size = 7 if restoration else 8
        _log.info("HF Swin2SR checkpoint carries no geometry buffers; "
                  "assuming window_size=%d (pass window_size to override)",
                  window_size)
    out["layers.0.residual_group.blocks.0.attn.relative_coords_table"] = \
        np.zeros((1, 2 * window_size - 1, 2 * window_size - 1, 2),
                 np.float32)
    return out


def _window_size(sd: Mapping[str, Any]) -> int:
    """From the coords table, else the index, else 8 (every public SR
    family; the JPEG-CAR family uses 7)."""
    b0 = "layers.0.residual_group.blocks.0.attn."
    if b0 + "relative_coords_table" in sd:
        return (int(sd[b0 + "relative_coords_table"].shape[1]) + 1) // 2
    if b0 + "relative_position_index" in sd:
        return int(round(np.sqrt(sd[b0 + "relative_position_index"]
                                 .shape[0])))
    _log.warning("Swin2SR checkpoint carries no geometry buffers; assuming "
                 "window_size=8 (every public SR family; the JPEG-CAR family "
                 "uses 7)")
    return 8


def swin2sr_from_state_dict(sd: Mapping[str, Any],
                            img_range: Optional[float] = None, *,
                            device: torch.device | str = "cuda"
                            ) -> Tuple[Swin2SR, Swin2SRConfig]:
    """(network on ``device``, config) from the official Swin2SR schema or
    its ``transformers`` export, every hyperparameter inferred from shapes
    and keys as the JAX loader does.  ``img_range`` is not stored in
    checkpoints: 1.0 for every SR head, 255.0 for the scale-1 ``""`` head
    (the JPEG-CAR family).  ``ape`` and ``pixelshuffle_hf`` checkpoints
    are refused."""
    if not is_swin2sr_state_dict(sd):
        raise ValueError("not a Swin2SR state dict")
    if is_hf_swin2sr_state_dict(sd):
        sd = hf_swin2sr_to_original(sd)
    if "absolute_pos_embed" in sd:
        raise ValueError("Swin2SR checkpoints with ape=True (absolute "
                         "position embedding) are not supported")
    if any(k.startswith(("conv_first_hf.", "layers_hf.")) for k in sd):
        raise ValueError(
            "Swin2SR 'pixelshuffle_hf' (high-frequency branch) checkpoints "
            "are not supported; supported heads: "
            f"{', '.join(repr(u) for u in UPSAMPLERS)}")
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := _BLOCK_RE.match(k)))
    depths = tuple(
        1 + max(int(m.group(2)) for k in sd
                if (m := _BLOCK_RE.match(k)) and int(m.group(1)) == li)
        for li in range(n_layers))
    shape = lambda k: _shape(sd, k, "Swin2SR")   # noqa: E731
    embed_dim, in_ch = shape("conv_first.weight")[:2]
    num_heads = tuple(shape(f"layers.{li}.residual_group.blocks.0.attn."
                            "logit_scale")[0] for li in range(n_layers))
    fc1 = shape("layers.0.residual_group.blocks.0.mlp.fc1.weight")
    if "conv_bicubic.weight" in sd:
        upsampler = "pixelshuffle_aux"
        num_feat = shape("conv_bicubic.weight")[0]
        scale = shuffle_scale(sd, num_feat)
    elif "conv_up1.weight" in sd:
        upsampler, num_feat = "nearest+conv", shape("conv_up1.weight")[0]
        scale = 4
    elif "conv_before_upsample.0.weight" in sd:
        upsampler = "pixelshuffle"
        num_feat = shape("conv_before_upsample.0.weight")[0]
        scale = shuffle_scale(sd, num_feat)
    elif "upsample.0.weight" in sd:
        upsampler, num_feat = "pixelshuffledirect", embed_dim
        scale = int(round(np.sqrt(shape("upsample.0.weight")[0] // in_ch)))
    else:
        upsampler, num_feat, scale = "", embed_dim, 1
    out_ch = in_ch if upsampler == "pixelshuffledirect" else \
        shape("conv_last.weight")[0]
    if img_range is None:
        img_range = 255.0 if upsampler == "" else 1.0
        if upsampler == "":
            _log.info("scale-1 Swin2SR checkpoint: assuming the JPEG-CAR "
                      "family's img_range=255.0 (pass img_range to "
                      "override)")
    cfg = Swin2SRConfig(
        in_channels=in_ch, out_channels=out_ch, embed_dim=embed_dim,
        depths=depths, num_heads=num_heads, window_size=_window_size(sd),
        mlp_ratio=fc1[0] / embed_dim, upsampler=upsampler,
        resi_connection="3conv" if "layers.0.conv.0.weight" in sd
        else "1conv", patch_norm="patch_embed.norm.weight" in sd,
        num_feat=num_feat, scale=scale, img_range=img_range)
    with torch.device("meta"):
        net = Swin2SR(cfg)
    return load_module(net, sd, "Swin2SR", device), cfg
