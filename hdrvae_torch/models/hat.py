"""HAT (Hybrid Attention Transformer) super-resolution on PyTorch, NHWC at
the boundaries, as ``hdrvae/models/hat.py``.

  - HAB blocks: SwinIR's shifted-window attention plus a parallel Channel
    Attention Block off the same LayerNorm, ``x + attn + conv_scale * cab``
    then the MLP; on a CUDA tensor in the fast tier the whole HAB past the
    CAB convs is one K7 launch with the rolled CAB branch as its ``extra``
    residual;
  - one OCAB per residual group: queries from ws-windows, keys and values
    from overlapping ``ws * (1 + overlap_ratio)`` windows (an unfold), its
    attention core K8 (``kernels/ocab.py``) in the fast tier on a CUDA
    tensor;
  - the pixelshuffle head, with HAT's LeakyReLU(0.01) after
    conv_before_upsample (SwinIR has a ReLU there).

:class:`HAT` holds the weights under the official ``hat_arch.py`` names;
:func:`hat_apply` runs it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels.ocab import HDP, ocab_attention, use_ocab_kernel
from hdrvae_torch.kernels.swin_attention import use_swin_kernel
from hdrvae_torch.models.layers import conv2d
from hdrvae_torch.models.swinir import (Mlp, PatchEmbed, WindowAttention,
                                        _conv, _shape, _shuffle_stack,
                                        block_weights, finish_output,
                                        fused_block, gather_bias, gelu,
                                        init_weights, layer_norm, linear,
                                        load_module, lrelu, matmul, mlp,
                                        prepare_input, shift_attn_mask,
                                        shuffle_head, shuffle_scale, spine,
                                        window_attention, window_merge,
                                        window_partition)


@dataclasses.dataclass(frozen=True)
class HATConfig:
    in_channels: int = 3
    out_channels: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 16
    compress_ratio: int = 3
    squeeze_factor: int = 30
    # the CAB's mixing weight: an architecture constant, never stored in
    # checkpoints
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    mlp_ratio: float = 2.0
    upsampler: str = "pixelshuffle"
    resi_connection: str = "1conv"
    patch_norm: bool = True
    num_feat: int = 64
    scale: int = 4
    img_range: float = 1.0

    @property
    def overlap_win_size(self) -> int:
        return int(self.window_size * self.overlap_ratio) + self.window_size

    def with_small(self) -> "HATConfig":
        """A tiny config for tests (fast on one CPU core)."""
        return dataclasses.replace(
            self, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
            window_size=4, compress_ratio=2, squeeze_factor=4,
            num_feat=8, scale=2)


# ---------------------------------------------------------------------------
# Modules (official key schema)
# ---------------------------------------------------------------------------


class ChannelAttention(nn.Module):
    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), _conv(dim, dim // squeeze, 1), nn.ReLU(),
            _conv(dim // squeeze, dim, 1), nn.Sigmoid())


class CAB(nn.Module):
    def __init__(self, dim: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(
            _conv(dim, dim // compress), nn.GELU(),
            _conv(dim // compress, dim), ChannelAttention(dim, squeeze))


class HAB(nn.Module):
    def __init__(self, cfg: HATConfig, heads: int):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, cfg.window_size)
        self.conv_block = CAB(dim, cfg.compress_ratio, cfg.squeeze_factor)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))


class OCAB(nn.Module):
    def __init__(self, cfg: HATConfig, heads: int):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (cfg.window_size + cfg.overlap_win_size - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))


class AttenBlocks(nn.Module):
    def __init__(self, cfg: HATConfig, li: int):
        super().__init__()
        heads = cfg.num_heads[li]
        self.blocks = nn.ModuleList(HAB(cfg, heads)
                                    for _ in range(cfg.depths[li]))
        self.overlap_attn = OCAB(cfg, heads)


class RHAG(nn.Module):
    def __init__(self, cfg: HATConfig, li: int):
        super().__init__()
        self.residual_group = AttenBlocks(cfg, li)
        self.conv = _conv(cfg.embed_dim, cfg.embed_dim)


class HAT(nn.Module):
    """The network's weights under the official names; :func:`hat_apply`
    runs it."""

    def __init__(self, cfg: HATConfig = HATConfig()):
        super().__init__()
        if cfg.upsampler != "pixelshuffle":
            raise ValueError(f"HAT ships only the pixelshuffle head, got "
                             f"{cfg.upsampler!r}")
        self.cfg = cfg
        dim, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = _conv(cfg.in_channels, dim)
        self.patch_embed = PatchEmbed(dim, cfg.patch_norm)
        self.layers = nn.ModuleList(RHAG(cfg, li)
                                    for li in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = _conv(dim, dim)
        self.conv_before_upsample = nn.Sequential(_conv(dim, nf),
                                                  nn.LeakyReLU())
        self.upsample = _shuffle_stack(nf, cfg.scale)
        self.conv_last = _conv(nf, cfg.out_channels)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rpi_oca_np(ws: int, wse: int) -> np.ndarray:
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                              indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(wse), np.arange(wse),
                              indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= ws + wse - 1
    return rel.sum(-1)


def rpi_oca(ws: int, wse: int) -> torch.Tensor:
    """[ws*ws, wse*wse] indices into the (ws + wse - 1)^2 OCAB bias table
    (the official ``calculate_rpi_oca``)."""
    return torch.from_numpy(_rpi_oca_np(ws, wse))


def _channel_attention(x: torch.Tensor, ca: ChannelAttention,
                       precision: Precision) -> torch.Tensor:
    """Squeeze-and-excitation: global mean -> 1x1 conv -> ReLU -> 1x1 conv
    -> sigmoid gate."""
    pooled = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
    y = torch.relu(conv2d(pooled, ca.attention[1], precision=precision))
    y = conv2d(y, ca.attention[3], precision=precision)
    return x * torch.sigmoid(y.float()).to(x.dtype)


def _cab(x: torch.Tensor, cab: CAB, precision: Precision) -> torch.Tensor:
    """3x3 conv (C -> C / compress) -> GELU -> 3x3 conv -> channel
    attention."""
    y = gelu(conv2d(x, cab.cab[0], precision=precision), precision)
    y = conv2d(y, cab.cab[2], precision=precision)
    return _channel_attention(y, cab.cab[3], precision)


def _hab(x: torch.Tensor, blk: HAB, cfg: HATConfig, heads: int, shift: int,
         precision: Precision) -> torch.Tensor:
    """One HAB: window attention and the CAB in parallel off norm1,
    ``shortcut + attn + conv_scale * cab``, then the MLP."""
    b, h, w, c = x.shape
    ws = cfg.window_size
    y = layer_norm(x, blk.norm1)
    conv_x = _cab(y, blk.conv_block, precision)
    if use_swin_kernel(precision, x, h, w, ws, c // heads):
        # past the CAB convs every piece is pointwise per token, so the
        # rest of the HAB runs as K7 in rolled space, the scaled CAB branch
        # its extra residual
        return fused_block(
            x, block_weights(blk, heads, ws, precision.compute_dtype), ws,
            shift, precision, extra=(conv_x * cfg.conv_scale).to(x.dtype))
    ya = torch.roll(y, (-shift, -shift), dims=(1, 2)) if shift else y
    mask = shift_attn_mask(h, w, ws, shift, x.device) if shift else None
    ya = window_merge(window_attention(window_partition(ya, ws), blk.attn,
                                       heads, ws, mask, precision), ws, h, w)
    if shift:
        ya = torch.roll(ya, (shift, shift), dims=(1, 2))
    x = x + ya + conv_x * cfg.conv_scale
    return x + mlp(layer_norm(x, blk.norm2), blk.mlp, precision)


def _unfold_overlap(kv: torch.Tensor, ws: int, wse: int) -> torch.Tensor:
    """torch ``nn.Unfold(kernel=wse, stride=ws, padding=(wse-ws)//2)`` on
    NHWC: [B, H, W, C] -> [B*nW, wse*wse, C] overlapping windows, token
    order (kh, kw), as pad + row / column gathers (data movement only)."""
    b, h, w, c = kv.shape
    pad = (wse - ws) // 2
    p = F.pad(kv, (0, 0, pad, pad, pad, pad))
    nh, nw = h // ws, w // ws
    ridx = (torch.arange(nh)[:, None] * ws + torch.arange(wse)[None, :])
    cidx = (torch.arange(nw)[:, None] * ws + torch.arange(wse)[None, :])
    p = p.index_select(1, ridx.reshape(-1).to(kv.device))
    p = p.index_select(2, cidx.reshape(-1).to(kv.device))
    p = p.reshape(b, nh, wse, nw, wse, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(b * nh * nw, wse * wse, c)


def _ocab(x: torch.Tensor, p: OCAB, cfg: HATConfig, heads: int,
          precision: Precision) -> torch.Tensor:
    """Overlapping cross-attention: q from ws-windows, k / v from the
    wse-windows of an unfold with stride ws (official ``OCAB.forward``)."""
    b, h, w, c = x.shape
    ws, wse = cfg.window_size, cfg.overlap_win_size
    hd = c // heads
    sdt = precision.storage_dtype
    qkv = linear(layer_norm(x, p.norm1), p.qkv, precision)
    q, k, v = torch.split(qkv, c, dim=-1)
    qw = window_partition(q, ws)
    kw, vw = _unfold_overlap(k, ws, wse), _unfold_overlap(v, ws, wse)
    nwb, nq, _ = qw.shape
    nk = wse * wse
    qh = qw.reshape(nwb, nq, heads, hd).permute(0, 2, 1, 3) * hd ** -0.5
    kh = kw.reshape(nwb, nk, heads, hd).permute(0, 2, 1, 3)
    vh = vw.reshape(nwb, nk, heads, hd).permute(0, 2, 1, 3)
    bias = gather_bias(p.relative_position_bias_table,
                       rpi_oca(ws, wse)).float()
    if use_ocab_kernel(precision, x, hd, nk):
        # scores, softmax and values per (window, head) in one kernel: the
        # [nwb, heads, nq, nk] scores never reach device memory
        pad = (0, HDP - hd)
        oh = ocab_attention(F.pad(qh, pad), F.pad(kh, pad), F.pad(vh, pad),
                            bias, compute_dtype=precision.compute_dtype,
                            storage_dtype=sdt)
        out = oh[..., :hd].permute(0, 2, 1, 3).reshape(nwb, nq, c)
    else:
        s = matmul(qh, kh.transpose(-1, -2), precision) + bias[None]
        out = matmul(torch.softmax(s, dim=-1), vh, precision)
        out = out.permute(0, 2, 1, 3).reshape(nwb, nq, c)
    out = linear(out.to(sdt), p.proj, precision)
    x = x + window_merge(out, ws, h, w)
    return x + mlp(layer_norm(x, p.norm2), p.mlp, precision)


@torch.no_grad()
def hat_apply(net: HAT, x: torch.Tensor, *,
              precision: Precision = Precision()) -> torch.Tensor:
    """Upscale NHWC [B, H, W, C] -> [B, scale*H, scale*W, C].  The
    official network needs H and W divisible by the window; like the JAX
    forward this one reflect-pads and crops, so any tile size works."""
    cfg = net.cfg
    ws = cfg.window_size
    h0, w0 = x.shape[1], x.shape[2]
    x = prepare_input(x, ws, cfg.in_channels, cfg.img_range, precision)
    feat = conv2d(x, net.conv_first, precision=precision)
    tok = feat
    if cfg.patch_norm:
        tok = layer_norm(tok, net.patch_embed.norm)
    for li, layer in enumerate(net.layers):
        heads = cfg.num_heads[li]
        y = tok
        for bi, blk in enumerate(layer.residual_group.blocks):
            y = _hab(y, blk, cfg, heads, 0 if bi % 2 == 0 else ws // 2,
                     precision)
        y = _ocab(y, layer.residual_group.overlap_attn, cfg, heads,
                  precision)
        tok = conv2d(y, layer.conv, precision=precision) + tok
    tok = layer_norm(tok, net.norm)
    feat = feat + conv2d(tok, net.conv_after_body, precision=precision)
    # HAT: LeakyReLU (torch's default slope 0.01); SwinIR has a ReLU here
    y = lrelu(conv2d(feat, net.conv_before_upsample[0], precision=precision),
              0.01)
    y = conv2d(shuffle_head(y, net.upsample, precision), net.conv_last,
               precision=precision)
    return finish_output(y, h0, w0, cfg.scale, cfg.in_channels,
                         cfg.img_range)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_hat(cfg: HATConfig = HATConfig(), seed: int = 0, *,
             device: torch.device | str = "cuda") -> HAT:
    """A randomly initialized HAT (``models.swinir.init_weights``)."""
    return init_weights(HAT, cfg, seed, device)


def is_hat_state_dict(sd: Mapping[str, Any]) -> bool:
    """HAT shares SwinIR's ``layers.N.residual_group.blocks.M`` spine; the
    CAB and OCAB keys are its own (check HAT before SwinIR)."""
    return any(".conv_block.cab." in k or ".overlap_attn." in k for k in sd)


def hat_from_state_dict(sd: Mapping[str, Any], *,
                        device: torch.device | str = "cuda"
                        ) -> Tuple[HAT, HATConfig]:
    """(network on ``device``, config) from the official HAT schema, every
    hyperparameter inferred from shapes as the JAX loader does; the
    ``relative_position_index_SA/OCA`` and ``attn_mask`` buffers some
    checkpoints carry are recomputed and ignored."""
    if not is_hat_state_dict(sd):
        raise ValueError("not a HAT state dict")
    kw = spine(sd, "HAT")
    dim, ws = kw["embed_dim"], kw["window_size"]
    oca_rows = _shape(sd, "layers.0.residual_group.overlap_attn."
                      "relative_position_bias_table", "HAT")[0]
    wse = int(round(np.sqrt(oca_rows))) + 1 - ws
    blk0 = "layers.0.residual_group.blocks.0.conv_block.cab."
    num_feat = _shape(sd, "conv_before_upsample.0.weight", "HAT")[0]
    cfg = HATConfig(
        out_channels=_shape(sd, "conv_last.weight", "HAT")[0],
        compress_ratio=dim // _shape(sd, blk0 + "0.weight", "HAT")[0],
        squeeze_factor=dim // _shape(sd, blk0 + "3.attention.1.weight",
                                     "HAT")[0],
        overlap_ratio=(wse - ws) / ws, num_feat=num_feat,
        scale=shuffle_scale(sd, num_feat), **kw)
    with torch.device("meta"):
        net = HAT(cfg)
    return load_module(net, sd, "HAT", device), cfg
