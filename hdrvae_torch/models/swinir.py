"""SwinIR super-resolution on PyTorch, NHWC at the boundaries, as
``hdrvae/models/swinir.py``.

Topology: conv_first -> patch LayerNorm -> RSTB stack (each a group of
Swin blocks, window attention with a relative-position bias and every
second block on a grid shifted by ws / 2, then a 3x3 conv or the 3conv
bottleneck, plus the group's input) -> LayerNorm -> conv_after_body (+ the
shallow feature) -> one of four heads (pixelshuffle, pixelshuffledirect,
nearest+conv, none), with the input reflect-padded to window multiples,
the RGB mean subtracted and the output cropped back.

:class:`SwinIR` is an ``nn.Module`` whose parameter names are the official
checkpoint keys; :func:`swinir_apply` runs it.  Each Swin block runs as one
fused block (K7, ``kernels/swin_attention.py``) on a CUDA tensor in the
fast tier, else as the unfused layers, as the JAX package runs its XLA
layers off the TPU (``Precision.swin_attn`` forces either).  HAT
(``models/hat.py``) reuses the window machinery.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels.swin_attention import (BlockWeights, prepare_block,
                                                 swin_block_chain,
                                                 swin_block_fused,
                                                 use_swin_kernel)
from hdrvae_torch.models.layers import conv2d, nearest_upsample_2x

# ImageNet RGB mean subtracted by every public 3-channel SwinIR / HAT
RGB_MEAN = (0.4488, 0.4371, 0.4040)

UPSAMPLERS = ("pixelshuffle", "pixelshuffledirect", "nearest+conv", "")

# checkpoint entries that are recomputed statics, not weights
STATIC_KEYS = ("relative_position_index", "relative_position_index_SA",
               "relative_position_index_OCA", "attn_mask",
               "relative_coords_table")


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    in_channels: int = 3
    out_channels: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upsampler: str = "nearest+conv"
    resi_connection: str = "1conv"
    patch_norm: bool = True
    num_feat: int = 64          # upsampler intermediate width
    scale: int = 4
    img_range: float = 1.0

    def with_small(self) -> "SwinIRConfig":
        """A tiny config for tests (fast on one CPU core)."""
        return dataclasses.replace(
            self, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
            window_size=4, num_feat=8, scale=2)


# ---------------------------------------------------------------------------
# Modules (official key schema)
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


class _Blocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class RSTB(nn.Module):
    """A group of ``block`` modules (SwinIR's, or Swin2SR's SwinV2 one)
    and its trailing conv."""

    def __init__(self, cfg, li: int, block=SwinBlock):
        super().__init__()
        dim = cfg.embed_dim
        self.residual_group = _Blocks(
            block(dim, cfg.num_heads[li], cfg.window_size, cfg.mlp_ratio)
            for _ in range(cfg.depths[li]))
        if cfg.resi_connection == "1conv":
            self.conv = _conv(dim, dim)
        else:   # 3conv: conv.0 3x3 -> lrelu -> conv.2 1x1 -> lrelu -> conv.4
            self.conv = nn.Sequential(
                _conv(dim, dim // 4), nn.LeakyReLU(0.2),
                _conv(dim // 4, dim // 4, 1), nn.LeakyReLU(0.2),
                _conv(dim // 4, dim))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_norm: bool):
        super().__init__()
        self.norm = nn.LayerNorm(dim) if patch_norm else None


def _shuffle_stack(nf: int, scale: int) -> nn.Sequential:
    """[conv, PixelShuffle] per factor 2 (or one 3): keys upsample.0,
    upsample.2, ..."""
    mods, s = [], scale
    while s > 1:
        r = 3 if s % 2 else 2
        mods += [_conv(nf, nf * r * r), nn.PixelShuffle(r)]
        s //= r
    return nn.Sequential(*mods)


class SwinIR(nn.Module):
    """The network's weights under the official names; :func:`swinir_apply`
    runs it."""

    def __init__(self, cfg: SwinIRConfig = SwinIRConfig()):
        super().__init__()
        if cfg.upsampler not in UPSAMPLERS:
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        self.cfg = cfg
        dim, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = _conv(cfg.in_channels, dim)
        self.patch_embed = PatchEmbed(dim, cfg.patch_norm)
        self.layers = nn.ModuleList(RSTB(cfg, li)
                                    for li in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = _conv(dim, dim)
        if cfg.upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(_conv(dim, nf),
                                                      nn.LeakyReLU())
            self.conv_up1 = _conv(nf, nf)
            if cfg.scale == 4:
                self.conv_up2 = _conv(nf, nf)
            self.conv_hr = _conv(nf, nf)
            self.conv_last = _conv(nf, cfg.out_channels)
        elif cfg.upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(_conv(dim, nf),
                                                      nn.ReLU())
            self.upsample = _shuffle_stack(nf, cfg.scale)
            self.conv_last = _conv(nf, cfg.out_channels)
        elif cfg.upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                _conv(dim, cfg.out_channels * cfg.scale ** 2),
                nn.PixelShuffle(cfg.scale))
        else:
            self.conv_last = _conv(dim, cfg.out_channels)


# ---------------------------------------------------------------------------
# Window geometry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _relative_position_index_np(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def relative_position_index(ws: int) -> torch.Tensor:
    """[ws*ws, ws*ws] indices into the (2ws-1)^2 bias table."""
    return torch.from_numpy(_relative_position_index_np(ws))


def shift_attn_mask(h: int, w: int, ws: int, shift: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """[nW, N, N] additive mask (-100 across region boundaries) of the
    shifted-window attention on an (h, w) grid, built on ``device``."""
    img = torch.zeros(h, w, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm (eps 1e-5) with float32 statistics, in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (y * norm.weight.float() + norm.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear,
           precision: Precision) -> torch.Tensor:
    """x @ W^T + b: operands rounded to the compute dtype, float32
    products and accumulation, the result in the storage dtype."""
    cdt = precision.compute_dtype
    with fp32_contractions(precision):
        y = x.to(cdt).float() @ lin.weight.to(cdt).float().t()
    return (y + lin.bias.float()).to(precision.storage_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: Precision) -> torch.Tensor:
    """a @ b in float32 on operands rounded to the compute dtype."""
    cdt = precision.compute_dtype
    with fp32_contractions(precision):
        return a.to(cdt).float() @ b.to(cdt).float()


def gelu(x: torch.Tensor, precision: Precision) -> torch.Tensor:
    """Exact (erf) GELU in float32, rounded to the storage dtype."""
    return F.gelu(x.float()).to(precision.storage_dtype)


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def gather_bias(table: torch.Tensor, rpi: torch.Tensor) -> torch.Tensor:
    """Relative-position bias [heads, N, M] of an [N, M] index."""
    n, m = rpi.shape
    bias = table[rpi.reshape(-1).to(table.device)]
    return bias.reshape(n, m, -1).permute(2, 0, 1)


def window_attention(x: torch.Tensor, attn: WindowAttention, heads: int,
                     ws: int, mask: Optional[torch.Tensor],
                     precision: Precision) -> torch.Tensor:
    """The official WindowAttention on windows x [nWB, N, C]: qkv, scaled
    scores + relative-position bias (+ shift mask), float32 softmax,
    values, proj (``swinir._window_attention``)."""
    nwb, n, c = x.shape
    hd = c // heads
    qkv = linear(x, attn.qkv, precision)
    qkv = qkv.reshape(nwb, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    s = matmul(q, k.transpose(-1, -2), precision)
    s = s + gather_bias(attn.relative_position_bias_table,
                        relative_position_index(ws)).float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(nwb // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(nwb, heads, n, n)
    p = torch.softmax(s, dim=-1)
    out = matmul(p, v, precision).permute(0, 2, 1, 3).reshape(nwb, n, c)
    return linear(out.to(precision.storage_dtype), attn.proj, precision)


def mlp(x: torch.Tensor, m: Mlp, precision: Precision) -> torch.Tensor:
    return linear(gelu(linear(x, m.fc1, precision), precision), m.fc2,
                  precision)


def block_weights(blk: nn.Module, heads: int, ws: int,
                  dtype: torch.dtype) -> BlockWeights:
    """K7's weights of a Swin block (or HAB), prepared once per compute
    dtype and device and kept on the module: the network is read-only."""
    key = (dtype, str(blk.norm1.weight.device))
    cache = blk.__dict__.setdefault("_fused_weights", {})
    if key not in cache:
        bias = gather_bias(blk.attn.relative_position_bias_table,
                           relative_position_index(ws))
        cache[key] = prepare_block(blk.attn, blk.norm1, blk.norm2, blk.mlp,
                                   heads, bias, dtype)
    return cache[key]


def _rolled_block(block_fn, x: torch.Tensor, w: BlockWeights, ws: int,
                  shift: int, precision: Precision,
                  extra: Optional[torch.Tensor]) -> torch.Tensor:
    """``block_fn`` (K7 or the staged chain) in rolled image space: LN is
    pointwise, so it commutes with the roll, and the rolled x is both the
    kernels' input and their residual (``swinir._swin_block_kernel``).
    ``extra`` is rolled here too."""
    def roll(t, s):
        return torch.roll(t, (s, s), dims=(1, 2)) if shift else t
    y = block_fn(roll(x, -shift).contiguous(), w, ws=ws, shift=shift,
                 extra=None if extra is None
                 else roll(extra, -shift).contiguous(),
                 precision=precision)
    return roll(y, shift)


def fused_block(x: torch.Tensor, w: BlockWeights, ws: int, shift: int,
                precision: Precision,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block (its K7 weights ``w``) through K7."""
    return _rolled_block(swin_block_fused, x, w, ws, shift, precision, extra)


def chain_block(x: torch.Tensor, w: BlockWeights, ws: int, shift: int,
                precision: Precision,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One v1 block (its K7 weights ``w``) through the staged chain K10 ->
    K9 -> K11: :func:`fused_block`'s function in three kernels.  No
    forward takes it; it is the chain's A/B against K7."""
    return _rolled_block(swin_block_chain, x, w, ws, shift, precision, extra)


def swin_block(x: torch.Tensor, blk: SwinBlock, heads: int, ws: int,
               shift: int, precision: Precision) -> torch.Tensor:
    """One Swin block on an NHWC grid (H, W multiples of ws)."""
    b, h, w, c = x.shape
    if use_swin_kernel(precision, x, h, w, ws, c // heads):
        return fused_block(
            x, block_weights(blk, heads, ws, precision.compute_dtype), ws,
            shift, precision)
    y = layer_norm(x, blk.norm1)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    mask = shift_attn_mask(h, w, ws, shift, x.device) if shift else None
    y = window_merge(window_attention(window_partition(y, ws), blk.attn,
                                      heads, ws, mask, precision), ws, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = x + y
    return x + mlp(layer_norm(x, blk.norm2), blk.mlp, precision)


def _rstb_conv(x: torch.Tensor, conv: nn.Module,
               precision: Precision) -> torch.Tensor:
    """The RSTB's trailing conv: '1conv' (3x3) or '3conv' (3x3 -> lrelu ->
    1x1 -> lrelu -> 3x3)."""
    if isinstance(conv, nn.Conv2d):
        return conv2d(x, conv, precision=precision)
    y = lrelu(conv2d(x, conv[0], precision=precision), 0.2)
    y = lrelu(conv2d(y, conv[2], precision=precision), 0.2)
    return conv2d(y, conv[4], precision=precision)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``nn.PixelShuffle`` on NHWC: channels r*r*C -> C, space x r, in
    torch's channel order (C outer, then r, r)."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, co)


def shuffle_head(y: torch.Tensor, stack: nn.Sequential,
                 precision: Precision) -> torch.Tensor:
    """The [conv, PixelShuffle] pairs of a pixelshuffle head."""
    for conv, shuffle in zip(stack[0::2], stack[1::2]):
        y = pixel_shuffle(conv2d(y, conv, precision=precision),
                          shuffle.upscale_factor)
    return y


def prepare_input(x: torch.Tensor, ws: int, in_channels: int,
                  img_range: float, precision: Precision) -> torch.Tensor:
    """Reflect-pad H and W to window multiples, subtract the RGB mean
    (3-channel nets) and scale by img_range, in the storage dtype."""
    pad_h, pad_w = (-x.shape[1]) % ws, (-x.shape[2]) % ws
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                  mode="reflect").permute(0, 2, 3, 1)
    if in_channels == 3:
        x = (x - torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)) \
            * img_range
    else:
        x = x * img_range
    return x.to(precision.storage_dtype)


def finish_output(y: torch.Tensor, h0: int, w0: int, scale: int,
                  in_channels: int, img_range: float) -> torch.Tensor:
    """Undo the input scaling and mean, crop to scale x the input size."""
    y = y.float() / img_range
    if in_channels == 3:
        y = y + torch.tensor(RGB_MEAN, device=y.device)
    return y[:, :h0 * scale, :w0 * scale]


@torch.no_grad()
def swinir_apply(net: SwinIR, x: torch.Tensor, *,
                 precision: Precision = Precision()) -> torch.Tensor:
    """Upscale NHWC [B, H, W, C] -> [B, scale*H, scale*W, C] (the official
    forward with reflect padding and a crop)."""
    cfg = net.cfg
    ws = cfg.window_size
    h0, w0 = x.shape[1], x.shape[2]
    x = prepare_input(x, ws, cfg.in_channels, cfg.img_range, precision)
    feat = conv2d(x, net.conv_first, precision=precision)
    tok = feat
    if cfg.patch_norm:
        tok = layer_norm(tok, net.patch_embed.norm)
    for li, layer in enumerate(net.layers):
        y = tok
        for bi, blk in enumerate(layer.residual_group.blocks):
            y = swin_block(y, blk, cfg.num_heads[li], ws,
                           0 if bi % 2 == 0 else ws // 2, precision)
        tok = _rstb_conv(y, layer.conv, precision) + tok
    tok = layer_norm(tok, net.norm)
    feat = feat + conv2d(tok, net.conv_after_body, precision=precision)

    if cfg.upsampler == "pixelshuffle":
        y = torch.relu(conv2d(feat, net.conv_before_upsample[0],
                              precision=precision))
        y = conv2d(shuffle_head(y, net.upsample, precision), net.conv_last,
                   precision=precision)
    elif cfg.upsampler == "pixelshuffledirect":
        y = shuffle_head(feat, net.upsample, precision)
    elif cfg.upsampler == "nearest+conv":
        # conv_before_upsample's LeakyReLU has torch's default slope 0.01;
        # the up / hr convs use the module's own lrelu of slope 0.2: two
        # different slopes in the official network
        y = lrelu(conv2d(feat, net.conv_before_upsample[0],
                         precision=precision), 0.01)
        y = lrelu(conv2d(nearest_upsample_2x(y), net.conv_up1,
                         precision=precision), 0.2)
        if cfg.scale == 4:
            y = lrelu(conv2d(nearest_upsample_2x(y), net.conv_up2,
                             precision=precision), 0.2)
        y = lrelu(conv2d(y, net.conv_hr, precision=precision), 0.2)
        y = conv2d(y, net.conv_last, precision=precision)
    else:   # restoration head (scale 1): conv_last over the body + input
        y = x + conv2d(feat, net.conv_last, precision=precision)
    return finish_output(y, h0, w0, cfg.scale, cfg.in_channels,
                         cfg.img_range)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def load_module(module: nn.Module, sd: Mapping[str, Any], family: str,
                device: torch.device | str) -> nn.Module:
    """``module`` (built on the meta device) on ``device`` holding the
    official state dict ``sd`` (tensors or numpy arrays; recomputed statics
    dropped); gradients off.  A missing or unexpected key raises a
    ValueError naming ``family``."""
    tensors = {k: v.detach().float() if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v, np.float32))
               for k, v in sd.items()
               if k.rsplit(".", 1)[-1] not in STATIC_KEYS}
    module = module.to_empty(device=device)
    want = set(module.state_dict())
    missing, extra = want - set(tensors), set(tensors) - want
    if missing or extra:
        raise ValueError(
            f"incomplete or foreign {family} checkpoint: missing "
            f"{sorted(missing)[:3]}, unexpected {sorted(extra)[:3]}")
    module.load_state_dict(tensors)
    return module.requires_grad_(False).eval()


def init_weights(module_cls, cfg, seed: int, device: torch.device | str,
                 draw=None) -> nn.Module:
    """A network with weights drawn with numpy from ``seed``: linears and
    bias tables N(0, 0.02) with zero linear biases (the official init),
    LayerNorms 1 / 0, convs PyTorch's U(+-sqrt(1/fan_in)).  ``draw(name,
    shape, rng)``, where given, is asked first and may return an array."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = module_cls(cfg)
    shapes = net.state_dict()
    mods = dict(net.named_modules())
    sd = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        owner, leaf = name.rsplit(".", 1)
        mod = mods[owner]
        own = None if draw is None else draw(name, shape, rng)
        if own is not None:
            sd[name] = np.asarray(own, np.float32)
        elif isinstance(mod, nn.LayerNorm):
            sd[name] = np.full(shape, 1.0 if leaf == "weight" else 0.0,
                               np.float32)
        elif isinstance(mod, nn.Linear):
            sd[name] = (rng.standard_normal(shape) * 0.02 if leaf == "weight"
                        else np.zeros(shape)).astype(np.float32)
        elif leaf == "relative_position_bias_table":
            sd[name] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        else:
            wshape = tuple(shapes[owner + ".weight"].shape)
            bound = float(np.sqrt(1.0 / int(np.prod(wshape[1:]))))
            sd[name] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return load_module(net, sd, module_cls.__name__, device)


def init_swinir(cfg: SwinIRConfig = SwinIRConfig(), seed: int = 0, *,
                device: torch.device | str = "cuda") -> SwinIR:
    """A randomly initialized SwinIR (see :func:`init_weights`)."""
    return init_weights(SwinIR, cfg, seed, device)


_BLOCK_RE = re.compile(r"^layers\.(\d+)\.residual_group\.blocks\.(\d+)\.")


def is_swinir_state_dict(sd: Mapping[str, Any]) -> bool:
    """The SwinIR v1 spine.  Swin2SR shares it but carries a continuous
    position MLP (``attn.logit_scale`` / ``attn.cpb_mlp``) in place of the
    bias table; HAT shares it too (check HAT first)."""
    if not any(_BLOCK_RE.match(k) for k in sd):
        return False
    return not any(k.endswith((".attn.logit_scale",
                               ".attn.cpb_mlp.0.weight")) for k in sd)


def _shape(sd: Mapping[str, Any], key: str, family: str) -> Tuple[int, ...]:
    if key not in sd:
        raise ValueError(f"incomplete {family} checkpoint: no {key}")
    return tuple(int(d) for d in sd[key].shape)


def spine(sd: Mapping[str, Any], family: str) -> Dict[str, Any]:
    """What the shapes of a SwinIR / HAT spine say: depths, width, heads,
    window size, MLP ratio, input channels and patch norm."""
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := _BLOCK_RE.match(k)))
    depths = tuple(
        1 + max(int(m.group(2)) for k in sd
                if (m := _BLOCK_RE.match(k)) and int(m.group(1)) == li)
        for li in range(n_layers))
    embed_dim, in_ch = _shape(sd, "conv_first.weight", family)[:2]
    tables = [_shape(sd, f"layers.{li}.residual_group.blocks.0.attn."
                     "relative_position_bias_table", family)
              for li in range(n_layers)]
    fc1 = _shape(sd, "layers.0.residual_group.blocks.0.mlp.fc1.weight",
                 family)
    return dict(in_channels=in_ch, embed_dim=embed_dim, depths=depths,
                num_heads=tuple(t[1] for t in tables),
                window_size=(int(round(np.sqrt(tables[0][0]))) + 1) // 2,
                mlp_ratio=fc1[0] / embed_dim,
                patch_norm="patch_embed.norm.weight" in sd)


def shuffle_scale(sd: Mapping[str, Any], num_feat: int) -> int:
    """The upscale factor of a pixelshuffle head's upsample convs."""
    scale = 1
    for k in sorted(sd):
        if re.match(r"^upsample\.\d+\.weight$", k):
            scale *= int(round(np.sqrt(sd[k].shape[0] // num_feat)))
    return scale


def swinir_from_state_dict(sd: Mapping[str, Any],
                           img_range: Optional[float] = None, *,
                           device: torch.device | str = "cuda"
                           ) -> Tuple[SwinIR, SwinIRConfig]:
    """(network on ``device``, config) from the official SwinIR schema,
    every hyperparameter inferred from shapes and keys as the JAX loader
    does.  ``img_range`` is not stored in checkpoints: 1.0 for every SR
    family and for denoising, 255.0 for the grayscale JPEG-CAR models."""
    if not is_swinir_state_dict(sd):
        raise ValueError("not a SwinIR state dict")
    kw = spine(sd, "SwinIR")
    resi = "3conv" if "layers.0.conv.0.weight" in sd else "1conv"
    if "conv_up1.weight" in sd:
        upsampler = "nearest+conv"
        num_feat = _shape(sd, "conv_up1.weight", "SwinIR")[0]
        scale = 4 if "conv_up2.weight" in sd else 2
        out_ch = _shape(sd, "conv_last.weight", "SwinIR")[0]
    elif "conv_before_upsample.0.weight" in sd:
        upsampler = "pixelshuffle"
        num_feat = _shape(sd, "conv_before_upsample.0.weight", "SwinIR")[0]
        out_ch = _shape(sd, "conv_last.weight", "SwinIR")[0]
        scale = shuffle_scale(sd, num_feat)
    elif "upsample.0.weight" in sd:
        upsampler = "pixelshuffledirect"
        num_feat = kw["embed_dim"]
        out_ch = kw["in_channels"]
        scale = int(round(np.sqrt(sd["upsample.0.weight"].shape[0]
                                  // out_ch)))
    else:
        upsampler, num_feat, scale = "", kw["embed_dim"], 1
        out_ch = _shape(sd, "conv_last.weight", "SwinIR")[0]
    cfg = SwinIRConfig(out_channels=out_ch, upsampler=upsampler,
                       resi_connection=resi, num_feat=num_feat, scale=scale,
                       img_range=1.0 if img_range is None else img_range,
                       **kw)
    with torch.device("meta"):
        net = SwinIR(cfg)
    return load_module(net, sd, "SwinIR", device), cfg
