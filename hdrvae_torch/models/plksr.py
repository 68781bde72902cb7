"""RealPLKSR (Partial Large-Kernel Super-Resolution) on PyTorch, NHWC at
the boundaries, as ``hdrvae/models/plksr.py``.

Topology (the neosr / spandrel ``realplksr`` definition):

  feats = conv3x3(in -> dim) -> n_blocks x PLKBlock -> [Dropout2d, an
          inference no-op] -> conv3x3(dim -> out * scale^2)
  out   = to_img(feats(x) + x repeated scale^2 times along channels)

  PLKBlock(x) = x + GroupNorm(refine1x1(EA(PLK(DCCM(x)))))
    DCCM = conv3x3(dim -> 2 dim) -> Mish -> conv3x3(2 dim -> dim)
    PLK  = a kernel_size^2 conv over the first pdim = split_ratio * dim
           channels; the rest pass through
    EA   = x * sigmoid(conv3x3(x))

``to_img`` is the pixel shuffle, or DySample (groups 4, content-aware
offsets and bilinear border sampling) for the ``_dysample`` releases.
:class:`RealPLKSR` holds the official keys (``feats.0``, ``feats.{1..n}``
blocks with ``channel_mixer.{0,2}``, ``lk.conv``, ``attn.f.0``,
``refine``, ``norm``; ``feats.{n+2}`` the head conv; ``to_img.offset``,
``to_img.scope``, ``to_img.end_conv``, ``to_img.init_pos``).  The layers
run it (``F.conv2d`` per tier) in every tier: the JAX package has no
Pallas kernel for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.layers import conv2d, group_norm
from hdrvae_torch.models.swinir import init_weights, load_module, \
    pixel_shuffle

GN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class RealPLKSRConfig:
    in_channels: int = 3
    out_channels: int = 3
    dim: int = 64
    n_blocks: int = 28
    scale: int = 4
    kernel_size: int = 17
    split_ratio: float = 0.25
    use_ea: bool = True
    # the GroupNorm group count is not in a checkpoint's shapes (the affine
    # params are [dim]); 4 is the published default
    norm_groups: int = 4
    upsampler: str = "pixelshuffle"   # "pixelshuffle" | "dysample"
    dysample_groups: int = 4

    @property
    def pdim(self) -> int:
        return int(self.dim * self.split_ratio)

    def with_small(self) -> "RealPLKSRConfig":
        return dataclasses.replace(self, dim=16, n_blocks=3, kernel_size=7,
                                   norm_groups=2)


class PLKConv(nn.Module):
    def __init__(self, pdim: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(pdim, pdim, kernel_size,
                              padding=kernel_size // 2)


class EA(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.f = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1),
                               nn.Sigmoid())


class PLKBlock(nn.Module):
    def __init__(self, cfg: RealPLKSRConfig):
        super().__init__()
        dim = cfg.dim
        self.channel_mixer = nn.Sequential(
            nn.Conv2d(dim, 2 * dim, 3, padding=1), nn.Mish(),
            nn.Conv2d(2 * dim, dim, 3, padding=1))
        self.lk = PLKConv(cfg.pdim, cfg.kernel_size)
        self.attn = EA(dim) if cfg.use_ea else nn.Identity()
        self.refine = nn.Conv2d(dim, dim, 1)
        self.norm = nn.GroupNorm(cfg.norm_groups, dim, eps=GN_EPS)


def dysample_init_pos(scale: int, groups: int) -> np.ndarray:
    """DySample's ``init_pos`` buffer as a flat [2 * groups * scale^2]
    vector (meshgrid ij -> transpose(1, 2) -> repeated over the groups)."""
    h = (np.arange(scale) - (scale - 1) / 2.0) / scale
    m = np.stack(np.meshgrid(h, h, indexing="ij")).transpose(0, 2, 1)
    return np.tile(m, (1, groups, 1)).reshape(-1).astype(np.float32)


class DySample(nn.Module):
    """The 'lp' DySample head; ``scope`` absent in the dyscope=False
    releases."""

    def __init__(self, cfg: RealPLKSRConfig, dyscope: bool = True):
        super().__init__()
        cin = cfg.out_channels * cfg.scale ** 2
        och = 2 * cfg.dysample_groups * cfg.scale ** 2
        self.offset = nn.Conv2d(cin, och, 1)
        self.scope = nn.Conv2d(cin, och, 1, bias=False) if dyscope else None
        self.end_conv = nn.Conv2d(cin, cfg.out_channels, 1)
        self.register_buffer("init_pos", torch.from_numpy(dysample_init_pos(
            cfg.scale, cfg.dysample_groups)).reshape(1, -1, 1, 1))


class RealPLKSR(nn.Module):
    """The network's weights under the official keys;
    :func:`realplksr_apply` runs it."""

    def __init__(self, cfg: RealPLKSRConfig = RealPLKSRConfig(),
                 dyscope: bool = True):
        super().__init__()
        self.cfg = cfg
        self.feats = nn.Sequential(
            nn.Conv2d(cfg.in_channels, cfg.dim, 3, padding=1),
            *(PLKBlock(cfg) for _ in range(cfg.n_blocks)),
            nn.Identity(),   # the official Dropout2d: no parameters
            nn.Conv2d(cfg.dim, cfg.out_channels * cfg.scale ** 2, 3,
                      padding=1))
        self.to_img = (DySample(cfg, dyscope) if cfg.upsampler == "dysample"
                       else nn.PixelShuffle(cfg.scale))


def _mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x)), the JAX package's formula, in float32."""
    return x * torch.tanh(F.softplus(x))


def _plk_block(x: torch.Tensor, blk: PLKBlock, cfg: RealPLKSRConfig,
               precision: Precision) -> torch.Tensor:
    h = conv2d(x, blk.channel_mixer[0], precision=precision)
    h = _mish(h.float()).to(precision.storage_dtype)
    h = conv2d(h, blk.channel_mixer[2], precision=precision)
    h1 = conv2d(h[..., :cfg.pdim], blk.lk.conv, precision=precision)
    h = torch.cat([h1, h[..., cfg.pdim:]], dim=-1)
    if cfg.use_ea:
        gate = torch.sigmoid(conv2d(h, blk.attn.f[0],
                                    precision=precision).float())
        h = h * gate.to(h.dtype)
    h = conv2d(h, blk.refine, precision=precision)
    h = group_norm(h, blk.norm, num_groups=cfg.norm_groups, eps=GN_EPS,
                   precision=precision)
    return h + x


def bilinear_border_sample(img: torch.Tensor, ix: torch.Tensor,
                           iy: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(mode="bilinear", padding_mode="border",
    align_corners=False)`` at absolute pixel positions, with the JAX
    package's arithmetic (clamp, then floor).  img [B, H, W, G, Cg] float32;
    ix / iy [B, h, w, G] float32 -> [B, h, w, G, Cg]."""
    b, h, w, g, cg = img.shape
    ix = torch.clamp(ix, 0.0, w - 1.0)
    iy = torch.clamp(iy, 0.0, h - 1.0)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0)[..., None], (iy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)   # fx == 0 there: exact
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = img.reshape(b * h * w * g, cg)
    bi = torch.arange(b, device=img.device)[:, None, None, None]
    gi = torch.arange(g, device=img.device)

    def at(yy, xx):
        return flat[((bi * h + yy) * w + xx) * g + gi]

    top = at(y0, x0) * (1.0 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1.0 - fx) + at(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def _dysample(head: DySample, x: torch.Tensor, cfg: RealPLKSRConfig,
              precision: Precision) -> torch.Tensor:
    """The DySample head: offsets from a 1x1 conv gated by sigmoid(scope) /
    2 (or times 1/4 without a scope), plus ``init_pos``, pixel-shuffled to
    the output grid; output pixel (Y, X) samples group k of x at (Y // s +
    dy, X // s + dx) (DySample's normalization and grid_sample's
    unnormalization compose to that); then ``end_conv``."""
    b, h, w, c = x.shape
    s, g = cfg.scale, cfg.dysample_groups
    off = conv2d(x, head.offset, precision=precision).float()
    if head.scope is not None:
        scope = conv2d(x, head.scope, precision=precision).float()
        off = off * torch.sigmoid(scope) * 0.5
    else:
        off = off * 0.25
    off = (off + head.init_pos.reshape(-1).float()).reshape(
        b, h, w, 2, g * s * s)
    off_x = pixel_shuffle(off[..., 0, :], s)      # [b, sH, sW, g]
    off_y = pixel_shuffle(off[..., 1, :], s)
    base_x = torch.div(torch.arange(w * s, device=x.device,
                                    dtype=torch.float32), s,
                       rounding_mode="floor")[None, None, :, None]
    base_y = torch.div(torch.arange(h * s, device=x.device,
                                    dtype=torch.float32), s,
                       rounding_mode="floor")[None, :, None, None]
    out = bilinear_border_sample(x.float().reshape(b, h, w, g, c // g),
                                 base_x + off_x, base_y + off_y)
    out = out.reshape(b, h * s, w * s, c).to(precision.storage_dtype)
    return conv2d(out, head.end_conv, precision=precision)


@torch.no_grad()
def realplksr_apply(net: RealPLKSR, x: torch.Tensor, *,
                    precision: Precision = Precision()) -> torch.Tensor:
    """[B, H, W, C] -> [B, sH, sW, C] float32: feats(x) + x repeated along
    channels, then the pixel shuffle or DySample."""
    cfg = net.cfg
    h = conv2d(x, net.feats[0], precision=precision)
    for blk in net.feats[1:cfg.n_blocks + 1]:
        h = _plk_block(h, blk, cfg, precision)
    h = conv2d(h, net.feats[-1], precision=precision)
    h = h + x.to(h.dtype).repeat_interleave(cfg.scale ** 2, dim=-1)
    if cfg.upsampler == "dysample":
        return _dysample(net.to_img, h, cfg, precision).float()
    return pixel_shuffle(h, cfg.scale).float()


def init_realplksr(cfg: RealPLKSRConfig = RealPLKSRConfig(), seed: int = 0,
                   *, device: torch.device | str = "cuda") -> RealPLKSR:
    """A randomly initialized RealPLKSR, its weights drawn with numpy from
    ``seed`` (convs PyTorch's U(+-sqrt(1/fan_in)), GroupNorm affines
    1 + 0.1 N(0, 1) / 0.1 N(0, 1), DySample's ``init_pos`` its published
    value)."""
    def draw(name: str, shape: tuple, rng) -> np.ndarray | None:
        if name.endswith(".norm.weight"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name.endswith(".norm.bias"):
            return 0.1 * rng.standard_normal(shape)
        if name == "to_img.init_pos":
            return dysample_init_pos(cfg.scale,
                                     cfg.dysample_groups).reshape(shape)
        return None

    return init_weights(RealPLKSR, cfg, seed, device, draw=draw)


# ---------------------------------------------------------------------------
# Checkpoint loading (official neosr / spandrel key schema)
# ---------------------------------------------------------------------------

_FEATS_RE = re.compile(r"^feats\.(\d+)\.")


def is_realplksr_state_dict(sd: Mapping[str, Any]) -> bool:
    """RealPLKSR: feats.1.lk.conv and feats.1.norm (the original PLKSR has
    no per-block GroupNorm: refused)."""
    return "feats.0.weight" in sd and "feats.1.lk.conv.weight" in sd and \
        "feats.1.norm.weight" in sd


def realplksr_from_state_dict(sd: Mapping[str, Any], *,
                              device: torch.device | str = "cuda"
                              ) -> Tuple[RealPLKSR, RealPLKSRConfig]:
    """(network on ``device``, config) from the official schema (tensors or
    numpy arrays): feats.0 the first conv, the blocks where ``lk.conv``
    is, the last feats entry the head; DySample checkpoints add
    ``to_img.*`` (``init_pos`` recomputed where absent).  An original-PLKSR
    checkpoint raises."""
    if "feats.0.weight" in sd and "feats.1.lk.conv.weight" in sd and \
            "feats.1.norm.weight" not in sd:
        raise ValueError(
            "original-PLKSR checkpoint (no per-block GroupNorm): only the "
            "RealPLKSR variant is implemented")
    idx = sorted({int(m.group(1)) for k in sd if (m := _FEATS_RE.match(k))})
    block_idx = [i for i in idx if f"feats.{i}.lk.conv.weight" in sd]
    head = idx[-1]
    dim, in_ch = (int(d) for d in sd["feats.0.weight"].shape[:2])
    lk = sd[f"feats.{block_idx[0]}.lk.conv.weight"]
    pdim, ksize = int(lk.shape[0]), int(lk.shape[2])
    use_ea = f"feats.{block_idx[0]}.attn.f.0.weight" in sd
    head_out = int(sd[f"feats.{head}.weight"].shape[0])
    dysample = "to_img.offset.weight" in sd
    out_ch = int(sd["to_img.end_conv.weight"].shape[0]) if dysample \
        else in_ch
    scale = int(round((head_out // out_ch) ** 0.5))
    if out_ch * scale * scale != head_out:
        raise ValueError(f"RealPLKSR head channels {head_out} are not "
                         f"out_ch*scale^2 (out_ch={out_ch})")
    cfg = RealPLKSRConfig(
        in_channels=in_ch, out_channels=out_ch, dim=dim,
        n_blocks=len(block_idx), scale=scale, kernel_size=ksize,
        split_ratio=pdim / dim, use_ea=use_ea,
        upsampler="dysample" if dysample else "pixelshuffle")
    if dysample:
        g = int(sd["to_img.offset.weight"].shape[0]) // (2 * scale * scale)
        cfg = dataclasses.replace(cfg, dysample_groups=g)
    out: Dict[str, Any] = {}
    for p in ("weight", "bias"):
        out[f"feats.0.{p}"] = sd[f"feats.0.{p}"]
        out[f"feats.{cfg.n_blocks + 2}.{p}"] = sd[f"feats.{head}.{p}"]
    for n, i in enumerate(block_idx):
        for k, v in sd.items():
            if k.startswith(f"feats.{i}."):
                out[f"feats.{n + 1}." + k[len(f"feats.{i}."):]] = v
    dyscope = "to_img.scope.weight" in sd
    if dysample:
        for k, v in sd.items():
            if k.startswith("to_img."):
                out[k] = v
        if "to_img.init_pos" not in sd:
            out["to_img.init_pos"] = dysample_init_pos(scale, g).reshape(
                1, -1, 1, 1)
    with torch.device("meta"):
        net = RealPLKSR(cfg, dyscope)
    return load_module(net, out, "RealPLKSR", device), cfg
