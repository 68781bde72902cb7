"""Plain PyTorch reference of the HDR decode: the Flux.1 AutoencoderKL
decoder (ldm / diffusers semantics) and the HDR expansion of its output,
in float32, NCHW inside, written from the published model and the HDR
decode node's description.  It reads the benchmark's own state dict and
latents; it imports nothing of the program.

decode:   z / scaling_factor + shift_factor -> conv_in -> mid (ResNet,
          single-head attention, ResNet) -> up levels (3 ResNets each,
          nearest 2x + conv above level 0) -> GroupNorm + SiLU (the
          pre-conv_out map) -> conv_out -> clamp(x / 2 + 1/2, 0, 1).
epilogue: the pre map collapsed to 3 channels by channel-group MAX
          (0:42, 42:84, 84:126 of 128); its and the
          image's min / max / mean / std (ddof 1); the image classified
          SIGMOID / TANH / CUSTOM by its range; the sRGB -> linear image
          times the midtone-aligned, range-matched inverse activation
          ("mathematical_recovery"), kept if it has a value above 1 or
          above 1.1, else the collapsed pre map.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.harness.models import FluxDecoder
from benchmark.reference.numerics import exact_float32, rounder

SIGMOID, TANH, CUSTOM = 0, 1, 2
ATTN_BLOCK = 4096     # queries a block of the mid attention


class Decoded(NamedTuple):
    image: torch.Tensor      # [B, H, W, 3] linear HDR
    rgb: torch.Tensor        # [B, H, W, 3] the standard decode in [0, 1]
    norm_kind: int
    used_fallback: bool


class _Net:
    def __init__(self, sd: Dict[str, torch.Tensor], m: FluxDecoder,
                 rounding: str):
        self.sd, self.m, self.r = sd, m, rounder(rounding)

    def conv(self, x, name):
        w = self.sd[name + ".weight"]
        return F.conv2d(self.r(x), self.r(w), self.sd[name + ".bias"],
                        padding=w.shape[-1] // 2)

    def norm(self, x, name):
        return F.group_norm(x, self.m.groups, self.sd[name + ".weight"],
                            self.sd[name + ".bias"], self.m.eps)

    def resnet(self, x, name):
        h = self.conv(F.silu(self.norm(x, name + ".norm1")), name + ".conv1")
        h = self.conv(F.silu(self.norm(h, name + ".norm2")), name + ".conv2")
        if name + ".nin_shortcut.weight" in self.sd:
            x = self.conv(x, name + ".nin_shortcut")
        return x + h

    def attention(self, x, name):
        b, c, hh, ww = x.shape
        h = self.norm(x, name + ".norm")
        q, k, v = (self.conv(h, f"{name}.{p}").flatten(2).transpose(1, 2)
                   for p in ("q", "k", "v"))
        k_t, v = self.r(k).transpose(1, 2), self.r(v)
        out = torch.empty_like(q)
        for s in range(0, q.shape[1], ATTN_BLOCK):
            scores = torch.matmul(self.r(q[:, s:s + ATTN_BLOCK]), k_t)
            p = torch.softmax(scores * c ** -0.5, dim=-1)
            del scores
            out[:, s:s + ATTN_BLOCK] = torch.matmul(self.r(p), v)
            del p
        out = out.transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.conv(out, name + ".proj_out")

    def forward(self, z):
        """z [B, h, w, z] -> (rgb [B, H, W, 3], pre map [B, H, W, C])."""
        m = self.m
        x = z.permute(0, 3, 1, 2).float() / m.scale + m.shift
        x = self.conv(x, "conv_in")
        x = self.resnet(x, "mid.block_1")
        if m.attn:
            x = self.attention(x, "mid.attn_1")
        x = self.resnet(x, "mid.block_2")
        for level in reversed(range(m.levels)):
            for j in range(m.blocks):
                x = self.resnet(x, f"up.{level}.block.{j}")
            if level != 0:
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = self.conv(x, f"up.{level}.upsample.conv")
        pre = F.silu(self.norm(x, "norm_out"))
        del x
        rgb = torch.clamp(self.conv(pre, "conv_out") * 0.5 + 0.5, 0.0, 1.0)
        return rgb.permute(0, 2, 3, 1), pre.permute(0, 2, 3, 1)


def _stats(x: torch.Tensor):
    """min, max, mean and std (ddof 1) as Python floats, summed in
    float64."""
    n = x.numel()
    mean = float(x.sum(dtype=torch.float64)) / n
    var = float(torch.square(x - mean).sum(dtype=torch.float64)) / (n - 1)
    return float(x.min()), float(x.max()), mean, var ** 0.5


def collapse(pre: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [..., 3] by MAX over three groups of C // 3 channels
    (42 of Flux's 128; the last channels left out)."""
    s = pre.shape[-1] // 3
    return torch.stack([pre[..., k * s:(k + 1) * s].amax(-1)
                        for k in range(3)], dim=-1)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.sign(x) * torch.where(a <= 0.04045, a / 12.92,
                                       ((a + 0.055) / 1.055) ** 2.4)


def hdr_expand(rgb: torch.Tensor, pre: torch.Tensor):
    """The HDR image of a decode's rgb [B, H, W, 3] and pre map [B, H, W,
    C] (both float32), its normalization kind and whether the raw-features
    fallback was taken."""
    pre_min, pre_max, pre_mean, _ = _stats(pre)
    post_min, post_max, _, _ = _stats(rgb)
    tol = 1e-3
    if abs(post_max - 1) < tol and abs(post_min) < tol:
        kind = SIGMOID
    elif abs(post_max - 1) < tol and abs(post_min + 1) < tol:
        kind = TANH
    else:
        kind = CUSTOM
    collapsed = collapse(pre).float()
    linear = srgb_to_linear(rgb)
    if float(collapsed.max()) > 1.0 + 1e-3:
        if kind == SIGMOID:
            c = torch.clamp(rgb, 1e-7, 1.0 - 1e-7)
            rec = torch.log(c / (1.0 - c))
        elif kind == TANH:
            rec = torch.atanh(torch.clamp(rgb, -1.0 + 1e-6, 1.0 - 1e-6))
        else:
            rec = rgb
        lo, hi = rec.min(), rec.max()
        rescaled = (rec - lo) / (hi - lo) * (pre_max - pre_min) + pre_min
        aligned = rescaled - pre_mean + 1.0
    else:
        aligned = torch.ones_like(collapsed)
    intelligent = linear * torch.clamp(aligned, min=1e-3)
    accept = bool((intelligent > 1.0).any()) or \
        float(intelligent.max()) > 1.1
    image = intelligent if accept else collapsed
    return image.float(), kind, not accept


@torch.no_grad()
def hdr_decode(sd: Dict[str, torch.Tensor], m: FluxDecoder,
               latent: torch.Tensor, rounding: str = "fp32") -> Decoded:
    """The reference HDR decode of ``latent`` [B, h, w, z]."""
    with exact_float32():
        rgb, pre = _Net(sd, m, rounding).forward(latent)
    image, kind, fallback = hdr_expand(rgb, pre)
    return Decoded(image=image, rgb=rgb, norm_kind=kind,
                   used_fallback=fallback)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], m: FluxDecoder,
            latent: torch.Tensor, rounding: str = "fp32"):
    """The decoder alone: (rgb, pre map), NHWC."""
    with exact_float32():
        return _Net(sd, m, rounding).forward(latent)
