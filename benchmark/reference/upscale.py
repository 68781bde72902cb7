"""Plain PyTorch reference of the HDR x4 upscale with an RRDBNet (the HDR
upscale node with a Real-ESRGAN model), in float32, NCHW inside, written
from Real-ESRGAN's RRDBNet and the node's description.  It reads the
benchmark's own state dict and image; it imports nothing of the program.

  pass 1: the model over the image, tile by tile, each tile's output
          reversed by atanh(clamp(y, -1 + 1e-6, 1 - 1e-6));
  pass 2: the same over the image clamped to [-1, 1];
  tiles:  ComfyUI tiled_scale's grid and blend: starts every tile -
          overlap pixels, each clamped to max(0, min(size - overlap,
          start)) with length min(tile, size - pos), on both axes as soon
          as either exceeds the tile; each output weighted by ramps of
          (t + 1) / feather (feather = overlap * scale) at both ends of
          each axis, the sum divided by the summed weight;
  combine: luma (BT.601) of pass 1 clamped to [0, 8] and 3x3-median
          filtered (zero border), with the Cb / Cr of pass 2, back to
          RGB unclamped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.harness.models import RRDBNet
from benchmark.reference.numerics import exact_float32, rounder

LRELU, RES = 0.2, 0.2
LUMA_MAX = 8.0


class _Net:
    def __init__(self, sd: Dict[str, torch.Tensor], m: RRDBNet,
                 rounding: str):
        self.sd, self.m, self.r = sd, m, rounder(rounding)

    def conv(self, x, name):
        return F.conv2d(self.r(x), self.r(self.sd[name + ".weight"]),
                        self.sd[name + ".bias"], padding=1)

    def rdb(self, x, name):
        feats = [x]
        for k in range(1, 5):
            feats.append(F.leaky_relu(
                self.conv(torch.cat(feats, 1), f"{name}.conv{k}"), LRELU))
        return x + RES * self.conv(torch.cat(feats, 1), f"{name}.conv5")

    def forward(self, x):
        """x [B, C, H, W] -> [B, C', sH, sW]."""
        fea = self.conv(x, "conv_first")
        trunk = fea
        for i in range(self.m.nb):
            h = trunk
            for r in (1, 2, 3):
                h = self.rdb(h, f"body.{i}.rdb{r}")
            trunk = trunk + RES * h
        fea = fea + self.conv(trunk, "conv_body")
        del trunk
        for u in range(self.m.ups):
            fea = F.interpolate(fea, scale_factor=2.0, mode="nearest")
            fea = F.leaky_relu(self.conv(fea, f"conv_up{u + 1}"), LRELU)
        fea = F.leaky_relu(self.conv(fea, "conv_hr"), LRELU)
        return self.conv(fea, "conv_last")


def tile_plan(h: int, w: int, tile: int, overlap: int
              ) -> List[Tuple[int, int, int, int]]:
    """(y, x, th, tw) of every tile in row-major order."""
    if h <= tile and w <= tile:
        return [(0, 0, h, w)]

    def axis(size):
        return [(p, min(tile, size - p)) for p in
                (max(0, min(size - overlap, s))
                 for s in range(0, size, tile - overlap))]

    return [(y, x, th, tw) for y, th in axis(h) for x, tw in axis(w)]


def _ramp(n: int, feather: int, device) -> torch.Tensor:
    """The blend weight along one axis of n output pixels: position t
    from either end (t < feather) scaled by (t + 1) / feather."""
    t = torch.arange(n, device=device, dtype=torch.float32)
    head = torch.where(t < feather, (t + 1) / feather, 1.0)
    tail = torch.where(n - 1 - t < feather, (n - t) / feather, 1.0)
    return head * tail


def tiled(net: _Net, x: torch.Tensor, scale: int, tile: int,
          overlap: int) -> torch.Tensor:
    """The reversed model output of x [B, C, H, W] over the tile grid."""
    b, _, h, w = x.shape
    plan = tile_plan(h, w, tile, overlap)
    if len(plan) == 1:
        return torch.atanh(torch.clamp(net.forward(x), -1 + 1e-6, 1 - 1e-6))
    feather = overlap * scale
    acc = weight = None
    for y, x0, th, tw in plan:
        out = net.forward(x[:, :, y:y + th, x0:x0 + tw])
        out = torch.atanh(torch.clamp(out, -1 + 1e-6, 1 - 1e-6))
        if acc is None:
            acc = torch.zeros(b, out.shape[1], h * scale, w * scale,
                              device=x.device)
            weight = torch.zeros(1, 1, h * scale, w * scale, device=x.device)
        mask = (_ramp(th * scale, feather, x.device)[:, None]
                * _ramp(tw * scale, feather, x.device)[None, :])
        ys, xs = y * scale, x0 * scale
        acc[:, :, ys:ys + th * scale, xs:xs + tw * scale] += out * mask
        weight[:, :, ys:ys + th * scale, xs:xs + tw * scale] += mask
        del out
    return acc / weight


def _luma(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def _median3(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    win = F.unfold(x, 3, padding=1).view(b, c, 9, h, w)
    return win.sort(dim=2).values[:, :, 4]


@torch.no_grad()
def hdr_upscale(sd: Dict[str, torch.Tensor], m: RRDBNet, image: torch.Tensor,
                tile: int, overlap: int, rounding: str = "fp32"
                ) -> torch.Tensor:
    """The reference HDR upscale of ``image`` [B, H, W, 3] -> [B, sH, sW,
    3]."""
    net = _Net(sd, m, rounding)
    x = image.permute(0, 3, 1, 2).float()
    with exact_float32():
        unclamped = tiled(net, x, m.scale, tile, overlap)
        y = _median3(torch.clamp(_luma(unclamped), 0.0, LUMA_MAX))
        del unclamped
        clamped = tiled(net, torch.clamp(x, -1.0, 1.0), m.scale, tile,
                        overlap)
    yc = _luma(clamped)
    cb = (clamped[:, 2:3] - yc) * 0.564
    cr = (clamped[:, 0:1] - yc) * 0.713
    out = torch.cat([y + 1.403 * cr, y - 0.714 * cr - 0.344 * cb,
                     y + 1.773 * cb], dim=1)
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], m: RRDBNet, image: torch.Tensor,
            rounding: str = "fp32") -> torch.Tensor:
    """The model alone on a whole [B, H, W, C] image, NHWC."""
    with exact_float32():
        return _Net(sd, m, rounding).forward(
            image.permute(0, 3, 1, 2).float()).permute(0, 2, 3, 1)
