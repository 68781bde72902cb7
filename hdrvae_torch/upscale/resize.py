"""Resize methods of the upscale node for ``local_fix``, on NHWC tensors,
as ``hdrvae/upscale/resize.py``: nearest-exact, bilinear, area, bicubic and
bislerp (ComfyUI's ``common_upscale`` methods).

Source coordinates are computed in float32 numpy exactly as the JAX
package computes them, so both packages pick the same source pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import UPSCALE_METHODS


def _half_pixel(n_out: int, n_in: int) -> np.ndarray:
    """float32 half-pixel source coordinates (i + 0.5) * n_in / n_out."""
    i = np.arange(n_out).astype(np.float32) + np.float32(0.5)
    return i * np.float32(n_in) / np.float32(n_out)


def nearest_exact(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """torch 'nearest-exact': floor of the half-pixel source coordinate."""
    h, w = x.shape[1], x.shape[2]
    ys = np.clip(np.floor(_half_pixel(height, h)), 0, h - 1).astype(np.int64)
    xs = np.clip(np.floor(_half_pixel(width, w)), 0, w - 1).astype(np.int64)
    return x[:, torch.from_numpy(ys).to(x.device)][
        :, :, torch.from_numpy(xs).to(x.device)]


def bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Half-pixel bilinear without antialiasing (torch's
    ``align_corners=False``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def bicubic_torch(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bicubic with torch's kernel (Keys a = -0.75), edges replicated."""
    a = -0.75

    def kernel(t: np.ndarray) -> np.ndarray:
        t = np.abs(t)
        return np.where(
            t <= 1.0, (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
            np.where(t < 2.0,
                     a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a,
                     0.0)).astype(np.float32)

    def axis_weights(n_out: int, n_in: int):
        s = _half_pixel(n_out, n_in) - np.float32(0.5)
        base = np.floor(s).astype(np.int64)
        frac = s - base.astype(np.float32)
        taps = np.arange(-1, 3)
        idx = np.clip(base[:, None] + taps[None, :], 0, n_in - 1)
        w = kernel(frac[:, None] - taps[None, :].astype(np.float32))
        return (torch.from_numpy(idx).to(x.device),
                torch.from_numpy(w).to(x.device, x.dtype))

    yi, yw = axis_weights(height, x.shape[1])
    xi, xw = axis_weights(width, x.shape[2])
    rows = torch.einsum("bhkwc,hk->bhwc", x[:, yi], yw)
    return torch.einsum("bhwkc,wk->bhwc", rows[:, :, xi], xw)


@functools.lru_cache(maxsize=16)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] box-mean matrix of adaptive average pooling (torch's
    integer boundaries floor(i * n_in / n_out), ceil((i + 1) * n_in /
    n_out)).  Bounded cache: a server resizing arbitrary resolutions would
    otherwise keep every matrix."""
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -((-(i + 1) * n_in) // n_out)
        w[i, s:e] = 1.0 / (e - s)
    return w


def area(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Adaptive average pooling (torch's mode='area') as two exact
    box-weight contractions, or a reshape-mean on whole factors."""
    b, h, w, c = x.shape
    if h % height == 0 and w % width == 0:
        fh, fw = h // height, w // width
        return x.reshape(b, height, fh, width, fw, c).mean(dim=(2, 4))
    wy = torch.from_numpy(_area_weights(h, height)).to(x.device)
    wx = torch.from_numpy(_area_weights(w, width)).to(x.device)
    rows = torch.einsum("oh,bhwc->bowc", wy, x.float())
    return torch.einsum("pw,bowc->bopc", wx, rows)


def _slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """ComfyUI's slerp of pixel vectors: directions slerped, magnitudes
    lerped; zero vectors have a zero direction; nearly parallel pairs
    give ``a``, nearly opposite ones a plain lerp."""
    t = t[..., None]
    na = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    nb = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    ua = torch.where(na == 0.0, 0.0, a / torch.where(na == 0.0, 1.0, na))
    ub = torch.where(nb == 0.0, 0.0, b / torch.where(nb == 0.0, 1.0, nb))
    dot = torch.sum(ua * ub, dim=-1, keepdim=True)
    omega = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    so = torch.sin(omega)
    safe_so = torch.where(so == 0.0, 1.0, so)
    direction = (torch.sin((1.0 - t) * omega) / safe_so * ua
                 + torch.sin(t * omega) / safe_so * ub)
    res = direction * (na * (1.0 - t) + nb * t)
    res = torch.where(dot > 1.0 - 1e-5, a, res)
    return torch.where(dot < 1e-5 - 1.0, a * (1.0 - t) + b * t, res)


def bislerp(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """ComfyUI's ``bislerp``, the node's default: the two horizontal
    bilinear neighbours slerped in channel space, then the two rows
    slerped vertically.  Source coordinates are the half-pixel ones
    clamped to [0, n - 1]."""
    b, h, w, c = x.shape
    x = x.float()

    def coords(n_out: int, n_in: int):
        s = np.clip(_half_pixel(n_out, n_in) - np.float32(0.5), 0, n_in - 1)
        lo = np.floor(s).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (s - lo.astype(np.float32)).astype(np.float32)
        dev = x.device
        return (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
                torch.from_numpy(frac).to(dev))

    y0, y1, fy = coords(height, h)
    x0, x1, fx = coords(width, w)
    top, bot = x[:, y0], x[:, y1]
    tl, tr = top[:, :, x0], top[:, :, x1]
    bl, br = bot[:, :, x0], bot[:, :, x1]
    fxg = fx[None, None, :].expand(tl.shape[:-1])
    fyg = fy[None, :, None].expand(tl.shape[:-1])
    return _slerp(_slerp(tl, tr, fxg), _slerp(bl, br, fxg), fyg)


def common_upscale(x: torch.Tensor, width: int, height: int,
                   method: str) -> torch.Tensor:
    """Resize NHWC ``x`` to (height, width) with one of the node's
    methods."""
    if method not in UPSCALE_METHODS:
        raise ValueError(f"unknown upscale method {method!r}; expected one "
                         f"of {UPSCALE_METHODS}")
    if x.shape[1] == height and x.shape[2] == width:
        return x
    if method == "nearest-exact":
        return nearest_exact(x, height, width)
    if method == "bilinear":
        return bilinear(x, height, width)
    if method == "bicubic":
        return bicubic_torch(x, height, width)
    if method == "area":
        return area(x, height, width)
    return bislerp(x, height, width)
