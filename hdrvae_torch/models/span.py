"""SPAN (Swift Parameter-free Attention Network) on PyTorch, NHWC at the
boundaries, as ``hdrvae/models/span.py``.

Topology: the input normalized ((x - rgb_mean) * img_range, unless the
checkpoint carries ``no_norm``), conv_1 -> num_blocks SPAB (three Conv3XC
with SiLU between, then the gate (out3 + x) * (sigmoid(out3) - 0.5)) ->
conv_2, a 1x1 ``conv_cat`` over [feat, final, block 1's output, the last
block's out1], a 3x3 conv and the pixel shuffle.

Each Conv3XC (1x1 -> 3x3 -> 1x1 chain plus a 1x1 skip) is folded into one
dense 3x3 conv at load (:func:`fuse_conv3xc`, the JAX package's numpy
algebra, operation for operation), which the official module computes
into its ``eval_conv`` before an eval forward.  :class:`SPAN` holds the
fused convs under those eval-mode keys (``conv_1.eval_conv``,
``block_N.c1_r.eval_conv``, ...), plus ``conv_cat`` and ``upsampler.0``.
The layers run it (``F.conv2d`` per tier) in every tier: the JAX package
has no Pallas kernel for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.layers import conv2d
from hdrvae_torch.models.swinir import init_weights, load_module, \
    pixel_shuffle

_RGB_MEAN = (0.4488, 0.4371, 0.4040)
_CONV3XC = ("c1_r", "c2_r", "c3_r")


@dataclasses.dataclass(frozen=True)
class SPANConfig:
    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 48
    num_blocks: int = 6
    scale: int = 4
    img_range: float = 255.0
    norm: bool = True

    def with_small(self) -> "SPANConfig":
        return dataclasses.replace(self, num_feat=8, num_blocks=2)


class Conv3XC(nn.Module):
    """A Conv3XC folded into its one dense 3x3 conv (``eval_conv``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.eval_conv = nn.Conv2d(cin, cout, 3, padding=1)


class SPAB(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        for name in _CONV3XC:
            setattr(self, name, Conv3XC(nf, nf))


class SPAN(nn.Module):
    """The network's fused weights; :func:`span_apply` runs it."""

    def __init__(self, cfg: SPANConfig = SPANConfig()):
        super().__init__()
        self.cfg = cfg
        nf = cfg.num_feat
        self.conv_1 = Conv3XC(cfg.in_channels, nf)
        for i in range(cfg.num_blocks):
            setattr(self, f"block_{i + 1}", SPAB(nf))
        self.conv_2 = Conv3XC(nf, nf)
        self.conv_cat = nn.Conv2d(4 * nf, nf, 1)
        self.upsampler = nn.Sequential(
            nn.Conv2d(nf, cfg.out_channels * cfg.scale ** 2, 3, padding=1),
            nn.PixelShuffle(cfg.scale))


def _silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _spab(x: torch.Tensor, blk: SPAB, precision: Precision):
    """(the gated output, out1): out1 feeds the last block's concat."""
    out1 = conv2d(x, blk.c1_r.eval_conv, precision=precision)
    out2 = conv2d(_silu(out1), blk.c2_r.eval_conv, precision=precision)
    out3 = conv2d(_silu(out2), blk.c3_r.eval_conv, precision=precision)
    o3f = out3.float()
    sim_att = torch.sigmoid(o3f) - 0.5
    return ((o3f + x.float()) * sim_att).to(x.dtype), out1


@torch.no_grad()
def span_apply(net: SPAN, x: torch.Tensor, *,
               precision: Precision = Precision()) -> torch.Tensor:
    """[B, H, W, C] -> [B, sH, sW, C] float32: the official forward on the
    fused convs (the output is not un-normalized, as the official one)."""
    cfg = net.cfg
    if cfg.norm and cfg.in_channels == 3:
        mean = torch.tensor(_RGB_MEAN, dtype=torch.float32, device=x.device)
        x = (x.float() - mean) * cfg.img_range
    x = x.to(precision.storage_dtype)
    feat = conv2d(x, net.conv_1.eval_conv, precision=precision)
    h, b1, last_out1 = feat, None, None
    for i in range(cfg.num_blocks):
        h, last_out1 = _spab(h, getattr(net, f"block_{i + 1}"), precision)
        if i == 0:
            b1 = h
    final = conv2d(h, net.conv_2.eval_conv, precision=precision)
    cat = torch.cat([feat, final, b1, last_out1], dim=-1)
    out = conv2d(cat, net.conv_cat, precision=precision)
    up = conv2d(out, net.upsampler[0], precision=precision)
    return pixel_shuffle(up, cfg.scale).float()


def init_span(cfg: SPANConfig = SPANConfig(), seed: int = 0, *,
              device: torch.device | str = "cuda") -> SPAN:
    """A randomly initialized SPAN in the fused layout, its weights drawn
    with numpy from ``seed`` (PyTorch's U(+-sqrt(1/fan_in)))."""
    return init_weights(SPAN, cfg, seed, device)


def _conv3xc_names(num_blocks: int):
    """The Conv3XC prefixes in a forward's order."""
    yield "conv_1"
    for i in range(1, num_blocks + 1):
        for name in _CONV3XC:
            yield f"block_{i}.{name}"
    yield "conv_2"


def official_state_dict(cfg: SPANConfig = SPANConfig(), seed: int = 0, *,
                        gain: int = 2) -> Dict[str, torch.Tensor]:
    """A random SPAN checkpoint in the official (unfused) schema, drawn with
    numpy from ``seed`` in PyTorch's U(+-sqrt(1/fan_in)): each Conv3XC as
    ``sk`` and ``conv.{0,1,2}`` (its chain ``gain`` times wider), plus
    ``conv_cat`` and ``upsampler.0`` (and ``no_norm`` without the input
    normalization); :func:`span_from_state_dict` fuses it."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, Any] = {}

    def conv(name, cout, cin, k):
        bound = (cin * k * k) ** -0.5
        sd[name + ".weight"] = rng.uniform(-bound, bound, (cout, cin, k, k))
        sd[name + ".bias"] = rng.uniform(-bound, bound, (cout,))

    nf = cfg.num_feat
    for name in _conv3xc_names(cfg.num_blocks):
        cin = cfg.in_channels if name == "conv_1" else nf
        conv(name + ".sk", nf, cin, 1)
        conv(name + ".conv.0", cin * gain, cin, 1)
        conv(name + ".conv.1", nf * gain, cin * gain, 3)
        conv(name + ".conv.2", nf, nf * gain, 1)
    conv("conv_cat", nf, 4 * nf, 1)
    conv("upsampler.0", cfg.out_channels * cfg.scale ** 2, nf, 3)
    if not cfg.norm:
        sd["no_norm"] = np.zeros(1)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Checkpoint loading (official SPAN key schema) and the Conv3XC fold
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A tensor or array as float32 numpy (the JAX package's ``to_np``)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def is_span_state_dict(sd: Mapping[str, Any]) -> bool:
    return "block_1.c1_r.sk.weight" in sd and "conv_cat.weight" in sd


def fuse_conv3xc(sd: Mapping[str, Any], prefix: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(OIHW weight, bias) of the dense 3x3 conv that Conv3XC ``prefix``'s
    (1x1 -> 3x3 -> 1x1) chain and 1x1 skip compose to, in float32 numpy:
    w12[m2, i, u, v] = sum_m w2[m2, m, u, v] w1[m, i]; w[o, i, u, v] =
    sum_m2 w3[o, m2] w12[m2, i, u, v]; b12 = w2.sum(taps) @ b1 + b2, b =
    w3 @ b12 + b3; the skip added at the centre tap."""
    w1 = _np(sd[f"{prefix}.conv.0.weight"])          # [cm, cin, 1, 1]
    w2 = _np(sd[f"{prefix}.conv.1.weight"])          # [cm2, cm, 3, 3]
    w3 = _np(sd[f"{prefix}.conv.2.weight"])          # [co, cm2, 1, 1]
    b1 = _np(sd[f"{prefix}.conv.0.bias"])
    b2 = _np(sd[f"{prefix}.conv.1.bias"])
    b3 = _np(sd[f"{prefix}.conv.2.bias"])
    sk_w = _np(sd[f"{prefix}.sk.weight"])            # [co, cin, 1, 1]
    sk_b = _np(sd[f"{prefix}.sk.bias"])
    w12 = np.einsum("nmuv,mi->niuv", w2, w1[:, :, 0, 0])
    w = np.einsum("on,niuv->oiuv", w3[:, :, 0, 0], w12)
    b12 = w2.sum(axis=(2, 3)) @ b1 + b2
    b = w3[:, :, 0, 0] @ b12 + b3
    w[:, :, 1, 1] += sk_w[:, :, 0, 0]
    b += sk_b
    return w, b


_BLOCK_RE = re.compile(r"^block_(\d+)\.")


def span_from_state_dict(sd: Mapping[str, Any], *,
                         device: torch.device | str = "cuda"
                         ) -> Tuple[SPAN, SPANConfig]:
    """(network on ``device``, config) from an official SPAN state dict,
    every Conv3XC fused at load; or from the fused layout of :class:`SPAN`
    (``*.eval_conv`` keys alone, as :func:`span_state_dict_from_jax`
    writes).  ``no_norm`` in the dict turns the input normalization off;
    out_channels = in_channels, as every public SPAN model."""
    fused = "conv_1.sk.weight" not in sd
    if not fused and not is_span_state_dict(sd):
        raise ValueError("not a SPAN state dict")
    n_blocks = max(int(m.group(1)) for k in sd if (m := _BLOCK_RE.match(k)))
    first = sd["conv_1.eval_conv.weight" if fused else "conv_1.sk.weight"]
    nf, cin = (int(d) for d in first.shape[:2])
    w_up = sd["upsampler.0.weight"]
    scale = int(round((int(w_up.shape[0]) // cin) ** 0.5))
    cfg = SPANConfig(in_channels=cin, out_channels=cin, num_feat=nf,
                     num_blocks=n_blocks, scale=scale,
                     norm="no_norm" not in sd)
    out: Dict[str, Any] = {}
    for name in _conv3xc_names(n_blocks):
        if fused:
            w, b = (sd[f"{name}.eval_conv.{p}"] for p in ("weight", "bias"))
        else:
            w, b = fuse_conv3xc(sd, name)
        out[f"{name}.eval_conv.weight"], out[f"{name}.eval_conv.bias"] = w, b
    for name in ("conv_cat", "upsampler.0"):
        for p in ("weight", "bias"):
            out[f"{name}.{p}"] = sd[f"{name}.{p}"]
    with torch.device("meta"):
        net = SPAN(cfg)
    return load_module(net, out, "SPAN", device), cfg
