"""ESRGAN-family RRDBNet on PyTorch, NHWC at the boundaries, as
``hdrvae/models/rrdbnet.py``.

Topology: conv_first -> nb x RRDB (each three dense blocks of five convs,
LeakyReLU(0.2), residual scale 0.2) -> conv_body (+ residual) ->
log2(scale * unshuffle) x [nearest 2x + conv + lrelu] -> conv_hr + lrelu ->
conv_last.  RealESRGAN's x2/x1 variants pixel-unshuffle the input first.

:class:`RRDBNet` is an ``nn.Module`` whose parameter names are the
new-schema checkpoint keys (``conv_first``, ``body.N.rdbJ.convK``,
``conv_body``, ``conv_upI``, ``conv_hr``, ``conv_last``);
:func:`rrdbnet_from_state_dict` also takes the old ``model.N`` schema.
:func:`rrdbnet_apply` runs the layers, or, for a CUDA input in the fast
tier, the fused K6 chain of ``models/rrdbnet_fused.py``.
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
from hdrvae_torch.models.layers import conv2d, nearest_upsample_2x

LRELU_SLOPE = 0.2
RESIDUAL_SCALE = 0.2


@dataclasses.dataclass(frozen=True)
class RRDBNetConfig:
    in_channels: int = 3   # image channels, before any unshuffle
    out_channels: int = 3
    nf: int = 64           # feature width
    nb: int = 23           # RRDB blocks
    gc: int = 32           # dense growth channels
    scale: int = 4         # net upscale factor
    # RealESRGAN x2 / x1 pixel-unshuffle the input (3 -> 12 / 48 channels)
    # and keep the 4x upsample stack: net scale 4 / unshuffle.
    unshuffle: int = 1

    @property
    def num_upsamples(self) -> int:
        return max(0, int(np.log2(self.scale * self.unshuffle)))

    def with_small(self) -> "RRDBNetConfig":
        return dataclasses.replace(self, nf=8, nb=2, gc=4, scale=2)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class DenseBlock(nn.Module):
    """ResidualDenseBlock_5C: conv_i takes nf + (i - 1) * gc channels."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", _conv(nf + (i - 1) * gc, gc))
        self.conv5 = _conv(nf + 4 * gc, nf)


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = DenseBlock(nf, gc)
        self.rdb2 = DenseBlock(nf, gc)
        self.rdb3 = DenseBlock(nf, gc)


class RRDBNet(nn.Module):
    """The network's weights under new-schema names; :func:`rrdbnet_apply`
    runs it."""

    def __init__(self, cfg: RRDBNetConfig = RRDBNetConfig()):
        super().__init__()
        self.cfg = cfg
        nf = cfg.nf
        self.conv_first = _conv(cfg.in_channels * cfg.unshuffle ** 2, nf)
        self.body = nn.ModuleList(RRDB(nf, cfg.gc) for _ in range(cfg.nb))
        self.conv_body = _conv(nf, nf)
        for i in range(cfg.num_upsamples):
            setattr(self, f"conv_up{i + 1}", _conv(nf, nf))
        self.conv_hr = _conv(nf, nf)
        self.conv_last = _conv(nf, cfg.out_channels)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LRELU_SLOPE * x)


def _dense_block(x: torch.Tensor, blk: DenseBlock,
                 precision: Precision) -> torch.Tensor:
    feats = [x]
    for i in range(1, 5):
        feats.append(lrelu(conv2d(torch.cat(feats, dim=-1),
                                  getattr(blk, f"conv{i}"),
                                  precision=precision)))
    y = conv2d(torch.cat(feats, dim=-1), blk.conv5, precision=precision)
    return x + RESIDUAL_SCALE * y


def _rrdb(x: torch.Tensor, blk: RRDB, precision: Precision) -> torch.Tensor:
    h = _dense_block(x, blk.rdb1, precision)
    h = _dense_block(h, blk.rdb2, precision)
    h = _dense_block(h, blk.rdb3, precision)
    return x + RESIDUAL_SCALE * h


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``F.pixel_unshuffle`` on NHWC: [B, H, W, C] -> [B, H/r, W/r, C*r*r]
    in torch's channel order (c*r*r + i*r + j), the order converted
    conv_first kernels were trained on."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def unshuffle_input(x: torch.Tensor, r: int) -> torch.Tensor:
    """RealESRGANer's pre-process: reflect-pad H and W up to multiples of
    ``r``, then pixel-unshuffle."""
    pad_h, pad_w = (-x.shape[1]) % r, (-x.shape[2]) % r
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                  mode="reflect").permute(0, 2, 3, 1)
    return pixel_unshuffle(x, r)


def rrdbnet_layers(net: RRDBNet, x: torch.Tensor, *,
                   precision: Precision = Precision()) -> torch.Tensor:
    """The layer path: [B, H, W, C] -> [B, scale*H, scale*W, C] on the
    layers' own ops (``conv2d`` per tier, ``torch.cat`` before each dense
    conv)."""
    cfg = net.cfg
    h0, w0 = x.shape[1], x.shape[2]
    if cfg.unshuffle > 1:
        x = unshuffle_input(x, cfg.unshuffle)
    fea = conv2d(x, net.conv_first, precision=precision)
    trunk = fea
    for blk in net.body:
        trunk = _rrdb(trunk, blk, precision)
    fea = fea + conv2d(trunk, net.conv_body, precision=precision)
    for i in range(cfg.num_upsamples):
        fea = lrelu(conv2d(nearest_upsample_2x(fea),
                           getattr(net, f"conv_up{i + 1}"),
                           precision=precision))
    fea = lrelu(conv2d(fea, net.conv_hr, precision=precision))
    out = conv2d(fea, net.conv_last, precision=precision)
    if cfg.unshuffle > 1:   # crop the pre-pad region
        out = out[:, :h0 * cfg.scale, :w0 * cfg.scale]
    return out


@torch.no_grad()
def rrdbnet_apply(net: RRDBNet, x: torch.Tensor, *,
                  precision: Precision = Precision()) -> torch.Tensor:
    """Upscale NHWC [B, H, W, C] -> [B, scale*H, scale*W, C].

    ``precision.upstack`` "auto": a CUDA input in the fast tier runs the
    fused chain (every conv one ``dense_conv3x3`` launch, K6); otherwise
    the layers run, as the JAX package runs its XLA layers off the TPU.
    "xla": the layers always.  "pallas": the fused chain (on a CPU tensor
    K6's plain version), which takes only the fast tier.
    """
    if precision.upstack == "pallas" and precision.mode != "fast":
        raise ValueError(
            "precision.upstack='pallas' runs the fused chain, which takes "
            f"only the fast tier (got mode={precision.mode!r})")
    if precision.mode == "fast" and (
            precision.upstack == "pallas"
            or (precision.upstack == "auto" and x.is_cuda)):
        from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply
        return rrdbnet_fused_apply(net, x, precision=precision)
    return rrdbnet_layers(net, x, precision=precision)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_rrdbnet(cfg: RRDBNetConfig = RRDBNetConfig(), seed: int = 0, *,
                 device: torch.device | str = "cuda") -> RRDBNet:
    """A randomly initialized network, its weights drawn with numpy from
    ``seed`` in PyTorch's default U(+-sqrt(1/fan_in)) for weight and
    bias."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = RRDBNet(cfg).state_dict()
    sd = {}
    for name, t in shapes.items():
        wshape = tuple(shapes[name.rsplit(".", 1)[0] + ".weight"].shape)
        bound = float(np.sqrt(1.0 / (wshape[1] * wshape[2] * wshape[3])))
        sd[name] = rng.uniform(-bound, bound, tuple(t.shape)).astype(
            np.float32)
    return _from_tensors(sd, cfg, device)


def _from_tensors(sd: Mapping[str, Any], cfg: RRDBNetConfig,
                  device: torch.device | str) -> RRDBNet:
    """A network on ``device`` holding a new-schema state dict (tensors or
    numpy arrays); gradients off."""
    tensors = {k: v.detach().float() if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v, np.float32))
               for k, v in sd.items()}
    with torch.device("meta"):
        net = RRDBNet(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(tensors)
    return net.requires_grad_(False).eval()


# old schema: model.0 = conv_first; model.1.sub.N.RDBj.convk.0 = the RRDB
# convs; model.1.sub.<nb> = conv_body; then the upsample convs (model.3,
# model.6, ...), conv_hr and conv_last as the remaining model.K convs
_OLD_RDB_RE = re.compile(
    r"^model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d)\.0\.(weight|bias)$")
_NEW_RDB_RE = re.compile(r"^body\.(\d+)\.rdb(\d)\.conv(\d)\.(weight|bias)$")
_OLD_PLAIN_RE = re.compile(r"^model\.(\d+)\.weight$")


def detect_architecture(sd: Mapping[str, Any]) -> str:
    if "model.0.weight" in sd:
        return "esrgan-old"
    if "conv_first.weight" in sd:
        return "esrgan-new"
    raise ValueError(
        "unrecognized upscale checkpoint schema; expected old-arch ESRGAN "
        "(model.0.weight ...) or new-arch RRDBNet (conv_first.weight ...)")


def _old_to_new(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Old-schema keys renamed to the new schema (no tensor copied)."""
    nb = max(int(m.group(1)) for k in sd if (m := _OLD_RDB_RE.match(k))) + 1
    plain = sorted(int(m.group(1)) for k in sd
                   if (m := _OLD_PLAIN_RE.match(k)))
    tail = [i for i in plain if i != 0]
    names = {0: "conv_first", tail[-2]: "conv_hr", tail[-1]: "conv_last"}
    for n, idx in enumerate(tail[:-2]):
        names[idx] = f"conv_up{n + 1}"
    out = {}
    for idx, name in names.items():
        for p in ("weight", "bias"):
            out[f"{name}.{p}"] = sd[f"model.{idx}.{p}"]
    for p in ("weight", "bias"):
        out[f"conv_body.{p}"] = sd[f"model.1.sub.{nb}.{p}"]
    for k, v in sd.items():
        if m := _OLD_RDB_RE.match(k):
            i, j, c, p = m.groups()
            out[f"body.{i}.rdb{j}.conv{c}.{p}"] = v
    return out


def rrdbnet_from_state_dict(sd: Mapping[str, Any], *,
                            device: torch.device | str = "cuda"
                            ) -> Tuple[RRDBNet, RRDBNetConfig]:
    """(network on ``device``, config) from either public ESRGAN key schema
    (tensors or numpy arrays), with the width, depth, growth, upscale
    factor and RealESRGAN unshuffle inferred from the shapes."""
    if detect_architecture(sd) == "esrgan-old":
        sd = _old_to_new(sd)
    nb = max(int(m.group(1)) for k in sd if (m := _NEW_RDB_RE.match(k))) + 1
    nf, in_ch = (int(d) for d in sd["conv_first.weight"].shape[:2])
    gc = int(sd["body.0.rdb1.conv1.weight"].shape[0])
    out_ch = int(sd["conv_last.weight"].shape[0])
    ups = [k for k in sd if k.startswith("conv_up") and k.endswith(".weight")]
    # RealESRGAN x2 / x1: conv_first takes the unshuffled input (4x or 16x
    # the output channels) and the upsample stack stays 4x
    unshuffle = {out_ch * 4: 2, out_ch * 16: 4}.get(in_ch, 1)
    cfg = RRDBNetConfig(in_channels=in_ch // unshuffle ** 2,
                        out_channels=out_ch, nf=nf, nb=nb, gc=gc,
                        scale=2 ** len(ups) // unshuffle,
                        unshuffle=unshuffle)
    return _from_tensors(sd, cfg, device), cfg
