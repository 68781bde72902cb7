"""SRVGGNetCompact ("Compact": realesr-general-x4v3, realesr-animevideov3)
on PyTorch, NHWC at the boundaries, as ``hdrvae/models/srvgg.py``.

Topology: num_conv + 1 3x3 convs at num_feat with PReLU (ReLU or
LeakyReLU(0.1)) between, a last conv to out_channels * scale^2, the pixel
shuffle, plus the nearest-upsampled input.  :class:`SRVGG` is an
``nn.Module`` on the official BasicSR keys: ``body.{2i}`` the convs,
``body.{2i + 1}`` the activations (a PReLU's ``weight`` [num_feat]; ReLU
variants have none), the last ``body`` entry the head conv.

The whole net is 3x3 convs at 64 features: the layers run it
(``F.conv2d`` per tier) in every tier, as the JAX package leaves it to
XLA's conv emitter (no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from hdrvae_torch.core.config import Precision
from hdrvae_torch.models.layers import conv2d
from hdrvae_torch.models.swinir import init_weights, load_module, \
    pixel_shuffle


@dataclasses.dataclass(frozen=True)
class SRVGGConfig:
    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 64
    num_conv: int = 32          # hidden convs (body has num_conv + 2)
    scale: int = 4
    act: str = "prelu"          # "prelu" | "relu" | "leakyrelu"

    def with_small(self) -> "SRVGGConfig":
        return dataclasses.replace(self, num_feat=8, num_conv=2)


def _act_module(kind: str, nf: int) -> nn.Module:
    if kind == "prelu":
        return nn.PReLU(nf)
    if kind == "leakyrelu":
        return nn.LeakyReLU(0.1)
    return nn.ReLU()


class SRVGG(nn.Module):
    """The network's weights under the official keys; :func:`srvgg_apply`
    runs it."""

    def __init__(self, cfg: SRVGGConfig = SRVGGConfig()):
        super().__init__()
        self.cfg = cfg
        layers, cin = [], cfg.in_channels
        for _ in range(cfg.num_conv + 1):
            layers += [nn.Conv2d(cin, cfg.num_feat, 3, padding=1),
                       _act_module(cfg.act, cfg.num_feat)]
            cin = cfg.num_feat
        layers.append(nn.Conv2d(cfg.num_feat, cfg.out_channels
                                * cfg.scale ** 2, 3, padding=1))
        self.body = nn.ModuleList(layers)


def _act(x: torch.Tensor, kind: str, module: nn.Module) -> torch.Tensor:
    """The activation in x's dtype: PReLU's slope rounded to it first."""
    if kind == "prelu":
        a = module.weight.to(x.dtype)
        return torch.where(x >= 0, x, a * x)
    if kind == "leakyrelu":
        return torch.where(x >= 0, x, 0.1 * x)
    return torch.relu(x)


def nearest(x: torch.Tensor, s: int) -> torch.Tensor:
    """``F.interpolate(mode="nearest", scale_factor=s)`` on NHWC."""
    return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


@torch.no_grad()
def srvgg_apply(net: SRVGG, x: torch.Tensor, *,
                precision: Precision = Precision()) -> torch.Tensor:
    """[B, H, W, C] -> [B, sH, sW, C]: BasicSR's forward, body -> pixel
    shuffle -> + nearest(x) (the storage-dtype body added to x by type
    promotion, as the JAX package adds them)."""
    cfg = net.cfg
    h = x
    for i in range(cfg.num_conv + 1):
        h = conv2d(h, net.body[2 * i], precision=precision)
        h = _act(h, cfg.act, net.body[2 * i + 1])
    h = conv2d(h, net.body[-1], precision=precision)
    return pixel_shuffle(h, cfg.scale) + nearest(x, cfg.scale)


def _draw(name: str, shape: tuple, rng) -> np.ndarray | None:
    """PReLU slopes around PyTorch's 0.25, distinct per channel."""
    if len(shape) == 1 and int(name.split(".")[1]) % 2 == 1:
        return rng.uniform(0.1, 0.4, shape)
    return None


def init_srvgg(cfg: SRVGGConfig = SRVGGConfig(), seed: int = 0, *,
               device: torch.device | str = "cuda") -> SRVGG:
    """A randomly initialized Compact net, its weights drawn with numpy from
    ``seed`` (convs PyTorch's U(+-sqrt(1/fan_in)), PReLU slopes U(0.1,
    0.4))."""
    return init_weights(SRVGG, cfg, seed, device, draw=_draw)


# ---------------------------------------------------------------------------
# Checkpoint loading (official BasicSR key schema)
# ---------------------------------------------------------------------------

_BODY_RE = re.compile(r"^body\.(\d+)\.(weight|bias)$")


def is_srvgg_state_dict(sd: Mapping[str, Any]) -> bool:
    """body.0.weight is a 4-D conv and there is no RRDB / Swin spine."""
    if "body.0.weight" not in sd:
        return False
    if any(k.startswith(("conv_first", "model.", "layers.",
                         "conv_body")) for k in sd):
        return False
    return len(tuple(sd["body.0.weight"].shape)) == 4


def srvgg_from_state_dict(sd: Mapping[str, Any], *,
                          device: torch.device | str = "cuda"
                          ) -> Tuple[SRVGG, SRVGGConfig]:
    """(network on ``device``, config) from the official schema (tensors or
    numpy arrays): the convs are the 4-D ``body`` weights in index order,
    the PReLU slopes the 1-D ones (none: ReLU); the scale follows from the
    head's out_channels * scale^2 (out_channels = in_channels, as every
    public Compact model)."""
    idx = sorted({int(m.group(1)) for k in sd if (m := _BODY_RE.match(k))})
    conv_idx = [i for i in idx if len(sd[f"body.{i}.weight"].shape) == 4]
    act_idx = [i for i in idx if len(sd[f"body.{i}.weight"].shape) == 1]
    last = conv_idx[-1]
    nf, cin = (int(d) for d in sd["body.0.weight"].shape[:2])
    cout_last = int(sd[f"body.{last}.weight"].shape[0])
    scale = int(round((cout_last // cin) ** 0.5))
    if cin * scale * scale != cout_last:
        raise ValueError(f"Compact head channels {cout_last} are not "
                         f"in_ch*scale^2 (in_ch={cin})")
    cfg = SRVGGConfig(in_channels=cin, out_channels=cin, num_feat=nf,
                      num_conv=len(conv_idx) - 2, scale=scale,
                      act="prelu" if act_idx else "relu")
    out = {}
    for n, i in enumerate(conv_idx):
        for p in ("weight", "bias"):
            out[f"body.{2 * n}.{p}"] = sd[f"body.{i}.{p}"]
    for n, i in enumerate(act_idx):
        out[f"body.{2 * n + 1}.weight"] = sd[f"body.{i}.weight"]
    with torch.device("meta"):
        net = SRVGG(cfg)
    return load_module(net, out, "Compact", device), cfg
