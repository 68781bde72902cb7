"""The benchmark's own view of each configuration: the published key
layout of its weights, the weights made on the device from the seed, and
the shapes the work arithmetic and the reference read.  Nothing here
imports the program."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Layout = List[Tuple[str, Tuple[int, ...]]]


@dataclasses.dataclass(frozen=True)
class FluxDecoder:
    """The AutoencoderKL decoder of a diffusers ``vae/config.json``."""

    z: int
    widths: Tuple[int, ...]       # block_out_channels, level 0 first
    blocks: int                   # layers_per_block + 1 ResNets a level
    groups: int
    out: int
    attn: bool
    scale: float
    shift: float
    eps: float = 1e-6

    @property
    def levels(self) -> int:
        return len(self.widths)

    @property
    def factor(self) -> int:
        return 2 ** (self.levels - 1)

    @classmethod
    def from_config(cls, c: Dict[str, Any]) -> "FluxDecoder":
        return cls(z=int(c["latent_channels"]),
                   widths=tuple(int(w) for w in c["block_out_channels"]),
                   blocks=int(c["layers_per_block"]) + 1,
                   groups=int(c["norm_num_groups"]),
                   out=int(c["out_channels"]),
                   attn=bool(c["mid_block_add_attention"]),
                   scale=float(c["scaling_factor"]),
                   shift=float(c["shift_factor"]),
                   eps=float(c.get("assumed", {}).get("norm_eps", 1e-6)))


@dataclasses.dataclass(frozen=True)
class RRDBNet:
    """Real-ESRGAN's RRDBNet(num_in_ch, num_out_ch, num_feat, num_block,
    num_grow_ch, scale)."""

    cin: int
    cout: int
    nf: int
    nb: int
    gc: int
    scale: int

    @property
    def ups(self) -> int:
        return int(np.log2(self.scale))

    @classmethod
    def from_config(cls, c: Dict[str, Any]) -> "RRDBNet":
        return cls(cin=int(c["num_in_ch"]), cout=int(c["num_out_ch"]),
                   nf=int(c["num_feat"]), nb=int(c["num_block"]),
                   gc=int(c["num_grow_ch"]), scale=int(c["scale"]))


def model_of(config: Dict[str, Any]):
    kind = config["model"]
    if kind == "autoencoderkl_decoder":
        return FluxDecoder.from_config(config)
    if kind == "rrdbnet":
        return RRDBNet.from_config(config)
    raise ValueError(f"unknown model kind {kind!r}")


def _conv(name: str, cin: int, cout: int, k: int = 3) -> Layout:
    return [(f"{name}.weight", (cout, cin, k, k)), (f"{name}.bias", (cout,))]


def _norm(name: str, c: int) -> Layout:
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _resnet(name: str, cin: int, cout: int) -> Layout:
    out = (_norm(f"{name}.norm1", cin) + _conv(f"{name}.conv1", cin, cout)
           + _norm(f"{name}.norm2", cout) + _conv(f"{name}.conv2", cout, cout))
    if cin != cout:
        out += _conv(f"{name}.nin_shortcut", cin, cout, 1)
    return out


def decoder_layout(m: FluxDecoder) -> Layout:
    """The ldm decoder keys of ``ae.safetensors`` (without the ``decoder.``
    prefix) and their shapes."""
    top = m.widths[-1]
    out = _conv("conv_in", m.z, top)
    out += _resnet("mid.block_1", top, top)
    if m.attn:
        out += _norm("mid.attn_1.norm", top)
        for p in ("q", "k", "v", "proj_out"):
            out += _conv(f"mid.attn_1.{p}", top, top, 1)
    out += _resnet("mid.block_2", top, top)
    cin = top
    for level in reversed(range(m.levels)):
        cout = m.widths[level]
        for j in range(m.blocks):
            out += _resnet(f"up.{level}.block.{j}", cin if j == 0 else cout,
                           cout)
        cin = cout
        if level != 0:
            out += _conv(f"up.{level}.upsample.conv", cout, cout)
    out += _norm("norm_out", m.widths[0])
    out += _conv("conv_out", m.widths[0], m.out)
    return out


def rrdbnet_layout(m: RRDBNet) -> Layout:
    """The ``params_ema`` keys of RealESRGAN_x4plus.pth and their shapes."""
    out = _conv("conv_first", m.cin, m.nf)
    for i in range(m.nb):
        for r in (1, 2, 3):
            for k in range(1, 6):
                out += _conv(f"body.{i}.rdb{r}.conv{k}",
                             m.nf + (k - 1) * m.gc, m.gc if k < 5 else m.nf)
    out += _conv("conv_body", m.nf, m.nf)
    for i in range(m.ups):
        out += _conv(f"conv_up{i + 1}", m.nf, m.nf)
    out += _conv("conv_hr", m.nf, m.nf)
    out += _conv("conv_last", m.nf, m.cout)
    return out


def layout_of(m) -> Layout:
    return decoder_layout(m) if isinstance(m, FluxDecoder) \
        else rrdbnet_layout(m)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of a run's seed: weights,
    inputs and samples draw from different streams of the same seed."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


WEIGHTS, INPUTS, SAMPLES, SCHEDULE = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_weights(m, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``m`` in its published layout, float32 on
    ``device``: one uniform draw on the device for every tensor, then
    each conv weight and bias scaled to U(+-sqrt(1/fan_in)) (PyTorch's
    default) and each GroupNorm to scale 1 + U(+-0.1), bias U(+-0.1).
    The same seed gives the same weights on the same device."""
    layout = layout_of(m)
    sizes = [int(np.prod(s)) for _, s in layout]
    flat = torch.rand(sum(sizes), generator=generator(seed, WEIGHTS, device),
                      device=device, dtype=torch.float32).mul_(2).sub_(1)
    shapes = dict(layout)
    sd, off = {}, 0
    for (name, shape), n in zip(layout, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        module, kind = name.rsplit(".", 1)
        wshape = shapes[module + ".weight"]
        if len(wshape) == 1:          # a GroupNorm
            t = t.mul(0.1).add_(1.0) if kind == "weight" else t.mul(0.1)
        else:
            t = t.mul(float(np.sqrt(1.0 / int(np.prod(wshape[1:])))))
        sd[name] = t
    return sd


def published_keys(m, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` under the checkpoint's own key names: the decoder's with the
    ``decoder.`` prefix of ``ae.safetensors``, RRDBNet's as they are."""
    if isinstance(m, FluxDecoder):
        return {f"decoder.{k}": v for k, v in sd.items()}
    return dict(sd)
