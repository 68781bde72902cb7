"""The model's work, counted from the configuration's shapes: each
operation of the model once and each input, weight and output byte of a
layer once, whatever kernels carry it out.  A kernel that splits a
product into three passes, or fuses two layers, leaves these counts as
they are.  Operations are those that ``torch.utils.flop_counter`` counts
(convolutions and matrix products, 2 a multiply-add); normalizations,
activations and resampling are left out of both."""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.harness.models import FluxDecoder, RRDBNet

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3.  Every
# share reads against these, in every tier.
PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

Work = Dict[str, Dict[str, float]]    # class -> {"flops", "bytes"}


def _add(work: Work, cls: str, flops: float, nbytes: float) -> None:
    w = work.setdefault(cls, {"flops": 0.0, "bytes": 0.0})
    w["flops"] += flops
    w["bytes"] += nbytes


def _conv(work: Work, b: int, hw: int, cin: int, cout: int, k: int,
          elsize: int) -> None:
    flops = 2.0 * b * hw * cin * cout * k * k
    nbytes = elsize * (b * hw * (cin + cout) + cout * cin * k * k + cout)
    _add(work, "conv", flops, nbytes)


def decoder_work(m: FluxDecoder, b: int, h: int, w: int,
                 elsize: int) -> Work:
    """One decoder forward of a [b, h, w, z] latent: the convs (3x3 and
    1x1, the attention's projections among them) and the mid attention's
    two products over h * w tokens."""
    work: Work = {}
    top = m.widths[-1]
    hw = h * w

    def resnet(hw_, cin, cout):
        _conv(work, b, hw_, cin, cout, 3, elsize)
        _conv(work, b, hw_, cout, cout, 3, elsize)
        if cin != cout:
            _conv(work, b, hw_, cin, cout, 1, elsize)

    _conv(work, b, hw, m.z, top, 3, elsize)
    resnet(hw, top, top)
    if m.attn:
        for _ in range(4):
            _conv(work, b, hw, top, top, 1, elsize)
        _add(work, "attn", 4.0 * b * hw * hw * top,
             elsize * 4 * b * hw * top)
    resnet(hw, top, top)
    cin, res = top, hw
    for level in reversed(range(m.levels)):
        cout = m.widths[level]
        for j in range(m.blocks):
            resnet(res, cin if j == 0 else cout, cout)
        cin = cout
        if level != 0:
            res *= 4
            _conv(work, b, res, cout, cout, 3, elsize)
    _conv(work, b, res, m.widths[0], m.out, 3, elsize)
    return work


def rrdbnet_work(m: RRDBNet, b: int, h: int, w: int, elsize: int) -> Work:
    """One RRDBNet forward of a whole [b, h, w, 3] image (no tiles)."""
    work: Work = {}
    hw = h * w
    _conv(work, b, hw, m.cin, m.nf, 3, elsize)
    for _ in range(m.nb * 3):
        for k in range(1, 6):
            _conv(work, b, hw, m.nf + (k - 1) * m.gc,
                  m.gc if k < 5 else m.nf, 3, elsize)
    _conv(work, b, hw, m.nf, m.nf, 3, elsize)
    for _ in range(m.ups):
        hw *= 4
        _conv(work, b, hw, m.nf, m.nf, 3, elsize)
    _conv(work, b, hw, m.nf, m.nf, 3, elsize)
    _conv(work, b, hw, m.nf, m.cout, 3, elsize)
    return work


def scaled(work: Work, k: float) -> Work:
    return {c: {q: v * k for q, v in d.items()} for c, d in work.items()}


def total_flops(work: Work) -> float:
    return sum(d["flops"] for d in work.values())


def bound_s(entry: Dict[str, float]) -> Tuple[float, str]:
    """The least time the card could take for a class's work: the larger
    of its operations over the bf16 peak and its bytes over the memory
    rate, and which of the two it is."""
    t_ops = entry["flops"] / PEAK_FLOPS
    t_bytes = entry["bytes"] / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
