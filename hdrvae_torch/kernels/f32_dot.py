"""A float32 matrix product in three precisions (K12): the CUDA kernel and
its plain PyTorch version, the counterpart of
``tools/perf/pallas_f32_dot_probe.py::pallas_dot``, the probe that prices
float32 contractions against bf16 tensor-core passes.

    highest  exact float32 products and sums (the CUDA cores' FFMA; TF32,
             with its 10 mantissa bits, is not exact)
    high     the bf16x3 split of ``hdrvae/kernels/attention.py::_dot3``:
             each operand v = hi + lo, hi = bf16(v), lo = bf16(v - hi), and
             hi.hi + hi.lo + lo.hi with float32 sums (what the mixed tier's
             3-pass contractions compute)
    default  what a TPU's DEFAULT float32 dot does: each operand rounded to
             bf16 once, one pass, float32 sums

The wrapper runs the plain version only for a CPU tensor.  On a CUDA tensor
it launches ``csrc/f32_dot.cu`` or raises: the kernel takes float32 x [M,
K] and w [K, N] with M and N multiples of 64 and K of 32.  In "high" and
"default" it first launches :func:`split_w`, which writes w's bf16 parts
once (transposed, the layout the tensor-core kernel reads).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build

PRECISIONS = ("highest", "high", "default")   # the kernel's mode numbers


def split_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) in bf16 with t ~ hi + lo: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _mode(precision: str) -> int:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")
    return PRECISIONS.index(precision)


def f32_dot_reference(x: torch.Tensor, w: torch.Tensor, *,
                      precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`f32_dot`: float32 matmuls (TF32 off) of the
    operands or of their bf16 parts."""
    _mode(precision)
    with fp32_contractions(Precision.parity()):
        if precision == "highest":
            return x.float() @ w.float()
        if precision == "default":
            return x.bfloat16().float() @ w.bfloat16().float()
        (xh, xl), (wh, wl) = split_bf16(x.float()), split_bf16(w.float())
        return (xh.float() @ wh.float() + xh.float() @ wl.float()
                + xl.float() @ wh.float())


def split_w_reference(w: torch.Tensor, *, lo: bool = True) -> torch.Tensor:
    """Plain version of :func:`split_w`: [2, N, K] bf16 (hi, lo of w^T), or
    [1, N, K] (hi) without ``lo``."""
    hi, low = split_bf16(w.float().t())
    return torch.stack([hi, low] if lo else [hi]).contiguous()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def split_w(w: torch.Tensor, *, lo: bool = True) -> torch.Tensor:
    """w [K, N] float32 -> its bf16 parts transposed, [2, N, K] (hi, lo)
    or [1, N, K] (hi): what "high" and "default" multiply by, written once
    a launch.  Launches ``csrc/f32_dot.cu``'s split for CUDA inputs; runs
    :func:`split_w_reference` for CPU ones."""
    if w.device.type == "cpu":
        return split_w_reference(w, lo=lo)
    _require(w.is_cuda, f"split_w: unsupported device {w.device}")
    _require(w.dim() == 2 and w.dtype == torch.float32 and w.is_contiguous(),
             f"split_w: a contiguous float32 w [K, N] expected, got "
             f"{w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    _require(k % 32 == 0 and n % 64 == 0 and k > 0 and n > 0,
             f"split_w: K {k} must be a multiple of 32, N {n} of 64")
    parts = torch.empty(2 if lo else 1, n, k, device=w.device,
                        dtype=torch.bfloat16)
    _build.check(_build.library().hdrvae_f32_dot_split_w(
        w.data_ptr(), parts.data_ptr(), k, n, int(lo),
        torch.cuda.current_stream(w.device).cuda_stream),
        "hdrvae_f32_dot_split_w")
    split_w.launches += 1
    _build.nan_check("split_w", parts)
    return parts


split_w.launches = 0


def f32_dot(x: torch.Tensor, w: torch.Tensor, *,
            precision: str = "highest") -> torch.Tensor:
    """y [M, N] = x [M, K] @ w [K, N] in float32 at ``precision``
    ("highest", "high" or "default", module doc).

    Launches ``csrc/f32_dot.cu`` for CUDA inputs (after :func:`split_w` in
    "high" and "default"); runs :func:`f32_dot_reference` for CPU ones."""
    mode = _mode(precision)
    if x.device.type == "cpu":
        return f32_dot_reference(x, w, precision=precision)
    _require(x.is_cuda, f"f32_dot: unsupported device {x.device}")
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"f32_dot: x [M, K] and w [K, N] expected, got "
             f"{tuple(x.shape)} and {tuple(w.shape)}")
    (m, k), n = x.shape, w.shape[1]
    _require(m % 64 == 0 and n % 64 == 0 and k % 32 == 0 and min(m, n, k) > 0,
             f"f32_dot: M {m} and N {n} must be multiples of 64, K {k} of 32")
    for name, t in (("x", x), ("w", w)):
        _require(t.dtype == torch.float32,
                 f"f32_dot: the CUDA kernel takes float32 {name}, got "
                 f"{t.dtype}")
        _require(t.is_contiguous(), f"f32_dot: {name} must be contiguous")
        _require(t.device == x.device, f"f32_dot: {name} is not on "
                 f"{x.device}")
    # highest reads w itself, the tensor-core modes its bf16 parts
    wk = w if mode == 0 else split_w(w, lo=precision == "high")
    y = torch.empty(m, n, device=x.device, dtype=torch.float32)
    _build.check(_build.library().hdrvae_f32_dot(
        x.data_ptr(), wk.data_ptr(), y.data_ptr(), m, n, k, mode,
        torch.cuda.current_stream(x.device).cuda_stream), "hdrvae_f32_dot")
    f32_dot.launches += 1
    _build.nan_check("f32_dot", y)
    return y


f32_dot.launches = 0
