"""The arithmetic of the plain references: every convolution and matrix
product in float32 with TF32 off, its operands first rounded by one of
four rules.  ``fp32`` leaves them as they are (the reference itself);
``tf32`` rounds them to TF32's 10-bit mantissa (the control of a float32
tier); ``bf16`` to bfloat16 (the yardstick of a bf16 tier's gap, below);
``fp8`` scales each operand tensor by its largest magnitude into float8
e4m3 and back (the control of a bf16 tier).  Accumulation is float32 in
all four."""

from __future__ import annotations

import contextlib

import torch

ROUNDINGS = ("fp32", "tf32", "bf16", "fp8")
_FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at TF32's 10 mantissa bits (13 bits of a
    float32 dropped)."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rounder(rounding: str):
    if rounding not in ROUNDINGS:
        raise ValueError(f"rounding must be one of {ROUNDINGS}")
    if rounding == "tf32":
        return _tf32
    if rounding == "fp8":
        return _fp8
    if rounding == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    return lambda x: x


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convolutions and cuBLAS products while open."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
