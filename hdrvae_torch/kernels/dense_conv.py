"""ESRGAN's dense 3x3 convolution (K6): the CUDA kernel and its plain
PyTorch version, as ``hdrvae/kernels/conv3x3.py::dense_conv3x3``.

``y = [residual + res_scale *] act(conv3x3(concat(inputs)) + bias)`` with
1-5 inputs [B, H, W, c_i], an HWIO kernel [3, 3, sum(c_i), Cout] with
Cout <= 128, ``act`` None or "lrelu" (slope 0.2).  The concat is never
formed: the kernel (``csrc/dense_conv.cu``) walks the inputs as K steps.

The wrapper runs the plain version only when the first input lies on the
CPU.  On a CUDA tensor it launches the kernel or raises: the kernel takes
bf16 inputs, kernel and residual, and stores bf16 or float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build

MAX_INPUTS = 5
MAX_COUT = 128
LRELU_SLOPE = 0.2


def dense_conv3x3_reference(inputs: Sequence[torch.Tensor],
                            kernel: torch.Tensor, bias: torch.Tensor, *,
                            act: Optional[str] = None,
                            residual: Optional[torch.Tensor] = None,
                            res_scale: float = 1.0,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain version of :func:`dense_conv3x3`: ``torch.cat`` and a SAME
    conv in exact float32 (TF32 off) of the inputs' values, then the
    epilogue in float32 and one cast to ``out_dtype``, the points at which
    the kernel rounds."""
    _require(act in (None, "lrelu"), f"dense_conv3x3: unknown act {act!r}")
    out_dtype = out_dtype or inputs[0].dtype
    x = torch.cat([t.float() for t in inputs], dim=-1)
    with fp32_contractions(Precision.parity()):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     kernel.float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    if act == "lrelu":
        y = torch.where(y >= 0, y, LRELU_SLOPE * y)
    if residual is not None:
        y = residual.float() + res_scale * y
    return y.to(out_dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_bf16(name: str, t: torch.Tensor, shape) -> None:
    _require(t.dtype == torch.bfloat16,
             f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")


def padded_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cout] -> the kernel's [9, Cin, NP] layout, Cout
    zero-padded to NP = 16 * ceil(Cout / 16)."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    w = kernel.reshape(9, cin, cout)
    pad = -cout % 16
    return (F.pad(w, (0, pad)) if pad else w).contiguous()


def dense_conv3x3(inputs: Sequence[torch.Tensor], kernel: torch.Tensor,
                  bias: torch.Tensor, *, act: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None,
                  res_scale: float = 1.0,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One dense conv (K6).

    ``inputs``: 1-5 tensors [B, H, W, c_i]; ``kernel`` [3, 3, sum(c_i),
    Cout], Cout <= 128; ``bias`` [Cout]; ``residual`` [B, H, W, Cout].
    Returns [B, H, W, Cout] in ``out_dtype`` (default: the inputs').

    Launches ``csrc/dense_conv.cu`` for CUDA inputs (bf16 inputs, kernel
    and residual; bf16 or float32 out); runs
    :func:`dense_conv3x3_reference` for CPU inputs.
    """
    x0 = inputs[0]
    if x0.device.type == "cpu":
        return dense_conv3x3_reference(inputs, kernel, bias, act=act,
                                       residual=residual,
                                       res_scale=res_scale,
                                       out_dtype=out_dtype)
    _require(x0.is_cuda, f"dense_conv3x3: unsupported device {x0.device}")
    _require(1 <= len(inputs) <= MAX_INPUTS,
             f"dense_conv3x3: 1-{MAX_INPUTS} inputs, got {len(inputs)}")
    _require(act in (None, "lrelu"), f"dense_conv3x3: unknown act {act!r}")
    _require(x0.dim() == 4, f"x must be [B, H, W, C], got {tuple(x0.shape)}")
    b, h, w, _ = x0.shape
    cins = [t.shape[-1] for t in inputs]
    for i, t in enumerate(inputs):
        _check_bf16(f"inputs[{i}]", t, (b, h, w, cins[i]))
    cout = kernel.shape[-1]
    _require(1 <= cout <= MAX_COUT,
             f"dense_conv3x3: Cout must be 1-{MAX_COUT}, got {cout}")
    _check_bf16("kernel", kernel, (3, 3, sum(cins), cout))
    out_dtype = out_dtype or x0.dtype
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"dense_conv3x3: the CUDA kernel stores bf16 or float32, not "
             f"{out_dtype}")
    bias = bias.float().contiguous()
    _require(tuple(bias.shape) == (cout,), f"bias must be [{cout}]")
    if residual is not None:
        _check_bf16("residual", residual, (b, h, w, cout))
    for t in (*inputs, kernel, bias, residual):
        _require(t is None or t.device == x0.device,
                 "dense_conv3x3: every operand must be on the inputs' device")

    wp = padded_weights(kernel)
    y = torch.empty(b, h, w, cout, device=x0.device, dtype=out_dtype)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (MAX_INPUTS - len(inputs))
    chans = cins + [0] * (MAX_INPUTS - len(inputs))
    _build.check(_build.library().hdrvae_dense_conv3x3(
        *ptrs, *chans, len(inputs), wp.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        b, h, w, cout, int(act == "lrelu"), float(res_scale),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x0.device).cuda_stream),
        "hdrvae_dense_conv3x3")
    dense_conv3x3.launches += 1
    return y


dense_conv3x3.launches = 0
