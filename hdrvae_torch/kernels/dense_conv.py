"""ESRGAN's dense 3x3 convolution (K6): the CUDA kernel and its plain
PyTorch version, as ``hdrvae/kernels/conv3x3.py::dense_conv3x3``.

``y = [residual + res_scale *] act(conv3x3(concat(inputs)) + bias)`` with
1-5 inputs [B, H, W, c_i], an HWIO kernel [3, 3, sum(c_i), Cout] with
Cout <= 128, ``act`` None or "lrelu" (slope 0.2).  The concat is never
formed: the kernel (``csrc/dense_conv.cu``) walks the inputs as K chunks.

The kernel reads its weights in a layout of its own, which
:func:`prepare_weights` builds from the HWIO kernel; a model prepares each
conv once (``models/rrdbnet_fused.py``) and passes the
:class:`DenseWeights`.  A call with a plain HWIO kernel prepares it on the
fly.

The wrapper runs the plain version only when the first input lies on the
CPU.  On a CUDA tensor it launches the kernel or raises: the kernel takes
bf16 inputs, weights and residual, and stores bf16 or float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build

MAX_INPUTS = 5
MAX_COUT = 128
LRELU_SLOPE = 0.2
# dense_conv.cu: Cout is padded to the first of these (its wgmma N), K runs
# in chunks of _KC channels
_NP_STEPS = (8, 16, 32, 64, 128)
_KC = 16


def padded_cout(cout: int) -> int:
    """The kernel's N: the first of 8, 16, 32, 64, 128 that holds Cout."""
    return next(n for n in _NP_STEPS if n >= cout)


def packs_taps(cins: Sequence[int]) -> bool:
    """True where the kernel packs K across the nine taps: one input
    narrower than one K chunk (conv_first's 3 or 12 channels)."""
    return len(cins) == 1 and cins[0] < _KC


@dataclasses.dataclass(frozen=True)
class DenseWeights:
    """One conv's weights as the kernel reads them (:func:`prepare_weights`).

    ``w`` [nchunks, taps, NP/8, 2, 8, 8]: for each K chunk of 16 channels
    (each input's last one zero-padded; packed: 16 rows of the im2col'd K,
    tap-major) and tap (9; packed: 1), K-major 8 x 8 core matrices [8 n][8
    k] ordered (n group, k group), zero past Cout.  ``bias`` [NP] float32,
    zero past Cout.  ``kernel`` is the HWIO kernel the plain version takes.
    """

    w: torch.Tensor
    bias: torch.Tensor
    kernel: torch.Tensor
    cins: tuple
    cout: int

    @property
    def packed(self) -> bool:
        return packs_taps(self.cins)


def _chunk_rows(kernel: torch.Tensor, cins: Sequence[int]) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cout] -> [taps, K, Cout] float32 in the kernel's K
    order: per input its channels, zero-padded to a multiple of 16, nine
    taps; packed, one tap of the 9 c im2col rows (tap-major), zero-padded."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    k = kernel.float().reshape(9, cin, cout)
    if packs_taps(cins):
        rows = k.reshape(1, 9 * cin, cout)
        return F.pad(rows, (0, 0, 0, -rows.shape[1] % _KC))
    parts, off = [], 0
    for c in cins:
        parts.append(F.pad(k[:, off:off + c], (0, 0, 0, -c % _KC)))
        off += c
    return torch.cat(parts, dim=1)


def prepare_weights(kernel: torch.Tensor, bias: torch.Tensor,
                    cins: Sequence[int]) -> DenseWeights:
    """The kernel's weights of one conv, in ``kernel``'s dtype and device:
    HWIO [3, 3, sum(cins), Cout] -> :class:`DenseWeights`.  Counts itself
    in ``prepare_weights.preparations``."""
    cins = tuple(int(c) for c in cins)
    cout = kernel.shape[-1]
    _require(kernel.dim() == 4 and tuple(kernel.shape[:3]) == (3, 3,
                                                               sum(cins)),
             f"kernel must be [3, 3, {sum(cins)}, Cout], got "
             f"{tuple(kernel.shape)}")
    _require(1 <= cout <= MAX_COUT,
             f"dense_conv3x3: Cout must be 1-{MAX_COUT}, got {cout}")
    np_ = padded_cout(cout)
    rows = F.pad(_chunk_rows(kernel, cins), (0, np_ - cout))
    taps, kp = rows.shape[:2]
    # [taps, chunk, k group, k, n group, n] -> [chunk, taps, n group,
    # k group, n, k]
    w = rows.reshape(taps, kp // _KC, 2, 8, np_ // 8, 8)
    w = w.permute(1, 0, 4, 2, 5, 3).contiguous().to(kernel.dtype)
    prepare_weights.preparations += 1
    return DenseWeights(w=w, bias=F.pad(bias.float(), (0, np_ - cout)),
                        kernel=kernel, cins=cins, cout=cout)


prepare_weights.preparations = 0


def dense_conv3x3_as_gemm(inputs: Sequence[torch.Tensor],
                          weights: DenseWeights) -> torch.Tensor:
    """The kernel's GEMM in float32, from the prepared layout: per K chunk
    and tap the shifted window of that chunk's 16 zero-padded channels (or
    of the packed im2col rows) times the chunk's [16, NP] slice decoded
    from its core matrices.  Returns the accumulator [B, H, W, Cout]
    (before bias and epilogue)."""
    b, h, w, _ = inputs[0].shape
    nch, taps, ng = weights.w.shape[:3]
    np_ = 8 * ng
    # [chunk, taps, n group, k group, n, k] -> [chunk, taps, 16 k, NP]
    wk = weights.w.float().permute(0, 1, 3, 5, 2, 4).reshape(nch, taps, _KC,
                                                             np_)
    if weights.packed:
        xp = F.pad(inputs[0].float(), (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, di:di + h, dj:dj + w] for di in range(3)
                          for dj in range(3)], dim=-1)
        chunks = F.pad(cols, (0, nch * _KC - cols.shape[-1]))
        windows = [[chunks[..., ci * _KC:(ci + 1) * _KC]]
                   for ci in range(nch)]
    else:
        windows = []
        for x in inputs:
            xp = F.pad(x.float(), (0, -x.shape[-1] % _KC, 1, 1, 1, 1))
            for c0 in range(0, xp.shape[-1], _KC):
                windows.append([xp[:, di:di + h, dj:dj + w, c0:c0 + _KC]
                                for di in range(3) for dj in range(3)])
    _require(len(windows) == nch, "prepared weights do not match the inputs")
    acc = torch.zeros(b, h, w, np_, device=inputs[0].device)
    with fp32_contractions(Precision.parity()):
        for ci, taps_a in enumerate(windows):
            for tap, a in enumerate(taps_a):
                acc = acc + a @ wk[ci, tap]
    return acc[..., :weights.cout]


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


def dense_conv3x3(inputs: Sequence[torch.Tensor],
                  kernel: Union[torch.Tensor, DenseWeights],
                  bias: Optional[torch.Tensor] = None, *,
                  act: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None,
                  res_scale: float = 1.0,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One dense conv (K6).

    ``inputs``: 1-5 tensors [B, H, W, c_i]; ``kernel`` the conv's
    :class:`DenseWeights` (bias inside; ``bias`` must then be None) or an
    HWIO [3, 3, sum(c_i), Cout] kernel with its ``bias`` [Cout], prepared
    here; Cout <= 128; ``residual`` [B, H, W, Cout].  Returns [B, H, W,
    Cout] in ``out_dtype`` (default: the inputs').

    Launches ``csrc/dense_conv.cu`` for CUDA inputs (bf16 inputs, weights
    and residual; bf16 or float32 out); runs :func:`dense_conv3x3_reference`
    for CPU inputs.
    """
    _require(act in (None, "lrelu"), f"dense_conv3x3: unknown act {act!r}")
    _require(1 <= len(inputs) <= MAX_INPUTS,
             f"dense_conv3x3: 1-{MAX_INPUTS} inputs, got {len(inputs)}")
    x0 = inputs[0]
    if isinstance(kernel, DenseWeights):
        _require(bias is None, "dense_conv3x3: prepared weights carry the "
                 "bias; pass bias=None")
        dw = kernel
    else:
        _require(bias is not None, "dense_conv3x3: an HWIO kernel needs its "
                 "bias")
        if x0.device.type == "cpu":
            return dense_conv3x3_reference(inputs, kernel, bias, act=act,
                                           residual=residual,
                                           res_scale=res_scale,
                                           out_dtype=out_dtype)
        dw = None
    if x0.device.type == "cpu":
        return dense_conv3x3_reference(inputs, dw.kernel, dw.bias[:dw.cout],
                                       act=act, residual=residual,
                                       res_scale=res_scale,
                                       out_dtype=out_dtype)
    _require(x0.is_cuda, f"dense_conv3x3: unsupported device {x0.device}")
    _require(x0.dim() == 4, f"x must be [B, H, W, C], got {tuple(x0.shape)}")
    b, h, w, _ = x0.shape
    cins = [t.shape[-1] for t in inputs]
    for i, t in enumerate(inputs):
        _check_bf16(f"inputs[{i}]", t, (b, h, w, cins[i]))
    if dw is None:
        _check_bf16("kernel", kernel, (3, 3, sum(cins), kernel.shape[-1]))
        _require(bias.device == x0.device,
                 "dense_conv3x3: every operand must be on the inputs' device")
        dw = prepare_weights(kernel, bias, cins)
    _require(dw.cins == tuple(cins),
             f"dense_conv3x3: weights prepared for widths {dw.cins}, inputs "
             f"are {tuple(cins)}")
    _require(dw.w.dtype == torch.bfloat16,
             f"weights: the CUDA kernel takes bf16, got {dw.w.dtype}")
    cout = dw.cout
    out_dtype = out_dtype or x0.dtype
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"dense_conv3x3: the CUDA kernel stores bf16 or float32, not "
             f"{out_dtype}")
    if residual is not None:
        _check_bf16("residual", residual, (b, h, w, cout))
    for t in (*inputs, dw.w, dw.bias, residual):
        _require(t is None or t.device == x0.device,
                 "dense_conv3x3: every operand must be on the inputs' device")

    y = torch.empty(b, h, w, cout, device=x0.device, dtype=out_dtype)
    ptrs = [t.data_ptr() for t in inputs] + [None] * (MAX_INPUTS - len(inputs))
    chans = cins + [0] * (MAX_INPUTS - len(inputs))
    _build.check(_build.library().hdrvae_dense_conv3x3(
        *ptrs, *chans, len(inputs), dw.w.data_ptr(), dw.bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        b, h, w, cout, padded_cout(cout), int(dw.packed),
        int(act == "lrelu"), float(res_scale),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x0.device).cuda_stream),
        "hdrvae_dense_conv3x3")
    dense_conv3x3.launches += 1
    return y


dense_conv3x3.launches = 0
