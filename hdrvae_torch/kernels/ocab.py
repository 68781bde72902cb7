"""HAT's overlapping cross-attention core (K8): the CUDA kernel and its
plain PyTorch version, as ``hdrvae/kernels/ocab.py::ocab_attention``.

Per (window, head): softmax(q k^T + bias) v with q [nq, 32] (scale folded
in), k / v [nk, 32] (head dim zero-padded to 32: exact), bias [nq, nk]
float32.  Scores and softmax in float32, the probabilities rounded to the
compute dtype for their product with v, the output stored in the storage
dtype.  HAT-M's shape: nq = 16^2 = 256 queries, nk = 24^2 = 576 keys.

The wrapper runs the plain version only for a CPU tensor.  On a CUDA
tensor it launches ``csrc/ocab.cu`` or raises: the kernel takes bf16 q, k
and v.  Token counts that are no multiple of 16 are zero-padded around the
launch (padded keys get a -inf bias, padded queries are cropped).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build
from hdrvae_torch.kernels.attention import exp_f32

HDP = 32
MAX_KEYS = 624   # HAT-M: 576; the kernel's resident bias takes up to 640


def use_ocab_kernel(precision: Precision, x: torch.Tensor, head_dim: int,
                    nk: int) -> bool:
    """Whether OCAB's attention runs as K8 (``use_ocab_kernel``): the fast
    tier on a CUDA tensor with head_dim <= 32.  The JAX gate's VMEM bound
    (``_MAX_SCORE_ELEMS``, a v5e budget) is gone; the kernel's own limit
    is nk <= 624 keys (HAT-M: 576).  ``precision.swin_attn`` forces either
    path, as for the Swin blocks."""
    knob = precision.swin_attn
    if knob == "xla":
        return False
    ok = head_dim <= HDP and nk <= MAX_KEYS
    if knob == "pallas":
        if not ok:
            raise ValueError(f"swin_attn='pallas' but OCAB's head_dim "
                             f"{head_dim} > {HDP} or {nk} keys > {MAX_KEYS}")
        return True
    if knob != "auto":
        raise ValueError(f"unknown swin_attn {knob!r}")
    return precision.mode == "fast" and x.is_cuda and ok


def ocab_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor, *,
                             compute_dtype: torch.dtype,
                             storage_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`ocab_attention` (the JAX kernel's order and
    rounding), exact float32 products of the operands' values."""
    q, k, v = (t.to(compute_dtype) for t in (q, k, v))
    with fp32_contractions(Precision.parity()):
        s = q.float() @ k.float().transpose(-1, -2) + bias.float()
        m = s.amax(dim=-1, keepdim=True)
        e = exp_f32(s - m)
        p = (e / e.sum(dim=-1, keepdim=True)).to(compute_dtype)
        o = p.float() @ v.float()
    return o.to(storage_dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def ocab_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, *, compute_dtype: torch.dtype,
                   storage_dtype: torch.dtype) -> torch.Tensor:
    """OCAB's attention core (K8).  q [nwb, heads, nq, 32], k / v [nwb,
    heads, nk, 32], bias [heads, nq, nk] float32; returns [nwb, heads, nq,
    32] in ``storage_dtype``.

    Launches ``csrc/ocab.cu`` for CUDA inputs (bf16 compute and storage);
    runs :func:`ocab_attention_reference` for CPU ones.
    """
    if q.device.type == "cpu":
        return ocab_attention_reference(q, k, v, bias,
                                        compute_dtype=compute_dtype,
                                        storage_dtype=storage_dtype)
    _require(q.is_cuda, f"ocab_attention: unsupported device {q.device}")
    _require(compute_dtype == torch.bfloat16 and
             storage_dtype == torch.bfloat16,
             f"ocab_attention: the CUDA kernel takes bf16, got "
             f"{compute_dtype} / {storage_dtype}")
    nwb, heads, nq, hdp = q.shape
    nk = k.shape[2]
    _require(hdp == HDP, f"ocab_attention: head dim must be padded to {HDP}")
    _require(tuple(k.shape) == tuple(v.shape) == (nwb, heads, nk, HDP),
             f"ocab_attention: k / v must be [{nwb}, {heads}, nk, {HDP}]")
    _require(tuple(bias.shape) == (heads, nq, nk),
             f"ocab_attention: bias must be [{heads}, {nq}, {nk}]")
    _require(nk <= MAX_KEYS, f"ocab_attention: {nk} keys > {MAX_KEYS}")
    for t in (k, v, bias):
        _require(t.device == q.device,
                 "ocab_attention: every operand must be on q's device")
    pq, pk = -nq % 16, -nk % 16
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    bias = bias.float()
    if pq or pk:
        q = F.pad(q, (0, 0, 0, pq))
        k, v = F.pad(k, (0, 0, 0, pk)), F.pad(v, (0, 0, 0, pk))
        bias = F.pad(F.pad(bias, (0, pk), value=float("-inf")), (0, 0, 0, pq))
    q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    out = torch.empty_like(q)
    _build.check(_build.library().hdrvae_ocab_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), nwb, heads, nq + pq, nk + pk,
        torch.cuda.current_stream(q.device).cuda_stream),
        "hdrvae_ocab_attention")
    ocab_attention.launches += 1
    return out[:, :, :nq] if pq else out


ocab_attention.launches = 0
