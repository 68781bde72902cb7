"""Spatial self-attention of the decoder's mid block, as
``hdrvae/kernels/attention.py``.

- :func:`spatial_attention_reference`: the plain version, scores
  materialized, exact float32 dots, float32 softmax.
- :func:`spatial_attention_3pass_reference`: the plain version of the mixed
  tier's arithmetic, the JAX kernel's ``HIGH`` mode (``_dot3``): both dots
  as three bf16 passes (hi.hi + hi.lo + lo.hi) summed in float32.
- :func:`flash_attention_bf16`, :func:`flash_attention_3pass` and
  :func:`flash_attention_f32` (K3): the flash kernels of
  ``csrc/attention.cu``, one per dot mode.
- :func:`spatial_attention`: the dispatch by tier.  Fast runs the bf16
  kernel, mixed the 3-pass bf16x3 kernel, parity (and a float32-compute
  fast tier) the exact float32 kernel.

q, k, v are [B, H, W, C] (NHWC) at every public function; the output is
float32 [B, H, W, C].  Every function takes ``key_valid``, an optional [H,
W] bool map on q's device shared by the batch (the JAX package's
``key_valid=``, a shape-bucketed decode's pad exclusion): a key outside it
drops out of the softmax, as if it were not there.  A mask with no live key
gives NaN rows.  Each kernel wrapper runs its plain version only when q lies
on the CPU; on a CUDA tensor it launches its kernel or raises.  Beside its
``launches`` each wrapper counts its launches with a mask in
``launches_masked``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build
from hdrvae_torch.kernels.f32_dot import f32_dot_reference

_MAX_C = 512   # the kernels keep C / 64 <= 8 column tiles per thread group


def _dead_keys(key_valid: Optional[torch.Tensor], n: int
               ) -> Optional[torch.Tensor]:
    """The [N] additive score bias of ``key_valid``: 0 for a live key, -inf
    for a dead one (the kernels' -inf; the JAX package's -1e12 gives the
    same weights, 0 in float32), or None."""
    if key_valid is None:
        return None
    dead = ~key_valid.reshape(n).bool()
    return torch.zeros(n, device=dead.device).masked_fill_(dead,
                                                           float("-inf"))


def spatial_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                key_valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v over the flattened spatial dims, with the
    N x N scores materialized: exact float32 (TF32 off), float32 softmax;
    the keys outside ``key_valid`` score -inf."""
    b, h, w, c = q.shape
    n = h * w
    qf = q.reshape(b, n, c).float()
    kf = k.reshape(b, n, c).float()
    vf = v.reshape(b, n, c).float()
    bias = _dead_keys(key_valid, n)
    with fp32_contractions(Precision.parity()):
        logits = (qf * c ** -0.5) @ kf.transpose(1, 2)
        if bias is not None:
            logits += bias
        out = torch.softmax(logits, dim=-1) @ vf
    return out.reshape(b, h, w, c)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the JAX package's ``_dot3`` (K12's plain "high" mode): each
    float32 operand split into bf16 hi + lo, hi.hi + hi.lo + lo.hi as
    float32 matmuls of the bf16 values, TF32 off."""
    return f32_dot_reference(a, b, precision="high")


def spatial_attention_3pass_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      key_valid: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """The mixed tier's attention as ``_flash_kernel`` computes it in HIGH,
    scores materialized: q scaled by C^-1/2 in float32, then split; s =
    _dot3(q, k^T), the keys outside ``key_valid`` at -inf; p = exp(s -
    rowmax), split the same way for _dot3(p, v); divided by the row sum."""
    b, h, w, c = q.shape
    n = h * w
    qs = q.reshape(b, n, c).float() * c ** -0.5
    s = _dot3(qs, k.reshape(b, n, c).float().transpose(1, 2))
    bias = _dead_keys(key_valid, n)
    if bias is not None:
        s += bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = _dot3(p, v.reshape(b, n, c).float()) / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, w, c)


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dtype: torch.dtype,
            key_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, h, w, c = q.shape
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype or tuple(t.shape) != (b, h, w, c):
            raise ValueError(f"{name}: {nm} must be {dtype} {(b, h, w, c)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share a device")
    if c % 64 != 0 or c > _MAX_C:
        raise ValueError(f"{name}: C must be a multiple of 64 up to "
                         f"{_MAX_C}, got {c}")
    kv_ptr = None
    if key_valid is not None:
        if tuple(key_valid.shape) != (h, w) or key_valid.device != q.device:
            raise ValueError(f"{name}: key_valid must be [H, W] = "
                             f"{(h, w)} on {q.device}, got "
                             f"{tuple(key_valid.shape)} on "
                             f"{key_valid.device}")
        key_valid = key_valid.reshape(h * w).to(torch.uint8).contiguous()
        kv_ptr = key_valid.data_ptr()
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty(b, h, w, c, device=q.device, dtype=torch.float32)
    fn = getattr(_build.library(), "hdrvae_" + name)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_ptr,
                    out.data_ptr(), b, h * w, c, float(c ** -0.5),
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    return out


def flash_attention_bf16(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor,
                         key_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Fast-tier flash attention (K3): bf16 q, k, v on the tensor cores
    with float32 accumulation and an online float32 softmax; float32 out.
    Runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return spatial_attention_reference(q, k, v, key_valid)
    out = _launch("flash_attention_bf16", q, k, v, torch.bfloat16, key_valid)
    flash_attention_bf16.launches += 1
    flash_attention_bf16.launches_masked += key_valid is not None
    return out


flash_attention_bf16.launches = 0
flash_attention_bf16.launches_masked = 0


def flash_attention_3pass(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          key_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mixed-tier flash attention (K3 in HIGH): float32 q, k, v, each split
    once into bf16 hi + lo; both dots as hi.hi + hi.lo + lo.hi on the
    tensor cores into float32 accumulators, an online float32 softmax whose
    probabilities are split the same way.  Runs
    :func:`spatial_attention_3pass_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return spatial_attention_3pass_reference(q, k, v, key_valid)
    out = _launch("flash_attention_3pass", q, k, v, torch.float32, key_valid)
    flash_attention_3pass.launches += 1
    flash_attention_3pass.launches_masked += key_valid is not None
    return out


flash_attention_3pass.launches = 0
flash_attention_3pass.launches_masked = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor,
                        key_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Parity-tier flash attention (K3 in HIGHEST): exact float32 dot
    products on the CUDA cores (never TF32), online float32 softmax.  Runs
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return spatial_attention_reference(q, k, v, key_valid)
    out = _launch("flash_attention_f32", q, k, v, torch.float32, key_valid)
    flash_attention_f32.launches += 1
    flash_attention_f32.launches_masked += key_valid is not None
    return out


flash_attention_f32.launches = 0
flash_attention_f32.launches_masked = 0


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      precision: Precision = Precision(),
                      key_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The mid attention in the tier's dot mode: the bf16 kernel for a bf16
    compute dtype (the fast tier), the 3-pass kernel for the mixed tier,
    the exact float32 kernel otherwise (parity, a float32-compute fast
    tier).  Every size goes through the kernel; there is no size gate.
    ``key_valid`` ([H, W] bool) drops the keys outside it."""
    mask = {} if key_valid is None else {"key_valid": key_valid}
    if precision.compute_dtype == torch.bfloat16:
        cdt = torch.bfloat16
        return flash_attention_bf16(q.to(cdt), k.to(cdt), v.to(cdt), **mask)
    if precision.mode == "mixed":
        return flash_attention_3pass(q.float(), k.float(), v.float(), **mask)
    return flash_attention_f32(q.float(), k.float(), v.float(), **mask)
