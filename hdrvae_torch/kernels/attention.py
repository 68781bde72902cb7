"""Spatial self-attention of the decoder's mid block, as
``hdrvae/kernels/attention.py``.

- :func:`spatial_attention_reference`: the plain version, scores
  materialized, exact float32 dots, float32 softmax.
- :func:`spatial_attention_3pass_reference`: the plain version of the mixed
  tier's arithmetic, the JAX kernel's ``HIGH`` mode (``_dot3``): both dots
  as three bf16 passes (hi.hi + hi.lo + lo.hi) summed in float32.
- :func:`flash_attention_bf16`, :func:`flash_attention_3pass` and
  :func:`flash_attention_f32` (K3): the flash kernels of
  ``csrc/attention.cu``, one per dot mode.  The 3-pass one runs on the
  bf16 parts of :func:`split_qkv` (``_dot3``'s split, once a launch);
  :func:`spatial_attention_3pass_parts` is its plain version on them.
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
from hdrvae_torch.kernels.f32_dot import f32_dot_reference, split_bf16

_MAX_C = 512   # the kernels keep C / 64 <= 8 column tiles per thread group
_LOG2E = 1.4426950408889634


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, the same on every run.  On the CPU,
    ``torch.exp`` of float32 runs MKL's vsExp, whose first call in each
    worker thread races on a loaded machine and can return a result good
    to ~12 bits (1.5e-4 relative) for that thread's share of the tensor;
    ATen's own exp2 keeps no such state.  Here exp(x) = exp2(x log2 e) in
    float64, rounded once to float32 (correctly rounded but for ties
    within 1e-14).  CUDA tensors take ``torch.exp``."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double() * _LOG2E).float()


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
    p = exp_f32(s - s.amax(dim=-1, keepdim=True))
    out = _dot3(p, v.reshape(b, n, c).float()) / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, w, c)


def _prepare(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             dtype: torch.dtype, key_valid: Optional[torch.Tensor]):
    """The checks every kernel wrapper makes: (q, k, v contiguous, the
    [N] uint8 key_valid or None)."""
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
    if key_valid is not None:
        if tuple(key_valid.shape) != (h, w) or key_valid.device != q.device:
            raise ValueError(f"{name}: key_valid must be [H, W] = "
                             f"{(h, w)} on {q.device}, got "
                             f"{tuple(key_valid.shape)} on "
                             f"{key_valid.device}")
        key_valid = key_valid.reshape(h * w).to(torch.uint8).contiguous()
    return (*(t.contiguous() for t in (q, k, v)), key_valid)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dtype: torch.dtype,
            key_valid: Optional[torch.Tensor]) -> torch.Tensor:
    q, k, v, key_valid = _prepare(name, q, k, v, dtype, key_valid)
    b, h, w, c = q.shape
    out = torch.empty(b, h, w, c, device=q.device, dtype=torch.float32)
    fn = getattr(_build.library(), "hdrvae_" + name)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    _ptr(key_valid), out.data_ptr(), b, h * w, c,
                    float(c ** -0.5),
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


def split_qkv_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`split_qkv`: [3, 2, *q.shape] bf16, the hi
    and lo parts (hi = bf16(x), lo = bf16(x - hi), ``_dot3``'s split) of q
    times C^-1/2 (in float32, before the split), of k and of v."""
    scale = q.shape[-1] ** -0.5
    return torch.stack([torch.stack(split_bf16(x)) for x in
                        (q.float() * scale, k.float(), v.float())])


def split_qkv(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The 3-pass kernel's operands, split once a launch: [3, 2, *q.shape]
    bf16 (q's scaled by C^-1/2 first), as :func:`split_qkv_reference`.
    Launches ``csrc/attention.cu``'s ``split_qkv_kernel`` for CUDA float32
    q, k, v of one shape; runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return split_qkv_reference(q, k, v)
    q, k, v, _ = _prepare("split_qkv", q, k, v, torch.float32, None)
    parts = torch.empty(3, 2, *q.shape, device=q.device,
                        dtype=torch.bfloat16)
    _build.check(_build.library().hdrvae_split_qkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), parts.data_ptr(),
        q.numel(), float(q.shape[-1] ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream), "split_qkv")
    split_qkv.launches += 1
    return parts


split_qkv.launches = 0


def spatial_attention_3pass_parts(parts: torch.Tensor,
                                  key_valid: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The 3-pass attention on the parts of :func:`split_qkv` (what the
    3-pass kernel computes from them), scores materialized: s = qh.kh +
    qh.kl + ql.kh, the keys outside ``key_valid`` at -inf; p = exp(s -
    rowmax) (:func:`exp_f32`) split as _dot3 splits it, ph.vh + ph.vl +
    pl.vh; divided by the row sum.  Equals :func:`spatial_attention_3pass_reference` on q, k, v
    bit for bit."""
    b, h, w, c = parts.shape[2:]
    n = h * w
    qh, ql, kh, kl, vh, vl = (t.reshape(b, n, c).float()
                              for t in parts.reshape(6, b, n, c))
    kh, kl = kh.transpose(1, 2), kl.transpose(1, 2)
    with fp32_contractions(Precision.parity()):
        s = qh @ kh + qh @ kl + ql @ kh
        bias = _dead_keys(key_valid, n)
        if bias is not None:
            s += bias
        p = exp_f32(s - s.amax(dim=-1, keepdim=True))
        ph, pl = (t.float() for t in split_bf16(p))
        out = (ph @ vh + ph @ vl + pl @ vh) / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, w, c)


def flash_attention_3pass(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          key_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mixed-tier flash attention (K3 in HIGH): float32 q, k, v, split
    once by :func:`split_qkv` into bf16 hi + lo (q scaled first); both dots
    as hi.hi + hi.lo + lo.hi on the tensor cores into float32 accumulators,
    an online float32 softmax whose probabilities are split the same way.
    Runs :func:`spatial_attention_3pass_reference` for CPU tensors."""
    if q.device.type == "cpu":
        return spatial_attention_3pass_reference(q, k, v, key_valid)
    name = "flash_attention_3pass"
    q, k, v, kv = _prepare(name, q, k, v, torch.float32, key_valid)
    parts = split_qkv(q, k, v)
    b, h, w, c = q.shape
    out = torch.empty(b, h, w, c, device=q.device, dtype=torch.float32)
    _build.check(_build.library().hdrvae_flash_attention_3pass(
        parts.data_ptr(), _ptr(kv), out.data_ptr(), b, h * w, c,
        torch.cuda.current_stream(q.device).cuda_stream), name)
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
