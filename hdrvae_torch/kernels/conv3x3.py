"""The decoder's fused 3x3 convolutions: CUDA kernels and their plain
PyTorch versions, as ``hdrvae/kernels/conv3x3.py``.

- :func:`fused_conv3x3` (K1): ``y = conv3x3(silu(x * gamma + beta)) + bias
  [+ r | + r @ res_kernel]``, optionally with the per-group (sum, sumsq) of
  y as stored.
- :func:`upsample_conv3x3` (K2): ``y = act(conv3x3(nearest2x(x)) + bias)``
  from the low-resolution map through the 2x2 phase decomposition, optionally
  with the same statistics, or (``stats_only``) the statistics alone.
- :func:`upconv_gn_conv3x3` (K5): ``conv3x3(silu(gn_affine(
  conv3x3(nearest2x(x)) + up_bias))) + bias`` and its statistics, with the
  upsampled map held only on chip: the streaming top level of the decoder.

Layouts are the JAX package's: x [B, H, W, C] NHWC, conv kernels HWIO
[3, 3, Cin, Cout], ``res_kernel`` [Cr, Cout].  Statistics are per sample:
(sum [B, G], sumsq [B, G]).  K1 and K2 take ``owned_rows`` = (lo, hi), host
ints at the output's resolution: the statistics then count only output rows
lo <= r < hi, the rows a slab shard owns (``sharding/mesh.py``), and y is
the same.

Each wrapper runs its plain version only when ``x`` lies on the CPU.  On a
CUDA tensor it launches the kernel (``csrc/conv3x3.cu``, ``csrc/upconv.cu``)
or raises: the kernels take bf16 activations and weights (the fast tier)
and nothing else.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build

Sums = Tuple[torch.Tensor, torch.Tensor]   # (sum [B, G], sumsq [B, G])
OwnedRows = Optional[Tuple[int, int]]      # [lo, hi) of the output's rows
LRELU_SLOPE = 0.2                          # K2's act="lrelu"

# conv3x3.cu (K1, K2): a work item's tile is _TR rows x _TWP pixels (K2: of
# the low-resolution map, for one output phase); the kernels take Cin and Cr
# multiples of _CIN_STEP and Cout of _COUT_STEP
_TR, _TWP, _CIN_STEP, _COUT_STEP = 4, 64, 16, 64
_ALL_ROWS = 2 ** 31 - 1                    # own_hi of an unrestricted launch
# upconv.cu (K5): its work item's output tile, _K5_TH rows x _K5_TW pixels
# (one statistics partial each), and its Cin step
_K5_TH, _K5_TW, _K5_CIN_STEP = 4, 64, 16

# Row/column tap sets of the phase decomposition: output pixel (2i+a, .) of
# conv3x3(nearest2x(x)) reads input rows i-1+u, u in {0, 1}, with the 3x3
# taps partitioned per phase (a=0: u=0 <- row 0, u=1 <- rows 1,2; a=1:
# u=0 <- rows 0,1, u=1 <- row 2); the same along columns.
_PHASE_SELECT = np.array(
    [[[1, 0, 0], [0, 1, 1]],
     [[1, 1, 0], [0, 0, 1]]], np.float32)


@functools.cache
def _phase_select(device: torch.device) -> torch.Tensor:
    """_PHASE_SELECT on ``device``, copied there once: a copy from pageable
    host memory on every call would wait for the device's queued work."""
    return torch.from_numpy(_PHASE_SELECT).to(device)


def phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> the [2, 2, 2, 2, Cin, Cout] (a, b, u, v) phase
    kernels of conv3x3 o nearest2x, summed in float32 and rounded to the
    kernel's dtype (so in bf16 they differ from the bf16 taps' exact sums
    by up to one bf16 ulp of the sum)."""
    sel = _phase_select(kernel.device)
    pk = torch.einsum("aud,bve,decf->abuvcf", sel, sel, kernel.float())
    return pk.to(kernel.dtype)


def conv_tiles(h: int, w: int) -> int:
    """Tiles of conv3x3.cu's K1 / K2 over an [h, w] (K2: low-resolution)
    map: the partial count T of K1's statistics (K2's is 4 T, one a
    phase)."""
    return -(-h // _TR) * -(-w // _TWP)


def upconv_tiles(h: int, w: int) -> int:
    """Work items of upconv.cu's K5 over a low-resolution [h, w] map (its
    output is [2 h, 2 w]): the partial count T of its statistics."""
    return -(-2 * h // _K5_TH) * -(-2 * w // _K5_TW)


def _owned_span(owned_rows: OwnedRows, h: int) -> Tuple[int, int]:
    """The rows r of [0, h) with lo <= r < hi, as a slice's (start, stop)
    (bounds outside the map select no row there)."""
    if owned_rows is None:
        return 0, h
    lo = min(max(int(owned_rows[0]), 0), h)
    return lo, min(max(int(owned_rows[1]), lo), h)


def conv_partials(y: torch.Tensor, upsampled: bool = False,
                  owned_rows: OwnedRows = None) -> torch.Tensor:
    """Plain version of the kernels' statistics partials: y [B, Ho, Wo, C]
    (K2: the upsampled map) -> [B, T, 2, C] float32, the per-channel (sum,
    sumsq) of each tile, indexed as conv3x3.cu writes them (K1: tile t; K2:
    4 t + the phase 2 a + b of output pixels (2 i + a, 2 j + b)), counting
    only the output rows in ``owned_rows`` when given."""
    b, ho, wo, c = y.shape
    y = y.float()
    if owned_rows is not None:
        lo, hi = _owned_span(owned_rows, ho)
        keep = torch.zeros(ho, dtype=torch.bool, device=y.device)
        keep[lo:hi] = True
        y = y * keep[None, :, None, None]
    if upsampled:
        y = y.reshape(b, ho // 2, 2, wo // 2, 2, c).permute(0, 2, 4, 1, 3, 5)
    else:
        y = y[:, None, None]
    _, pa, pb, h, w, _ = y.shape
    th, tw = -(-h // _TR), -(-w // _TWP)
    y = F.pad(y, (0, 0, 0, tw * _TWP - w, 0, th * _TR - h))
    y = y.reshape(b, pa * pb, th, _TR, tw, _TWP, c)
    y = y.permute(0, 2, 4, 1, 3, 5, 6).reshape(b, th * tw * pa * pb, -1, c)
    return torch.stack([y.sum(dim=2), torch.square(y).sum(dim=2)], dim=2)


def conv3x3_as_gemm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The kernels' GEMM view of a SAME 3x3 conv, in float32: A [pixels,
    9 Cin] (each tap a shifted window of the zero-padded map), B the HWIO
    kernel as it is stored, viewed as [9 Cin, Cout] (no repack)."""
    b, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[:, di:di + h, dj:dj + w] for di in range(3)
                   for dj in range(3)], dim=-1)
    with fp32_contractions(Precision.parity()):
        y = a.reshape(-1, 9 * cin) @ kernel.float().reshape(9 * cin, -1)
    return y.reshape(b, h, w, -1)


def _conv3x3_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of a float32 NHWC map with an HWIO kernel, exact
    float32 (TF32 off)."""
    with fp32_contractions(Precision.parity()):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     kernel.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _group_sums(y: torch.Tensor, num_groups: int,
                owned_rows: OwnedRows = None) -> Sums:
    """Per-group (sum, sumsq) of y's rows in ``owned_rows`` (all: None)."""
    lo, hi = _owned_span(owned_rows, y.shape[1])
    y = y[:, lo:hi]
    b, h, w, c = y.shape
    g = y.float().reshape(b, h * w, num_groups, c // num_groups)
    return g.sum(dim=(1, 3)), torch.square(g).sum(dim=(1, 3))


def _per_sample(v: torch.Tensor, b: int) -> torch.Tensor:
    """[C] or [B, C] float32 -> [B, C]."""
    v = v.float()
    return v.expand(b, v.shape[-1]) if v.dim() == 1 else v


def fused_conv3x3_reference(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, *,
                            gamma: Optional[torch.Tensor] = None,
                            beta: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            res_kernel: Optional[torch.Tensor] = None,
                            emit_stats: bool = False, num_groups: int = 32,
                            out_dtype: Optional[torch.dtype] = None,
                            out: Optional[torch.Tensor] = None,
                            owned_rows: OwnedRows = None):
    """Plain version of :func:`fused_conv3x3`, rounding where the kernel
    does: the prologue output to x's dtype before the taps, y to
    ``out_dtype`` before its statistics (of the ``owned_rows`` alone when
    given).  The SAME zeros are zeros of the normalized activation.
    ``out`` receives y when given."""
    out_dtype = out_dtype or x.dtype
    b = x.shape[0]
    z = x.float()
    if gamma is not None:
        z = (z * _per_sample(gamma, b)[:, None, None, :]
             + _per_sample(beta, b)[:, None, None, :])
        z = (z * torch.sigmoid(z)).to(x.dtype).float()
    y = _conv3x3_f32(z, kernel) + bias.float()
    if residual is not None:
        r = residual.float()
        if res_kernel is not None:
            with fp32_contractions(Precision.parity()):
                r = r @ res_kernel.float()
        y = y + r
    y = y.to(out_dtype)
    if out is not None:
        y = out.copy_(y)
    if emit_stats:
        return y, _group_sums(y, num_groups, owned_rows)
    return y


def _check_act(name: str, act: Optional[str]) -> None:
    _require(act in (None, "lrelu"), f"{name}: unknown act {act!r}")


def upsample_conv3x3_reference(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor, *,
                               emit_stats: bool = False, num_groups: int = 32,
                               out_dtype: Optional[torch.dtype] = None,
                               stats_only: bool = False,
                               act: Optional[str] = None,
                               owned_rows: OwnedRows = None):
    """Plain version of :func:`upsample_conv3x3`: the nearest 2x upsample
    materialized, then the 3x3 conv in float32 from the same weights, the
    bias and ``act`` in float32, one cast to ``out_dtype``.  ``stats_only``
    returns only the (sum, sumsq) of y as stored; ``owned_rows`` limits
    them to those output rows."""
    _check_act("upsample_conv3x3", act)
    out_dtype = out_dtype or x.dtype
    up = x.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = _conv3x3_f32(up, kernel) + bias.float()
    if act == "lrelu":
        y = torch.where(y >= 0, y, LRELU_SLOPE * y)
    y = y.to(out_dtype)
    if stats_only:
        return _group_sums(y, num_groups, owned_rows)
    if emit_stats:
        return y, _group_sums(y, num_groups, owned_rows)
    return y


def upconv_gn_conv3x3_reference(x: torch.Tensor, up_kernel: torch.Tensor,
                                up_bias: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, kernel: torch.Tensor,
                                bias: torch.Tensor, *,
                                emit_stats: bool = True, num_groups: int = 32,
                                out_dtype: Optional[torch.dtype] = None,
                                store_dtype: Optional[torch.dtype] = None):
    """Plain version of :func:`upconv_gn_conv3x3`, rounding where the
    kernel does: ``z = store_dtype(upconv(x) + up_bias)``; the band
    ``x.dtype(silu(z * gamma + beta))``, zero outside the image (the SAME
    padding of the band); ``y = out_dtype(conv3x3(band) + bias)``, with the
    statistics of y as stored."""
    out_dtype = out_dtype or x.dtype
    store_dtype = store_dtype or x.dtype
    b = x.shape[0]
    z = upsample_conv3x3_reference(x, up_kernel, up_bias,
                                   out_dtype=store_dtype).float()
    a = (z * _per_sample(gamma, b)[:, None, None, :]
         + _per_sample(beta, b)[:, None, None, :])
    band = (a * torch.sigmoid(a)).to(x.dtype).float()
    y = (_conv3x3_f32(band, kernel) + bias.float()).to(out_dtype)
    if emit_stats:
        return y, _group_sums(y, num_groups)
    return y


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_bf16(name: str, t: torch.Tensor, shape) -> None:
    _require(t.dtype == torch.bfloat16,
             f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
             f"{name}: must be contiguous and 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _own_args(owned_rows: OwnedRows, emit_stats: bool,
              name: str) -> Tuple[int, int]:
    """The kernel's (own_lo, own_hi) launch arguments: every row when
    ``owned_rows`` is None."""
    if owned_rows is None:
        return 0, _ALL_ROWS
    _require(emit_stats, f"{name}: owned_rows needs emit_stats")
    lo, hi = (int(r) for r in owned_rows)
    return lo, hi


def _group_stats(partial: torch.Tensor, num_groups: int) -> Sums:
    b, t, _, c = partial.shape
    out = torch.empty(b, 2, num_groups, device=partial.device,
                      dtype=torch.float32)
    _build.check(_build.library().hdrvae_group_stats(
        partial.data_ptr(), out.data_ptr(), b, t, c, num_groups,
        _stream(partial)), "hdrvae_group_stats")
    return out[:, 0], out[:, 1]


def fused_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  *, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  res_kernel: Optional[torch.Tensor] = None,
                  emit_stats: bool = False, num_groups: int = 32,
                  out_dtype: Optional[torch.dtype] = None,
                  out: Optional[torch.Tensor] = None,
                  owned_rows: OwnedRows = None):
    """One fused ResNet conv step (K1).

    x [B, H, W, Cin]; kernel [3, 3, Cin, Cout]; bias [Cout] float32;
    gamma/beta ([Cin] or [B, Cin] float32) enable the GroupNorm-apply +
    SiLU prologue; residual [B, H, W, Cr] is added, or projected through
    ``res_kernel`` [Cr, Cout] first (fold the projection's bias into
    ``bias``).  Returns y [B, H, W, Cout], and with ``emit_stats`` also the
    per-group (sum, sumsq) of y as stored, each [B, G] float32.

    ``out`` is y's storage when given, and may be an identity-add
    ``residual`` itself: each output element reads only its own residual
    element, so the block's output can overwrite a residual that is not
    used again (one full-resolution map less).

    ``owned_rows`` = (lo, hi), host ints (with ``emit_stats``): the
    statistics count only rows lo <= r < hi of y, the rows a slab shard
    owns.  Those launches also count in ``fused_conv3x3.owned_launches``.

    Launches ``csrc/conv3x3.cu`` for a CUDA ``x`` (bf16 x, kernel,
    residual and output; Cin and Cr multiples of 16, Cout of 64); runs
    :func:`fused_conv3x3_reference` for a CPU ``x``.
    """
    own = _own_args(owned_rows, emit_stats, "fused_conv3x3")
    if x.device.type == "cpu":
        return fused_conv3x3_reference(
            x, kernel, bias, gamma=gamma, beta=beta, residual=residual,
            res_kernel=res_kernel, emit_stats=emit_stats,
            num_groups=num_groups, out_dtype=out_dtype, out=out,
            owned_rows=owned_rows)
    _require(x.is_cuda, f"fused_conv3x3: unsupported device {x.device}")
    _require(x.dim() == 4, f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    _require(cin % _CIN_STEP == 0 and cout % _COUT_STEP == 0,
             f"fused_conv3x3: Cin % {_CIN_STEP} and Cout % {_COUT_STEP} "
             f"must be 0, got {cin}, {cout}")
    _require((out_dtype or x.dtype) == torch.bfloat16,
             "fused_conv3x3: the CUDA kernel stores bf16")
    _check_bf16("x", x, (b, h, w, cin))
    _check_bf16("kernel", kernel, (3, 3, cin, cout))
    bias = bias.float().contiguous()
    _require(bias.shape == (cout,), f"bias must be [{cout}]")
    if gamma is not None:
        gamma = _per_sample(gamma, b).contiguous()
        beta = _per_sample(beta, b).contiguous()
        _require(gamma.shape == (b, cin) and beta.shape == (b, cin),
                 f"gamma/beta must be [{cin}] or [{b}, {cin}]")
    res_mode, cr = 0, 0
    if residual is not None:
        cr = residual.shape[-1]
        _check_bf16("residual", residual, (b, h, w, cr))
        if res_kernel is None:
            _require(cr == cout, "an 'add' residual needs Cr == Cout")
            res_mode = 1
        else:
            _require(cr % _CIN_STEP == 0,
                     f"residual channels % {_CIN_STEP} must be 0")
            _check_bf16("res_kernel", res_kernel, (cr, cout))
            res_mode = 2
    if emit_stats:
        _require(cout % num_groups == 0, "Cout % num_groups must be 0")
    for t in (kernel, bias, gamma, beta, residual, res_kernel, out):
        _require(t is None or t.device == x.device,
                 "fused_conv3x3: every operand must be on x's device")
    if out is not None:
        _check_bf16("out", out, (b, h, w, cout))
        _require(out.data_ptr() != x.data_ptr()
                 and (res_mode == 1 or out is not residual),
                 "fused_conv3x3: out may alias an 'add' residual only")

    y = (out if out is not None else
         torch.empty(b, h, w, cout, device=x.device, dtype=torch.bfloat16))
    partial = (torch.empty(b, conv_tiles(h, w), 2, cout, device=x.device,
                           dtype=torch.float32) if emit_stats else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(_build.library().hdrvae_fused_conv3x3(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), ptr(gamma),
        ptr(beta), ptr(residual), ptr(res_kernel), y.data_ptr(),
        ptr(partial), b, h, w, cin, cout, cr, res_mode, *own, _stream(x)),
        "hdrvae_fused_conv3x3")
    fused_conv3x3.launches += 1
    fused_conv3x3.owned_launches += owned_rows is not None
    if emit_stats:
        return y, _group_stats(partial, num_groups)
    return y


fused_conv3x3.launches = 0
fused_conv3x3.owned_launches = 0


def upsample_conv3x3(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, *, emit_stats: bool = False,
                     num_groups: int = 32,
                     out_dtype: Optional[torch.dtype] = None,
                     stats_only: bool = False, act: Optional[str] = None,
                     owned_rows: OwnedRows = None):
    """``act(conv3x3(nearest2x(x)) + bias)`` as one kernel (K2): x [B, H, W,
    Cin] -> [B, 2H, 2W, Cout]; ``kernel`` is the plain [3, 3, Cin, Cout]
    conv kernel, collapsed here into phase kernels; ``act`` None or
    "lrelu" (LeakyReLU, slope 0.2, in float32 before the storage cast).
    With ``emit_stats`` also the per-group (sum, sumsq) of the output as
    stored (after ``act``), each [B, G].

    ``stats_only`` (with ``emit_stats``) returns only that (sum, sumsq):
    y is computed and rounded tile by tile but never allocated, the
    GroupNorm moments of the streaming top level's absent upsampled map.
    Those launches count in ``upsample_conv3x3.stats_only_launches``, the
    others in ``upsample_conv3x3.launches``.

    ``owned_rows`` = (lo, hi), host ints at the output's resolution (with
    ``emit_stats``, in either mode): the statistics count only output rows
    lo <= r < hi.  Those launches also count in
    ``upsample_conv3x3.owned_launches``.

    Launches ``csrc/conv3x3.cu`` for a CUDA ``x`` (bf16 in and out; Cin a
    multiple of 16, Cout of 64); runs :func:`upsample_conv3x3_reference`
    for a CPU ``x``.
    """
    _require(not stats_only or emit_stats,
             "upsample_conv3x3: stats_only needs emit_stats")
    _check_act("upsample_conv3x3", act)
    own = _own_args(owned_rows, emit_stats, "upsample_conv3x3")
    if x.device.type == "cpu":
        return upsample_conv3x3_reference(
            x, kernel, bias, emit_stats=emit_stats, num_groups=num_groups,
            out_dtype=out_dtype, stats_only=stats_only, act=act,
            owned_rows=owned_rows)
    _require(x.is_cuda, f"upsample_conv3x3: unsupported device {x.device}")
    _require(x.dim() == 4, f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    _require(cin % _CIN_STEP == 0 and cout % _COUT_STEP == 0,
             f"upsample_conv3x3: Cin % {_CIN_STEP} and Cout % {_COUT_STEP} "
             f"must be 0, got {cin}, {cout}")
    _require((out_dtype or x.dtype) == torch.bfloat16,
             "upsample_conv3x3: the CUDA kernel stores bf16")
    _check_bf16("x", x, (b, h, w, cin))
    _check_bf16("kernel", kernel, (3, 3, cin, cout))
    _require(kernel.device == x.device and bias.device == x.device,
             "upsample_conv3x3: every operand must be on x's device")
    bias = bias.float().contiguous()
    _require(bias.shape == (cout,), f"bias must be [{cout}]")
    if emit_stats:
        _require(cout % num_groups == 0, "Cout % num_groups must be 0")
    pk = phase_kernels(kernel).contiguous()

    y = (None if stats_only else
         torch.empty(b, 2 * h, 2 * w, cout, device=x.device,
                     dtype=torch.bfloat16))
    partial = (torch.empty(b, 4 * conv_tiles(h, w), 2, cout, device=x.device,
                           dtype=torch.float32) if emit_stats else None)
    _build.check(_build.library().hdrvae_upsample_conv3x3(
        x.data_ptr(), pk.data_ptr(), bias.data_ptr(),
        None if y is None else y.data_ptr(),
        None if partial is None else partial.data_ptr(), b, h, w, cin, cout,
        int(act == "lrelu"), *own, _stream(x)), "hdrvae_upsample_conv3x3")
    upsample_conv3x3.owned_launches += owned_rows is not None
    if stats_only:
        upsample_conv3x3.stats_only_launches += 1
        return _group_stats(partial, num_groups)
    upsample_conv3x3.launches += 1
    if emit_stats:
        return y, _group_stats(partial, num_groups)
    return y


upsample_conv3x3.launches = 0
upsample_conv3x3.stats_only_launches = 0
upsample_conv3x3.owned_launches = 0


def upconv_gn_conv3x3(x: torch.Tensor, up_kernel: torch.Tensor,
                      up_bias: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, *, emit_stats: bool = True,
                      num_groups: int = 32,
                      out_dtype: Optional[torch.dtype] = None,
                      store_dtype: Optional[torch.dtype] = None,
                      phase: Optional[torch.Tensor] = None):
    """The streaming upsample junction as one kernel (K5): x [B, H, W, Cin]
    -> y [B, 2H, 2W, Cout] = conv3x3(silu(z * gamma + beta)) + bias with z
    = conv3x3(nearest2x(x)) + up_bias, the [B, 2H, 2W, Cm] map z never
    leaving the chip.  ``up_kernel`` [3, 3, Cin, Cm] and ``up_bias`` [Cm]
    are the upsample conv's; ``gamma``/``beta`` ([Cm] or [B, Cm] float32)
    the folded GroupNorm affine of z (its moments from
    ``upsample_conv3x3(stats_only=True)``); ``kernel`` [3, 3, Cm, Cout] and
    ``bias`` [Cout] the next conv's.  z is rounded to ``store_dtype`` (the
    chain's storage, as the unfused pair would store it) and the band to
    x's dtype.  With ``emit_stats`` also the per-group (sum, sumsq) of y as
    stored, each [B, G].

    ``phase``: ``phase_kernels(up_kernel)``, the kernel's layout of the
    up-conv, prepared once by the caller (the decoder keeps it on the
    module); collapsed here from ``up_kernel`` on every call when None.

    Launches ``csrc/upconv.cu`` for a CUDA ``x`` (bf16 throughout; Cin a
    multiple of 16 up to 512, Cm 128 or 256, Cout 64 or 128); runs
    :func:`upconv_gn_conv3x3_reference` for a CPU ``x``.
    """
    if x.device.type == "cpu":
        return upconv_gn_conv3x3_reference(
            x, up_kernel, up_bias, gamma, beta, kernel, bias,
            emit_stats=emit_stats, num_groups=num_groups,
            out_dtype=out_dtype, store_dtype=store_dtype)
    _require(x.is_cuda, f"upconv_gn_conv3x3: unsupported device {x.device}")
    _require(x.dim() == 4, f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cm, cout = up_kernel.shape[-1], kernel.shape[-1]
    _require(cin % _K5_CIN_STEP == 0 and cin <= 512,
             f"upconv_gn_conv3x3: Cin must be a multiple of {_K5_CIN_STEP} "
             f"up to 512, got {cin}")
    _require(cm in (128, 256) and cout in (64, 128),
             f"upconv_gn_conv3x3: Cm must be 128 or 256 and Cout 64 or 128, "
             f"got {cm}, {cout}")
    _require((out_dtype or x.dtype) == torch.bfloat16
             and (store_dtype or x.dtype) == torch.bfloat16,
             "upconv_gn_conv3x3: the CUDA kernel stores bf16")
    _check_bf16("x", x, (b, h, w, cin))
    _check_bf16("up_kernel", up_kernel, (3, 3, cin, cm))
    _check_bf16("kernel", kernel, (3, 3, cm, cout))
    up_bias = up_bias.float().contiguous()
    bias = bias.float().contiguous()
    gamma = _per_sample(gamma, b).contiguous()
    beta = _per_sample(beta, b).contiguous()
    _require(up_bias.shape == (cm,) and bias.shape == (cout,),
             f"up_bias must be [{cm}] and bias [{cout}]")
    _require(gamma.shape == (b, cm) and beta.shape == (b, cm),
             f"gamma/beta must be [{cm}] or [{b}, {cm}]")
    if emit_stats:
        _require(cout % num_groups == 0, "Cout % num_groups must be 0")
    if phase is None:
        phase = phase_kernels(up_kernel).contiguous()
    _check_bf16("phase", phase, (2, 2, 2, 2, cin, cm))
    for t in (up_kernel, up_bias, gamma, beta, kernel, bias, phase):
        _require(t.device == x.device,
                 "upconv_gn_conv3x3: every operand must be on x's device")

    y = torch.empty(b, 2 * h, 2 * w, cout, device=x.device,
                    dtype=torch.bfloat16)
    partial = (torch.empty(b, upconv_tiles(h, w), 2, cout, device=x.device,
                           dtype=torch.float32) if emit_stats else None)
    _build.check(_build.library().hdrvae_upconv_gn_conv3x3(
        x.data_ptr(), phase.data_ptr(), up_bias.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), b, h, w, cin, cm,
        cout, _stream(x)), "hdrvae_upconv_gn_conv3x3")
    upconv_gn_conv3x3.launches += 1
    if emit_stats:
        return y, _group_stats(partial, num_groups)
    return y


upconv_gn_conv3x3.launches = 0
