"""The whole Swin transformer block (K7): the CUDA kernel and its plain
PyTorch version, as ``hdrvae/kernels/swin_attention.py::swin_block_fused``
(both bodies, with HAT's optional ``extra`` residual).

    v1: x2 = x + proj(WindowMHA(LN1(x))) + bp [+ extra]
        y = x2 + MLP(LN2(x2))
    v2: x2 = x + LN1(proj(CosineMHA(x)) + bp) [+ extra]
        y = x2 + LN2(MLP(x2))

v2 is Swin2SR's SwinV2 block (``post_norm`` with ``qk_scale``): qkv on the
raw input, the q and k rows L2-normalized in float32 after the bias add
and q times its head's clamped logit scale, before the rounding to the
storage dtype; the position bias is the continuous one, given as v1's
table is.  The v1 scale hd ** -0.5 stays folded into the q weights (the
normalization cancels it), so the bf16 weights are the JAX kernel's.

Both act on an image [B, H, W, C] already rolled by -shift: the shift
only selects the masks, computed from each window's place in the grid
(-100 between the band labels of ``band_masks`` in the last window row
and column; a corner window takes both, as the JAX kernel does).

The weights are prepared once per block (:func:`prepare_block`): the
qkv projection in the head-major [head][q|k|v] layout of 32-wide slots
(head dim zero-padded to 32, the softmax scale folded into q before the
cast to the compute dtype), the proj rows scattered to the same padded
layout, channel and MLP widths zero-padded to multiples of 16.  Zero pads
are exact.  Both versions round where the JAX kernel does: LN outputs,
q/k/v, the probabilities and the attention output in the storage dtype;
scores, softmax, residuals, LN statistics and the MLP accumulation in
float32.

The staged chain computes the v1 block in three kernels, as the JAX
module's debugging tier does: K10 :func:`ln_qkv` (LN1 + qkv into the
[nwb, n16, heads * 96] layout of K7's scratch), K9
:func:`window_attention_core` (the attention core, into [nwb, n16, heads *
32]) and K11 :func:`proj_mlp` (proj + residuals, LN2, MLP, back to the
image); :func:`swin_block_chain` runs the three, and
:func:`swin_window_attention` runs K9 between plain qkv and proj products.
No model takes the chain: it is reached through these functions.

Each wrapper runs its plain version only for a CPU tensor.  On a CUDA
tensor it launches ``csrc/swin_block.cu`` (``csrc/swin_chain.cu`` for the
chain) or raises: the kernels take bf16 images, q/k/v and weights (the
fast tier), windows of at most 256 tokens and C <= 256, head_dim <= 32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hdrvae_torch.core.config import Precision, fp32_contractions
from hdrvae_torch.kernels import _build
from hdrvae_torch.kernels.attention import exp_f32

HDP = 32          # padded head dim (30 at SwinIR-M / HAT-M)
MAX_TOKENS = 256  # the kernel holds a score row of at most 256 columns
MAX_CHANNELS = 256  # and a token's LayerNorm row of at most 256 channels
MASK = -100.0     # the shifted-window mask of the official networks


def _round16(v: int) -> int:
    return -(-v // 16) * 16


class BlockWeights(NamedTuple):
    """One Swin block's weights in the kernel's layout (see module doc)."""
    wq: torch.Tensor     # [CP, heads * 96] compute dtype
    bq: torch.Tensor     # [heads * 96] float32
    wp: torch.Tensor     # [heads * 32, CP] compute dtype
    bp: torch.Tensor     # [C] float32
    g1: torch.Tensor     # LN1 / LN2 affine, [C] float32
    be1: torch.Tensor
    g2: torch.Tensor
    be2: torch.Tensor
    w1: torch.Tensor     # [CP, HP] compute dtype
    b1: torch.Tensor     # [HP] float32
    w2: torch.Tensor     # [HP, CP] compute dtype
    b2: torch.Tensor     # [C] float32
    bias: torch.Tensor   # [heads, n, n] float32 position bias
    heads: int
    hidden: int
    post_norm: bool = False                   # v2: LN on the branch outputs
    qk_scale: Optional[torch.Tensor] = None   # v2: [heads] float32 q scales


def prep_qkv_weights(weight: torch.Tensor, bias: torch.Tensor, heads: int,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear(C, 3C)`` weight [3C, C] and bias [3C] -> ([CP, heads *
    96] in ``dtype``, [heads * 96] float32): column (h * 3 + j) * 32 + d is
    slot j (q, k, v) of head h, dim d < hd; the scale hd ** -0.5 is folded
    into q in float32, before the cast (``_prep_qkv_weights``)."""
    c = weight.shape[1]
    hd = c // heads
    w = weight.float().t().reshape(c, 3, heads, hd).clone()
    b = bias.float().reshape(3, heads, hd).clone()
    w[:, 0] *= hd ** -0.5
    b[0] *= hd ** -0.5
    w = F.pad(w, (0, HDP - hd)).permute(0, 2, 1, 3).reshape(c, heads * 96)
    b = F.pad(b, (0, HDP - hd)).permute(1, 0, 2).reshape(heads * 96)
    w = F.pad(w, (0, 0, 0, _round16(c) - c))
    return w.to(dtype).contiguous(), b.contiguous()


def prep_proj_weights(weight: torch.Tensor, heads: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """``nn.Linear(C, C)`` weight [C, C] -> [heads * 32, CP]: each head's
    input rows at its padded slot, zero rows under the pad and zero columns
    past C (``_prep_proj_weights``)."""
    c = weight.shape[0]
    hd = c // heads
    w = weight.float().t().reshape(heads, hd, c)
    w = F.pad(w, (0, _round16(c) - c, 0, HDP - hd))
    return w.reshape(heads * HDP, _round16(c)).to(dtype).contiguous()


def _pad2(w: torch.Tensor, rows: int, cols: int,
          dtype: torch.dtype) -> torch.Tensor:
    return F.pad(w.float(), (0, cols - w.shape[1], 0, rows - w.shape[0])).to(
        dtype).contiguous()


def prepare_block(attn, norm1, norm2, mlp, heads: int, bias: torch.Tensor,
                  dtype: torch.dtype, *,
                  qkv_bias: Optional[torch.Tensor] = None,
                  post_norm: bool = False,
                  qk_scale: Optional[torch.Tensor] = None) -> BlockWeights:
    """A block's modules (``attn.qkv`` / ``attn.proj`` and ``mlp.fc1`` /
    ``mlp.fc2`` linears, the two LayerNorms) and its gathered bias
    [heads, n, n] in the kernel's layout, matmul weights in ``dtype``.
    ``qkv_bias`` [3C] stands in for ``attn.qkv.bias`` (SwinV2's qkv has
    none); ``post_norm`` and ``qk_scale`` [heads] select the v2 body."""
    c = attn.qkv.weight.shape[1]
    hidden = mlp.fc1.weight.shape[0]
    cp, hp = _round16(c), _round16(hidden)
    wq, bq = prep_qkv_weights(attn.qkv.weight, attn.qkv.bias
                              if qkv_bias is None else qkv_bias, heads, dtype)
    f32 = lambda t: t.detach().float().contiguous()   # noqa: E731
    return BlockWeights(
        wq=wq, bq=bq, wp=prep_proj_weights(attn.proj.weight, heads, dtype),
        bp=f32(attn.proj.bias), g1=f32(norm1.weight), be1=f32(norm1.bias),
        g2=f32(norm2.weight), be2=f32(norm2.bias),
        w1=_pad2(mlp.fc1.weight.t(), cp, hp, dtype),
        b1=F.pad(f32(mlp.fc1.bias), (0, hp - hidden)),
        w2=_pad2(mlp.fc2.weight.t(), hp, cp, dtype),
        b2=f32(mlp.fc2.bias), bias=f32(bias), heads=heads, hidden=hidden,
        post_norm=post_norm,
        qk_scale=None if qk_scale is None else f32(qk_scale.reshape(heads)))


@functools.lru_cache(maxsize=None)
def _band_masks_np(ws: int, shift: int) -> Tuple[np.ndarray, np.ndarray]:
    n = ws * ws
    loc = np.arange(n)
    row_band = (loc // ws >= ws - shift).astype(np.int32)
    col_band = (loc % ws >= ws - shift).astype(np.int32)
    mrow = np.where(row_band[:, None] != row_band[None, :], MASK, 0.0)
    mcol = np.where(col_band[:, None] != col_band[None, :], MASK, 0.0)
    return mrow.astype(np.float32), mcol.astype(np.float32)


def band_masks(ws: int, shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask_row, mask_col): [n, n] additive masks of the windows in the
    last window row / column of a shifted grid (``_band_masks``).  After
    the roll by -shift only those windows mix regions, and a token's region
    depends only on its window-local row (column): below ws - shift it lies
    in the pre-wrap band, else in the wrapped one."""
    mrow, mcol = _band_masks_np(ws, shift)
    return torch.from_numpy(mrow), torch.from_numpy(mcol)


def use_swin_kernel(precision: Precision, x: torch.Tensor, h_img: int,
                    w_img: int, ws: int, head_dim: int) -> bool:
    """Whether a Swin block runs fused (``use_swin_kernel``): the fast
    tier on a CUDA tensor, a window grid that divides the padded image and
    head_dim <= 32.  The JAX gate's Mosaic conditions are gone: its
    score-width lane alignment and ``pick_bwin``'s even window-grid width
    (a 128 x 120 tile at window 8 has 15 windows across; there the JAX
    package falls back to its XLA layers and the port runs K7: the same
    function).  The kernel takes windows of up to 256 tokens and up to 256
    channels (``x``'s last dimension; SwinIR-L has 240).
    ``precision.swin_attn`` forces either path: "xla" the unfused layers,
    "pallas" the fused block (on a CPU tensor: K7's plain version)."""
    knob = precision.swin_attn
    if knob == "xla":
        return False
    ok = (h_img % ws == 0 and w_img % ws == 0 and head_dim <= HDP
          and ws * ws <= MAX_TOKENS and x.shape[-1] <= MAX_CHANNELS)
    if knob == "pallas":
        if not ok:
            raise ValueError(
                f"swin_attn='pallas' but the {h_img}x{w_img} grid (window "
                f"{ws}, head_dim {head_dim}) is unsupported by the kernel")
        return True
    if knob != "auto":
        raise ValueError(f"unknown swin_attn {knob!r}")
    return precision.mode == "fast" and x.is_cuda and ok


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _merge(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _ln(x32: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + 1e-5) * g + b


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w on the operands' values, exact float32 (TF32 off)."""
    with fp32_contractions(Precision.parity()):
        return a.float() @ w.float()


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor, *, ws: int, shift: int,
               grid: Tuple[int, int]) -> torch.Tensor:
    """softmax(q k^T + bias + masks) v of every (window, head): q, k, v
    [nwb, heads, n, 32] (the windows of each image in row-major order on a
    ``grid`` of (nwh, nww) windows), bias [heads, n, n] float32; the band
    masks act in the last window row and column of a shifted grid.  Float32
    scores and softmax; P and the output rounded to v's dtype."""
    nwb, heads, n, _ = q.shape
    nwh, nww = grid
    s = _mm(q, k.transpose(-1, -2)).reshape(-1, nwh, nww, heads, n, n)
    if shift:
        mrow, mcol = (m.to(s.device) for m in band_masks(ws, shift))
        rows = torch.zeros(nwh, 1, 1, 1, 1, device=s.device)
        rows[-1] = 1.0
        cols = torch.zeros(1, nww, 1, 1, 1, device=s.device)
        cols[:, -1] = 1.0
        s = s + (bias + rows * mrow) + cols * mcol
    else:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    e = exp_f32(s - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype).reshape(nwb, heads, n, n)
    return _mm(p, v).to(v.dtype)


def _mlp(y: torch.Tensor, w: BlockWeights, cdt: torch.dtype,
         c: int) -> torch.Tensor:
    """fc2(GELU(fc1(y))) of rows y [..., CP] in the compute dtype, the
    first c columns: float32 sums, the exact GELU rounded to ``cdt``."""
    h1 = _mm(y, w.w1.to(cdt)) + w.b1
    h1 = (0.5 * h1 * (1.0 + torch.erf(h1 * 2.0 ** -0.5))).to(cdt)
    return _mm(h1, w.w2.to(cdt))[..., :c]


def swin_block_fused_reference(img: torch.Tensor, w: BlockWeights, *,
                               ws: int, shift: int,
                               extra: Optional[torch.Tensor] = None,
                               precision: Precision = Precision()
                               ) -> torch.Tensor:
    """Plain version of :func:`swin_block_fused`, step for step the JAX
    kernel's order and rounding (v1 or v2 body), on batched windows."""
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    b, hh, ww, c = img.shape
    heads, cp = w.heads, w.wq.shape[0]
    n = ws * ws
    xw = _partition(img, ws).float()                          # [nwb, n, C]
    y = xw if w.post_norm else _ln(xw, w.g1, w.be1)
    y = F.pad(y, (0, cp - c)).to(cdt)
    qkv = (_mm(y, w.wq.to(cdt)) + w.bq).reshape(-1, n, heads, 3, HDP)
    if w.qk_scale is not None:   # cosine: float32 q / k rows normalized
        qk = qkv[..., :2, :]
        qk = qk / torch.linalg.vector_norm(qk, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
        q = qk[..., 0, :] * w.qk_scale.to(qk.device)[:, None]
        qkv = torch.stack([q, qk[..., 1, :], qkv[..., 2, :]], dim=3)
    q, k, v = qkv.to(sdt).permute(3, 0, 2, 1, 4)           # [nwb, H, n, 32]
    o = _attention(q, k, v, w.bias, ws=ws, shift=shift,
                   grid=(hh // ws, ww // ws))
    o = o.permute(0, 2, 1, 3).reshape(-1, n, heads * HDP)
    proj = _mm(o.to(cdt), w.wp.to(cdt))[..., :c]
    if w.post_norm:
        x2 = xw + _ln(proj + w.bp, w.g1, w.be1)
    else:
        x2 = xw + proj + w.bp
    if extra is not None:
        x2 = x2 + _partition(extra, ws).float()
    y2 = x2 if w.post_norm else _ln(x2, w.g2, w.be2)
    fc2 = _mlp(F.pad(y2, (0, cp - c)).to(cdt), w, cdt, c)
    if w.post_norm:
        out = x2 + _ln(fc2 + w.b2, w.g2, w.be2)
    else:
        out = x2 + fc2 + w.b2
    return _merge(out.to(sdt), ws, b, hh, ww)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_bf16(name: str, device: torch.device, tensors) -> None:
    """Raise unless every (label, tensor) of ``tensors`` (None skipped) is
    a contiguous bf16 tensor on ``device``."""
    for label, t in tensors:
        if t is None:
            continue
        _require(t.dtype == torch.bfloat16,
                 f"{name}: the CUDA kernel takes bf16 {label}, got {t.dtype}")
        _require(t.is_contiguous(), f"{name}: {label} must be contiguous")
        _require(t.device == device, f"{name}: {label} is not on {device}")


def _require_cuda_block(name: str, img: torch.Tensor, w: BlockWeights,
                        ws: int, tensors) -> None:
    """Raise unless the CUDA kernels of a Swin block take ``img`` [B, H, W,
    C] with weights ``w``: a CUDA tensor on a grid of ws-windows of at most
    MAX_TOKENS tokens, C <= MAX_CHANNELS, head_dim <= 32, the bias [heads,
    n, n], and the bf16 ``tensors`` (an ``extra`` of img's shape)."""
    _require(img.is_cuda, f"{name}: unsupported device {img.device}")
    _require(img.dim() == 4, f"img must be [B, H, W, C], got "
             f"{tuple(img.shape)}")
    _, hh, ww, c = img.shape
    heads, n = w.heads, ws * ws
    _require(hh % ws == 0 and ww % ws == 0,
             f"{name}: {hh}x{ww} is not a grid of {ws}-windows")
    _require(n <= MAX_TOKENS,
             f"{name}: window {ws} has more than {MAX_TOKENS} tokens")
    _require(c % heads == 0 and c // heads <= HDP,
             f"{name}: head_dim {c / heads} must be an integer <= {HDP}")
    _require(c <= MAX_CHANNELS, f"{name}: {c} channels > {MAX_CHANNELS}")
    _require_bf16(name, img.device, tensors)
    extra = dict(tensors).get("extra")
    if extra is not None:
        _require(extra.shape == img.shape,
                 f"extra must be {tuple(img.shape)}, got "
                 f"{tuple(extra.shape)}")
    _require(tuple(w.bias.shape) == (heads, n, n),
             f"bias must be [{heads}, {n}, {n}]")


def qkv_scratch_shape(nwin: int, ws: int,
                      heads: int) -> Optional[Tuple[int, ...]]:
    """The device-memory scratch K7 takes for ``nwin`` windows of ``ws``:
    none for windows of at most 64 tokens (one row block: q, k and v stay
    on chip), else [nwin, heads, 3, n64, 32] (q, k and v of each head, the
    tokens rounded up to n64, a multiple of 64), filled by the kernel with
    every row block's q, k and v before the window's attention."""
    n = ws * ws
    if n <= 64:
        return None
    return (nwin, heads, 3, -(-n // 64) * 64, HDP)


def swin_block_fused(img: torch.Tensor, w: BlockWeights, *, ws: int,
                     shift: int, extra: Optional[torch.Tensor] = None,
                     precision: Precision = Precision()) -> torch.Tensor:
    """One whole Swin block (K7) on ``img`` [B, H, W, C], already rolled by
    -shift, H and W multiples of ``ws``; ``extra`` an optional residual of
    the same shape (HAT's ``conv_scale * CAB``, rolled).  Returns the
    block's output, still rolled, in the storage dtype.

    Launches ``csrc/swin_block.cu`` for CUDA inputs (bf16 image, extra and
    matmul weights); runs :func:`swin_block_fused_reference` for CPU ones.
    """
    if img.device.type == "cpu":
        return swin_block_fused_reference(img, w, ws=ws, shift=shift,
                                          extra=extra, precision=precision)
    _require_cuda_block("swin_block_fused", img, w, ws, (
        ("img", img), ("extra", extra), ("wq", w.wq), ("wp", w.wp),
        ("w1", w.w1), ("w2", w.w2)))
    _require(0 <= shift < ws, f"swin_block_fused: shift {shift} not in "
             f"[0, {ws})")
    b, hh, ww, c = img.shape
    heads = w.heads
    _require(w.post_norm == (w.qk_scale is not None),
             "swin_block_fused: the CUDA kernel takes the v2 body whole "
             "(post_norm with qk_scale) or v1")
    if w.qk_scale is not None:
        _require(w.qk_scale.dtype == torch.float32
                 and tuple(w.qk_scale.shape) == (heads,)
                 and w.qk_scale.device == img.device,
                 f"qk_scale must be float32 [{heads}] on {img.device}")
    shape = qkv_scratch_shape(b * (hh // ws) * (ww // ws), ws, heads)
    scratch = None if shape is None else torch.empty(
        shape, device=img.device, dtype=torch.bfloat16)
    y = torch.empty_like(img)
    _build.check(_build.library().hdrvae_swin_block(
        img.data_ptr(), None if extra is None else extra.data_ptr(),
        w.wq.data_ptr(), w.bq.data_ptr(),
        None if w.qk_scale is None else w.qk_scale.data_ptr(),
        w.wp.data_ptr(), w.bp.data_ptr(),
        w.g1.data_ptr(), w.be1.data_ptr(), w.g2.data_ptr(), w.be2.data_ptr(),
        w.w1.data_ptr(), w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
        w.bias.data_ptr(), None if scratch is None else scratch.data_ptr(),
        y.data_ptr(), b, hh, ww, c,
        heads, w.hidden, ws, shift, int(w.post_norm),
        torch.cuda.current_stream(img.device).cuda_stream),
        "hdrvae_swin_block")
    swin_block_fused.launches += 1
    return y


swin_block_fused.launches = 0


# ---------------------------------------------------------------------------
# The staged chain: K10 -> K9 -> K11, the v1 block in three kernels
# ---------------------------------------------------------------------------


def _require_v1(name: str, w: BlockWeights) -> None:
    _require(not w.post_norm and w.qk_scale is None,
             f"{name}: the staged chain takes the v1 body only")


def _require_bf16_tier(name: str, precision: Precision) -> None:
    _require(precision.compute_dtype == torch.bfloat16
             and precision.storage_dtype == torch.bfloat16,
             f"{name}: the CUDA kernel takes bf16 (the fast tier), got "
             f"{precision.compute_dtype} / {precision.storage_dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ln_qkv_reference(img: torch.Tensor, w: BlockWeights, *, ws: int,
                     precision: Precision = Precision()) -> torch.Tensor:
    """Plain version of :func:`ln_qkv` (the JAX ``_ln_qkv_kernel``'s order
    and rounding): LN1 in float32 rounded to the compute dtype, float32
    sums + the bias, rounded to the storage dtype; pad rows zero."""
    cdt = precision.compute_dtype
    c, n, cp = img.shape[-1], ws * ws, w.wq.shape[0]
    y = _ln(_partition(img, ws).float(), w.g1, w.be1)
    qkv = _mm(F.pad(y, (0, cp - c)).to(cdt), w.wq.to(cdt)) + w.bq
    return F.pad(qkv.to(precision.storage_dtype), (0, 0, 0, _round16(n) - n))


def ln_qkv(img: torch.Tensor, w: BlockWeights, *, ws: int,
           precision: Precision = Precision()) -> torch.Tensor:
    """K10: LN1 and the qkv projection of every window of ``img`` [B, H, W,
    C] (rolled by -shift, H and W multiples of ``ws``), as
    ``hdrvae/kernels/swin_attention.py::ln_qkv``.  Returns qkv [nwb, n16,
    heads * 96] in the storage dtype: column h * 96 + j * 32 + d is slot j
    (q, k, v) of head h, dim d (the softmax scale folded into q), n16 the
    window's tokens rounded up to 16, pad rows zero.  The window partition
    happens in the kernel's addressing.

    Launches ``csrc/swin_chain.cu`` for CUDA inputs (bf16, the fast tier);
    runs :func:`ln_qkv_reference` for CPU ones."""
    _require_v1("ln_qkv", w)
    if img.device.type == "cpu":
        return ln_qkv_reference(img, w, ws=ws, precision=precision)
    _require_cuda_block("ln_qkv", img, w, ws, (("img", img), ("wq", w.wq)))
    _require_bf16_tier("ln_qkv", precision)
    b, hh, ww, c = img.shape
    qkv = torch.empty(b * (hh // ws) * (ww // ws), _round16(ws * ws),
                      w.heads * 96, device=img.device, dtype=torch.bfloat16)
    _build.check(_build.library().hdrvae_swin_ln_qkv(
        img.data_ptr(), w.wq.data_ptr(), w.bq.data_ptr(), w.g1.data_ptr(),
        w.be1.data_ptr(), qkv.data_ptr(), b, hh, ww, c, w.heads, ws,
        _stream(img)), "hdrvae_swin_ln_qkv")
    ln_qkv.launches += 1
    return qkv


ln_qkv.launches = 0


def window_attention_core_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                    *, heads: int, ws: int, shift: int,
                                    grid: Tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`window_attention_core`."""
    nwb, n16, _ = qkv.shape
    n = ws * ws
    q, k, v = qkv[:, :n].reshape(nwb, n, heads, 3, HDP).permute(3, 0, 2, 1, 4)
    o = _attention(q, k, v, bias.to(qkv.device), ws=ws, shift=shift,
                   grid=grid)
    o = o.permute(0, 2, 1, 3).reshape(nwb, n, heads * HDP)
    return F.pad(o, (0, 0, 0, n16 - n))


def window_attention_core(qkv: torch.Tensor, bias: torch.Tensor, *,
                          heads: int, ws: int, shift: int,
                          grid: Tuple[int, int]) -> torch.Tensor:
    """K9: softmax(q k^T + bias + masks) v of every (window, head), as
    ``hdrvae/kernels/swin_attention.py::_attn_core``.  ``qkv`` [nwb, n16,
    heads * 96] is :func:`ln_qkv`'s layout (the windows of each image in
    row-major order on a ``grid`` of (nwh, nww) windows), ``bias`` [heads,
    n, n] float32; the -100 band masks of ``band_masks(ws, shift)`` act in
    the last window row and column of a shifted grid (a corner window takes
    both).  Float32 scores and softmax, P rounded to qkv's dtype.  Returns
    [nwb, n16, heads * 32] in qkv's dtype, head h at columns h * 32 ..
    h * 32 + 31, pad rows zero.

    Launches ``csrc/swin_chain.cu`` for CUDA inputs (bf16 qkv); runs
    :func:`window_attention_core_reference` for CPU ones."""
    if qkv.device.type == "cpu":
        return window_attention_core_reference(qkv, bias, heads=heads, ws=ws,
                                               shift=shift, grid=grid)
    name = "window_attention_core"
    _require(qkv.is_cuda, f"{name}: unsupported device {qkv.device}")
    n = ws * ws
    nwh, nww = grid
    _require(n <= MAX_TOKENS,
             f"{name}: window {ws} has more than {MAX_TOKENS} tokens")
    _require(qkv.dim() == 3 and qkv.shape[1:] == (_round16(n), heads * 96),
             f"{name}: qkv must be [nwb, {_round16(n)}, {heads * 96}], got "
             f"{tuple(qkv.shape)}")
    nwb = qkv.shape[0]
    _require(nwb > 0 and nwh > 0 and nww > 0 and nwb % (nwh * nww) == 0,
             f"{name}: {nwb} windows are no batch of {nwh}x{nww} grids")
    _require(0 <= shift < ws, f"{name}: shift {shift} not in [0, {ws})")
    _require(tuple(bias.shape) == (heads, n, n),
             f"bias must be [{heads}, {n}, {n}]")
    _require(bias.device == qkv.device, f"{name}: bias is not on "
             f"{qkv.device}")
    _require_bf16(name, qkv.device, (("qkv", qkv),))
    bias = bias.float().contiguous()
    out = torch.empty(nwb, _round16(n), heads * HDP, device=qkv.device,
                      dtype=torch.bfloat16)
    _build.check(_build.library().hdrvae_swin_attn_core(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), nwb, heads, ws,
        shift, nwh, nww, _stream(qkv)), "hdrvae_swin_attn_core")
    window_attention_core.launches += 1
    return out


window_attention_core.launches = 0


def proj_mlp_reference(attn_out: torch.Tensor, img: torch.Tensor,
                       w: BlockWeights, *, ws: int,
                       extra: Optional[torch.Tensor] = None,
                       precision: Precision = Precision()) -> torch.Tensor:
    """Plain version of :func:`proj_mlp` (the JAX ``_proj_mlp_kernel``'s
    order and rounding, the exact GELU)."""
    cdt = precision.compute_dtype
    b, hh, ww, c = img.shape
    n, cp = ws * ws, w.wq.shape[0]
    proj = _mm(attn_out[:, :n].to(cdt), w.wp.to(cdt))[..., :c]
    x2 = _partition(img, ws).float() + proj + w.bp
    if extra is not None:
        x2 = x2 + _partition(extra, ws).float()
    y2 = F.pad(_ln(x2, w.g2, w.be2), (0, cp - c)).to(cdt)
    out = x2 + _mlp(y2, w, cdt, c) + w.b2
    return _merge(out.to(precision.storage_dtype), ws, b, hh, ww)


def proj_mlp(attn_out: torch.Tensor, img: torch.Tensor, w: BlockWeights, *,
             ws: int, extra: Optional[torch.Tensor] = None,
             precision: Precision = Precision()) -> torch.Tensor:
    """K11: the proj of the attention output ``attn_out`` [nwb, n16, heads
    * 32] (:func:`window_attention_core`'s layout) + bp + the block's input
    ``img`` [B, H, W, C] (rolled) [+ ``extra``, HAT's CAB term], then LN2,
    fc1, the exact GELU, fc2 and the residual, as
    ``hdrvae/kernels/swin_attention.py::proj_mlp``.  Returns [B, H, W, C]
    in the storage dtype, still rolled: the window merge happens in the
    kernel's addressing.

    Launches ``csrc/swin_chain.cu`` for CUDA inputs (bf16, the fast tier);
    runs :func:`proj_mlp_reference` for CPU ones."""
    _require_v1("proj_mlp", w)
    if img.device.type == "cpu":
        return proj_mlp_reference(attn_out, img, w, ws=ws, extra=extra,
                                  precision=precision)
    _require_cuda_block("proj_mlp", img, w, ws, (
        ("img", img), ("attn_out", attn_out), ("extra", extra),
        ("wp", w.wp), ("w1", w.w1), ("w2", w.w2)))
    _require_bf16_tier("proj_mlp", precision)
    b, hh, ww, c = img.shape
    nwb = b * (hh // ws) * (ww // ws)
    _require(attn_out.shape == (nwb, _round16(ws * ws), w.heads * HDP),
             f"proj_mlp: attn_out must be [{nwb}, {_round16(ws * ws)}, "
             f"{w.heads * HDP}], got {tuple(attn_out.shape)}")
    y = torch.empty_like(img)
    _build.check(_build.library().hdrvae_swin_proj_mlp(
        attn_out.data_ptr(), img.data_ptr(),
        None if extra is None else extra.data_ptr(), w.wp.data_ptr(),
        w.bp.data_ptr(), w.g2.data_ptr(), w.be2.data_ptr(), w.w1.data_ptr(),
        w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(), y.data_ptr(), b,
        hh, ww, c, w.heads, w.hidden, ws, _stream(img)),
        "hdrvae_swin_proj_mlp")
    proj_mlp.launches += 1
    return y


proj_mlp.launches = 0


def swin_block_chain(img: torch.Tensor, w: BlockWeights, *, ws: int,
                     shift: int, extra: Optional[torch.Tensor] = None,
                     precision: Precision = Precision()) -> torch.Tensor:
    """The v1 block of :func:`swin_block_fused` as the staged chain K10 ->
    K9 -> K11 on ``img`` [B, H, W, C], already rolled by -shift: the same
    function, each stage rounding where K7 rounds."""
    _, hh, ww, _ = img.shape
    qkv = ln_qkv(img, w, ws=ws, precision=precision)
    o = window_attention_core(qkv, w.bias, heads=w.heads, ws=ws, shift=shift,
                              grid=(hh // ws, ww // ws))
    return proj_mlp(o, img, w, ws=ws, extra=extra, precision=precision)


def swin_window_attention(wins: torch.Tensor, w: BlockWeights, *, ws: int,
                          grid_hw: Tuple[int, int], shift: int,
                          precision: Precision = Precision()
                          ) -> torch.Tensor:
    """The window attention of post-LN windows ``wins`` [nwb, n, C] (in
    (batch, row, col) order on an image of ``grid_hw`` pixels) with K9 as
    its core, as ``hdrvae/kernels/swin_attention.py::swin_window_attention``
    (the drop-in for ``models/swinir.py::window_attention``): the qkv and
    proj products are plain float32 matmuls of operands in the compute
    dtype, as the JAX function leaves them to XLA.  Returns [nwb, n, C] in
    the storage dtype (proj applied)."""
    cdt, sdt = precision.compute_dtype, precision.storage_dtype
    _, n, c = wins.shape
    qkv = (_mm(wins.to(cdt), w.wq[:c].to(cdt)) + w.bq).to(sdt)
    qkv = F.pad(qkv, (0, 0, 0, _round16(n) - n)).contiguous()
    o = window_attention_core(qkv, w.bias, heads=w.heads, ws=ws, shift=shift,
                              grid=(grid_hw[0] // ws, grid_hw[1] // ws))
    y = _mm(o[:, :n].to(cdt), w.wp.to(cdt))[..., :c] + w.bp
    return y.to(sdt)
