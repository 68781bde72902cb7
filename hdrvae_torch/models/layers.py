"""Primitive layers as functions on NHWC tensors, as
``hdrvae/models/layers.py``.

Activations are NHWC at every function boundary.  A contiguous NHWC tensor
permuted to NCHW is exactly a ``channels_last`` NCHW tensor, so
``F.conv2d`` runs on it without a copy and its output permutes back to a
contiguous NHWC tensor.  Weights stay in PyTorch's own modules
(``nn.Conv2d`` OIHW, ``nn.GroupNorm``) so an ldm state dict loads as it is.

Numerics per tier follow the JAX package: float32 accumulation and
statistics, operands rounded to ``precision.compute_dtype`` and outputs to
``precision.storage_dtype``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from hdrvae_torch.core.config import Precision, fp32_contractions

Moments = Tuple[torch.Tensor, torch.Tensor]   # (mean [B, G], var [B, G])

EPS = 1e-6   # GroupNorm epsilon of the ldm decoder


def conv2d(x: torch.Tensor, conv: nn.Conv2d, *,
           precision: Precision = Precision()) -> torch.Tensor:
    """SAME convolution of x [B, H, W, Cin] with ``conv``'s OIHW weight.

    The operands are rounded to the compute dtype and convolved in float32
    (bf16 products are exact in float32), the bias is added in float32 and
    the result is rounded to the storage dtype: the JAX package's
    ``preferred_element_type=float32`` contract.  A conv without a bias adds
    none (the JAX package adds zeros).
    """
    cdt = precision.compute_dtype
    w = conv.weight.to(cdt).float()
    xin = x.to(cdt).float().permute(0, 3, 1, 2)
    with fp32_contractions(precision):
        y = F.conv2d(xin, w, padding=conv.kernel_size[0] // 2)
    y = y.permute(0, 2, 3, 1)
    if conv.bias is not None:
        y = y + conv.bias.float()
    return y.to(precision.storage_dtype)


def group_moments(xf: torch.Tensor, num_groups: int,
                  two_pass: bool) -> Moments:
    """Per-(batch, group) mean and variance of a float32 NHWC map.

    ``two_pass`` is the stable parity form (mean, then the mean of squared
    deviations); otherwise the one-pass E[x^2] - mean^2, clamped at 0.
    """
    b, h, w, c = xf.shape
    g = xf.reshape(b, h * w, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 3))
    if two_pass:
        var = torch.square(g - mean[:, None, :, None]).mean(dim=(1, 3))
    else:
        var = torch.clamp(torch.square(g).mean(dim=(1, 3))
                          - torch.square(mean), min=0.0)
    return mean, var


def gn_affine(moments: Moments, norm: nn.GroupNorm, eps: float = EPS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the normalization and the learned scale/bias into one
    per-channel (gamma, beta) pair, each [B, C] float32."""
    mean, var = (m.float() for m in moments)
    cpg = norm.weight.shape[0] // mean.shape[-1]
    rstd_c = torch.rsqrt(var + eps).repeat_interleave(cpg, dim=-1)
    mean_c = mean.repeat_interleave(cpg, dim=-1)
    gamma = norm.weight.float() * rstd_c
    beta = norm.bias.float() - mean_c * gamma
    return gamma, beta


class PadMask:
    """Makes a zero-padded (shape-bucketed) decode equal the unpadded one:
    the pad region is kept out of every GroupNorm statistic and re-zeroed
    after every layer that could write into it, so every conv sees at the
    valid boundary the zeros that SAME padding gives the unpadded decode,
    and nothing of the pad region reaches a valid pixel.  The decoder's
    optional ``tape``, as ``hdrvae/models/layers.py::PadMask``:
    :meth:`reduce_stats` for the GroupNorm moments, :meth:`mask_output`
    on the prescaled latent, :meth:`zero_pad_` after the norms and the
    ResNet blocks, :meth:`key_valid` for the mid attention.  A tape of the
    tail alone has ``reduce_stats`` and ``zero_pad_``.

    ``base_h`` / ``base_w`` are the padded dims at the tape's entry
    resolution (the latent for ``decoder_apply``), ``valid_h`` / ``valid_w``
    the real ones; a map of width ``f * base_w`` is valid on its first
    ``valid_h * f`` rows and ``valid_w * f`` columns.  The masks are built
    on the map's device from ``torch.arange`` comparisons (no host sync).
    """

    def __init__(self, base_h: int, base_w: int, valid_h: int,
                 valid_w: int):
        self.base_h, self.base_w = base_h, base_w
        self.valid_h, self.valid_w = valid_h, valid_w

    def _f(self, w: int) -> int:
        assert w % self.base_w == 0, (w, self.base_w)
        return w // self.base_w

    def _mask2d(self, h: int, w: int, device) -> torch.Tensor:
        f = self._f(w)
        rows = torch.arange(h, device=device) < self.valid_h * f
        cols = torch.arange(w, device=device) < self.valid_w * f
        return rows[:, None] & cols[None, :]

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        """The [1, H, W, 1] 0/1 mask of NHWC ``x`` in x's dtype."""
        _, h, w, _ = x.shape
        return self._mask2d(h, w, x.device)[None, :, :, None].to(x.dtype)

    def mask_output(self, x: torch.Tensor) -> torch.Tensor:
        """x with its pad region zeroed, as a new tensor."""
        return x * self.mask(x)

    def zero_pad_(self, x: torch.Tensor) -> torch.Tensor:
        """x with its pad region zeroed in place."""
        return x.mul_(self.mask(x))

    def key_valid(self, x: torch.Tensor) -> torch.Tensor:
        """[H, W] bool validity map of the attention keys at x's
        resolution."""
        return self._mask2d(x.shape[1], x.shape[2], x.device)

    def reduce_stats(self, xf: torch.Tensor, num_groups: int,
                     two_pass: bool) -> Moments:
        """Per-(batch, group) moments of the float32 NHWC map ``xf`` over
        its valid region: sums of x * mask over n_valid = (valid_h f)
        (valid_w f) C/G elements; the centred values times the mask in
        the two-pass (parity) form, E[(x mask)^2] - mean^2 clamped at 0
        otherwise."""
        b, h, w, c = xf.shape
        f = self._f(w)
        cpg = c // num_groups
        n_valid = (self.valid_h * f) * (self.valid_w * f) * cpg
        mask = self.mask(xf)
        xm = (xf * mask).reshape(b, h * w, num_groups, cpg)
        mean = xm.sum(dim=(1, 3)) / n_valid
        if two_pass:
            centred = (xf.reshape(b, h * w, num_groups, cpg)
                       - mean[:, None, :, None]) \
                * mask.reshape(1, h * w, 1, 1)
            var = torch.square(centred).sum(dim=(1, 3)) / n_valid
        else:
            var = torch.clamp(torch.square(xm).sum(dim=(1, 3)) / n_valid
                              - torch.square(mean), min=0.0)
        return mean, var


class GNTape:
    """Records or replays the GroupNorm statistics of a decoder forward,
    as ``hdrvae/models/layers.py::GNTape``: a tape "collect"ed from a
    whole-image decode and "inject"ed into each tile's decode makes every
    tile normalize with the whole image's statistics (the tiled decode's
    ``norm_stats="global"``).  "off" computes and records nothing.

    ``stats`` holds (mean, var) pairs, each [B, G] float32, in the order
    the decoder calls its GroupNorms; "collect" computes them by the
    tier's rule (two-pass in parity, one-pass otherwise) and appends
    them, "inject" hands them out in turn in place of the map's own.  The
    decoder's tape hooks: :meth:`reduce_stats`; :meth:`mask_output`,
    :meth:`zero_pad_` and :meth:`key_valid` mask nothing."""

    def __init__(self, mode: str = "off", stats=None):
        if mode not in ("off", "collect", "inject"):
            raise ValueError(f"GNTape mode must be 'off', 'collect' or "
                             f"'inject', got {mode!r}")
        self.mode = mode
        self.stats = list(stats) if stats is not None else []
        self._idx = 0

    def record(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.mode == "collect":
            self.stats.append((mean, var))

    def next_override(self) -> Optional[Moments]:
        """The next recorded pair in "inject" mode, else None."""
        if self.mode != "inject":
            return None
        entry = self.stats[self._idx]
        self._idx += 1
        return entry

    def reduce_stats(self, xf: torch.Tensor, num_groups: int,
                     two_pass: bool) -> Moments:
        override = self.next_override()
        if override is not None:
            return override[0].float(), override[1].float()
        moments = group_moments(xf, num_groups, two_pass=two_pass)
        self.record(*moments)
        return moments

    def mask_output(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def zero_pad_(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def key_valid(self, x: torch.Tensor) -> None:
        return None


Tape = Union[PadMask, GNTape]


def _normalize(x: torch.Tensor, norm: nn.GroupNorm, num_groups: int,
               precision: Precision, moments: Optional[Moments],
               tape: Optional[Tape] = None,
               eps: float = EPS) -> torch.Tensor:
    """x * gamma + beta in float32, as a new tensor.  The moments are
    ``moments`` when the caller already has them (the fused chain hands its
    output's moments to ``norm_out`` this way), else the ``tape``'s when
    one is given (a ``PadMask``: those of the valid region; a ``GNTape``:
    recorded or replayed), else computed here: two-pass in parity,
    one-pass otherwise.

    The affine runs in place on one float32 copy of x, so a full-resolution
    map costs one float32 temporary here, not three (the same products and
    sums, bit for bit)."""
    xf = x.to(torch.float32, copy=True)
    two_pass = precision.mode == "parity"
    if moments is None and tape is not None:
        moments = tape.reduce_stats(xf, num_groups, two_pass)
    elif moments is None:
        moments = group_moments(xf, num_groups, two_pass=two_pass)
    gamma, beta = gn_affine(moments, norm, eps)
    return xf.mul_(gamma[:, None, None, :]).add_(beta[:, None, None, :])


def _store(y: torch.Tensor, precision: Precision,
           tape: Optional[Tape]) -> torch.Tensor:
    """The float32 norm output y, its pad region zeroed in place when a
    tape is given, rounded to the storage dtype."""
    if tape is not None:
        tape.zero_pad_(y)
    return y.to(precision.storage_dtype)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, *, num_groups: int,
               eps: float = EPS, precision: Precision = Precision(),
               tape: Optional[Tape] = None) -> torch.Tensor:
    """GroupNorm over NHWC; the output is rounded to the storage dtype."""
    return _store(_normalize(x, norm, num_groups, precision, None, tape,
                             eps), precision, tape)


def group_norm_silu(x: torch.Tensor, norm: nn.GroupNorm, *, num_groups: int,
                    precision: Precision = Precision(),
                    moments: Optional[Moments] = None,
                    tape: Optional[Tape] = None) -> torch.Tensor:
    """GroupNorm followed by SiLU, rounded to the storage dtype; y * sigmoid
    (y) in place, so only the sigmoid is live beside y."""
    y = _normalize(x, norm, num_groups, precision, moments, tape)
    return _store(y.mul_(torch.sigmoid(y)), precision, tape)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
