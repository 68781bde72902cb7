"""The exact slab-sharded decode across ranks, as the slab path of
``hdrvae/sharding/mesh.py``.

The JAX package shards over a device mesh inside one program; the port
runs one process a rank, joined by ``torch.distributed``
(``sharding/multihost.py`` starts them), each rank on its own device or
several on one card.  :class:`Mesh` is the counterpart of the JAX mesh: the
default process group and this rank's device, its size checked against a
``MeshConfig``.

:func:`sharded_slab_decode` is exact, in four stages:

1. the head (conv_in, the mid with its global attention, the up levels
   above ``tail_levels``) runs whole-image on every rank;
2. each rank cuts its row slab of the head output, with a halo of the
   tail's receptive radius (``models.decoder.tail_receptive_radius``), and
   runs the tail levels on it;
3. every GroupNorm of the tail takes whole-image moments: each rank sums
   over the rows it owns and the sums are all-reduced.  On the layers
   (parity, mixed, fast with ``upstack="xla"``, and every bucketed decode)
   that is the :class:`SlabGNReducer` tape (:class:`SlabPadGNReducer` when
   bucketed); on the fast chain it is ``fused_tail.SlabStatScope``, K1 /
   K2 counting only the owned rows;
4. the pre-map statistics are reduced the same way (sum, min, max), the
   owned rows of rgb and of the collapsed pre map are gathered and
   stitched, and the HDR epilogue runs once on the whole image, on every
   rank: every rank returns the same result.

The collectives take the tensors where they lie: NCCL on the cards,
gloo on the CPU or, for ranks that share one card, through host copies
of its own (its CUDA all_reduce and all_gather were checked on an H100
with torch 2.11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from hdrvae_torch.core.config import HDRDecodeConfig, MeshConfig, Precision
from hdrvae_torch.decode.formatting import collapse_channels_maxpool
from hdrvae_torch.decode.pipeline import (HDRDecodeResult, _to_nhwc,
                                          result_from_parts)
from hdrvae_torch.models import fused_tail
from hdrvae_torch.models.decoder import (Decoder, decoder_head,
                                         decoder_tail, tail_receptive_radius)
from hdrvae_torch.models.layers import Moments, PadMask

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


class Mesh:
    """A 1-D mesh of ranks: the default process group, this rank on
    ``device``; a group whose size is not ``config.num_devices`` raises.
    Without an initialized process group it is the one-rank mesh, whose
    collectives are the identity; a one-rank group runs them."""

    def __init__(self, device="cuda", config: MeshConfig = MeshConfig()):
        self.device = torch.device(device)
        self.joined = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size() if self.joined else 1
        self.rank = dist.get_rank() if self.joined else 0
        if config.num_devices not in (None, self.size):
            raise ValueError(f"MeshConfig.num_devices={config.num_devices} "
                             f"but the process group has {self.size} "
                             f"rank(s)")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over the ranks by ``op`` ("sum" or
        "min"); returns ``t``."""
        if self.joined:
            dist.all_reduce(t, op=_OPS[op])
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on each), in rank order."""
        if not self.joined:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t)
        return out


# ---------------------------------------------------------------------------
# Slab geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """Row-slab geometry at the tail entry's resolution: n slabs of one
    height whose owned row intervals partition [0, entry_h); each slab
    carries a ``halo`` of at least the tail's receptive radius, so the
    halo-crop is exact for the tail's convs."""

    entry_h: int
    halo: int
    slab_h: int
    starts: Tuple[int, ...]                # slab top row (incl. halo)
    owned: Tuple[Tuple[int, int], ...]     # global owned row interval


def plan_slabs(entry_h: int, n: int, halo: int) -> SlabPlan:
    """JAX's ``plan_slabs``: near-equal owned cuts; the slab height rounded
    up to a multiple of 8 (the extra halo rows are exact and cropped)."""
    cuts = [round(i * entry_h / n) for i in range(n + 1)]
    widest = max(cuts[i + 1] - cuts[i] for i in range(n))
    slab_h = min(entry_h, ((widest + 2 * halo + 7) // 8) * 8)
    starts = tuple(min(max(cuts[i] - halo, 0), entry_h - slab_h)
                   for i in range(n))
    owned = tuple((cuts[i], cuts[i + 1]) for i in range(n))
    return SlabPlan(entry_h, halo, slab_h, starts, owned)


# ---------------------------------------------------------------------------
# GroupNorm statistics over the owned rows
# ---------------------------------------------------------------------------


class SlabGNReducer:
    """Whole-image GroupNorm moments under slab sharding, as JAX's
    ``SlabGNReducer``: the decoder's tape (``reduce_stats``; its
    ``zero_pad_`` is the identity, an unbucketed slab has no pad).  Each rank sums over the rows
    it owns, ``[top, bot)`` of its slab at the entry's resolution (halo
    rows out, so no pixel counts twice), the sums are all-reduced over
    ``mesh`` and divided by the whole image's element count.  A layer's
    resolution multiple is its width over ``entry_w`` (slabs span the
    image's width)."""

    def __init__(self, mesh: Mesh, entry_h: int, entry_w: int, top: int,
                 bot: int):
        self.mesh = mesh
        self.entry_h, self.entry_w = entry_h, entry_w
        self.top, self.bot = top, bot

    def _f(self, w: int) -> int:
        assert w % self.entry_w == 0, (w, self.entry_w)
        return w // self.entry_w

    def region(self, h: int, w: int, f: int) -> Tuple[int, int, int]:
        """(first row, row end, column end) of the owned (and valid)
        region of an [h, w] map at resolution multiple f."""
        r0 = min(max(self.top * f, 0), h)
        return r0, min(max(self.bot * f, r0), h), w

    def n_global(self, f: int, w: int, cpg: int) -> int:
        return (self.entry_h * f) * w * cpg

    def reduce_stats(self, xf: torch.Tensor, num_groups: int,
                     two_pass: bool) -> Moments:
        """Per-(batch, group) moments of the float32 NHWC map ``xf`` over
        the whole image: the two-pass variance from centred values in
        parity (``two_pass``), else the one-pass E[x^2] - mean^2 clamped
        at 0."""
        b, h, w, c = xf.shape
        f = self._f(w)
        cpg = c // num_groups
        r0, r1, c1 = self.region(h, w, f)
        xo = xf[:, r0:r1, :c1].reshape(b, -1, num_groups, cpg)
        n = self.n_global(f, w, cpg)
        if two_pass:
            mean = self.mesh.all_reduce(xo.sum(dim=(1, 3))) / n
            centred = xo - mean[:, None, :, None]
            var = self.mesh.all_reduce(
                torch.square(centred).sum(dim=(1, 3))) / n
            return mean, var
        sums = self.mesh.all_reduce(torch.stack(
            [xo.sum(dim=(1, 3)), torch.square(xo).sum(dim=(1, 3))]))
        mean = sums[0] / n
        return mean, torch.clamp(sums[1] / n - torch.square(mean), min=0.0)

    def zero_pad_(self, x: torch.Tensor) -> torch.Tensor:
        return x


class SlabPadGNReducer(SlabGNReducer):
    """:class:`SlabGNReducer` for a zero-padded (bucketed) latent, as JAX's
    ``SlabPadGNReducer``: the sums count owned rows that are also valid
    and the valid columns, over the valid element count, and
    :meth:`zero_pad_` zeroes the pad region (never the halo rows, whose real
    values the convs need), with the slab's global row offset ``start``.
    ``valid_eh`` / ``valid_ew``: the image's valid rows and columns at the
    entry's resolution."""

    def __init__(self, mesh: Mesh, entry_h: int, entry_w: int, top: int,
                 bot: int, start: int, valid_eh: int, valid_ew: int):
        super().__init__(mesh, entry_h, entry_w, top, bot)
        self.start = start
        self.valid_eh, self.valid_ew = valid_eh, valid_ew

    def region(self, h: int, w: int, f: int) -> Tuple[int, int, int]:
        r0, r1, _ = super().region(h, w, f)
        r1 = max(min(r1, (self.valid_eh - self.start) * f), r0)
        return r0, r1, min(self.valid_ew * f, w)

    def n_global(self, f: int, w: int, cpg: int) -> int:
        return (self.valid_eh * f) * (self.valid_ew * f) * cpg

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        """The [1, H, W, 1] 0/1 validity mask of the slab map ``x`` in x's
        dtype."""
        _, h, w, _ = x.shape
        f = self._f(w)
        rows = (torch.arange(h, device=x.device) + self.start * f
                < self.valid_eh * f)
        cols = torch.arange(w, device=x.device) < self.valid_ew * f
        return (rows[:, None] & cols[None, :])[None, :, :, None].to(x.dtype)

    def zero_pad_(self, x: torch.Tensor) -> torch.Tensor:
        return x.mul_(self.mask(x))


# ---------------------------------------------------------------------------
# The slab decode
# ---------------------------------------------------------------------------


def _pre_stats(pre: torch.Tensor, reducer: SlabGNReducer, fo: int,
               mesh: Mesh) -> Dict[str, torch.Tensor]:
    """min / max / mean / std (ddof = 1, one pass) of the whole image's
    pre-conv_out map from this slab's ``pre`` [B, H, W, C]: sums (in
    float64) over the owned and valid region, all-reduced, and its
    extrema, all-reduced by min."""
    b, h, w, c = pre.shape
    r0, r1, c1 = reducer.region(h, w, fo)
    po = pre[:, r0:r1, :c1].float()
    sums = mesh.all_reduce(torch.stack([
        po.sum(dtype=torch.float64),
        torch.square(po).sum(dtype=torch.float64)]))
    if po.numel():
        ext = torch.stack([po.min(), -po.max()])
    else:
        ext = torch.full((2,), float("inf"), device=pre.device)
    ext = mesh.all_reduce(ext, "min")
    n = float(b * reducer.n_global(fo, w, 1) * c)
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - torch.square(mean), min=0.0)
    var = var * n / max(n - 1.0, 1.0)
    return {"min": ext[0], "max": -ext[1], "mean": mean.float(),
            "std": torch.sqrt(var).float()}


def _stitch(pieces: torch.Tensor, plan: SlabPlan, fo: int,
            mesh: Mesh) -> torch.Tensor:
    """The owned rows of every rank, [B, rows, W, K] each (this rank's
    ``pieces``), in row order: gathered at the widest owned count, each
    cropped to its own."""
    counts = [(o1 - o0) * fo for o0, o1 in plan.owned]
    pad = max(counts) - pieces.shape[1]
    gathered = mesh.all_gather(F.pad(pieces, (0, 0, 0, 0, 0, pad)))
    return torch.cat([g[:, :n] for g, n in zip(gathered, counts)], dim=1)


def _use_chain(precision: Precision, batch: int, tail_levels: int,
               bucketed: bool) -> bool:
    """The fused chain runs the slab tail where JAX's kernel path does
    (``mesh.py:408-419``): the fast tier, batch 1, a tail of one level or
    more, no bucket; ``upstack="pallas"`` raises elsewhere."""
    use = (precision.mode == "fast" and precision.upstack != "xla"
           and batch == 1 and tail_levels >= 1 and not bucketed)
    if precision.upstack == "pallas" and not use:
        raise ValueError(
            "precision.upstack='pallas' runs the slab tail on the fused "
            "chain, which takes the fast tier, batch 1, tail_levels >= 1 "
            f"and no bucket (got mode={precision.mode!r}, batch={batch}, "
            f"tail_levels={tail_levels}, bucketed={bucketed})")
    return use


def _slab_parts(dec: Decoder, latent: torch.Tensor,
                valid_hw: Tuple[int, int], cfg: HDRDecodeConfig,
                precision: Precision, mesh: Mesh, tail_levels: int,
                bucketed: bool):
    """Stages 1-4 up to the epilogue: the stitched (rgb, collapsed pre
    map, first three pre channels or None) of the (padded) image and its
    whole-image pre-map statistics."""
    dcfg = dec.cfg
    use_chain = _use_chain(precision, latent.shape[0], tail_levels,
                           bucketed)
    f_head = 2 ** (dcfg.num_levels - max(tail_levels, 1))
    if use_chain:
        x, moments = fused_tail.chain_head(dec, latent,
                                           tail_levels=tail_levels,
                                           precision=precision)
    else:
        tape = (PadMask(latent.shape[1], latent.shape[2], *valid_hw)
                if bucketed else None)
        x = decoder_head(dec, latent, precision=precision,
                         tail_levels=tail_levels, tape=tape)
    entry_h, entry_w = x.shape[1], x.shape[2]
    plan = plan_slabs(entry_h, mesh.size,
                      tail_receptive_radius(dcfg, tail_levels))
    fo = 2 ** max(tail_levels - 1, 0)    # the tail output's multiple
    start = plan.starts[mesh.rank]
    o0, o1 = plan.owned[mesh.rank]
    top, bot = o0 - start, o1 - start
    slab = x[:, start:start + plan.slab_h]
    if bucketed:
        reducer = SlabPadGNReducer(mesh, entry_h, entry_w, top, bot, start,
                                   valid_hw[0] * f_head,
                                   valid_hw[1] * f_head)
    else:
        reducer = SlabGNReducer(mesh, entry_h, entry_w, top, bot)
    if use_chain:
        scope = fused_tail.SlabStatScope(mesh, (top, bot), entry_h)
        pre, mom = fused_tail.upstack_slab_apply(
            dec, slab, moments, scope, tail_levels=tail_levels,
            precision=precision)
        del x, slab
        out = decoder_tail(dec, pre, precision=precision, moments=mom)
    else:
        del x
        out = decoder_tail(dec, slab, precision=precision,
                           tail_levels=tail_levels, tape=reducer)
    pre_stats = _pre_stats(out.pre_conv_out, reducer, fo, mesh)
    want_first3 = cfg.fallback_collapse == "first3"
    own = slice(top * fo, bot * fo)
    pre_own = out.pre_conv_out[:, own]
    pieces = [out.rgb[:, own], collapse_channels_maxpool(pre_own).float()]
    if want_first3:
        pieces.append(pre_own[..., :3].float())
    whole = _stitch(torch.cat(pieces, dim=-1), plan, fo, mesh)
    parts = [whole[..., k:k + 3].contiguous()
             for k in range(0, whole.shape[-1], 3)]
    return parts[0], parts[1], parts[2] if want_first3 else None, pre_stats


@torch.no_grad()
def sharded_slab_decode(dec: Decoder, latent: torch.Tensor,
                        cfg: HDRDecodeConfig = HDRDecodeConfig(), *,
                        mesh: Optional[Mesh] = None,
                        tail_levels: Optional[int] = None,
                        pad_to: Optional[Tuple[int, int]] = None,
                        precision: Precision = Precision()
                        ) -> HDRDecodeResult:
    """The exact sharded decode (module docstring): head whole-image on
    every rank, tail on row slabs with whole-image GroupNorm statistics.
    Every rank of ``mesh`` (default: ``Mesh()``, on the card) calls it with the
    same latent [B, h, w, z_channels] (or NCHW) and weights, and every
    rank returns the same :class:`HDRDecodeResult`, the contract of
    ``hdr_decode``.  On a one-rank mesh it is the whole-image decode.

    ``tail_levels`` (default min(2, num_levels)) up levels run on slabs,
    each with a halo of ``tail_receptive_radius`` rows.  ``pad_to`` zero-pads
    the latent to a bucket shape and decodes it exactly on the layers
    (:class:`SlabPadGNReducer`), the outputs cropped before the epilogue.
    """
    dcfg = dec.cfg
    latent = _to_nhwc(latent, dcfg.z_channels)
    mesh = mesh or Mesh()
    if tail_levels is None:
        tail_levels = min(2, dcfg.num_levels)
    if not 0 <= tail_levels <= dcfg.num_levels:
        raise ValueError(f"tail_levels {tail_levels} out of range")
    orig_h, orig_w = latent.shape[1], latent.shape[2]
    latent = latent.to(mesh.device)
    orig_latent = latent
    bucketed = pad_to is not None
    if bucketed:
        if pad_to[0] < orig_h or pad_to[1] < orig_w:
            raise ValueError(f"pad_to {tuple(pad_to)} smaller than latent "
                             f"{(orig_h, orig_w)}")
        latent = F.pad(latent, (0, 0, 0, pad_to[1] - orig_w,
                                0, pad_to[0] - orig_h))
    rgb, pre_c, pre3, pre_stats = _slab_parts(
        dec, latent, (orig_h, orig_w), cfg, precision, mesh, tail_levels,
        bucketed)
    if bucketed:
        s = dcfg.spatial_scale
        rgb = rgb[:, :orig_h * s, :orig_w * s]
        pre_c = pre_c[:, :orig_h * s, :orig_w * s]
        if pre3 is not None:
            pre3 = pre3[:, :orig_h * s, :orig_w * s]
    return result_from_parts(dec, rgb, pre_c, pre_stats, orig_latent, cfg,
                             pre3)
