"""Overlap-tiled execution with seam blending, as ``hdrvae/tiling/tiled.py``.

The tile grid is computed from shapes on the host and the tiles run as a
host loop over views of the device tensor: one model call per tile, the
output blended into the full-resolution accumulator as it arrives, so at
most one tile's activations are live at a time.

Seam modes:
  - ``comfy``: ComfyUI ``tiled_scale``'s grid and blend exactly: starts
    every ``tile - overlap`` pixels, edge tiles clamped and truncated (so
    they shrink, slivers included), every tile weighted by linear ramps of
    ``(t + 1) / feather`` on all four edges (``feather = round(overlap *
    scale)``), the sum divided by the summed weight with no epsilon; an
    image that fits one tile is one un-feathered call.
  - ``feather``: a uniform grid (all tiles the same size, the last shifted
    to fit) with ``(t + 1) / (feather + 1)`` ramps.
  - ``crop``: each tile computed with an ``overlap``-wide halo and only its
    interior pasted; exact for receptive fields <= overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Uniform tiling geometry of an (H, W) image."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    overlap: int
    positions: Tuple[Tuple[int, int], ...]  # top-left (y, x) per tile

    @property
    def num_tiles(self) -> int:
        return len(self.positions)


def plan_tiles(height: int, width: int, tile: int, overlap: int) -> TilePlan:
    """Uniform grid: stride ``tile - overlap``, the last tile clamped to
    fit; an image smaller than a tile is one clamped tile."""
    tile_h, tile_w = min(tile, height), min(tile, width)
    if overlap >= tile:
        raise ValueError(f"overlap {overlap} must be < tile {tile}")

    def starts(size: int, t: int) -> List[int]:
        if size <= t:
            return [0]
        pos = list(range(0, size - t, t - overlap)) + [size - t]
        return list(dict.fromkeys(max(0, min(p, size - t)) for p in pos))

    positions = tuple((y, x) for y in starts(height, tile_h)
                      for x in starts(width, tile_w))
    return TilePlan(height, width, tile_h, tile_w, overlap, positions)


@dataclasses.dataclass(frozen=True)
class ComfyTilePlan:
    """ComfyUI-semantics grid: (y, x, th, tw) per tile in row-major
    emission order, duplicates included (the algorithm does not dedupe)."""

    height: int
    width: int
    overlap: int
    tiles: Tuple[Tuple[int, int, int, int], ...]

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)


def plan_tiles_comfy(height: int, width: int, tile: int,
                     overlap: int) -> ComfyTilePlan:
    """ComfyUI ``tiled_scale``'s grid.  When the whole image fits one tile
    (H <= tile and W <= tile) it is a single call.  Otherwise starts every
    ``tile - overlap``, each clamped to ``max(0, min(size - overlap,
    start))``, with length ``min(tile, size - pos)``: edge tiles shrink,
    down to overlap-wide slivers, and both axes tile as soon as either
    exceeds the tile."""
    if overlap >= tile:
        raise ValueError(f"overlap {overlap} must be < tile {tile}")
    if height <= tile and width <= tile:
        return ComfyTilePlan(height, width, overlap,
                             ((0, 0, height, width),))

    def axis(size: int) -> List[Tuple[int, int]]:
        out = []
        for start in range(0, size, tile - overlap):
            pos = max(0, min(size - overlap, start))
            out.append((pos, min(tile, size - pos)))
        return out

    tiles = tuple((y, x, th, tw)
                  for y, th in axis(height) for x, tw in axis(width))
    return ComfyTilePlan(height, width, overlap, tiles)


def _comfy_mask(tile_h: int, tile_w: int, feather: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """ComfyUI's blend weight [h, w] as float32, formed on ``device``: no
    host-to-device copy, which would wait for the tile's model run and
    stall the tile loop."""
    def ramp(n: int) -> torch.Tensor:
        idx = torch.arange(n, dtype=torch.float32, device=device)
        up = torch.where(idx < feather, (idx + 1) / feather, 1.0)
        down = torch.where(idx >= n - feather, (n - idx) / feather, 1.0)
        return up * down

    return ramp(tile_h)[:, None] * ramp(tile_w)[None, :]


def comfy_feather_mask(tile_h: int, tile_w: int, feather: int) -> np.ndarray:
    """ComfyUI's per-tile blend weight: row t and row size-1-t scaled by
    (t + 1) / feather, the same along columns (multiplied where the ramps
    overlap on small tiles)."""
    return _comfy_mask(tile_h, tile_w, feather).numpy()


def blend_tiles_comfy(outs: Iterable[torch.Tensor], plan: ComfyTilePlan, *,
                      scale: int = 1) -> torch.Tensor:
    """ComfyUI ``tiled_scale``'s accumulation over the per-tile outputs in
    emission order (any iterable; a generator keeps one tile live):
    weighted add, then a divide by the summed weight."""
    outs = iter(outs)
    if plan.tiles == ((0, 0, plan.height, plan.width),):
        # the single-tile early-out: the model output as it is
        return next(outs).float()
    feather = round(plan.overlap * scale)
    acc = weight = None
    for (y, x0, th, tw), o in zip(plan.tiles, outs):
        if acc is None:
            b, c = o.shape[0], o.shape[-1]
            acc = torch.zeros(b, plan.height * scale, plan.width * scale, c,
                              device=o.device, dtype=torch.float32)
            weight = torch.zeros(1, plan.height * scale, plan.width * scale,
                                 1, device=o.device, dtype=torch.float32)
        mask = _comfy_mask(th * scale, tw * scale, feather,
                           o.device)[None, :, :, None]
        ys, xs = y * scale, x0 * scale
        acc[:, ys:ys + th * scale, xs:xs + tw * scale] += o.float() * mask
        weight[:, ys:ys + th * scale, xs:xs + tw * scale] += mask
    # no epsilon: every pixel lies in a tile whose ramp there is >= 1/feather
    return acc / weight


def tiled_apply_comfy(fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, *, tile: int = 512, overlap: int = 64,
                      scale: int = 1, pbar=None) -> torch.Tensor:
    """Apply ``fn`` over [B, H, W, C] with ComfyUI ``tiled_scale``'s grid
    and blend, one tile at a time in emission order."""
    return tiled_apply(fn, x, tile=tile, overlap=overlap, scale=scale,
                       mode="comfy", pbar=pbar)


def _tile_views(x: torch.Tensor, plan: TilePlan) -> List[torch.Tensor]:
    return [x[:, y:y + plan.tile_h, x0:x0 + plan.tile_w, :]
            for y, x0 in plan.positions]


def extract_tiles(x: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """[B, H, W, C] -> [T, B, th, tw, C]: the plan's tiles stacked, in
    ``plan.positions`` order."""
    return torch.stack(_tile_views(x, plan), dim=0)


def _feather_mask(tile_h: int, tile_w: int, feather: int) -> np.ndarray:
    """Linear ramps of (t + 1) / (feather + 1) on all four edges (index
    based, so tiles narrower than the feather get overlapping ramps)."""
    def ramp(n: int) -> np.ndarray:
        idx = np.arange(n, dtype=np.float32)
        up = np.where(idx < feather, (idx + 1) / (feather + 1), 1.0)
        down = np.where(idx >= n - feather, (n - idx) / (feather + 1), 1.0)
        return (up * down).astype(np.float32)

    if feather <= 0:
        return np.ones((tile_h, tile_w), np.float32)
    return ramp(tile_h)[:, None] * ramp(tile_w)[None, :]


def blend_tiles(tiles: torch.Tensor, plan: TilePlan, *, scale: int = 1,
                mode: str = "feather") -> torch.Tensor:
    """[T, B, s*th, s*tw, C] -> [B, s*H, s*W, C] ("feather" or "crop")."""
    t, b, th, tw, c = tiles.shape
    out_h, out_w = plan.height * scale, plan.width * scale
    feather = plan.overlap * scale
    dev = tiles.device

    if mode == "feather":
        mask = torch.from_numpy(_feather_mask(th, tw, feather)).to(dev)
        mask = mask[None, :, :, None]
        acc = torch.zeros(b, out_h, out_w, c, device=dev,
                          dtype=torch.float32)
        weight = torch.zeros(1, out_h, out_w, 1, device=dev,
                             dtype=torch.float32)
        for i, (y, x0) in enumerate(plan.positions):
            ys, xs = y * scale, x0 * scale
            acc[:, ys:ys + th, xs:xs + tw] += tiles[i] * mask
            weight[:, ys:ys + th, xs:xs + tw] += mask
        return acc / torch.clamp(weight, min=1e-8)

    if mode == "crop":
        half = feather // 2
        out = torch.zeros(b, out_h, out_w, c, device=dev,
                          dtype=torch.float32)
        for i, (y, x0) in enumerate(plan.positions):
            ys, xs = y * scale, x0 * scale
            # interior bounds: the halo is kept only at image borders
            top = 0 if ys == 0 else half
            left = 0 if xs == 0 else half
            bottom = th if ys + th >= out_h else th - half
            right = tw if xs + tw >= out_w else tw - half
            out[:, ys + top:ys + bottom, xs + left:xs + right] = \
                tiles[i][:, top:bottom, left:right]
        return out

    raise ValueError(f"unknown blend mode {mode!r}")


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                *, tile: int = 512, overlap: int = 64, scale: int = 1,
                mode: str = "feather", pbar=None) -> torch.Tensor:
    """Apply ``fn`` ([B, th, tw, C] -> [B, s*th, s*tw, C']) tile by tile
    over [B, H, W, C] with the seam ``mode``; ``pbar`` (an object with
    ``update(n)``) is advanced once per tile."""
    tiles, blend = tile_grid(x, tile=tile, overlap=overlap, scale=scale,
                             mode=mode)
    return blend(map_tiles(fn, tiles, pbar))


def tile_grid(x: torch.Tensor, *, tile: int = 512, overlap: int = 64,
              scale: int = 1, mode: str = "feather"
              ) -> Tuple[List[torch.Tensor],
                         Callable[[Iterable[torch.Tensor]], torch.Tensor]]:
    """:func:`tiled_apply` split at its tile calls: the tiles of
    [B, H, W, C] under the seam ``mode`` (views, in the plan's order) and
    the blend that takes their outputs ([B, s*th, s*tw, C'], in the same
    order, any iterable) to [B, s*H, s*W, C'].  A grid of one tile blends
    to that tile's output as it is."""
    if mode == "comfy":
        plan_c = plan_tiles_comfy(x.shape[1], x.shape[2], tile, overlap)
        tiles = [x[:, y:y + th, x0:x0 + tw, :]
                 for y, x0, th, tw in plan_c.tiles]
        return tiles, lambda outs: blend_tiles_comfy(outs, plan_c,
                                                     scale=scale)
    plan = plan_tiles(x.shape[1], x.shape[2], tile, overlap)

    def blend(outs: Iterable[torch.Tensor]) -> torch.Tensor:
        outs = list(outs)
        if plan.num_tiles == 1:
            return outs[0]
        return blend_tiles(torch.stack(outs, dim=0), plan, scale=scale,
                           mode=mode)

    return _tile_views(x, plan), blend


def map_tiles(fn: Callable[[torch.Tensor], torch.Tensor],
              tiles: Iterable[torch.Tensor], pbar=None
              ) -> Iterator[torch.Tensor]:
    """``fn`` of each tile, here, lazily and in order (a blend that takes
    the outputs as they come keeps one live); ``pbar`` (an object with
    ``update(n)``) is advanced once per tile."""
    for t in tiles:
        out = fn(t)
        if pbar is not None:
            pbar.update(1)
        yield out


def num_tiles(height: int, width: int, tile: int, overlap: int,
              mode: str = "feather") -> int:
    """Tile count of the plan, for sizing a progress bar up front."""
    if mode == "comfy":
        return plan_tiles_comfy(height, width, tile, overlap).num_tiles
    return plan_tiles(height, width, tile, overlap).num_tiles


def select_tile_size(height: int, width: int, *, bytes_per_pixel: float,
                     hbm_budget_bytes: int, preferred: int = 512,
                     min_tile: int = 128, alignment: int = 64) -> int:
    """The largest aligned tile <= ``preferred`` whose working set fits the
    budget (the planned replacement of a halve-on-OOM retry; floor
    ``min_tile``)."""
    tile = min(preferred, max(height, width))
    tile = max(min_tile, -(-tile // alignment) * alignment)
    while tile > min_tile and tile * tile * bytes_per_pixel > \
            hbm_budget_bytes:
        tile = max(min_tile, (tile // 2 // alignment) * alignment)
    return tile
