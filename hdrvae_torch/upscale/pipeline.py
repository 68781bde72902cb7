"""HDR-aware two-pass tiled upscaling, as ``hdrvae/upscale/pipeline.py``
(the ``HDRUpscaleWithModel`` node):

  pass 1: the tiled model over the UNCLAMPED input, each tile's output
          un-normalized by the inverse activation of the architecture;
  pass 2: the same over the input clamped to [-1, 1] (colour-stable);
  recombine in YCbCr: luma from pass 1 (clamped to [0, 8], 3x3 median),
          chroma from pass 2, unclamped YCbCr -> RGB;
  optional small_blur (gaussian pre-filter + median post-filter) and
  local_fix (dark areas pulled back to the clamped result).

Each pass is a host loop over the tiles (``tiling/tiled.py``); the model
runs per tile on the input's device, or on the rank a ``tile_map`` deals
the tile to (``sharding/mesh.py``).
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import torch

from hdrvae_torch.core.color import luma, rgb_to_ycbcr, ycbcr_to_rgb
from hdrvae_torch.core.config import Precision, UpscaleConfig
from hdrvae_torch.decode.modes import inverse_sigmoid, inverse_tanh
from hdrvae_torch.models.zoo import (ModelConfig, upscaler_apply,
                                     working_set_bytes_per_pixel)
from hdrvae_torch.tiling.tiled import (map_tiles, num_tiles, select_tile_size,
                                       tile_grid)
from hdrvae_torch.upscale.filters import gaussian_blur, median_blur
from hdrvae_torch.upscale.resize import common_upscale

# Architectures reversed with atanh (ESRGAN family, SwinIR, HAT and any
# VAE-like model); every other one with the logit.
_ATANH_ARCHES = ("ESRGAN", "RealESRGAN", "SwinIR", "HAT")


def get_reversal_fn(architecture: str
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    if architecture in _ATANH_ARCHES or "VAE" in architecture:
        return inverse_tanh
    return inverse_sigmoid


class UpscaleResult(NamedTuple):
    image: torch.Tensor        # [B, sH, sW, 3] float32 HDR
    unclamped: torch.Tensor    # pass-1 result (before the recombine)
    clamped: torch.Tensor      # pass-2 result


def _select_pass_tile(x: torch.Tensor, model_cfg: ModelConfig,
                      cfg: UpscaleConfig, precision: Precision) -> int:
    tile = cfg.tiling.tile
    if cfg.tiling.hbm_budget_bytes is not None:
        tile = select_tile_size(
            x.shape[1], x.shape[2],
            bytes_per_pixel=working_set_bytes_per_pixel(model_cfg,
                                                        precision),
            hbm_budget_bytes=cfg.tiling.hbm_budget_bytes, preferred=tile,
            min_tile=cfg.tiling.min_tile)
    return tile


def _recombine(unclamped: torch.Tensor, clamped: torch.Tensor,
               original: torch.Tensor, cfg: UpscaleConfig) -> torch.Tensor:
    y_stab = median_blur(torch.clamp(luma(unclamped), 0.0, cfg.luma_max),
                         kernel_size=3)
    cbcr = rgb_to_ycbcr(clamped)[..., 1:3]
    s_final = ycbcr_to_rgb(torch.cat([y_stab, cbcr], dim=-1))
    if cfg.small_blur:
        s_final = median_blur(s_final, kernel_size=3)
    if cfg.local_fix:
        # dark-area hotspot suppression
        h, w = s_final.shape[1], s_final.shape[2]
        y_scaled = common_upscale(luma(original), w, h, cfg.upscale_method)
        mask = (y_scaled < cfg.local_fix_threshold).float()
        conservative = torch.clamp(s_final, -1.0, 1.0)
        s_final = s_final * (1.0 - mask) + conservative * mask
    return s_final


def upscale_progress_total(image: torch.Tensor, model_cfg: ModelConfig,
                           cfg: UpscaleConfig,
                           precision: Precision = Precision()) -> int:
    """Progress steps of :func:`hdr_upscale`: 2 passes x tiles."""
    tile = _select_pass_tile(image, model_cfg, cfg, precision)
    return 2 * num_tiles(image.shape[1], image.shape[2], tile,
                         cfg.tiling.overlap, mode=cfg.tiling.seam_mode)


@torch.no_grad()
def hdr_upscale(model, image: torch.Tensor,
                cfg: UpscaleConfig = UpscaleConfig(), *,
                architecture: str = "ESRGAN",
                precision: Precision = Precision(),
                pbar=None, tile_map=None) -> UpscaleResult:
    """Upscale an HDR float image [B, H, W, 3] (NHWC) on its device.

    ``model`` is a loaded upscaler (``models/zoo.py``) on the same device;
    tile and overlap come from ``cfg.tiling`` (512 / 64 by default).  With
    ``pbar`` (``update(n)``; size it with :func:`upscale_progress_total`)
    each tile advances the bar by one.  ``tile_map(fn, tiles)`` returns
    ``fn`` of every tile of both passes (the unclamped pass's, then the
    clamped pass's, in one list) in order; by default the tiles run here
    one by one (``tiling.tiled.map_tiles``), and
    ``sharding.mesh.sharded_hdr_upscale`` deals them across ranks.
    """
    if image.dim() != 4 or image.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3] image, got "
                         f"{tuple(image.shape)}")
    image = image.float()
    in_filtered = image
    if cfg.small_blur:
        in_filtered = gaussian_blur(image, kernel_size=3, sigma=0.1)
    clamped_in = torch.clamp(in_filtered, cfg.color_stable_min,
                             cfg.color_stable_max)
    grid = dict(tile=_select_pass_tile(in_filtered, model.cfg, cfg,
                                       precision),
                overlap=cfg.tiling.overlap, scale=model.cfg.scale,
                mode=cfg.tiling.seam_mode)
    tiles_u, blend_u = tile_grid(in_filtered, **grid)
    tiles_c, blend_c = tile_grid(clamped_in, **grid)
    reverse = get_reversal_fn(architecture)

    def fn(t: torch.Tensor) -> torch.Tensor:
        return reverse(upscaler_apply(model, t, precision=precision))

    outs = iter(map_tiles(fn, tiles_u + tiles_c, pbar) if tile_map is None
                else tile_map(fn, tiles_u + tiles_c))
    # pass 1's outputs are blended before pass 2's are computed here
    s_unclamped = blend_u(itertools.islice(outs, len(tiles_u)))
    s_clamped = blend_c(outs)
    s_final = _recombine(s_unclamped, s_clamped, in_filtered, cfg)
    return UpscaleResult(image=s_final.float(), unclamped=s_unclamped,
                         clamped=s_clamped)
