"""The node pack, as ``hdrvae/api/nodes.py``: the three HDR nodes with the
JAX package's INPUT_TYPES contracts (ComfyUI's node protocol), and the two
host builtins its example workflows wire beside them.

Tensors cross this boundary as ComfyUI's sockets carry them: a LATENT's
``samples`` may be a torch tensor or a numpy array, NHWC or NCHW, and goes
to the VAE handle's device; an IMAGE comes back as a float32 NHWC torch
tensor on the CPU (numpy arrays are taken too).  The decode runs on the
handle's device and tier; the upscale on :attr:`HDRUpscaleWithModel.device`
(the card unless a host sets another) in the JAX node's tier, parity.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hdrvae_torch.api import folders
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import (EXR_COMPRESSIONS, HDR_MODES,
                                      UPSCALE_METHODS, ExportConfig,
                                      HDRDecodeConfig, UpscaleConfig)
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.io.export import export_linear, export_node_return
from hdrvae_torch.models.zoo import load_upscale_model
from hdrvae_torch.upscale.pipeline import hdr_upscale, upscale_progress_total
from hdrvae_torch.utils.progress import ProgressBar

logger = logging.getLogger(__name__)


def _to_tensor(x) -> torch.Tensor:
    """A socket value (torch tensor or array-like) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x, np.float32))


def _image_out(image: torch.Tensor) -> torch.Tensor:
    """What an IMAGE socket carries: float32 NHWC on the CPU."""
    return image.detach().float().cpu()


class HDRVAEDecode:
    """The HDR VAE decode node."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "samples": ("LATENT",),
                "vae": ("VAE",),
            },
            "optional": {
                "hdr_mode": (list(HDR_MODES),
                             {"default": "mathematical_recovery",
                              "tooltip":
                              "conservative: Gentle conservative_ev_multiplier "
                              "expansion, safest for general use \n "
                              "exposure: Natural exposure-based HDR for "
                              "compositing workflows \n "
                              "mathematical_recovery: Full mathematical "
                              "recovery, maximum range"}),
                "conservative_ev_multiplier": (
                    "FLOAT", {"default": 1.0, "min": 0.1, "max": 10.0,
                              "step": 0.1,
                              "tooltip": "Expansion multiplier for the "
                                         "conservative mode."}),
            },
        }

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "simple_hdr_decode"
    CATEGORY = "latent"

    @classmethod
    def adapt_widgets(cls, widgets: list) -> Dict[str, Any]:
        """Map a positional widget list to kwargs, the LEGACY 4-widget
        signature included (``['conservative', 50, 1, False]``: the old
        hdr_mode, max_range, scale_factor, enable_negatives).
        scale_factor maps onto conservative_ev_multiplier; max_range and
        enable_negatives are gone."""
        if len(widgets) >= 4:
            return {"hdr_mode": widgets[0],
                    "conservative_ev_multiplier": float(widgets[2])}
        names = ("hdr_mode", "conservative_ev_multiplier")
        return dict(zip(names, widgets))

    def simple_hdr_decode(self, samples: Dict[str, Any], vae: VAE,
                          hdr_mode: str = "mathematical_recovery",
                          conservative_ev_multiplier: float = 1.0
                          ) -> Tuple[torch.Tensor]:
        latent = _to_tensor(samples["samples"]).to(vae.device,
                                                   torch.float32)
        cfg = HDRDecodeConfig(
            hdr_mode=hdr_mode,
            conservative_ev_multiplier=conservative_ev_multiplier)
        result = hdr_decode(vae.decoder, latent, cfg, vae.precision)
        logger.info("HDRVAEDecode: %s", decode_summary(result))
        return (_image_out(result.image),)


class LinearEXRExport:
    """The linear EXR / HDR export node."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "hdr_image": ("IMAGE", {"tooltip": "HDR image tensor with "
                                        "values potentially above 1.0"}),
                "filename_prefix": ("STRING", {
                    "default": "comfyUI",
                    "tooltip": "Base filename (without extension)"}),
            },
            "optional": {
                "versioning": ("BOOLEAN", {"default": False, "tooltip":
                               "Incremental versioning save. adding v001, "
                               "v002... to it's file name"}),
                "frame_sequence": ("BOOLEAN", {"default": False, "tooltip":
                                   "Save animation into multiple frames "
                                   "1001, 1002..."}),
                "start_frame": ("INT", {"default": 1001, "min": 0,
                                        "max": 99999999}),
                "frame_pad": ("INT", {"default": 4, "min": 1, "max": 8}),
                "output_path": ("STRING", {"default": "/HDR", "tooltip":
                                "Output path: Empty=default output, "
                                "/subfolder=output/subfolder, or full "
                                "custom path"}),
                "format": (["exr", "hdr"], {"default": "exr",
                                            "tooltip": "file format"}),
                "bit_depth": (["16bit", "32bit"], {
                    "default": "16bit",
                    "tooltip": "EXR precision: 32bit = maximum quality, "
                               "16bit = smaller files"}),
                "compression": (list(EXR_COMPRESSIONS), {
                    "default": "zip", "tooltip": "EXR compression type"}),
                "save_workflow": ("BOOLEAN", {
                    "default": False,
                    "tooltip": "Saves the workflow JSON to a sidecar file "
                               "next to the HDR image"}),
            },
            "hidden": {
                "prompt": "PROMPT",
                "extra_pnginfo": "EXTRA_PNGINFO",
            },
        }

    RETURN_TYPES = ("STRING",)
    RETURN_NAMES = ("filepath",)
    FUNCTION = "export_linear_exr"
    CATEGORY = "image"
    OUTPUT_NODE = True

    @classmethod
    def adapt_widgets(cls, widgets: list) -> Dict[str, Any]:
        """Positional widgets -> kwargs, the LEGACY 6-widget signature
        ``['image', '/Test', 1, 'exr', '32bit', 'zip']`` (filename_prefix,
        output_path, versioning, format, bit_depth, compression) included,
        told apart by the string in slot 1 (today's slot 1 is the boolean
        ``versioning``)."""
        if len(widgets) >= 6 and isinstance(widgets[1], str):
            return {"filename_prefix": widgets[0],
                    "output_path": widgets[1],
                    "versioning": bool(widgets[2]),
                    "format": widgets[3],
                    "bit_depth": widgets[4],
                    "compression": widgets[5]}
        names = ("filename_prefix", "versioning", "frame_sequence",
                 "start_frame", "frame_pad", "output_path", "format",
                 "bit_depth", "compression", "save_workflow")
        return dict(zip(names, widgets))

    def export_linear_exr(self, hdr_image, filename_prefix: str = "comfyUI",
                          output_path: str = "/HDR", start_frame: int = 1001,
                          frame_pad: int = 4, versioning: bool = False,
                          frame_sequence: bool = False, format: str = "exr",
                          bit_depth: str = "16bit", compression: str = "zip",
                          save_workflow: bool = False,
                          prompt: Optional[dict] = None,
                          extra_pnginfo: Optional[dict] = None
                          ) -> Tuple[str]:
        cfg = ExportConfig(filename_prefix=filename_prefix,
                           versioning=versioning,
                           frame_sequence=frame_sequence,
                           start_frame=start_frame, frame_pad=frame_pad,
                           output_path=output_path, format=format,
                           bit_depth=bit_depth, compression=compression,
                           save_workflow=save_workflow)
        shape = tuple(getattr(hdr_image, "shape", ()))
        pbar = None
        if len(shape) == 4 and shape[0] > 1:
            pbar = ProgressBar(shape[0], desc="export ")   # a frame a step
        result = export_linear(
            hdr_image, cfg,
            default_output_dir=folders.get_output_directory(),
            prompt=prompt, extra_pnginfo=extra_pnginfo, pbar=pbar)
        return export_node_return(result)


class VAEDecode:
    """The standard (clamping) VAE decode: the host builtin the example
    workflows wire beside HDRVAEDecode for comparison.  The bare decoder
    forward, no HDR epilogue."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"samples": ("LATENT",), "vae": ("VAE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "decode"
    CATEGORY = "latent"

    def decode(self, samples: Dict[str, Any], vae: VAE
               ) -> Tuple[torch.Tensor]:
        latent = _to_tensor(samples["samples"]).to(torch.float32)
        zc = vae.config.z_channels
        if latent.dim() == 4 and latent.shape[-1] != zc \
                and latent.shape[1] == zc:
            latent = latent.permute(0, 2, 3, 1)   # NCHW -> NHWC
        return (_image_out(vae.decode(latent).rgb),)


class PreviewImage:
    """A UI-less stand-in for the host's preview node: logs the image's
    HDR statistics and has no outputs."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",)}}

    RETURN_TYPES = ()
    FUNCTION = "preview"
    CATEGORY = "image"
    OUTPUT_NODE = True

    def preview(self, images) -> Tuple:
        img = _to_tensor(images).float()
        logger.info("PreviewImage: shape=%s range=[%.4f, %.4f] "
                    "hdr_pixels=%d", tuple(img.shape), float(img.min()),
                    float(img.max()), int((img > 1.0).sum()))
        return ()


class HDRUpscaleWithModel:
    """The HDR upscale node: a checkpoint from the ``upscale_models``
    folders (``api/folders.py``), loaded with ``models/zoo.py``'s
    :func:`load_upscale_model` onto :attr:`device`; one loaded model is
    kept across calls."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "image": ("IMAGE",),
            "model_name": (folders.get_filename_list("upscale_models"),),
            "small_blur": ("BOOLEAN", {
                "default": False,
                "tooltip": "Apply small blur to avoid hot-pixels."}),
            "local_fix": ("BOOLEAN", {
                "default": False,
                "tooltip": "Apply local masking to suppress extreme "
                           "hotspots in dark areas."}),
            "upscale_method": (list(UPSCALE_METHODS), {
                "default": "bislerp",
                "tooltip": "method used by the local_fix"}),
        }}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "upscale"
    CATEGORY = "HDR/Upscale"

    # where the model loads and the upscale runs: the node has no device
    # socket, so a host (``cli run --device``, a test) sets it here
    device: str = "cuda"
    # (path, device) -> (model, config, architecture), one entry at most
    _MODEL_CACHE: Dict[tuple, tuple] = {}

    def upscale(self, image, model_name: str, small_blur: bool,
                local_fix: bool, upscale_method: str
                ) -> Tuple[torch.Tensor]:
        path = folders.get_full_path("upscale_models", model_name)
        key = (path, str(self.device))
        cached = self._MODEL_CACHE.get(key)
        if cached is None:
            cached = load_upscale_model(path, device=self.device)
            self._MODEL_CACHE.clear()   # hold one model at most
            self._MODEL_CACHE[key] = cached
        net, model_cfg, arch = cached
        img = _to_tensor(image).to(self.device, torch.float32)
        if img.dim() == 3:
            img = img[None]
        cfg = UpscaleConfig(small_blur=small_blur, local_fix=local_fix,
                            upscale_method=upscale_method)
        # a step a tile over both passes
        pbar = ProgressBar(upscale_progress_total(img, model_cfg, cfg),
                           desc="upscale ")
        result = hdr_upscale(net, img, cfg, architecture=arch, pbar=pbar)
        return (_image_out(result.image),)
