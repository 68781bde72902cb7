"""The node registry, as ``hdrvae/api/comfy.py`` and ``hdrvae/__init__.py``
name it: what a ComfyUI ``custom_nodes`` package re-exports.

The port's nodes (``api/nodes.py``) already hand torch tensors across, so
the classes register as they are.  A ComfyUI shim is one
``custom_nodes/<pack>/__init__.py``::

    from hdrvae_torch.api.comfy import (NODE_CLASS_MAPPINGS,
                                        NODE_DISPLAY_NAME_MAPPINGS)
"""

from __future__ import annotations

from hdrvae_torch.api.nodes import (HDRUpscaleWithModel, HDRVAEDecode,
                                    LinearEXRExport, PreviewImage, VAEDecode)

# the plugin contract: the three HDR nodes
NODE_CLASS_MAPPINGS = {
    "HDRVAEDecode": HDRVAEDecode,
    "LinearEXRExport": LinearEXRExport,
    "HDRUpscaleWithModel": HDRUpscaleWithModel,
}

# host builtins the example workflows assume, kept apart so that loading
# the pack into ComfyUI never shadows the host's own; the graph executor
# (``api/graph.py``) merges both
BUILTIN_NODE_MAPPINGS = {
    "VAEDecode": VAEDecode,
    "PreviewImage": PreviewImage,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "HDRVAEDecode": "HDR VAE Decode",
    "LinearEXRExport": "Linear EXR Export",
    "HDRUpscaleWithModel": "HDR Upscale with Model",
}
