"""Model-folder registry, as ``hdrvae/api/folders.py``: the port's
counterpart of ComfyUI's ``folder_paths``.

Model search roots come from ``HDRVAE_MODELS_DIR`` (``os.pathsep``-
separated) and from roots registered in code; the output directory from
``HDRVAE_OUTPUT_DIR``, else ComfyUI's ``folder_paths`` when hosted inside
ComfyUI, else a ComfyUI root found above the package, else ``./output``.
The same variables and rules as the JAX package, so both find the same
files.
"""

from __future__ import annotations

import os
from typing import Dict, List

_MODEL_EXTENSIONS = (".safetensors", ".pth", ".pt", ".ckpt")

_registered_roots: Dict[str, List[str]] = {}


def register_model_folder(kind: str, path: str) -> None:
    _registered_roots.setdefault(kind, []).append(path)


def _search_roots(kind: str) -> List[tuple]:
    """``(path, recursive)`` pairs.  Kind-specific roots (registered or
    ``<MODELS_DIR>/<kind>``) recurse into subdirectories; a bare
    ``HDRVAE_MODELS_DIR`` root contributes only loose files sitting
    directly in it — recursing there would re-list the kind subdir's
    contents under a second relative path and surface sibling kinds'
    checkpoints (e.g. ``vae/ae.safetensors``) as selectable models of
    the wrong kind."""
    roots = [(r, True) for r in _registered_roots.get(kind, [])]
    env = os.environ.get("HDRVAE_MODELS_DIR", "")
    for root in filter(None, env.split(os.pathsep)):
        roots.append((os.path.join(root, kind), True))
        roots.append((root, False))
    return [(r, rec) for r, rec in roots if os.path.isdir(r)]


def get_model_folders(kind: str) -> List[str]:
    return [r for r, _rec in _search_roots(kind)]


def get_filename_list(kind: str) -> List[str]:
    """Recursive relative paths, like ComfyUI's
    ``folder_paths.get_filename_list`` — models organized in
    subdirectories (``upscale_models/4x/RealESRGAN_x4plus.pth``) must
    appear in the dropdown as ``4x/RealESRGAN_x4plus.pth``."""
    names = []
    for root, recursive in _search_roots(kind):
        if recursive:
            for dirpath, _dirnames, files in os.walk(root):
                rel = os.path.relpath(dirpath, root)
                for name in files:
                    if name.lower().endswith(_MODEL_EXTENSIONS):
                        names.append(name if rel == "."
                                     else os.path.join(rel, name).replace(
                                         os.sep, "/"))
        else:
            for name in os.listdir(root):
                if (name.lower().endswith(_MODEL_EXTENSIONS)
                        and os.path.isfile(os.path.join(root, name))):
                    names.append(name)
    return sorted(set(names))


def get_full_path(kind: str, name: str) -> str:
    for root in get_model_folders(kind):
        candidate = os.path.join(root, name)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(
        f"model {name!r} not found under {kind!r} folders "
        f"{get_model_folders(kind) or '(none registered)'}; set "
        f"HDRVAE_MODELS_DIR or call register_model_folder()")


def discover_comfyui_output(start_dir: str,
                            levels: int = 5) -> str | None:
    """Walk up from ``start_dir`` looking for a ComfyUI root (a directory
    holding both ``custom_nodes`` and ``models``) and return its
    ``output`` subdirectory."""
    search = os.path.abspath(start_dir)
    for _ in range(levels):
        if (os.path.isdir(os.path.join(search, "custom_nodes"))
                and os.path.isdir(os.path.join(search, "models"))):
            return os.path.join(search, "output")
        parent = os.path.dirname(search)
        if parent == search:
            break
        search = parent
    return None


def get_output_directory() -> str:
    """The output directory, first of:

      1. the ``HDRVAE_OUTPUT_DIR`` environment variable;
      2. ComfyUI's ``folder_paths`` module when hosted inside ComfyUI;
      3. a ComfyUI root above this package's install location
         (:func:`discover_comfyui_output`);
      4. ``./output`` under the working directory.
    """
    env = os.environ.get("HDRVAE_OUTPUT_DIR")
    if env:
        return env
    try:
        import folder_paths  # ComfyUI host runtime
        return folder_paths.get_output_directory()
    except Exception:
        pass
    found = discover_comfyui_output(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    if found:
        return found
    return os.path.join(os.getcwd(), "output")
