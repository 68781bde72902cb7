"""Model and checkpoint introspection, as ``hdrvae/utils/introspect.py``:
parameter trees and checkpoint files described by their keys, shapes and
dtypes, without building a model."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def _sorted_keys(d: dict) -> list:
    """A dict's keys in the JAX pytree's order (sorted)."""
    try:
        return sorted(d)
    except TypeError:
        return sorted(d, key=str)


def flatten_params(params: Any) -> List[Tuple[str, Any]]:
    """[(dotted path, leaf)] of a parameter tree: a module (its state dict,
    in module order), a state dict, or nested dicts (keys sorted, as JAX's
    pytree order), lists and tuples (their indices); every other value is
    a leaf."""
    out: List[Tuple[str, Any]] = []

    def walk(node: Any, path: Tuple[str, ...]) -> None:
        if isinstance(node, nn.Module):
            node = node.state_dict()
        if isinstance(node, dict):
            keys = (list(node) if hasattr(node, "_metadata")
                    else _sorted_keys(node))
            for k in keys:
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append((".".join(path), node))

    walk(params, ())
    return out


def _shape_dtype(v: Any) -> Tuple[tuple, str]:
    """A leaf's shape and dtype name from its metadata (no copy): numpy's
    names ("float32"), a tensor's without its "torch." prefix."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype).replace("torch.", "")
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return tuple(v.shape), str(v.dtype)
    arr = np.asarray(v)
    return tuple(arr.shape), str(arr.dtype)


def describe_params(params: Any, name: str = "model",
                    max_rows: int = 0) -> str:
    """A parameter tree's summary: a header with the tensor and parameter
    totals, then one line a leaf (path, shape, dtype, size)."""
    rows = []
    for path, leaf in flatten_params(params):
        shape, dtype = _shape_dtype(leaf)
        rows.append((path, shape, dtype, int(np.prod(shape))))
    total = sum(r[3] for r in rows)
    lines = [f"{name}: {len(rows)} tensors, {total / 1e6:.2f}M params"]
    shown = rows if not max_rows else rows[:max_rows]
    width = max((len(r[0]) for r in shown), default=0)
    for path, shape, dtype, size in shown:
        lines.append(f"  {path:<{width}}  {str(shape):<22} {dtype:<10} "
                     f"{size:>10,}")
    if max_rows and len(rows) > max_rows:
        lines.append(f"  ... {len(rows) - max_rows} more")
    return "\n".join(lines)


def describe_state_dict(path: str) -> str:
    """A checkpoint file (safetensors or torch) described without building
    a model: its key schema and its first tensors, in the JAX package's
    text (safetensors read as numpy arrays, bf16 ones through torch)."""
    if path.endswith(".safetensors"):
        sd = _read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for nested in ("params_ema", "params", "state_dict"):
            if isinstance(sd, dict) and nested in sd:
                sd = sd[nested]
                break
    keys = sorted(sd)
    total = sum(int(np.prod(_shape_dtype(v)[0])) for v in sd.values())
    kind = "unknown"
    if any(k.startswith(("decoder.", "first_stage_model.decoder."))
           or k.startswith("conv_in.") for k in keys):
        kind = "vae-decoder (ldm layout)"
    elif any(k.startswith("model.0.") for k in keys):
        kind = "esrgan (old arch)"
    elif any(k.startswith("conv_first.") for k in keys):
        kind = "esrgan/rrdbnet (new arch)"
    lines = [f"{path}: {len(keys)} tensors, {total / 1e6:.2f}M params, "
             f"schema: {kind}"]
    for k in keys[:20]:
        shape, dtype = _shape_dtype(sd[k])
        if isinstance(sd[k], torch.Tensor):
            dtype = str(sd[k].dtype)       # torch.load's tensors, as JAX's
        lines.append(f"  {k}: {shape} {dtype}")
    if len(keys) > 20:
        lines.append(f"  ... {len(keys) - 20} more")
    return "\n".join(lines)


def _read_safetensors(path: str) -> Dict[str, Any]:
    from safetensors import safe_open
    try:
        with safe_open(path, framework="numpy") as f:
            return {k: f.get_tensor(k) for k in f.keys()}
    except TypeError:       # bf16 has no numpy dtype
        with safe_open(path, framework="pt") as f:
            return {k: f.get_tensor(k) for k in f.keys()}
