"""Linear EXR / HDR export, as ``hdrvae/io/export.py``.

Output-path resolution, prefix-embedded subdirectories, ``_v%03d``
versioning, frame sequences, a sidecar workflow JSON, one file a frame
through the port's own codecs (``io/exr.py``, ``io/hdr.py``), and a
read-back verification of the last file.  Errors come back as
``ExportResult.error`` (``"ERROR: ..."``) and never raise: the export
node's contract.

Every compression of :data:`EXR_COMPRESSIONS` is written, byte-identical
to the JAX package's files.  PIZ needs the native codec: where it cannot
be built, "piz" comes back as an ERROR and nothing is written (the JAX
package writes zip in its place; the port writes no other compression
than the one asked for).
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from glob import escape as glob_escape, glob
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hdrvae_torch.core.config import (BIT_DEPTHS, EXPORT_FORMATS,
                                      EXR_COMPRESSIONS, ExportConfig)
from hdrvae_torch.io import exr as exr_io
from hdrvae_torch.io import hdr as hdr_io

logger = logging.getLogger(__name__)


def get_highest_numbered_file(directory: str, prefix: str) -> int:
    """Highest existing ``<prefix>_v<N>...`` version in a directory, or 0."""
    # glob.escape: a prefix like "shot[1]" must match literally, or the
    # existing version is missed and the next export overwrites it
    pattern = os.path.join(glob_escape(directory), f"{glob_escape(prefix)}*")
    regex = re.compile(r"^" + re.escape(prefix) + r"_v(\d+).*$")
    max_num = 0
    for file_path in glob(pattern):
        match = regex.match(os.path.basename(file_path))
        if match:
            max_num = max(max_num, int(match.group(1)))
    return max_num


def resolve_output_dir(output_path: str, default_output_dir: str) -> str:
    """The node's three-way path rule: empty -> the default output dir; a
    leading "/" -> a subdirectory of it (not an absolute path); anything
    else -> that directory."""
    cleaned = output_path.strip() if output_path else ""
    if not cleaned:
        return default_output_dir
    if cleaned.startswith("/"):
        return os.path.join(default_output_dir, cleaned[1:])
    return cleaned


@dataclass
class ExportResult:
    filepaths: List[str] = field(default_factory=list)
    verified: bool = False
    verify_stats: Dict[str, Any] = field(default_factory=dict)
    error: Optional[str] = None

    @property
    def last(self) -> Optional[str]:
        return self.filepaths[-1] if self.filepaths else None


def plan_output(cfg: ExportConfig, default_output_dir: str,
                batch: int) -> Tuple[str, str, bool]:
    """Resolve (output_dir, filename_template, sequenced) by the node's
    path, versioning and frame-template rules.  Creates the directory."""
    output_dir = resolve_output_dir(cfg.output_path, default_output_dir)
    # the prefix may embed subdirectories
    parts = cfg.filename_prefix.replace("\\", "/").split("/")
    base_prefix = parts[-1]
    if len(parts) > 1:
        output_dir = os.path.join(output_dir, *parts[:-1])
    os.makedirs(output_dir, exist_ok=True)

    # the template is %-formatted with the frame number; a literal "%"
    # in the user prefix must not be taken for a format directive
    name_parts = [base_prefix.replace("%", "%%")]
    if cfg.versioning:
        version = get_highest_numbered_file(
            os.path.normpath(output_dir), base_prefix) + 1
        name_parts.append(f"_v{version:03d}")
    sequenced = batch > 1 or cfg.frame_sequence
    if sequenced:
        name_parts.append(f"_frame_%0{cfg.frame_pad}d")
    elif "%" in base_prefix:
        # an un-sequenced template is used verbatim (no % substitution)
        name_parts[0] = base_prefix
    template = "".join(name_parts) + f".{cfg.format}"
    return output_dir, template, sequenced


def _save_one(filepath: str, image: np.ndarray, fmt: str, bit_depth: str,
              compression: str) -> None:
    if fmt == "exr":
        pixel_type = "float" if bit_depth == "32bit" else "half"
        exr_io.write_exr(filepath, image, pixel_type=pixel_type,
                         compression=compression)
    elif fmt == "hdr":
        hdr_io.write_hdr(filepath, image)
    else:
        raise ValueError(f"unsupported format: {fmt}")


def verify_save(filepath: str) -> Dict[str, Any]:
    """Read the file back and report its HDR-preservation statistics."""
    if filepath.endswith(".hdr"):
        img = hdr_io.read_hdr(filepath)
    else:
        img = exr_io.read_exr(filepath)
    stats = {
        "min": float(img.min()),
        "max": float(img.max()),
        "hdr_preserved": bool(img.max() > 1.0),
        "negatives_preserved": bool(img.min() < 0.0),
        "width": int(img.shape[1]),
        "height": int(img.shape[0]),
        "channels": int(img.shape[2]) if img.ndim == 3 else 1,
        "size_mb": os.path.getsize(filepath) / (1024 * 1024),
    }
    logger.info("verify %s: range=[%.6f, %.6f] hdr=%s size=%.2fMB",
                filepath, stats["min"], stats["max"], stats["hdr_preserved"],
                stats["size_mb"])
    return stats


def _write_sidecar(filepath: str, prompt: Optional[dict],
                   extra_pnginfo: Optional[dict]) -> None:
    """The workflow JSON next to frame 0; written only when there is a
    prompt or extra info."""
    payload = {"prompt": prompt or {}, "extra_pnginfo": extra_pnginfo or {}}
    if not (payload["prompt"] or payload["extra_pnginfo"]):
        return
    base, _ = os.path.splitext(filepath)
    try:
        with open(base + ".json", "w") as f:
            json.dump(payload, f, indent=4)
    except Exception as e:
        # non-fatal: an unserializable prompt or a sidecar write error must
        # not abort an export whose frames are already on disk
        logger.warning("sidecar workflow JSON not written: %s", e)


def _host_image(hdr_image) -> np.ndarray:
    """The image batch as a float32 numpy array; a tensor on any device
    is fetched to the host in one copy."""
    if isinstance(hdr_image, torch.Tensor):
        t = hdr_image.detach()
        if t.dtype not in (torch.float16, torch.float32):
            t = t.float()
        hdr_image = t.cpu().numpy()
    return np.asarray(hdr_image, np.float32)


def export_linear(hdr_image, cfg: ExportConfig = ExportConfig(),
                  *, default_output_dir: str = "output",
                  prompt: Optional[dict] = None,
                  extra_pnginfo: Optional[dict] = None,
                  pbar=None) -> ExportResult:
    """Export a float image batch to EXR / HDR files.

    hdr_image: (H, W, 3) or (B, H, W, 3), a numpy array or a tensor on any
    device (values outside [0, 1] kept).  Returns an ExportResult; on
    failure ``error`` is set and no exception escapes.  ``pbar``
    (``update(n)``) is advanced once a frame.
    """
    result = ExportResult()
    try:
        if cfg.format not in EXPORT_FORMATS:
            raise ValueError(f"unsupported format: {cfg.format}")
        if cfg.bit_depth not in BIT_DEPTHS:
            raise ValueError(f"unsupported bit depth: {cfg.bit_depth}")
        if cfg.format == "exr" and cfg.compression not in EXR_COMPRESSIONS:
            raise ValueError(f"unsupported compression: {cfg.compression}")
        if cfg.format == "exr":
            exr_io.check_writable(cfg.compression)

        image = _host_image(hdr_image)
        if image.ndim == 3:
            image = image[None]
        if image.ndim != 4:
            raise ValueError(f"expected (B,H,W,C) or (H,W,C), got "
                             f"{image.shape}")
        batch = image.shape[0]

        hdr_pixels = int((image > 1.0).sum())
        negative_pixels = int((image < 0.0).sum())
        logger.info("export: range=[%.6f, %.6f] hdr_pixels=%d negatives=%d",
                    image.min(), image.max(), hdr_pixels, negative_pixels)

        output_dir, template, sequenced = plan_output(
            cfg, default_output_dir, batch)

        for i in range(batch):
            frame_number = cfg.start_frame + i
            filename = template % frame_number if sequenced else template
            filepath = os.path.join(output_dir, filename)
            _save_one(filepath, image[i], cfg.format, cfg.bit_depth,
                      cfg.compression)
            if i == 0 and cfg.save_workflow:
                _write_sidecar(filepath, prompt, extra_pnginfo)
            result.filepaths.append(filepath)
            if pbar is not None:
                pbar.update(1)

        if result.filepaths:
            try:
                result.verify_stats = verify_save(result.filepaths[-1])
                result.verified = True
            except Exception as e:
                # the read-back is diagnostic, not gating: the files are
                # already on disk
                logger.warning("read-back verification failed: %s", e)
        return result
    except Exception as e:  # the node contract: report, don't raise
        logger.error("export failed: %s", e, exc_info=True)
        result.error = f"ERROR: {e}"
        return result


def export_node_return(result: ExportResult) -> Tuple[str]:
    """The node's return value: (filepath,) or ('ERROR: ...',)."""
    if result.error is not None:
        return (result.error,)
    return (result.last or "ERROR: no files written",)
