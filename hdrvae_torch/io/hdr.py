"""Radiance HDR (.hdr, RGBE) writer and reader in numpy, as
``hdrvae/io/hdr.py``: byte for byte the same files.

New-style RLE scanlines are written for widths in [8, 32767], flat RGBE
otherwise.  RGBE encoding: a shared exponent e = ceil(log2(max(r, g, b)))
with mantissas scaled to [0, 256); negative values clamp to 0 (the format
is unsigned), NaN to 0, and values beyond the largest RGBE value
saturate there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


# Largest RGBE-representable value: mantissa 255 at stored exponent 255
# -> 255 * 2^(255-136) = (255/256) * 2^127 ~= 1.69e38.  Brighter float32
# inputs (incl. +inf) must SATURATE here: e + 128 would exceed 255 and
# the uint8 cast would wrap the exponent byte, silently turning the
# brightest pixels into black (e byte 0 decodes to scale 0).
_RGBE_MAX = np.float32(255.0 * 2.0 ** 119)


def rgb_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE."""
    rgb = np.asarray(rgb, np.float32)
    rgb = np.nan_to_num(rgb, nan=0.0, posinf=float(_RGBE_MAX),
                        neginf=0.0)
    rgb = np.clip(rgb, 0.0, _RGBE_MAX)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    valid = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    mant = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., :3] = np.where(valid[..., None], mant, 0)
    rgbe[..., 3] = np.where(valid, (e + 128).astype(np.int32), 0).astype(
        np.uint8)
    return rgbe


def rgbe_to_rgb(rgbe: np.ndarray) -> np.ndarray:
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 128 - 8), 0.0)
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(
        np.float32)


def _rle_component(comp: np.ndarray) -> bytes:
    """New-style Radiance RLE for one scanline component (length W):
    code > 128 -> (code - 128)-long run of the next byte; code <= 128 ->
    code literal bytes.

    Segment-vectorized: equal-value segments come from one np.diff pass,
    then only run segments (>= 4 long) and 128-byte literal chunks are
    visited in Python — O(segments) instead of a per-byte interpreter
    loop (a 4K scanline costs ~30 iterations, not ~4000)."""
    w = len(comp)
    if w == 0:
        return b""
    comp = np.ascontiguousarray(comp, np.uint8)
    starts = np.concatenate(([0], np.flatnonzero(np.diff(comp)) + 1))
    lens = np.diff(np.concatenate((starts, [w])))
    long_idx = np.flatnonzero(lens >= 4)

    out = bytearray()
    raw = comp.tobytes()
    lit_start = 0

    def flush_literals(upto: int) -> None:
        nonlocal lit_start
        while lit_start < upto:
            n = min(128, upto - lit_start)
            out.append(n)
            out.extend(raw[lit_start:lit_start + n])
            lit_start += n

    for k in long_idx:
        s, length = int(starts[k]), int(lens[k])
        flush_literals(s)
        v = int(comp[s])
        r = length
        while r >= 4:
            n = min(127, r)
            out.append(128 + n)
            out.append(v)
            r -= n
        # a < 4 leftover joins the following literal stretch
        lit_start = s + length - r
    flush_literals(w)
    return bytes(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"HDR writer needs (H, W, 3), got {image.shape}")
    h, w, _ = image.shape
    rgbe = rgb_to_rgbe(image)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(f"-Y {h} +X {w}\n".encode())
        if 8 <= w < 32768:
            for y in range(h):
                f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
                for comp in range(4):
                    f.write(_rle_component(rgbe[y, :, comp]))
        else:
            f.write(rgbe.tobytes())


def _read_rle_scanline(buf: bytes, pos: int, w: int
                       ) -> Tuple[np.ndarray, int]:
    line = np.zeros((w, 4), np.uint8)
    for comp in range(4):
        x = 0
        while x < w:
            code = buf[pos]
            pos += 1
            if code > 128:  # run
                line[x:x + code - 128, comp] = buf[pos]
                x += code - 128
                pos += 1
            else:  # literal
                line[x:x + code, comp] = np.frombuffer(
                    buf[pos:pos + code], np.uint8)
                x += code
                pos += code
    return line, pos


def read_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    # header ends at blank line; then resolution line
    end = buf.index(b"\n\n") + 2
    res_end = buf.index(b"\n", end)
    res = buf[end:res_end].decode().split()
    if res[0] != "-Y" or res[2] != "+X":
        raise NotImplementedError(f"unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    pos = res_end + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (w >= 8 and w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and (buf[pos + 2] << 8 | buf[pos + 3]) == w):
            line, pos = _read_rle_scanline(buf, pos + 4, w)
            rgbe[y] = line
        else:
            rgbe[y] = np.frombuffer(buf[pos:pos + 4 * w],
                                    np.uint8).reshape(w, 4)
            pos += 4 * w
    return rgbe_to_rgb(rgbe)
