"""A scanline OpenEXR writer and reader (numpy + zlib) for the decode's
output: HALF or FLOAT pixels, NONE or ZIP compression.

Files are byte-identical to the JAX package's pure-Python codec
(``hdrvae/io/exr_py.py``) for those settings: the same header attributes
in the same order, channels stored sorted by name (B, G, R), 16-line ZIP
chunks with the byte-reorder + delta pre-filter, and chunks that do not
shrink stored raw.  PIZ, RLE, PXR24, band streaming and sidecars are not
here.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

MAGIC = 0x01312F76
VERSION = 2
COMPRESSION_IDS = {"none": 0, "zip": 3}
LINES_PER_CHUNK = {0: 1, 3: 16}
PIXEL_TYPES = {"half": 1, "float": 2}
_PIX_DTYPE = {1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _filter_encode(raw: bytes) -> bytes:
    """ZIP pre-filter: split the bytes into even and odd halves, then a
    delta predictor over the reordered buffer."""
    data = np.frombuffer(raw, np.uint8)
    reordered = np.concatenate([data[0::2], data[1::2]])
    delta = np.empty_like(reordered)
    delta[0] = reordered[0]
    delta[1:] = (reordered[1:].astype(np.int16)
                 - reordered[:-1].astype(np.int16) + (128 + 256)) & 0xFF
    return delta.tobytes()


def _filter_decode(filtered: bytes) -> bytes:
    delta = np.frombuffer(filtered, np.uint8).astype(np.int64)
    delta[1:] -= 128 + 256
    merged = (np.cumsum(delta) & 0xFF).astype(np.uint8)
    half = (len(merged) + 1) // 2
    out = np.empty(len(merged), np.uint8)
    out[0::2] = merged[:half]
    out[1::2] = merged[half:]
    return out.tobytes()


def _attr(name: str, typ: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def _channel_names(c: int) -> List[str]:
    if c == 3:
        return ["R", "G", "B"]
    if c == 1:
        return ["Y"]
    width = len(str(c - 1))
    return [f"channel{i:0{width}d}" for i in range(c)]


def _header(w: int, h: int, ptype: int, comp_id: int,
            names: List[str]) -> bytes:
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype)
                      + struct.pack("<BBBB", 0, 0, 0, 0)
                      + struct.pack("<ii", 1, 1) for n in sorted(names))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr = (_attr("channels", "chlist", chlist + b"\0")
           + _attr("compression", "compression", struct.pack("<B", comp_id))
           + _attr("dataWindow", "box2i", box)
           + _attr("displayWindow", "box2i", box)
           + _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
           + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
           + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
           + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)))
    return (struct.pack("<I", MAGIC) + struct.pack("<i", VERSION) + hdr
            + b"\0")


def write_exr(path: str, image, *, pixel_type: str = "half",
              compression: str = "zip", zip_level: int = 4) -> None:
    """Write an (H, W, C) or (H, W) float image (numpy array, or a tensor
    on any device) as a scanline EXR."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.dtype != np.float16:
        image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if pixel_type not in PIXEL_TYPES or compression not in COMPRESSION_IDS:
        raise ValueError(f"unsupported EXR settings {pixel_type!r}/"
                         f"{compression!r}: pixel_type is one of "
                         f"{sorted(PIXEL_TYPES)}, compression one of "
                         f"{sorted(COMPRESSION_IDS)}")
    ptype = PIXEL_TYPES[pixel_type]
    comp_id = COMPRESSION_IDS[compression]
    lines = LINES_PER_CHUNK[comp_id]
    names = _channel_names(c)
    order = sorted(range(c), key=lambda i: names[i])
    dtype = _PIX_DTYPE[ptype]
    # [H, C_sorted, W] rows in file order, converted once
    planes = np.ascontiguousarray(
        np.transpose(image[..., order], (0, 2, 1)).astype(dtype))

    header = _header(w, h, ptype, comp_id, names)
    n_chunks = -(-h // lines)
    chunks = []
    for y0 in range(0, h, lines):
        raw = planes[y0:y0 + lines].tobytes()
        data = raw
        if comp_id == 3:
            data = zlib.compress(_filter_encode(raw), zip_level)
            if len(data) >= len(raw):
                data = raw
        chunks.append(struct.pack("<ii", y0, len(data)) + data)
    offsets, pos = [], len(header) + 8 * n_chunks
    for chunk in chunks:
        offsets.append(pos)
        pos += len(chunk)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for chunk in chunks:
            f.write(chunk)


def _cstr(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR (HALF/FLOAT, NONE/ZIP) into float32 (H, W, C);
    RGB files come back in RGB order."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<Ii", buf, 0)
    if magic != MAGIC or version & (0x200 | 0x800 | 0x1000):
        raise ValueError(f"{path}: not a single-part scanline EXR")
    pos, attrs = 8, {}
    while buf[pos] != 0:
        name, pos = _cstr(buf, pos)
        _, pos = _cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if size < 0 or pos + size > len(buf):
            raise ValueError(f"corrupt EXR header: attribute {name!r}")
        attrs[name] = buf[pos:pos + size]
        pos += size
    pos += 1
    channels, cpos, ch = [], 0, attrs["channels"]
    while ch[cpos] != 0:
        cname, cpos = _cstr(ch, cpos)
        (ptype,) = struct.unpack_from("<i", ch, cpos)
        cpos += 16
        if ptype not in _PIX_DTYPE:
            raise ValueError(f"unsupported EXR pixel type {ptype}")
        channels.append((cname, ptype))
    comp_id = attrs["compression"][0]
    if comp_id not in LINES_PER_CHUNK:
        raise ValueError(f"unsupported EXR compression id {comp_id}")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines = LINES_PER_CHUNK[comp_id]
    n_chunks = -(-h // lines)
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    row_bytes = sum(w * _PIX_DTYPE[pt].itemsize for _, pt in channels)
    planes = {name: np.empty((h, w), np.float32) for name, _ in channels}
    seen = np.zeros(h, bool)
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        y -= y0
        if y < 0 or y >= h or size < 0 or off + 8 + size > len(buf):
            raise ValueError("corrupt EXR chunk table")
        data = buf[off + 8:off + 8 + size]
        nrows = min(y + lines, h) - y
        raw = data
        if comp_id == 3 and len(data) < nrows * row_bytes:
            raw = _filter_decode(zlib.decompress(data))
        rpos = 0
        for yy in range(y, y + nrows):
            for name, pt in channels:
                nbytes = w * _PIX_DTYPE[pt].itemsize
                planes[name][yy] = np.frombuffer(
                    raw[rpos:rpos + nbytes], _PIX_DTYPE[pt])
                rpos += nbytes
        seen[y:y + nrows] = True
    if not seen.all():
        raise ValueError("corrupt EXR: scanlines covered by no chunk")
    names = [name for name, _ in channels]
    if set(names) >= {"R", "G", "B"}:
        names = ["R", "G", "B"] + [n for n in names
                                   if n not in ("R", "G", "B")]
    return np.stack([planes[n] for n in names], -1)
