"""Scanline OpenEXR codecs for the decode's output: the numpy codec of
``hdrvae/io/exr_py.py`` and the dispatch of ``hdrvae/io/exr.py`` to the
native C++ codec (``csrc/exr_codec.cpp``, built by ``io/native_build.py``).

HALF or FLOAT pixels; NONE, RLE, ZIPS, ZIP, PIZ and PXR24 compression.
Both codecs write files byte-identical to the JAX package's: the same
header attributes in the same order, channels stored sorted by name
(B, G, R), chunks of 1 (NONE, RLE, ZIPS), 16 (ZIP, PXR24) or 32 (PIZ)
scanlines, the byte-reorder + delta pre-filter before RLE and zlib, and
chunks that do not shrink stored raw.  Both readers read every file either
package writes; the numpy reader decodes PIZ too.

Only the native codec writes PIZ.  Where it cannot be built, or its PIZ
write fails, ``piz`` raises ``ValueError``: unlike the JAX package, the
port never writes another compression in its place.  The other
compressions fall back to the numpy codec (the same bytes), with a
warning.
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from hdrvae_torch.io.native_build import load_native

logger = logging.getLogger(__name__)

MAGIC = 0x01312F76
VERSION = 2

# OpenEXR compression ids
COMPRESSION_IDS = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4,
                   "pxr24": 5}
_ID_TO_NAME = {v: k for k, v in COMPRESSION_IDS.items()}
LINES_PER_CHUNK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}

PIXEL_UINT, PIXEL_HALF, PIXEL_FLOAT = 0, 1, 2
PIXEL_TYPES = {"half": PIXEL_HALF, "float": PIXEL_FLOAT}
_PIX_SIZE = {PIXEL_HALF: 2, PIXEL_FLOAT: 4, PIXEL_UINT: 4}
_PIX_DTYPE = {PIXEL_HALF: np.dtype("<f2"), PIXEL_FLOAT: np.dtype("<f4"),
              PIXEL_UINT: np.dtype("<u4")}


# ---------------------------------------------------------------------------
# Pre-filter: byte reorder + delta predictor (RLE, ZIPS, ZIP)
# ---------------------------------------------------------------------------


def _filter_encode(raw: bytes) -> bytes:
    """Split the bytes into even and odd halves, then a delta predictor
    over the reordered buffer (OpenEXR's order)."""
    data = np.frombuffer(raw, np.uint8)
    reordered = np.concatenate([data[0::2], data[1::2]])
    delta = np.empty_like(reordered)
    delta[0] = reordered[0]
    delta[1:] = (reordered[1:].astype(np.int16)
                 - reordered[:-1].astype(np.int16) + (128 + 256)) & 0xFF
    return delta.tobytes()


def _filter_decode(filtered: bytes) -> bytes:
    """Undo the predictor (a running sum), then merge the two halves."""
    delta = np.frombuffer(filtered, np.uint8).astype(np.int64)
    delta[1:] -= 128 + 256
    merged = (np.cumsum(delta) & 0xFF).astype(np.uint8)
    half = (len(merged) + 1) // 2
    out = np.empty(len(merged), np.uint8)
    out[0::2] = merged[:half]
    out[1::2] = merged[half:]
    return out.tobytes()


# ---------------------------------------------------------------------------
# RLE (OpenEXR's: signed-count runs over the filtered bytes)
# ---------------------------------------------------------------------------

_MIN_RUN, _MAX_RUN = 3, 127


def _rle_encode(data: bytes) -> bytes:
    out = bytearray()
    d = data
    n = len(d)
    i = 0
    while i < n:
        run = 1
        while i + run < n and d[i + run] == d[i] and run < _MAX_RUN:
            run += 1
        if run >= _MIN_RUN:
            out.append(run - 1)
            out.append(d[i])
            i += run
        else:
            # a literal stretch: up to the next run of 3 or _MAX_RUN bytes
            start = i
            i += 1
            while (i < n and i - start < _MAX_RUN
                   and not (i + 2 < n and d[i] == d[i + 1] == d[i + 2])):
                i += 1
            count = i - start
            out.append((256 - count) & 0xFF)   # negative as a signed byte
            out.extend(d[start:i])
    return bytes(out)


def _rle_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out.extend(data[i:i - count])
            i += -count
        else:
            out.extend(data[i:i + 1] * (count + 1))
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# PXR24 (24-bit float, per-byte-plane deltas, zlib)
# ---------------------------------------------------------------------------


def float_to_float24(f: np.ndarray) -> np.ndarray:
    """float32 array -> uint32 array of 24-bit float bit patterns."""
    bits = f.astype("<f4").view(np.uint32)
    s = bits & 0x80000000
    e = bits & 0x7F800000
    m = bits & 0x007FFFFF
    body = e | m
    # finite: round the significand to 15 bits (half up); an overflow to
    # inf truncates instead
    rounded = (body + 0x80) >> 8
    overflow = (rounded << 8) & 0x7F800000 == 0x7F800000
    rounded = np.where(overflow, body >> 8, rounded)
    # inf / nan: keep the exponent, 15 mantissa bits (a nan keeps a bit)
    m15 = m >> 8
    special = (e >> 8) | m15 | np.where((m != 0) & (m15 == 0), 1, 0)
    out24 = np.where(e == 0x7F800000, special, rounded)
    return (s >> 8) | out24


def float24_to_float(i24: np.ndarray) -> np.ndarray:
    return (i24.astype("<u4") << np.uint32(8)).view("<f4").astype(
        np.float32, copy=False)


def _pxr24_pack_rows(rows: List[Tuple[np.ndarray, int]]) -> bytes:
    """rows: (values, pixel type) a channel row; the plane-packed deltas."""
    parts = []
    for values, ptype in rows:
        if ptype == PIXEL_FLOAT:
            p24 = float_to_float24(values.astype(np.float32))
            diff = np.empty_like(p24)
            diff[0] = p24[0]
            diff[1:] = (p24[1:] - p24[:-1]) & 0xFFFFFF
            parts.append(((diff >> 16) & 0xFF).astype(np.uint8).tobytes())
            parts.append(((diff >> 8) & 0xFF).astype(np.uint8).tobytes())
            parts.append((diff & 0xFF).astype(np.uint8).tobytes())
        elif ptype == PIXEL_HALF:
            h = values.astype("<f2").view(np.uint16).astype(np.uint32)
            diff = np.empty_like(h)
            diff[0] = h[0]
            diff[1:] = (h[1:] - h[:-1]) & 0xFFFF
            parts.append(((diff >> 8) & 0xFF).astype(np.uint8).tobytes())
            parts.append((diff & 0xFF).astype(np.uint8).tobytes())
        else:
            raise ValueError("pxr24 supports half/float only")
    return b"".join(parts)


def _pxr24_unpack_rows(data: bytes, w: int,
                       row_types: List[int]) -> List[np.ndarray]:
    out = []
    pos = 0
    buf = np.frombuffer(data, np.uint8)
    for ptype in row_types:
        if ptype == PIXEL_FLOAT:
            hi = buf[pos:pos + w].astype(np.uint32)
            mid = buf[pos + w:pos + 2 * w].astype(np.uint32)
            lo = buf[pos + 2 * w:pos + 3 * w].astype(np.uint32)
            pos += 3 * w
            diff = (hi << 16) | (mid << 8) | lo
            p24 = np.cumsum(diff.astype(np.uint64)).astype(np.uint32) \
                & 0xFFFFFF
            out.append(float24_to_float(p24))
        else:   # HALF
            hi = buf[pos:pos + w].astype(np.uint32)
            lo = buf[pos + w:pos + 2 * w].astype(np.uint32)
            pos += 2 * w
            diff = (hi << 8) | lo
            h = (np.cumsum(diff.astype(np.uint64)).astype(np.uint32)
                 & 0xFFFF).astype(np.uint16)
            out.append(h.view("<f2").astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# PIZ reading: canonical Huffman + the 2D wavelet, independent of the
# native codec (which alone writes PIZ)
# ---------------------------------------------------------------------------

_PIZ_MAXLEN = 58
_PIZ_SHORT_ZEROCODE = 59
_PIZ_LONG_ZEROCODE = 63
_PIZ_SHORTEST_LONG_RUN = 2 + _PIZ_LONG_ZEROCODE - _PIZ_SHORT_ZEROCODE
_PIZ_TABLE_BITS = 14


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos >= len(self.data):
                raise ValueError("PIZ: bitstream exhausted")
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)


def _piz_canonical_codes(lengths: Dict[int, int]
                         ) -> Dict[int, Tuple[int, int]]:
    """symbol -> (code, length) by OpenEXR's canonical assignment: base
    codes a length computed longest first, symbols in index order."""
    n = [0] * (_PIZ_MAXLEN + 1)
    for length in lengths.values():
        n[length] += 1
    c = 0
    base = [0] * (_PIZ_MAXLEN + 1)
    for i in range(_PIZ_MAXLEN, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    codes = {}
    nxt = list(base)
    for sym in sorted(lengths):
        length = lengths[sym]
        if length > 0:
            codes[sym] = (nxt[length], length)
            nxt[length] += 1
    return codes


def _piz_huf_decode(data: bytes, n_out: int) -> np.ndarray:
    im, iM, tlen, nbits, _ = struct.unpack_from("<IIIII", data, 0)
    table = _BitReader(data[20:20 + tlen])
    lengths: Dict[int, int] = {}
    i = im
    while i <= iM:
        length = table.read(6)
        if length == _PIZ_LONG_ZEROCODE:
            i += table.read(8) + _PIZ_SHORTEST_LONG_RUN
        elif length >= _PIZ_SHORT_ZEROCODE:
            i += length - _PIZ_SHORT_ZEROCODE + 2
        else:
            if length > 0:
                lengths[i] = length
            i += 1
    codes = _piz_canonical_codes(lengths)

    # a 2^14 lookup resolves any code of <= 14 bits in one step; longer
    # codes fall back to a (code, length) dict probe
    tb = _PIZ_TABLE_BITS
    table_sym = np.full(1 << tb, -1, np.int64)
    table_len = np.zeros(1 << tb, np.uint8)
    long_codes: Dict[Tuple[int, int], int] = {}
    for sym, (code, length) in codes.items():
        if length <= tb:
            base = code << (tb - length)
            table_sym[base:base + (1 << (tb - length))] = sym
            table_len[base:base + (1 << (tb - length))] = length
        else:
            long_codes[(code, length)] = sym

    rlc = iM
    stream = data[20 + tlen:]
    out = np.empty(n_out, np.uint16)
    produced = 0
    consumed = 0
    acc = 0
    nacc = 0
    pos = 0
    n_stream = len(stream)
    prev = -1
    while produced < n_out and consumed < nbits:
        # refill to peek a whole table window (zero-padded at the end)
        while nacc < tb + 8:
            acc = (acc << 8) | (stream[pos] if pos < n_stream else 0)
            pos += 1
            nacc += 8
        window = (acc >> (nacc - tb)) & ((1 << tb) - 1)
        sym = int(table_sym[window])
        if sym >= 0:
            length = int(table_len[window])
        else:
            # a long code: extend bit by bit beyond the table width
            code = window
            length = tb
            sym = None
            while sym is None and length < _PIZ_MAXLEN:
                while nacc < length + 1 + 8:
                    acc = (acc << 8) | (stream[pos] if pos < n_stream
                                        else 0)
                    pos += 1
                    nacc += 8
                length += 1
                code = (acc >> (nacc - length)) & ((1 << length) - 1)
                sym = long_codes.get((code, length))
            if sym is None:
                raise ValueError("PIZ: invalid code")
        nacc -= length
        consumed += length
        if sym == rlc:
            while nacc < 8:
                acc = (acc << 8) | (stream[pos] if pos < n_stream else 0)
                pos += 1
                nacc += 8
            n = (acc >> (nacc - 8)) & 0xFF
            nacc -= 8
            consumed += 8
            if prev < 0 or produced + n > n_out:
                raise ValueError("PIZ: bad run")
            out[produced:produced + n] = prev
            produced += n
        else:
            out[produced] = sym
            prev = sym
            produced += 1
        acc &= (1 << nacc) - 1 if nacc else 0
    if produced != n_out:
        raise ValueError("PIZ: short output")
    return out


def _piz_wav_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                    mx: int) -> None:
    """In-place 2D wavelet decode (the inverse of the encoder's wenc14 /
    wenc16 passes) of a flat uint16 array."""
    w14 = mx < (1 << 14)

    def wdec14(lo, hi):
        ls = lo.astype(np.int16).astype(np.int32)
        hs = hi.astype(np.int16).astype(np.int32)
        ai = ls + (hs & 1) + (hs >> 1)
        return (ai.astype(np.int16).astype(np.uint16),
                (ai - hs).astype(np.int16).astype(np.uint16))

    def wdec16(lo, hi):
        m = lo.astype(np.int64)
        d = hi.astype(np.int64)
        bb = (m - (d >> 1)) & 0xFFFF
        aa = (d + bb - 0x8000) & 0xFFFF
        return aa.astype(np.uint16), bb.astype(np.uint16)

    wdec = wdec14 if w14 else wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        # the aligned 2x2 blocks (disjoint from the leftovers)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        i00 = (yy * oy + xx * ox).ravel()
        i01 = i00 + p * ox
        i10 = i00 + p * oy
        i11 = i10 + p * ox
        a00, a10 = wdec(buf[i00], buf[i10])
        a01, a11 = wdec(buf[i01], buf[i11])
        b00, b01 = wdec(a00, a01)
        b10, b11 = wdec(a10, a11)
        buf[i00], buf[i01] = b00, b01
        buf[i10], buf[i11] = b10, b11
        # the leftover column: the first x past the aligned loop
        if nx & p:
            x_l = int(xs[-1]) + p2
            if x_l < nx:
                idx0 = ys * oy + x_l * ox
                a, b = wdec(buf[idx0], buf[idx0 + p * oy])
                buf[idx0], buf[idx0 + p * oy] = a, b
        # the leftover row
        if ny & p:
            y_l = int(ys[-1]) + p2
            if y_l < ny:
                idx0 = y_l * oy + xs * ox
                a, b = wdec(buf[idx0], buf[idx0 + p * ox])
                buf[idx0], buf[idx0 + p * ox] = a, b
        p2 = p
        p >>= 1


def _piz_decode_chunk(data: bytes, channels, w: int, nrows: int,
                      raw_size: int) -> bytes:
    """One PIZ chunk -> its raw scanline bytes: the bitmap range and
    bitmap, the Huffman block, the wavelet a short plane, the reverse
    lookup, then channel planes re-interleaved into scanlines."""
    min_nz, max_nz = struct.unpack_from("<HH", data, 0)
    ppos = 4
    bitmap = np.zeros(65536 // 8, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(
            data[ppos:ppos + count], np.uint8)
        ppos += count
    (hlen,) = struct.unpack_from("<i", data, ppos)
    ppos += 4
    shorts = _piz_huf_decode(data[ppos:ppos + hlen], raw_size // 2)
    present = np.nonzero(np.unpackbits(bitmap, bitorder="little"))[0]
    rlut = np.zeros(65536, np.uint16)
    vals = np.unique(np.concatenate([[0], present]))
    rlut[:len(vals)] = vals.astype(np.uint16)
    plane_offsets, plane_pos = [], 0
    for _, pt in channels:
        nshorts = _PIX_SIZE[pt] // 2
        plane_len = nrows * w * nshorts
        for j in range(nshorts):
            # in place over a strided view: short plane j of the channel's
            # interleaved buffer (x stride nshorts)
            _piz_wav_decode(shorts[plane_pos + j:plane_pos + plane_len], w,
                            nshorts, nrows, w * nshorts, len(vals) - 1)
        plane_offsets.append(plane_pos)
        plane_pos += plane_len
    shorts = rlut[shorts]
    rows = []
    for yy in range(nrows):
        for (_, pt), poff in zip(channels, plane_offsets):
            nshorts = _PIX_SIZE[pt] // 2
            rows.append(shorts[poff + yy * w * nshorts:
                               poff + (yy + 1) * w * nshorts])
    return np.concatenate(rows).astype("<u2").tobytes()


# ---------------------------------------------------------------------------
# Header
# ---------------------------------------------------------------------------


def _attr(name: str, typ: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def _channel_list(names: List[str], pixel_type: int) -> bytes:
    return b"".join(n.encode() + b"\0" + struct.pack("<i", pixel_type)
                    + struct.pack("<BBBB", 0, 0, 0, 0)   # pLinear, reserved
                    + struct.pack("<ii", 1, 1)           # x / y sampling
                    for n in sorted(names)) + b"\0"


def _build_header(w: int, h: int, pixel_type: int, compression_id: int,
                  channel_names: List[str]) -> bytes:
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    return (_attr("channels", "chlist",
                  _channel_list(channel_names, pixel_type))
            + _attr("compression", "compression",
                    struct.pack("<B", compression_id))
            + _attr("dataWindow", "box2i", box)
            + _attr("displayWindow", "box2i", box)
            + _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
            + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + _attr("screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
            + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + b"\0")


def _channel_names(c: int) -> List[str]:
    if c == 3:
        return ["R", "G", "B"]
    if c == 1:
        return ["Y"]
    # zero-padded, so that the stored (alphabetical) order is the numeric
    # one ("channel10" would sort before "channel2")
    width = len(str(c - 1))
    return [f"channel{i:0{width}d}" for i in range(c)]


# ---------------------------------------------------------------------------
# The numpy writer
# ---------------------------------------------------------------------------


def _encode_chunk(band: np.ndarray, yb0: int, yb1: int, y0_global: int,
                  order: List[int], ptype: int, comp_id: int,
                  zip_level: int) -> bytes:
    """One scanline chunk: rows [yb0, yb1) of ``band``, whose first row
    is the file's row ``y0_global``.  Chunks are independent in every
    compression, so band streaming and chunk threads write the serial
    writer's bytes."""
    # [rows, C sorted, W]: the channel rows in file order
    raw = np.ascontiguousarray(np.transpose(
        band[yb0:yb1][..., order], (0, 2, 1))).astype(
            _PIX_DTYPE[ptype]).tobytes()
    if comp_id == 0:
        data = raw
    elif comp_id == 1:   # RLE
        data = _rle_encode(_filter_encode(raw))
    elif comp_id in (2, 3):   # ZIPS / ZIP
        data = zlib.compress(_filter_encode(raw), zip_level)
    elif comp_id == 5:   # PXR24
        rows = [(np.asarray(band[y, :, i], np.float32), ptype)
                for y in range(yb0, yb1) for i in order]
        data = zlib.compress(_pxr24_pack_rows(rows), zip_level)
    else:
        raise NotImplementedError(_ID_TO_NAME.get(comp_id, comp_id))
    if len(data) >= len(raw):
        data = raw
    return struct.pack("<ii", y0_global, len(data)) + data


class _NumpyBandWriter:
    """The numpy codec's incremental writer (``exr_py.ExrBandWriter``):
    the header and a zeroed offset table first, chunks appended band by
    band (a band's chunks compressed on a small thread pool: zlib and
    numpy release the GIL), the table patched on :meth:`close`."""

    def __init__(self, path: str, height: int, width: int, channels: int,
                 *, pixel_type: str = "half", compression: str = "zip",
                 zip_level: int = 4, workers: int = 0):
        self._comp_id = COMPRESSION_IDS[compression]
        if self._comp_id == COMPRESSION_IDS["piz"]:
            raise ValueError("the numpy EXR codec writes no PIZ")
        self._ptype = PIXEL_TYPES[pixel_type]
        self._h, self._w, self._c = height, width, channels
        self._lines = LINES_PER_CHUNK[self._comp_id]
        names = _channel_names(channels)
        self._order = sorted(range(channels), key=lambda i: names[i])
        self._zip_level = zip_level
        if workers <= 0:
            workers = min(8, os.cpu_count() or 1)
        self._pool = None
        if workers > 1:
            import concurrent.futures as cf
            self._pool = cf.ThreadPoolExecutor(workers)
        header = (struct.pack("<I", MAGIC) + struct.pack("<i", VERSION)
                  + _build_header(width, height, self._ptype, self._comp_id,
                                  names))
        n_chunks = (height + self._lines - 1) // self._lines
        self._offsets: List[int] = []
        self._closed = False
        self._f = open(path, "wb")
        try:
            self._f.write(header)
            self._table_pos = len(header)
            self._f.write(b"\0" * (8 * n_chunks))
        except BaseException:
            self._release()
            raise
        self._pos = len(header) + 8 * n_chunks
        self._next_row = 0

    def _release(self) -> None:
        self._f.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def write_rows(self, band: np.ndarray) -> None:
        rows, w, c = band.shape
        if (w, c) != (self._w, self._c):
            raise ValueError(f"band is {w}x{c}, file is "
                             f"{self._w}x{self._c}")
        y0 = self._next_row
        if y0 + rows > self._h:
            raise ValueError(f"rows {y0}+{rows} beyond height {self._h}")
        if rows % self._lines and y0 + rows != self._h:
            raise ValueError(
                f"band of {rows} rows is not a whole number of "
                f"{self._lines}-line chunks (use band_rows())")
        spans = [(yb0, min(yb0 + self._lines, rows))
                 for yb0 in range(0, rows, self._lines)]

        def enc(span):
            return _encode_chunk(band, span[0], span[1], y0 + span[0],
                                 self._order, self._ptype, self._comp_id,
                                 self._zip_level)

        chunks = (self._pool.map(enc, spans) if self._pool is not None
                  else map(enc, spans))
        for chunk in chunks:   # map keeps the order
            self._offsets.append(self._pos)
            self._f.write(chunk)
            self._pos += len(chunk)
        self._next_row = y0 + rows

    def close(self) -> None:
        try:
            if self._next_row != self._h:
                raise ValueError(f"only {self._next_row} of {self._h} "
                                 "rows written")
            self._f.seek(self._table_pos)
            self._f.write(struct.pack(f"<{len(self._offsets)}Q",
                                      *self._offsets))
        finally:
            self._release()

    def abort(self) -> None:
        self._release()


# ---------------------------------------------------------------------------
# Dispatch: the native codec, the numpy codec where it may stand in
# ---------------------------------------------------------------------------


def _check_settings(pixel_type: str, compression: str) -> str:
    compression = compression.lower()
    if compression not in COMPRESSION_IDS:
        raise ValueError(f"unknown EXR compression {compression!r}")
    if pixel_type not in PIXEL_TYPES:
        raise ValueError(f"unknown EXR pixel type {pixel_type!r}: one of "
                         f"{sorted(PIXEL_TYPES)}")
    return compression


def _no_piz(why: str) -> ValueError:
    return ValueError(f"compression 'piz' is written by the native EXR "
                      f"codec only, and {why}; the port writes no other "
                      f"compression in its place")


def check_writable(compression: str) -> None:
    """Raise ``ValueError`` where ``compression`` cannot be written here:
    PIZ without the native codec (built on this call if need be)."""
    if compression.lower() == "piz" and load_native() is None:
        raise _no_piz("it is unavailable")


def _host_array(image) -> np.ndarray:
    """A float16 array stays float16 (the half-input entry points);
    anything else (a tensor on any device included) becomes float32."""
    if isinstance(image, torch.Tensor):
        t = image.detach()
        if t.dtype not in (torch.float16, torch.float32):
            t = t.float()
        image = t.cpu().numpy()
    image = np.asarray(image)
    if image.dtype != np.float16:
        image = np.asarray(image, np.float32)
    return np.ascontiguousarray(image)


def write_exr(path: str, image, *, pixel_type: str = "half",
              compression: str = "zip", use_native: bool = True,
              zip_level: int = 4, workers: int = 0) -> None:
    """Write an (H, W, C) or (H, W) float image (a numpy array, or a
    tensor on any device) as a scanline EXR.

    pixel_type: "half" | "float"; compression: none / rle / zips / zip /
    piz / pxr24; zip_level: the zlib level of zip / zips / pxr24 chunks;
    workers: the numpy codec's chunk threads (0 = auto).  float16 input
    goes through the half-input entry point with no float32 round trip.
    ``piz`` raises ``ValueError`` where the native codec is unavailable
    (``use_native=False`` included) or its write fails.
    """
    compression = _check_settings(pixel_type, compression)
    image = _host_array(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3:
        raise ValueError(f"image must be HxWxC, got {image.shape}")
    h, w, c = image.shape
    lib = load_native() if use_native else None
    if lib is not None:
        ptype = PIXEL_TYPES[pixel_type]
        comp_id = COMPRESSION_IDS[compression]
        if image.dtype == np.float16:
            rc = lib.exr_write_half(
                path.encode(), image.view(np.uint16).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint16)),
                h, w, c, ptype, comp_id, zip_level)
        else:
            rc = lib.exr_write(
                path.encode(), image.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)),
                h, w, c, ptype, comp_id, zip_level)
        if rc == 0:
            return
        if compression == "piz":
            raise _no_piz(f"its write returned {rc}")
        logger.warning("native EXR write returned %d; writing %s with the "
                       "numpy codec (the same bytes)", rc, compression)
    elif compression == "piz":
        raise _no_piz("it is " + ("not asked for" if not use_native
                                  else "unavailable"))
    elif use_native:
        logger.warning("native EXR codec unavailable; writing %s with the "
                       "numpy codec (the same bytes)", compression)
    writer = _NumpyBandWriter(path, h, w, c, pixel_type=pixel_type,
                              compression=compression, zip_level=zip_level,
                              workers=workers)
    try:
        writer.write_rows(image)
    except BaseException:
        writer.abort()
        raise
    writer.close()


class ExrBandWriter:
    """Incremental scanline-EXR writer: append bands top to bottom with
    :meth:`write_rows`; every band but the last covers a whole number of
    chunks (round with :meth:`band_rows`).  The file is byte-identical to
    :func:`write_exr`'s on the same pixels at any band split and thread
    count (chunks are independent).  The encode half of the streamed
    export (``io/pipeline.py``): band k encodes on host threads while
    band k+1 is still being copied from the card.  ``piz`` raises
    ``ValueError`` without the native codec, as :func:`write_exr` does."""

    def __init__(self, path: str, height: int, width: int, channels: int,
                 *, pixel_type: str = "half", compression: str = "zip",
                 zip_level: int = 4, workers: int = 0,
                 use_native: bool = True):
        compression = _check_settings(pixel_type, compression)
        self._lib = load_native() if use_native else None
        self._handle = None
        self._py = None
        self._closed = False
        self._h, self._w, self._c = height, width, channels
        if self._lib is not None:
            comp_id = COMPRESSION_IDS[compression]
            handle = self._lib.exr_begin(path.encode(), height, width,
                                         channels, PIXEL_TYPES[pixel_type],
                                         comp_id, zip_level, workers)
            if handle:
                self._handle = ctypes.c_void_p(handle)
                self._lines = self._lib.exr_lines_per_chunk(comp_id)
                return
            if compression == "piz":
                raise _no_piz("its writer could not begin the file")
            logger.warning("native EXR begin failed; writing %s with the "
                           "numpy band writer", compression)
        elif compression == "piz":
            raise _no_piz("it is " + ("not asked for" if not use_native
                                      else "unavailable"))
        self._py = _NumpyBandWriter(
            path, height, width, channels, pixel_type=pixel_type,
            compression=compression, zip_level=zip_level, workers=workers)
        self._lines = self._py._lines

    def band_rows(self, requested: int) -> int:
        """Round a band size up to a whole number of chunks."""
        return max(self._lines,
                   (requested + self._lines - 1) // self._lines
                   * self._lines)

    def write_rows(self, band) -> None:
        band = _host_array(band)
        if band.ndim == 2:
            band = band[..., None]
        if band.ndim != 3:
            raise ValueError(f"band must be [rows, W, C], got {band.shape}")
        if self._py is not None:
            self._py.write_rows(band)
            return
        # the native codec trusts the buffer's dimensions: a mismatched
        # band would be an out-of-bounds read
        if (band.shape[1], band.shape[2]) != (self._w, self._c):
            self.abort()
            raise ValueError(f"band is {band.shape[1]}x{band.shape[2]}, "
                             f"file is {self._w}x{self._c}")
        if band.dtype == np.float16:
            rc = self._lib.exr_write_rows_half(
                self._handle, band.view(np.uint16).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint16)), band.shape[0])
        else:
            rc = self._lib.exr_write_rows(
                self._handle, band.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), band.shape[0])
        if rc != 0:
            self.abort()
            raise ValueError(f"native EXR band write failed (rc={rc})")

    def close(self) -> None:
        """Patch the offset table and close; a second close is a no-op."""
        if self._closed:
            return
        self._closed = True
        if self._py is not None:
            self._py.close()
            return
        rc = self._lib.exr_end(self._handle)
        self._handle = None
        if rc != 0:
            raise ValueError(f"native EXR finalize failed (rc={rc})")

    def abort(self) -> None:
        """Close without finalizing (the file is left invalid)."""
        if self._closed:
            return
        self._closed = True
        if self._py is not None:
            self._py.abort()
        elif self._handle is not None:
            self._lib.exr_abort(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


def _read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def read_exr_header(buf: bytes) -> Tuple[Dict, int]:
    """(header record, offset of the chunk table) of a scanline EXR."""
    magic, version = struct.unpack_from("<Ii", buf, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    if version & (0x800 | 0x1000):
        raise NotImplementedError("deep/multipart EXR not supported")
    pos = 8
    attrs: Dict = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        typ, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        # a negative size would walk pos backwards and re-parse the same
        # attribute forever
        if size < 0 or pos + size > len(buf):
            raise ValueError(f"corrupt EXR header: attribute {name!r} "
                             f"size {size} out of bounds")
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    ch_payload = attrs["channels"][1]
    channels = []
    cpos = 0
    while ch_payload[cpos] != 0:
        cname, cpos = _read_cstr(ch_payload, cpos)
        (ptype,) = struct.unpack_from("<i", ch_payload, cpos)
        cpos += 4 + 4 + 8   # type + pLinear / reserved + sampling
        channels.append((cname, ptype))
    comp_id = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    header = {
        "channels": channels,
        "compression": _ID_TO_NAME.get(comp_id, str(comp_id)),
        "compression_id": comp_id,
        "width": x1 - x0 + 1,
        "height": y1 - y0 + 1,
        "y_min": y0,
        "attrs": attrs,
    }
    return header, pos


def _read_exr_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    header, pos = read_exr_header(buf)
    w, h = header["width"], header["height"]
    comp_id = header["compression_id"]
    if comp_id not in LINES_PER_CHUNK:
        raise NotImplementedError(header["compression"])
    lines = LINES_PER_CHUNK[comp_id]
    channels = header["channels"]
    n_chunks = -(-h // lines)
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    planes = {name: np.empty((h, w), np.float32) for name, _ in channels}
    row_bytes = sum(w * _PIX_SIZE[pt] for _, pt in channels)
    rows_seen = np.zeros(h, bool)
    for ci, off in enumerate(offsets):
        if off > len(buf) - 8:
            raise ValueError(f"corrupt EXR: chunk offset {off} out of "
                             "bounds")
        y, size = struct.unpack_from("<ii", buf, off)
        y -= header["y_min"]
        # a lying scanline would write rows through negative indexing and
        # leave others uninitialized
        if y < 0 or y >= h:
            raise ValueError(f"corrupt EXR: chunk {ci} claims scanline "
                             f"{y + header['y_min']}")
        if size < 0 or off + 8 + size > len(buf):
            raise ValueError(f"corrupt EXR: chunk {ci} size {size} out "
                             "of bounds")
        data = buf[off + 8:off + 8 + size]
        y1 = min(y + lines, h)
        nrows = y1 - y
        rows_seen[y:y1] = True
        raw_size = nrows * row_bytes
        if comp_id == 0 or len(data) >= raw_size:
            raw = data   # writers store raw what does not shrink
        elif comp_id == 4:
            raw = _piz_decode_chunk(data, channels, w, nrows, raw_size)
        elif comp_id == 1:
            raw = _filter_decode(_rle_decode(data, raw_size))
        elif comp_id in (2, 3):
            raw = _filter_decode(zlib.decompress(data))
        else:   # PXR24
            row_types = [pt for _ in range(nrows) for _, pt in channels]
            rows = _pxr24_unpack_rows(zlib.decompress(data), w, row_types)
            ri = 0
            for yy in range(y, y1):
                for name, _ in channels:
                    planes[name][yy] = rows[ri]
                    ri += 1
            continue
        rpos = 0
        for yy in range(y, y1):
            for name, pt in channels:
                nbytes = w * _PIX_SIZE[pt]
                planes[name][yy] = np.frombuffer(raw[rpos:rpos + nbytes],
                                                 _PIX_DTYPE[pt])
                rpos += nbytes
    if not rows_seen.all():
        # duplicated chunk scanlines cover some rows twice, others never
        missing = np.nonzero(~rows_seen)[0]
        raise ValueError(f"corrupt EXR: {missing.size} scanlines "
                         f"(first {missing[0]}) covered by no chunk")
    names = [name for name, _ in channels]
    if set(names) >= {"R", "G", "B"}:
        # RGB first, then every other channel in header order (the native
        # reader's plane layout)
        stack = [planes["R"], planes["G"], planes["B"]]
        stack += [planes[n] for n in names if n not in ("R", "G", "B")]
        return np.stack(stack, -1)
    # channelN planes in numeric order (unpadded names sort channel10
    # before channel2)
    ms = [re.match(r"^channel(\d+)$", n) for n in names]
    if len(names) > 1 and all(ms):
        names = [n for _, n in sorted(
            (int(m.group(1)), n) for m, n in zip(ms, names))]
    return np.stack([planes[n] for n in names], -1)


def read_exr(path: str, *, use_native: bool = True) -> np.ndarray:
    """Read a scanline EXR as float32 (H, W, C); RGB files come back in
    RGB order.  The native reader first, the numpy one where it is
    unavailable or refuses the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = load_native() if use_native else None
    if lib is not None:
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.exr_read_header(path.encode(), ctypes.byref(w),
                                 ctypes.byref(h), ctypes.byref(c))
        if rc == 0:
            out = np.empty((h.value, w.value, c.value), np.float32)
            rc = lib.exr_read(path.encode(), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)))
            if rc == 0:
                return out
        logger.warning("native EXR read returned %d; reading with the "
                       "numpy codec", rc)
    return _read_exr_numpy(path)
