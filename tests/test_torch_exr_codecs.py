"""The port's EXR codecs (``hdrvae_torch/io/exr.py``, the native codec it
builds from ``hdrvae_torch/csrc/exr_codec.cpp``) against the JAX package's.

The numpy codec and the native one must write files byte-identical to
``hdrvae/io/exr_py.py`` for none, rle, zips, zip and pxr24, and PIZ files
byte-identical to the JAX native codec's; every reader of either package
must read every file either package writes, bit-exact; the corrupt files
the JAX suite rejects are rejected here too.  Unlike the JAX package, the
port refuses PIZ where it has no native codec instead of writing zip.
"""

import os
import struct

import numpy as np
import pytest
import torch

from hdrvae.io import exr as jexr
from hdrvae.io import exr_py
from hdrvae_torch.core import config as tconfig
from hdrvae_torch.io import exr as texr
from hdrvae_torch.io import export as texport
from hdrvae_torch.io import native_build

NUMPY_COMPRESSIONS = ["none", "rle", "zips", "zip", "pxr24"]
SHAPES = [(1, 1), (16, 5), (17, 9), (33, 7)]   # chunk edges: 1, 16, 32


@pytest.fixture(scope="module", autouse=True)
def native():
    lib = native_build.load_native()
    assert lib is not None, "the native EXR codec did not build (g++, zlib)"
    return lib


def _image(shape, seed=0):
    """HDR values, negatives, NaN, +-inf and -0 (specials where they fit)."""
    r = np.random.default_rng(seed)
    img = (r.standard_normal(shape) * 4).astype(np.float32)
    flat = img.reshape(-1)
    for i, v in enumerate([np.nan, np.inf, -np.inf, -0.0, 65504.0, 1e-6]):
        if i < flat.size:
            flat[i] = v
    return img


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_array(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("compression", NUMPY_COMPRESSIONS)
def test_bytes_match_exr_py(tmp_path, compression, pixel_type, channels):
    """Both of the port's writers against exr_py, at odd shapes and chunk
    edges, with NaN, +-inf and negative values."""
    for i, hw in enumerate(SHAPES):
        img = _image((*hw, channels), seed=i)
        ref = tmp_path / "ref.exr"
        exr_py.write_exr(str(ref), img, pixel_type=pixel_type,
                         compression=compression)
        for use_native in (False, True):
            got = tmp_path / f"got{use_native}.exr"
            texr.write_exr(str(got), img, pixel_type=pixel_type,
                           compression=compression, use_native=use_native)
            assert _read(got) == _read(ref), (hw, use_native)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_piz_bytes_match_jax_native(tmp_path, pixel_type, channels):
    for i, hw in enumerate(SHAPES + [(64, 40)]):
        img = _image((*hw, channels), seed=10 + i)
        ref, got = tmp_path / "ref.exr", tmp_path / "got.exr"
        jexr.write_exr(str(ref), img, pixel_type=pixel_type,
                       compression="piz", use_native=True)
        texr.write_exr(str(got), img, pixel_type=pixel_type,
                       compression="piz")
        assert exr_py.read_exr_header(_read(got))[0]["compression"] == "piz"
        assert _read(got) == _read(ref), hw


@pytest.mark.parametrize("compression", NUMPY_COMPRESSIONS + ["piz"])
def test_cross_reads(tmp_path, compression):
    """Files of either package read bit-exact by every reader of both."""
    img = _image((37, 21, 3), seed=5)
    for pixel_type in ("half", "float"):
        jpath, tpath = tmp_path / "j.exr", tmp_path / "t.exr"
        jexr.write_exr(str(jpath), img, pixel_type=pixel_type,
                       compression=compression, use_native=True)
        texr.write_exr(str(tpath), img, pixel_type=pixel_type,
                       compression=compression)
        want = exr_py.read_exr(str(jpath))
        for path in (jpath, tpath):
            for use_native in (False, True):
                _same_array(texr.read_exr(str(path), use_native=use_native),
                            want)
            _same_array(exr_py.read_exr(str(path)), want)
            _same_array(jexr.read_exr(str(path), use_native=True), want)
        if compression != "pxr24":
            expect = (img.astype(np.float16).astype(np.float32)
                      if pixel_type == "half" else img)
            _same_array(want, expect)


def test_pxr24_float24_matches_jax():
    bits = np.random.default_rng(3).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64)
    f = bits.astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(texr.float_to_float24(f),
                                  exr_py.float_to_float24(f))
    i24 = texr.float_to_float24(f)
    _same_array(texr.float24_to_float(i24), exr_py.float24_to_float(i24))


@pytest.mark.parametrize("compression,use_native", [
    (c, n) for c in NUMPY_COMPRESSIONS + ["piz"] for n in (False, True)
    if n or c != "piz"])   # PIZ: native only (refused without it, below)
def test_band_writer_matches_serial(tmp_path, compression, use_native):
    """ExrBandWriter at band sizes 1, 7, 16 and 256 and two thread
    counts, float32 and float16 band input, against the whole-image
    write."""
    img = _image((45, 33, 3), seed=7)
    for pixel_type in ("half", "float"):
        ref = tmp_path / "ref.exr"
        jexr.write_exr(str(ref), img, pixel_type=pixel_type,
                       compression=compression, use_native=True)
        for src in (img, img.astype(np.float16)):
            if src.dtype == np.float16:
                ref16 = tmp_path / "ref16.exr"
                texr.write_exr(str(ref16), src, pixel_type=pixel_type,
                               compression=compression)
                want = _read(ref16)
            else:
                want = _read(ref)
            for band, workers in [(1, 1), (7, 2), (16, 1), (256, 4)]:
                p = tmp_path / f"b{band}.exr"
                w = texr.ExrBandWriter(str(p), *src.shape,
                                       pixel_type=pixel_type,
                                       compression=compression,
                                       workers=workers,
                                       use_native=use_native)
                rows = w.band_rows(band)
                with w:
                    for y in range(0, src.shape[0], rows):
                        w.write_rows(src[y:y + rows])
                assert _read(p) == want, (pixel_type, src.dtype, band)


def test_float16_input_matches_float32_input(tmp_path):
    """float16 input (the streamed export's fetch) writes the file that
    float32 input of the same binary16 values writes."""
    img16 = _image((21, 37, 3), seed=8).astype(np.float16)
    for compression in NUMPY_COMPRESSIONS + ["piz"]:
        for pixel_type in ("half", "float"):
            a, b = tmp_path / "a.exr", tmp_path / "b.exr"
            texr.write_exr(str(a), img16.astype(np.float32),
                           pixel_type=pixel_type, compression=compression)
            texr.write_exr(str(b), torch.from_numpy(img16),
                           pixel_type=pixel_type, compression=compression)
            assert _read(a) == _read(b), (compression, pixel_type)


def test_band_writer_rejects_partial_and_mismatched_bands(tmp_path):
    for use_native in (False, True):
        w = texr.ExrBandWriter(str(tmp_path / "x.exr"), 40, 8, 3,
                               compression="zip", use_native=use_native)
        if not use_native:
            with pytest.raises(ValueError, match="chunk"):
                w.write_rows(np.zeros((10, 8, 3), np.float32))
        with pytest.raises(ValueError, match="8x3"):
            w.write_rows(np.zeros((16, 8, 4), np.float32))
        w.abort()
        w = texr.ExrBandWriter(str(tmp_path / "y.exr"), 32, 8, 3,
                               compression="zip", use_native=use_native)
        w.write_rows(np.zeros((16, 8, 3), np.float32))
        with pytest.raises(ValueError):
            w.close()


# ---------------------------------------------------------------------------
# PIZ: the wavelet's 16-bit path, many shapes, the refusal
# ---------------------------------------------------------------------------


def test_piz_16bit_wavelet_path(tmp_path):
    """> 16384 distinct shorts take wenc16 / wdec16."""
    img = (np.random.default_rng(8).standard_normal((128, 128, 3))
           * 100).astype(np.float32)
    path = str(tmp_path / "big.exr")
    texr.write_exr(path, img, pixel_type="float", compression="piz")
    for use_native in (True, False):
        _same_array(texr.read_exr(path, use_native=use_native), img)
    _same_array(exr_py.read_exr(path), img)


def test_piz_many_shapes_lossless(tmp_path):
    r = np.random.default_rng(9)
    shapes = [(1, 1, 3), (7, 3, 3), (31, 5, 3), (32, 8, 3), (33, 129, 3),
              (96, 17, 3), (64, 64, 1)]
    for i, shape in enumerate(shapes):
        img = (r.standard_normal(shape) * (10 ** (i % 4))).astype(
            np.float32)
        img.flat[0], img.flat[-1] = 65504.0, -65504.0
        for ptype in ("half", "float"):
            path = str(tmp_path / f"f{i}{ptype}.exr")
            texr.write_exr(path, img, pixel_type=ptype, compression="piz")
            expect = (img.astype(np.float16).astype(np.float32)
                      if ptype == "half" else img)
            for use_native in (True, False):
                _same_array(texr.read_exr(path, use_native=use_native),
                            expect)


def _no_native(monkeypatch):
    monkeypatch.setattr(texr, "load_native", lambda: None)


def test_piz_refused_without_native_codec(tmp_path, monkeypatch):
    """With the loader made to fail, piz raises and the export is an
    ERROR with nothing written (the JAX package writes zip instead); the
    other compressions still write the same bytes through numpy."""
    _no_native(monkeypatch)
    img = _image((9, 11, 3))
    with pytest.raises(ValueError, match="piz"):
        texr.write_exr(str(tmp_path / "p.exr"), img, compression="piz")
    with pytest.raises(ValueError, match="piz"):
        texr.ExrBandWriter(str(tmp_path / "b.exr"), 9, 11, 3,
                           compression="piz")
    assert not os.listdir(tmp_path)
    res = texport.export_linear(img, tconfig.ExportConfig(
        compression="piz", output_path=""),
        default_output_dir=str(tmp_path / "o"))
    assert res.error is not None and res.error.startswith("ERROR: ")
    assert "piz" in res.error and res.filepaths == []
    assert not (tmp_path / "o").exists()
    texr.write_exr(str(tmp_path / "z.exr"), img, compression="zip")
    exr_py.write_exr(str(tmp_path / "r.exr"), img, compression="zip")
    assert _read(tmp_path / "z.exr") == _read(tmp_path / "r.exr")


def test_failed_native_write(tmp_path, monkeypatch):
    """A native write that fails: piz raises, zip falls back to numpy."""

    class FailingLib:
        def exr_write(self, *a):
            return -5

    monkeypatch.setattr(texr, "load_native", lambda: FailingLib())
    img = _image((6, 6, 3))
    with pytest.raises(ValueError, match="returned -5"):
        texr.write_exr(str(tmp_path / "p.exr"), img, compression="piz")
    texr.write_exr(str(tmp_path / "z.exr"), img, compression="zip")
    exr_py.write_exr(str(tmp_path / "r.exr"), img, compression="zip")
    assert _read(tmp_path / "z.exr") == _read(tmp_path / "r.exr")


def test_jax_zip_in_place_of_piz_differs(tmp_path, monkeypatch):
    """The difference kept from the JAX package: without its native codec
    JAX writes zip when asked for piz; the port raises."""
    import hdrvae.io.exr as jexr_mod
    monkeypatch.setattr(jexr_mod, "load_native", lambda: None)
    img = _image((6, 6, 3))
    jexr_mod.write_exr(str(tmp_path / "j.exr"), img, compression="piz")
    assert exr_py.read_exr_header(_read(tmp_path / "j.exr"))[0][
        "compression"] == "zip"
    _no_native(monkeypatch)
    with pytest.raises(ValueError):
        texr.write_exr(str(tmp_path / "t.exr"), img, compression="piz")


# ---------------------------------------------------------------------------
# Corrupt files (the JAX suite's rejections)
# ---------------------------------------------------------------------------


def _base(tmp_path, comp="none", h=6, w=5):
    img = np.random.default_rng(1).standard_normal((h, w, 3)).astype(
        np.float32)
    p = str(tmp_path / f"base_{comp}.exr")
    texr.write_exr(p, img, compression=comp, pixel_type="half")
    return p, bytearray(_read(p))


def _both_readers_raise(path, match=None):
    for use_native in (True, False):
        with pytest.raises(Exception, match=match):
            texr.read_exr(path, use_native=use_native)


def test_truncated_files_rejected(tmp_path):
    p = str(tmp_path / "t.exr")
    texr.write_exr(p, np.random.default_rng(2).standard_normal(
        (32, 32, 3)).astype(np.float32), compression="zip")
    blob = _read(p)
    for cut in (len(blob) - 7, len(blob) // 2):
        pt = str(tmp_path / f"cut{cut}.exr")
        with open(pt, "wb") as f:
            f.write(blob[:cut])
        _both_readers_raise(pt)


def test_lying_chunk_sizes(tmp_path):
    """A size past the end: the native reader refuses, the numpy one
    refuses or returns the true pixels; a none chunk shorter than its
    rows is refused by both."""
    p = str(tmp_path / "c.exr")
    img = np.random.default_rng(3).standard_normal((32, 32, 3)).astype(
        np.float32)
    texr.write_exr(p, img, compression="none")
    blob = bytearray(_read(p))
    size_pos = len(blob) - 32 * 3 * 2 - 4
    for value, must_raise in ((2 ** 31 - 1, False), (0, True)):
        blob[size_pos:size_pos + 4] = value.to_bytes(4, "little")
        pc = str(tmp_path / f"size{value}.exr")
        with open(pc, "wb") as f:
            f.write(bytes(blob))
        if must_raise:
            _both_readers_raise(pc)
            continue
        for use_native in (True, False):
            try:
                got = texr.read_exr(pc, use_native=use_native)
            except ValueError:
                continue
            np.testing.assert_array_equal(got, texr.read_exr(p))


@pytest.mark.parametrize("flag", [0x200, 0x800, 0x1000])
def test_nonscanline_layouts_rejected(tmp_path, flag):
    p = str(tmp_path / "v.exr")
    texr.write_exr(p, np.zeros((8, 8, 3), np.float32), compression="none")
    blob = bytearray(_read(p))
    version = int.from_bytes(blob[4:8], "little") | flag
    blob[4:8] = version.to_bytes(4, "little")
    pv = str(tmp_path / "flag.exr")
    with open(pv, "wb") as f:
        f.write(bytes(blob))
    _both_readers_raise(pv)


def test_crafted_header_and_table_corruption(tmp_path):
    """A negative attribute size and a wild chunk offset (both readers
    refuse), a lying chunk scanline and a duplicated one (the numpy
    reader refuses, as the JAX suite holds exr_py to)."""
    p, blob = _base(tmp_path)
    name_end = blob.index(b"\0", 8)
    pos = blob.index(b"\0", name_end + 1) + 1
    bad = bytearray(blob)
    bad[pos:pos + 4] = struct.pack("<i", -28)
    with pytest.raises(ValueError, match="out of bounds"):
        texr.read_exr_header(bytes(bad))
    cases = {"negative_size": (bad, None, True)}
    header, tpos = texr.read_exr_header(bytes(blob))
    off0, off1 = struct.unpack_from("<2Q", bytes(blob), tpos)
    bad = bytearray(blob)
    bad[off0:off0 + 4] = struct.pack("<i", header["y_min"] - 1)
    cases["lying_y"] = (bad, "scanline", False)
    bad = bytearray(blob)
    bad[off1:off1 + 4] = bytes(blob[off0:off0 + 4])
    cases["duplicate_y"] = (bad, "covered by no chunk", False)
    bad = bytearray(blob)
    bad[tpos:tpos + 8] = struct.pack("<Q", 2 ** 64 - 1)
    cases["wild_offset"] = (bad, "out of bounds", True)
    for name, (data, match, dispatch) in cases.items():
        pc = str(tmp_path / f"{name}.exr")
        with open(pc, "wb") as f:
            f.write(bytes(data))
        if dispatch:
            with pytest.raises(Exception):
                texr.read_exr(pc)
        with pytest.raises(ValueError, match=match):
            texr.read_exr(pc, use_native=False)


def test_piz_huffman_tlen_overflow_rejected(tmp_path):
    img = np.tile(np.linspace(0, 1, 16, dtype=np.float32)[None, :, None],
                  (40, 1, 3))
    p = str(tmp_path / "piz.exr")
    texr.write_exr(p, img, compression="piz", pixel_type="half")
    blob = bytearray(_read(p))
    header, pos = texr.read_exr_header(bytes(blob))
    (off0,) = struct.unpack_from("<Q", bytes(blob), pos)
    (csize,) = struct.unpack_from("<i", bytes(blob), off0 + 4)
    assert csize < 32 * 16 * 2 * 3, "chunk stored raw; patch useless"
    payload = off0 + 8
    min_nz, max_nz = struct.unpack_from("<HH", bytes(blob), payload)
    count = (max_nz - min_nz + 1) if min_nz <= max_nz else 0
    tlen_pos = payload + 4 + count + 4 + 8
    blob[tlen_pos:tlen_pos + 4] = struct.pack("<I", 0xFFFFFFF6)
    with open(p, "wb") as f:
        f.write(bytes(blob))
    _both_readers_raise(p)


def test_nan_payloads_byte_identical(tmp_path):
    """Every binary16 pattern, NaN payloads included, written as float32
    values by the native codec, the numpy one and exr_py: one file."""
    img = np.arange(65536, dtype=np.uint16).view(np.float16).astype(
        np.float32).reshape(256, 256, 1)
    ref = tmp_path / "ref.exr"
    exr_py.write_exr(str(ref), img, pixel_type="half", compression="none")
    for use_native in (True, False):
        p = tmp_path / f"n{use_native}.exr"
        texr.write_exr(str(p), img, pixel_type="half", compression="none",
                       use_native=use_native)
        assert _read(p) == _read(ref)


def test_reader_corruption_fuzz(tmp_path):
    """Random corruptions: a clean exception or a parse, never a crash."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((32, 24, 3)).astype(np.float32)
    bases = {}
    for comp in NUMPY_COMPRESSIONS + ["piz"]:
        p = str(tmp_path / f"{comp}.exr")
        texr.write_exr(p, img, compression=comp)
        bases[comp] = _read(p)
    pt = str(tmp_path / "fuzz.exr")
    for comp, blob in bases.items():
        for seed in range(12):
            r = np.random.default_rng(seed + 100 * len(comp))
            b = bytearray(blob)
            if seed % 3 == 0:
                b = b[:int(r.integers(8, len(b)))]
            else:
                for _ in range(int(r.integers(1, 16))):
                    pos = int(r.integers(0, len(b) - 4))
                    b[pos:pos + 4] = int(r.integers(0, 2 ** 32)).to_bytes(
                        4, "little")
            with open(pt, "wb") as f:
                f.write(bytes(b))
            try:
                texr.read_exr(pt)
            except Exception:
                pass   # a clean rejection


def test_channel_order_rules(tmp_path, monkeypatch):
    """12 channels come back in numeric order; legacy unpadded names too;
    R, G, B plus an extra channel: RGB first, then the extra."""
    img = np.random.default_rng(0).standard_normal((6, 5, 12)).astype(
        np.float32)
    for use_native in (True, False):
        p = str(tmp_path / f"multi{use_native}.exr")
        texr.write_exr(p, img, pixel_type="float", compression="zip",
                       use_native=use_native)
        _same_array(texr.read_exr(p, use_native=not use_native), img)
    monkeypatch.setattr(exr_py, "_channel_names",
                        lambda c: [f"channel{i}" for i in range(c)])
    p = str(tmp_path / "legacy.exr")
    exr_py.write_exr(p, img[..., :11], pixel_type="float",
                     compression="zip")
    for use_native in (True, False):
        _same_array(texr.read_exr(p, use_native=use_native), img[..., :11])
    monkeypatch.setattr(exr_py, "_channel_names",
                        lambda c: ["B", "G", "R", "Z"])
    p = str(tmp_path / "rgbz.exr")
    exr_py.write_exr(p, img[..., :4], pixel_type="float", compression="zip")
    for use_native in (True, False):
        got = texr.read_exr(p, use_native=use_native)
        _same_array(got[..., 0], img[..., 2])
        _same_array(got[..., 3], img[..., 3])


def test_native_library_built_from_the_port(native):
    """The loaded codec is the port's build of its own copy of the
    source, under hdrvae_torch/build/."""
    path = native_build.library_path()
    assert path.exists() and path.parent == native_build.BUILD_DIR
    assert native_build.SRC.parent.name == "csrc"
    assert native._name == str(path)
