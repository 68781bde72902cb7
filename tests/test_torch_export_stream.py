"""The port's streamed export (``hdrvae_torch/io/pipeline.py``) against the
JAX package's (``hdrvae/io/pipeline.py``) and against its own serial
exporter.

The same numpy frames (made from seeds) go through both packages'
``export_stream`` / ``export_frame_streamed`` and the port's
``export_linear`` into separate directories: file names and bytes must be
identical.  The port's frames may also be torch tensors (here on the CPU;
``tests/test_torch_frontend_cuda.py`` covers CUDA frames on the card).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from hdrvae.core import config as jconfig
from hdrvae.io import export as jexport
from hdrvae.io import pipeline as jpipe
from hdrvae_torch.core import config as tconfig
from hdrvae_torch.io import export as texport
from hdrvae_torch.io import exr as texr
from hdrvae_torch.io import pipeline as tpipe


def _frames(n=4, h=12, w=10, seed=33):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = rng.standard_normal((h, w, 3)).astype(np.float32) * 1.5
        f[0, 0, 0] = -0.3
        f[1, 1, 1] = 70.0
        out.append(f)
    return out


def _frame(seed=42, shape=(45, 37, 3)):
    r = np.random.default_rng(seed)
    img = (r.standard_normal(shape) * 4).astype(np.float32)
    img[0, 0] = [50.0, -3.5, 0.0]
    img[0, 1] = [np.nan, np.inf, -np.inf]
    img[0, 2] = [-0.0, 6e-8, 1e-5]   # -0 and float16 subnormals
    return img


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _cfgs(**kw):
    return jconfig.ExportConfig(**kw), tconfig.ExportConfig(**kw)


@pytest.mark.parametrize("compression", ["none", "rle", "zip", "piz",
                                         "pxr24"])
@pytest.mark.parametrize("bit_depth", ["16bit", "32bit"])
def test_stream_matches_jax_and_serial(tmp_path, compression, bit_depth):
    """export_stream: the JAX package's files, and the serial exporter's,
    byte for byte, from numpy frames and from tensors."""
    frames = _frames()
    jcfg, tcfg = _cfgs(filename_prefix="pipe", output_path="",
                       bit_depth=bit_depth, compression=compression,
                       versioning=True)
    ref = jpipe.export_stream(frames, jcfg,
                              default_output_dir=str(tmp_path / "jax"))
    got = tpipe.export_stream(frames, tcfg,
                              default_output_dir=str(tmp_path / "np"))
    got_t = tpipe.export_stream([torch.from_numpy(f) for f in frames], tcfg,
                                default_output_dir=str(tmp_path / "t"))
    serial = texport.export_linear(np.stack(frames), tcfg,
                                   default_output_dir=str(tmp_path / "s"))
    for res in (ref, got, got_t, serial):
        assert res.error is None, res.error
        assert len(res.filepaths) == 4
    want = _files(tmp_path / "jax")
    assert len(want) == 4
    for d in ("np", "t", "s"):
        assert _files(tmp_path / d) == want, d
    assert got.verified and got.verify_stats == ref.verify_stats


@pytest.mark.parametrize("compression", ["none", "rle", "zip", "piz",
                                         "pxr24"])
@pytest.mark.parametrize("bit_depth", ["16bit", "32bit"])
def test_frame_streamed_matches_jax_and_serial(tmp_path, compression,
                                               bit_depth):
    """export_frame_streamed at band sizes that cut chunks: the JAX
    package's file and the serial exporter's, from an array and from a
    tensor (float32 and float16), NaN, +-inf, -0 and subnormals included."""
    img = _frame()
    jcfg, tcfg = _cfgs(filename_prefix="f", output_path="",
                       bit_depth=bit_depth, compression=compression)
    ref = jpipe.export_frame_streamed(img, jcfg, band_rows=16,
                                      default_output_dir=str(tmp_path / "j"))
    assert ref.error is None
    want = _files(tmp_path / "j")
    serial = texport.export_linear(img, tcfg,
                                   default_output_dir=str(tmp_path / "s"))
    assert serial.error is None and _files(tmp_path / "s") == want
    inputs = {"np": img, "t": torch.from_numpy(img), "call": lambda: img}
    for name, frame in inputs.items():
        for band in (1, 7, 16, 256):
            d = tmp_path / f"{name}{band}"
            got = tpipe.export_frame_streamed(
                frame, tcfg, band_rows=band, workers=1 + band % 3,
                default_output_dir=str(d))
            assert got.error is None and got.verified, got.error
            assert _files(d) == want, (name, band)
    if bit_depth == "16bit":
        # float16 frames: the file of the same binary16 values
        half = torch.from_numpy(img).half()
        got = tpipe.export_frame_streamed(
            half, tcfg, band_rows=16, default_output_dir=str(tmp_path / "h"))
        assert got.error is None and _files(tmp_path / "h") == want


def test_frame_streamed_reports_like_serial(tmp_path, caplog):
    img = np.nan_to_num(_frame(shape=(20, 9, 3)), posinf=9.0, neginf=-9.0)
    cfg = tconfig.ExportConfig(filename_prefix="v", output_path="",
                               bit_depth="32bit", save_workflow=True)
    with caplog.at_level("INFO", logger="hdrvae_torch.io.pipeline"):
        got = tpipe.export_frame_streamed(
            img, cfg, prompt={"p": 1}, default_output_dir=str(tmp_path / "a"))
    serial = texport.export_linear(img, cfg, prompt={"p": 1},
                                   default_output_dir=str(tmp_path / "b"))
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    assert got.verify_stats == serial.verify_stats
    assert (f"hdr_pixels={int((img > 1.0).sum())} "
            f"negatives={int((img < 0.0).sum())}") in caplog.text


def test_non_exr_and_errors(tmp_path):
    img = _frame(shape=(6, 5, 3))
    res = tpipe.export_frame_streamed(
        img, tconfig.ExportConfig(filename_prefix="h", output_path="",
                                  format="hdr"),
        default_output_dir=str(tmp_path))
    assert res.error is None and res.last.endswith(".hdr")
    for fn in (tpipe.export_frame_streamed,
               lambda f, c, **k: tpipe.export_stream([f], c, **k)):
        res = fn(img, tconfig.ExportConfig(filename_prefix="e",
                                           output_path="",
                                           compression="nope"),
                 default_output_dir=str(tmp_path))
        assert res.error is not None and res.error.startswith("ERROR")
    res = tpipe.export_stream([], tconfig.ExportConfig(),
                              default_output_dir=str(tmp_path))
    assert res.error == "ERROR: no frames"


def test_piz_without_native_codec_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(texr, "load_native", lambda: None)
    cfg = tconfig.ExportConfig(filename_prefix="z", output_path="",
                               compression="piz")
    for res in (tpipe.export_frame_streamed(_frame(), cfg,
                                            default_output_dir=str(tmp_path)),
                tpipe.export_stream(_frames(2), cfg,
                                    default_output_dir=str(tmp_path))):
        assert res.error is not None and "piz" in res.error
        assert res.filepaths == []
    assert not any(n.endswith(".exr") for _, _, ns in os.walk(tmp_path)
                   for n in ns)


def test_reduced_precision_and_chunked_fetch(tmp_path):
    """float16 fetch for 16-bit output and a chunked fetch write the
    files of a full float32 fetch."""
    frames = [torch.from_numpy(f) for f in _frames(2, h=16)]
    for bit_depth, kw in (("16bit", {"reduced_precision_fetch": False}),
                          ("32bit", {"fetch_workers": 4})):
        cfg = tconfig.ExportConfig(filename_prefix="rp", output_path="",
                                   bit_depth=bit_depth)
        a = tpipe.export_stream(frames, cfg,
                                default_output_dir=str(tmp_path / "a"))
        b = tpipe.export_stream(frames, cfg,
                                default_output_dir=str(tmp_path / "b"), **kw)
        assert a.error is None and b.error is None
        assert _files(tmp_path / "a") == _files(tmp_path / "b")


def test_midstream_failure_reports_written_files(tmp_path):
    frames = _frames(4)

    def boom():
        raise RuntimeError("device died")

    seq = tconfig.ExportConfig(filename_prefix="part", frame_sequence=True)
    res = tpipe.export_stream(frames[:2] + [boom] + frames[3:], seq,
                              default_output_dir=str(tmp_path))
    assert res.error is not None and "device died" in res.error
    assert len(res.filepaths) >= 1
    assert all(os.path.exists(p) for p in res.filepaths)


def test_write_failure_stops_the_sequence(tmp_path, monkeypatch):
    orig_save = tpipe._save_one
    calls = []

    def failing_save(path, *a, **k):
        calls.append(path)
        if len(calls) == 3:
            raise RuntimeError("disk full")
        return orig_save(path, *a, **k)

    monkeypatch.setattr(tpipe, "_save_one", failing_save)
    seq = tconfig.ExportConfig(filename_prefix="hole", frame_sequence=True)
    res = tpipe.export_stream(_frames(8), seq, depth=2,
                              default_output_dir=str(tmp_path))
    assert res.error is not None and "disk full" in res.error
    assert len(calls) <= 3 + 2, calls
    assert len(res.filepaths) >= 2
    assert all(os.path.exists(p) for p in res.filepaths)


def test_verify_and_sidecar_failures_are_nonfatal(tmp_path, monkeypatch):
    def bad_verify(path):
        raise RuntimeError("reader unavailable")

    monkeypatch.setattr(tpipe, "verify_save", bad_verify)
    res = tpipe.export_stream(
        _frames(2), tconfig.ExportConfig(filename_prefix="vs",
                                         frame_sequence=True),
        default_output_dir=str(tmp_path))
    assert res.error is None and len(res.filepaths) == 2
    assert res.verified is False
    res = tpipe.export_frame_streamed(
        _frame(), tconfig.ExportConfig(filename_prefix="vf"),
        default_output_dir=str(tmp_path))
    assert res.error is None and res.verified is False
    monkeypatch.undo()
    res = tpipe.export_frame_streamed(
        _frame(), tconfig.ExportConfig(filename_prefix="sc",
                                       save_workflow=True),
        default_output_dir=str(tmp_path), prompt={"bad": {1, 2, 3}})
    assert res.error is None and res.verified


def test_writer_queue_is_bounded(tmp_path, monkeypatch):
    state = {"fetched": 0, "written": 0, "max_gap": 0}
    lock = threading.Lock()
    orig_fetch, orig_save = tpipe._fetch, tpipe._save_one

    def counting_fetch(*a, **k):
        out = orig_fetch(*a, **k)
        with lock:
            state["fetched"] += 1
            state["max_gap"] = max(state["max_gap"],
                                   state["fetched"] - state["written"])
        return out

    def slow_save(*a, **k):
        time.sleep(0.05)
        out = orig_save(*a, **k)
        with lock:
            state["written"] += 1
        return out

    monkeypatch.setattr(tpipe, "_fetch", counting_fetch)
    monkeypatch.setattr(tpipe, "_save_one", slow_save)
    seq = tconfig.ExportConfig(filename_prefix="bq", frame_sequence=True)
    res = tpipe.export_stream(_frames(10), seq, depth=2,
                              default_output_dir=str(tmp_path))
    assert res.error is None, res.error
    assert len(res.filepaths) == 10
    assert state["max_gap"] <= 2 * 2 + 1, state


def test_stream_consumes_generator_lazily(tmp_path, monkeypatch):
    """A generator is drawn at the pipeline's pace, never whole."""
    state = {"produced": 0, "written": 0, "max_gap": 0}
    lock = threading.Lock()
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.uniform(0, 2, (8, 6, 3)).astype(
        np.float32)) for _ in range(10)]

    def gen():
        for img in imgs:
            with lock:
                state["produced"] += 1
                state["max_gap"] = max(state["max_gap"],
                                       state["produced"] - state["written"])
            yield img

    orig_save = tpipe._save_one

    def slow_save(*a, **k):
        time.sleep(0.03)
        out = orig_save(*a, **k)
        with lock:
            state["written"] += 1
        return out

    monkeypatch.setattr(tpipe, "_save_one", slow_save)
    res = tpipe.export_stream(gen(), tconfig.ExportConfig(
        filename_prefix="lazy", frame_sequence=True), depth=2,
        default_output_dir=str(tmp_path))
    assert res.error is None, res.error
    assert len(res.filepaths) == 10
    assert state["max_gap"] <= 2 * 2 + 2, state


def test_serial_jax_and_port_stream_one_frame(tmp_path):
    """One frame through export_stream: no frame template, the serial
    file, in both packages."""
    img = _frame(shape=(17, 8, 3))
    jcfg, tcfg = _cfgs(filename_prefix="one", output_path="",
                       bit_depth="16bit")
    jpipe.export_stream([img], jcfg, default_output_dir=str(tmp_path / "j"))
    tpipe.export_stream(iter([torch.from_numpy(img)]), tcfg,
                        default_output_dir=str(tmp_path / "t"))
    jexport.export_linear(img, jcfg, default_output_dir=str(tmp_path / "s"))
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == \
        _files(tmp_path / "s")
    assert list(_files(tmp_path / "t")) == ["one.exr"]


def test_card_cast_keeps_numpy_nan_bits():
    """The float16 cast of the streamed export (run on the card for CUDA
    frames) gives numpy's bits for every float32 pattern class: finite
    values rounded to nearest even, subnormals, overflow to inf, and NaNs
    with their sign and payload's top bits (the card's own cast gives
    0x7FFF for every NaN)."""
    r = np.random.default_rng(0)
    x = r.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    x[:65536] = (np.arange(65536, dtype=np.uint32) << 13) | 0x7F800000
    x[65536:131072] |= 0x7F800000
    x[131072:131072 + 65536] = np.arange(65536, dtype=np.uint32) << 16
    f = x.view(np.float32)
    with np.errstate(over="ignore"):
        want = f.astype(np.float16).view(np.uint16)
    got = tpipe._half_like_numpy(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)
