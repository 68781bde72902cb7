"""The port's export path (``io/export.py``, ``io/hdr.py``,
``core/config.py::ExportConfig``) against the JAX package's.

Every case runs the same numpy image (made from a seed) through both
packages' functions into two directories and compares what they wrote:
file names, file bytes, sidecar JSON and ``verify_save``'s record must be
identical, in every compression.  PIZ without the native EXR codec is
an ERROR in the port (the JAX package writes zip in its place).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from hdrvae.core import config as jconfig
from hdrvae.io import export as jexport
from hdrvae.io import hdr as jhdr
from hdrvae_torch.core import config as tconfig
from hdrvae_torch.io import exr as texr
from hdrvae_torch.io import export as texport
from hdrvae_torch.io import hdr as thdr


def _image(seed=3, shape=(2, 19, 23, 3)):
    """HDR values above 1, negatives, and flat runs (RLE / zip paths)."""
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    img[..., :4, :, :] = 0.5
    return img


def _pair_cfg(**kw):
    return jconfig.ExportConfig(**kw), tconfig.ExportConfig(**kw)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _export_both(tmp_path, image, prompt=None, extra=None, **kw):
    jcfg, tcfg = _pair_cfg(**kw)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    ref = jexport.export_linear(image, jcfg, default_output_dir=str(jdir),
                                prompt=prompt, extra_pnginfo=extra)
    got = texport.export_linear(image, tcfg, default_output_dir=str(tdir),
                                prompt=prompt, extra_pnginfo=extra)
    return ref, got, jdir, tdir


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def test_export_config_matches_jax():
    assert tconfig.EXR_COMPRESSIONS == jconfig.EXR_COMPRESSIONS
    assert tconfig.EXPORT_FORMATS == jconfig.EXPORT_FORMATS
    assert tconfig.BIT_DEPTHS == jconfig.BIT_DEPTHS
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ExportConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ExportConfig)}
    assert tf == jf


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------

HDR_SHAPES = {"rle": (13, 40), "narrow": (5, 6), "wide_runs": (3, 300)}


@pytest.mark.parametrize("case", sorted(HDR_SHAPES))
def test_hdr_bytes_match_jax(tmp_path, case):
    h, w = HDR_SHAPES[case]
    rng = np.random.default_rng(len(case))
    img = (np.abs(rng.standard_normal((h, w, 3))) * 4.0).astype(np.float32)
    img[0] = 7.0                           # long runs
    img[1, ::3] = -1.0                     # clamps to 0
    img[-1, :2] = [np.inf, np.nan, 3e38]   # saturates / zero
    a, b = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    thdr.write_hdr(str(a), img)
    jhdr.write_hdr(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    # each side reads the other's file to the same pixels
    np.testing.assert_array_equal(thdr.read_hdr(str(b)), jhdr.read_hdr(str(a)))
    np.testing.assert_array_equal(thdr.read_hdr(str(a)), jhdr.read_hdr(str(b)))


def test_rgbe_and_rle_match_jax():
    rng = np.random.default_rng(5)
    rgb = (rng.standard_normal((7, 33, 3)) * 50).astype(np.float32)
    np.testing.assert_array_equal(thdr.rgb_to_rgbe(rgb), jhdr.rgb_to_rgbe(rgb))
    rgbe = thdr.rgb_to_rgbe(rgb)
    np.testing.assert_array_equal(thdr.rgbe_to_rgb(rgbe),
                                  jhdr.rgbe_to_rgb(rgbe))
    comp = np.repeat(rng.integers(0, 4, 40), rng.integers(1, 9, 40)).astype(
        np.uint8)
    assert thdr._rle_component(comp) == jhdr._rle_component(comp)


def test_hdr_write_rejects_non_rgb(tmp_path):
    with pytest.raises(ValueError, match="needs"):
        thdr.write_hdr(str(tmp_path / "a.hdr"), np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------------------
# Output paths and names
# ---------------------------------------------------------------------------

PATH_CASES = {
    "default": dict(),
    "versioning": dict(versioning=True),
    "sequence": dict(frame_sequence=True, start_frame=7, frame_pad=3),
    "prefix_subdirs": dict(filename_prefix="shots/sh010/beauty"),
    "percent_prefix": dict(filename_prefix="a%b"),
    "glob_prefix": dict(filename_prefix="shot[1]", versioning=True),
    "custom_dir": dict(output_path="custom"),
    "empty_path": dict(output_path=""),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
@pytest.mark.parametrize("batch", [1, 2])
def test_plan_output_matches_jax(tmp_path, case, batch):
    kw = dict(PATH_CASES[case])
    if kw.get("output_path") == "custom":
        kw["output_path"] = str(tmp_path / "custom")
    jcfg, tcfg = _pair_cfg(**kw)
    root = str(tmp_path / "out")
    ref = jexport.plan_output(jcfg, root, batch)
    got = texport.plan_output(tcfg, root, batch)
    assert got == ref


def test_output_dir_rule_and_versions_match_jax(tmp_path):
    for path in ("", "  ", "/sub", "/a/b", "rel/dir", str(tmp_path)):
        assert texport.resolve_output_dir(path, "base") == \
            jexport.resolve_output_dir(path, "base")
    for name in ("pre_v003.exr", "pre_v012_frame_0001.exr", "pre.exr",
                 "other_v099.exr", "pre_vx.exr"):
        (tmp_path / name).write_bytes(b"")
    assert texport.get_highest_numbered_file(str(tmp_path), "pre") == \
        jexport.get_highest_numbered_file(str(tmp_path), "pre") == 12


def test_versioned_saves_match_jax(tmp_path):
    """Two versioned exports in a row: _v001 then _v002 on both sides."""
    img = _image(shape=(1, 9, 10, 3))
    names = []
    for _ in range(2):
        ref, got, jdir, tdir = _export_both(tmp_path, img, versioning=True,
                                            output_path="")
        names.append((_rel(ref.filepaths, jdir), _rel(got.filepaths, tdir)))
    assert [n[1] for n in names] == [n[0] for n in names] == \
        [["comfyUI_v001.exr"], ["comfyUI_v002.exr"]]
    assert _files(tdir) == _files(jdir)


# ---------------------------------------------------------------------------
# export_linear: files, verification, sidecar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "zip"])
@pytest.mark.parametrize("bit_depth", ["16bit", "32bit"])
@pytest.mark.parametrize("batch", [1, 2])
def test_export_exr_matches_jax(tmp_path, compression, bit_depth, batch):
    """The same file names and byte-identical EXR files, the same
    verify_save record of the last file."""
    img = _image(shape=(batch, 19, 23, 3))
    ref, got, jdir, tdir = _export_both(
        tmp_path, img if batch > 1 else img[0], compression=compression,
        bit_depth=bit_depth)
    assert ref.error is None and got.error is None, (ref.error, got.error)
    assert _rel(got.filepaths, tdir) == _rel(ref.filepaths, jdir)
    assert len(got.filepaths) == batch
    assert _files(tdir) == _files(jdir)
    assert got.verified and ref.verified
    assert got.verify_stats == ref.verify_stats
    assert got.verify_stats["hdr_preserved"]
    assert got.verify_stats["negatives_preserved"]
    back = texr.read_exr(got.last)
    want = img[-1].astype(np.float16).astype(np.float32) \
        if bit_depth == "16bit" else img[-1]
    np.testing.assert_array_equal(back, want)
    assert texport.export_node_return(got) == (got.last,)


def test_export_hdr_matches_jax(tmp_path):
    img = np.abs(_image(shape=(1, 11, 17, 3)))
    ref, got, jdir, tdir = _export_both(tmp_path, img, format="hdr")
    assert _rel(got.filepaths, tdir) == _rel(ref.filepaths, jdir)
    assert got.last.endswith(".hdr")
    assert _files(tdir) == _files(jdir)
    assert got.verify_stats == ref.verify_stats


def test_sidecar_matches_jax(tmp_path):
    prompt = {"1": {"class_type": "HDRVAEDecode", "inputs": {"ev": 1.5}}}
    extra = {"workflow": {"nodes": [1, 2]}}
    ref, got, jdir, tdir = _export_both(
        tmp_path, _image(shape=(2, 8, 9, 3)), prompt=prompt, extra=extra,
        save_workflow=True, frame_sequence=True)
    files = _files(tdir)
    assert files == _files(jdir)
    sidecars = [n for n in files if n.endswith(".json")]
    assert len(sidecars) == 1 and "frame_1001" in sidecars[0]
    assert json.loads(files[sidecars[0]]) == {"prompt": prompt,
                                              "extra_pnginfo": extra}
    # no prompt and no extra info: no sidecar on either side
    ref, got, jdir, tdir = _export_both(tmp_path / "none", _image(),
                                        save_workflow=True)
    assert not any(n.endswith(".json") for n in _files(tdir))
    assert _files(tdir) == _files(jdir)


def test_export_tensor_input_matches_numpy(tmp_path):
    """A tensor (here on the CPU; on a card the same one copy) exports to
    the same bytes as its numpy array, float16 and bf16 included."""
    img = _image(shape=(1, 10, 12, 3))
    cfg = tconfig.ExportConfig(bit_depth="32bit", output_path="")
    a = texport.export_linear(img, cfg, default_output_dir=str(tmp_path / "n"))
    b = texport.export_linear(torch.from_numpy(img), cfg,
                              default_output_dir=str(tmp_path / "t"))
    assert _files(tmp_path / "n") == _files(tmp_path / "t")
    half = torch.from_numpy(img).half()
    c = texport.export_linear(half, cfg,
                              default_output_dir=str(tmp_path / "h"))
    np.testing.assert_array_equal(texr.read_exr(c.last),
                                  half.float().numpy()[0])
    d = texport.export_linear(torch.from_numpy(img).bfloat16(), cfg,
                              default_output_dir=str(tmp_path / "b"))
    assert d.error is None and a.error is None and b.error is None


@pytest.mark.parametrize("compression", ["rle", "piz", "pxr24"])
def test_unwritten_compressions_are_errors(tmp_path, monkeypatch,
                                           compression):
    """The compressions the port once refused now write the JAX package's
    bytes; PIZ without the native codec is the one ERROR left, and then
    nothing is written in another compression (the JAX package writes
    zip there)."""
    for bit_depth in ("16bit", "32bit"):
        ref, got, jdir, tdir = _export_both(
            tmp_path / bit_depth, _image(), compression=compression,
            bit_depth=bit_depth, output_path="")
        assert ref.error is None and got.error is None, got.error
        assert _rel(got.filepaths, tdir) == _rel(ref.filepaths, jdir)
        assert _files(tdir) == _files(jdir)
    if compression != "piz":
        return
    monkeypatch.setattr(texr, "load_native", lambda: None)
    cfg = tconfig.ExportConfig(compression=compression)
    res = texport.export_linear(_image(), cfg,
                                default_output_dir=str(tmp_path / "o"))
    assert res.error is not None and res.error.startswith("ERROR: ")
    assert "'piz'" in res.error and "native" in res.error
    assert res.filepaths == [] and not (tmp_path / "o").exists()
    assert texport.export_node_return(res) == (res.error,)


@pytest.mark.parametrize("field,value", [("format", "png"),
                                         ("bit_depth", "8bit"),
                                         ("compression", "lzma")])
def test_error_contract_matches_jax(tmp_path, field, value):
    img = _image()
    ref, got, _, _ = _export_both(tmp_path, img, **{field: value})
    assert got.error == ref.error
    assert got.error.startswith("ERROR: unsupported")
    bad = texport.export_linear(np.zeros((2, 3)), tconfig.ExportConfig(),
                                default_output_dir=str(tmp_path))
    assert bad.error.startswith("ERROR: expected")
    assert texport.export_node_return(texport.ExportResult()) == \
        ("ERROR: no files written",)


def test_progress_bar_counts_frames(tmp_path):
    class Bar:
        n = 0

        def update(self, k):
            self.n += k
    bar = Bar()
    res = texport.export_linear(_image(shape=(3, 6, 6, 3)),
                                tconfig.ExportConfig(),
                                default_output_dir=str(tmp_path), pbar=bar)
    assert res.error is None and bar.n == 3
