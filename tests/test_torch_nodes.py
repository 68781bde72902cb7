"""The port's node pack (``hdrvae_torch/api/nodes.py``, ``api/comfy.py``,
``api/folders.py``) against the JAX package's (``hdrvae/api``).

The contracts (INPUT_TYPES, RETURN_TYPES, FUNCTION, CATEGORY, OUTPUT_NODE,
``adapt_widgets``) must be identical.  The nodes run the same numpy inputs
with the same weights (``state_dict_from_jax``, or one checkpoint file) in
the parity tier: the decode at the bounds of ``test_torch_pipeline.py``
(conservative max-abs <= 1e-4, the logit / EV modes mean <= 1e-4 and
p99.9 <= 1e-3 of |diff|), VAEDecode <= 1e-4, the upscale at
``test_torch_upscale.py``'s (mean <= 1e-5, p99.9 <= 1e-4 after the
reversal), the export byte for byte.
"""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

import hdrvae
from hdrvae.api import comfy as jcomfy
from hdrvae.api import folders as jfolders
from hdrvae.api import nodes as jnodes
from hdrvae.api.vae import VAE as JVAE
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.models.decoder import init_decoder as jinit
import hdrvae_torch
from hdrvae_torch.api import comfy as tcomfy
from hdrvae_torch.api import folders as tfolders
from hdrvae_torch.api import nodes as tnodes
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet

torch.set_num_threads(2)

NODES = ["HDRVAEDecode", "LinearEXRExport", "HDRUpscaleWithModel",
         "VAEDecode", "PreviewImage"]
CONTRACT = ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY",
            "OUTPUT_NODE")


@pytest.fixture(scope="module")
def vaes():
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return (JVAE(params=params, config=jcfg, precision=JPrecision.parity()),
            VAE(decoder=dec, precision=Precision.parity()))


def _latent(seed):
    return (np.random.default_rng(seed).standard_normal((1, 8, 8, 4))
            * 2.0).astype(np.float32)


def _jclass(name):
    return getattr(jnodes, name)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


# ---------------------------------------------------------------------------
# Contracts and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NODES)
def test_contract_matches_jax(tmp_path, monkeypatch, name):
    (tmp_path / "upscale_models" / "4x").mkdir(parents=True)
    (tmp_path / "upscale_models" / "4x" / "a.pth").write_bytes(b"x")
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path))
    t, j = getattr(tnodes, name), _jclass(name)
    assert t.INPUT_TYPES() == j.INPUT_TYPES()
    for attr in CONTRACT:
        assert getattr(t, attr, None) == getattr(j, attr, None), attr
    assert hasattr(t, "adapt_widgets") == hasattr(j, "adapt_widgets")


@pytest.mark.parametrize("name,widgets", [
    ("HDRVAEDecode", ["conservative", 50, 1, False]),
    ("HDRVAEDecode", ["conservative", 2.5]),
    ("HDRVAEDecode", ["exposure"]),
    ("LinearEXRExport", ["image", "/Test", 1, "exr", "32bit", "zip"]),
    ("LinearEXRExport", ["p", True, False, 1001, 4, "/HDR", "exr",
                         "16bit", "piz", True]),
    ("LinearEXRExport", ["p", False]),
])
def test_adapt_widgets_matches_jax(name, widgets):
    assert getattr(tnodes, name).adapt_widgets(list(widgets)) == \
        _jclass(name).adapt_widgets(list(widgets))


def test_registry_matches_jax():
    for attr in ("NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS",
                 "BUILTIN_NODE_MAPPINGS"):
        assert getattr(tcomfy, attr, None) is getattr(hdrvae_torch, attr)
    assert list(tcomfy.NODE_CLASS_MAPPINGS) == list(
        hdrvae.NODE_CLASS_MAPPINGS)
    assert list(tcomfy.BUILTIN_NODE_MAPPINGS) == list(
        hdrvae.BUILTIN_NODE_MAPPINGS)
    assert tcomfy.NODE_DISPLAY_NAME_MAPPINGS == \
        jcomfy.NODE_DISPLAY_NAME_MAPPINGS == hdrvae.NODE_DISPLAY_NAME_MAPPINGS
    for name, cls in tcomfy.NODE_CLASS_MAPPINGS.items():
        assert cls is getattr(tnodes, name)
    with pytest.raises(AttributeError):
        hdrvae_torch.NOT_A_REGISTRY


def test_node_python_defaults_match_input_types():
    """The FUNCTION's Python defaults agree with INPUT_TYPES' declared
    ones, in both packages alike."""
    for name, cls in {**tcomfy.NODE_CLASS_MAPPINGS,
                      **tcomfy.BUILTIN_NODE_MAPPINGS}.items():
        fn = getattr(cls, cls.FUNCTION)
        sig = inspect.signature(fn)
        jsig = inspect.signature(getattr(_jclass(name), cls.FUNCTION))
        assert list(sig.parameters) == list(jsig.parameters), name
        it = cls.INPUT_TYPES()
        declared = {**it.get("required", {}), **it.get("optional", {})}
        for pname, spec in declared.items():
            if not (isinstance(spec, tuple) and len(spec) > 1
                    and isinstance(spec[1], dict)
                    and "default" in spec[1]):
                continue
            param = sig.parameters.get(pname)
            if param is None or param.default is inspect.Parameter.empty:
                continue
            assert param.default == spec[1]["default"], (name, pname)
            assert jsig.parameters[pname].default == param.default


# ---------------------------------------------------------------------------
# The nodes against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["conservative", "exposure",
                                  "adaptive_recovery",
                                  "mathematical_recovery"])
def test_hdr_decode_node_matches_jax(vaes, mode):
    jvae, tvae = vaes
    z = _latent(2)
    (ref,) = jnodes.HDRVAEDecode().simple_hdr_decode(
        {"samples": z}, jvae, hdr_mode=mode, conservative_ev_multiplier=1.5)
    (got,) = tnodes.HDRVAEDecode().simple_hdr_decode(
        {"samples": z}, tvae, hdr_mode=mode, conservative_ev_multiplier=1.5)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device.type == "cpu" and got.shape == (1, 16, 16, 3)
    d = np.abs(got.numpy() - np.asarray(ref))
    if mode == "conservative":
        assert d.max() <= 1e-4
    else:
        assert d.mean() <= 1e-4 and np.percentile(d, 99.9) <= 1e-3


def test_hdr_decode_node_latent_layouts(vaes):
    """An NCHW torch latent, an NHWC one and a numpy one: one image."""
    _, tvae = vaes
    z = _latent(0)
    node = tnodes.HDRVAEDecode()
    (a,) = node.simple_hdr_decode({"samples": z}, tvae)
    (b,) = node.simple_hdr_decode(
        {"samples": torch.from_numpy(z).permute(0, 3, 1, 2)}, tvae)
    (c,) = node.simple_hdr_decode({"samples": torch.from_numpy(z)}, tvae)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_vae_decode_node_matches_jax(vaes):
    jvae, tvae = vaes
    z = _latent(3)
    (ref,) = jnodes.VAEDecode().decode({"samples": z}, jvae)
    for latent in (z, torch.from_numpy(z).permute(0, 3, 1, 2)):
        (got,) = tnodes.VAEDecode().decode({"samples": latent}, tvae)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)


def test_preview_node(caplog):
    img = torch.full((1, 4, 4, 3), 2.0)
    with caplog.at_level("INFO", logger="hdrvae_torch.api.nodes"):
        assert tnodes.PreviewImage().preview(img) == ()
    assert "hdr_pixels=48" in caplog.text


@pytest.mark.parametrize("widgets", [
    {"filename_prefix": "api", "output_path": "", "bit_depth": "32bit",
     "compression": "zip"},
    {"filename_prefix": "sub/api", "output_path": "/HDR",
     "bit_depth": "16bit", "compression": "piz", "versioning": True},
    {"filename_prefix": "seq", "frame_sequence": True, "start_frame": 7,
     "frame_pad": 3, "compression": "pxr24", "save_workflow": True},
    {"filename_prefix": "rad", "format": "hdr"},
])
def test_export_node_matches_jax(tmp_path, monkeypatch, widgets):
    img = (np.random.default_rng(4).standard_normal((2, 5, 7, 3))
           * 4).astype(np.float32)
    if not widgets.get("frame_sequence"):
        img = img[:1]
    out = {}
    for name, mod, x in (("jax", jnodes, img),
                         ("port", tnodes, torch.from_numpy(img))):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / name))
        (path,) = mod.LinearEXRExport().export_linear_exr(
            x, prompt={"p": 1}, extra_pnginfo={"w": 2}, **widgets)
        out[name] = os.path.relpath(path, tmp_path / name)
    assert out["port"] == out["jax"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_export_node_error_tuple(tmp_path, monkeypatch):
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    (ret,) = tnodes.LinearEXRExport().export_linear_exr(
        np.zeros((3,)), filename_prefix="bad", output_path="")
    (jret,) = jnodes.LinearEXRExport().export_linear_exr(
        np.zeros((3,)), filename_prefix="bad", output_path="")
    assert ret.startswith("ERROR:") and ret == jret


def _checkpoint(root, name="tiny_x2.pth"):
    mdir = root / "upscale_models"
    mdir.mkdir(parents=True, exist_ok=True)
    net = init_rrdbnet(RRDBNetConfig().with_small(), seed=5, device="cpu")
    torch.save(net.state_dict(), str(mdir / name))
    return name


@pytest.mark.parametrize("options", [
    {"small_blur": False, "local_fix": False, "upscale_method": "bislerp"},
    {"small_blur": True, "local_fix": True, "upscale_method": "bicubic"}])
def test_upscale_node_matches_jax(tmp_path, monkeypatch, options):
    name = _checkpoint(tmp_path)
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path))
    monkeypatch.setattr(tnodes.HDRUpscaleWithModel, "device", "cpu")
    assert name in tnodes.HDRUpscaleWithModel.INPUT_TYPES()[
        "required"]["model_name"][0]
    img = (np.random.default_rng(6).standard_normal((1, 10, 12, 3))
           * 1.5).astype(np.float32)
    (ref,) = jnodes.HDRUpscaleWithModel().upscale(img, name, **options)
    node = tnodes.HDRUpscaleWithModel()
    (got,) = node.upscale(torch.from_numpy(img), name, **options)
    assert got.shape == (1, 20, 24, 3) and got.device.type == "cpu"
    d = np.abs(got.numpy() - np.asarray(ref))
    assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-4, \
        (d.mean(), np.percentile(d, 99.9))
    # one model is kept across calls, on the node's device
    (again,) = node.upscale(img[0], name, **options)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert len(tnodes.HDRUpscaleWithModel._MODEL_CACHE) == 1
    (key,) = tnodes.HDRUpscaleWithModel._MODEL_CACHE
    assert key[1] == "cpu"


def test_comfy_registry_hands_torch_across(vaes):
    _, tvae = vaes
    node = tcomfy.NODE_CLASS_MAPPINGS["HDRVAEDecode"]()
    (image,) = node.simple_hdr_decode({"samples": _latent(1)}, tvae)
    assert isinstance(image, torch.Tensor) and image.dtype == torch.float32


# ---------------------------------------------------------------------------
# Folders (the JAX suite's rules)
# ---------------------------------------------------------------------------


def test_missing_model_error(monkeypatch):
    monkeypatch.delenv("HDRVAE_MODELS_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="HDRVAE_MODELS_DIR"):
        tfolders.get_full_path("upscale_models", "nope.pth")


def test_filename_list_rules_match_jax(tmp_path, monkeypatch):
    """Recursive relative paths under <root>/<kind>; a bare root gives
    its loose files only; registered roots recurse."""
    (tmp_path / "upscale_models" / "4x").mkdir(parents=True)
    (tmp_path / "upscale_models" / "4x" / "x.pth").write_bytes(b"x")
    (tmp_path / "upscale_models" / "top.safetensors").write_bytes(b"y")
    (tmp_path / "vae").mkdir()
    (tmp_path / "vae" / "ae.safetensors").write_bytes(b"v")
    (tmp_path / "loose.pth").write_bytes(b"l")
    (tmp_path / "notes.txt").write_bytes(b"n")
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path))
    names = tfolders.get_filename_list("upscale_models")
    assert names == ["4x/x.pth", "loose.pth", "top.safetensors"]
    assert names == jfolders.get_filename_list("upscale_models")
    assert tfolders.get_full_path("upscale_models", "4x/x.pth") == \
        jfolders.get_full_path("upscale_models", "4x/x.pth")
    extra = tmp_path / "extra"
    (extra / "deep").mkdir(parents=True)
    (extra / "deep" / "e.ckpt").write_bytes(b"e")
    monkeypatch.setattr(tfolders, "_registered_roots", {})
    tfolders.register_model_folder("upscale_models", str(extra))
    assert "deep/e.ckpt" in tfolders.get_filename_list("upscale_models")


def test_output_directory_rules(tmp_path, monkeypatch):
    root = tmp_path / "ComfyUI"
    (root / "custom_nodes" / "pack").mkdir(parents=True)
    (root / "models").mkdir()
    start = str(root / "custom_nodes" / "pack")
    assert tfolders.discover_comfyui_output(start) == str(root / "output")
    assert tfolders.discover_comfyui_output(start) == \
        jfolders.discover_comfyui_output(start)
    assert tfolders.discover_comfyui_output(str(tmp_path)) in (
        None, str(root / "output"))
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", "/somewhere/else")
    assert tfolders.get_output_directory() == "/somewhere/else"
    monkeypatch.delenv("HDRVAE_OUTPUT_DIR")
    # the packages sit side by side: the same walk up, the same answer
    assert tfolders.get_output_directory() == \
        jfolders.get_output_directory()
