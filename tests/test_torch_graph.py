"""The port's graph executor (``hdrvae_torch/api/graph.py``) against the
JAX package's (``hdrvae/api/graph.py``).

Workflows run in both packages with the same weights (``state_dict_from_
jax``, or one checkpoint file) and the same numpy latent, in the parity
tier: images agree within the node bounds of ``test_torch_nodes.py``
(mean <= 1e-4 and p99.9 <= 1e-3 of |diff| after the logit / EV modes),
and an export node given the same pixels writes the same bytes.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import hdrvae
from hdrvae.api import graph as jgraph
from hdrvae.api.vae import VAE as JVAE
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae_torch.api import comfy as tcomfy
from hdrvae_torch.api import graph as tgraph
from hdrvae_torch.api import nodes as tnodes
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.io import exr as texr
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet

torch.set_num_threads(2)

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "workflow_examples", "hdr_decode_export.json")


@pytest.fixture(scope="module")
def vaes():
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(4), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return (JVAE(params=params, config=jcfg, precision=JPrecision.parity()),
            VAE(decoder=dec, precision=Precision.parity()))


@pytest.fixture()
def models_dir(tmp_path, monkeypatch):
    """The example's checkpoint name over a small RRDBNet (x2)."""
    mdir = tmp_path / "models" / "upscale_models"
    mdir.mkdir(parents=True)
    net = init_rrdbnet(RRDBNetConfig().with_small(), seed=2, device="cpu")
    torch.save(net.state_dict(), str(mdir / "RealESRGAN_x4plus.pth"))
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(tmp_path / "models"))
    monkeypatch.setattr(tnodes.HDRUpscaleWithModel, "device", "cpu")
    return mdir


def _latent(seed=1, hw=6):
    return (np.random.default_rng(seed).standard_normal((1, hw, hw, 4))
            * 2.0).astype(np.float32)


def _close(got, ref):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    assert d.mean() <= 1e-4 and np.percentile(d, 99.9) <= 1e-3, \
        (d.mean(), np.percentile(d, 99.9))


def _run_both(tmp_path, monkeypatch, wf, vaes, externals, hidden=None):
    jvae, tvae = vaes
    out = {}
    for name, mod, vae in (("jax", jgraph, jvae), ("port", tgraph, tvae)):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / name))
        ext = {k: (vae,) if v == "VAE" else v for k, v in externals.items()}
        out[name] = mod.GraphExecutor(external_inputs=ext).run(wf, hidden)
    return out["jax"], out["port"]


def test_example_workflow_runs_in_both(tmp_path, monkeypatch, vaes,
                                       models_dir):
    """workflow_examples/hdr_decode_export.json: decode -> upscale ->
    32-bit EXR in both packages; the EXRs agree within the node bounds,
    and the export node writes the JAX bytes for the same pixels."""
    with open(EXAMPLE) as f:
        wf = json.load(f)
    ref, got = _run_both(
        tmp_path, monkeypatch, wf, vaes,
        {"latent_source": ({"samples": _latent()},), "vae_loader": "VAE"},
        hidden={"PROMPT": {}, "EXTRA_PNGINFO": {"workflow": wf}})
    assert isinstance(got[1][0], torch.Tensor)
    assert got[2][0].shape == (1, 24, 24, 3)
    _close(got[1][0], ref[1][0])
    _close(got[2][0], ref[2][0])
    jpath, tpath = ref[3][0], got[3][0]
    assert os.path.relpath(tpath, tmp_path / "port") == \
        os.path.relpath(jpath, tmp_path / "jax")
    assert tpath.endswith(os.path.join("HDR", "hdrvae_demo_v001.exr"))
    _close(texr.read_exr(tpath), texr.read_exr(jpath))
    with open(os.path.splitext(tpath)[0] + ".json") as f:
        assert json.load(f)["extra_pnginfo"]["workflow"] == wf
    # the export node alone, on the JAX image: the JAX file's bytes
    same = np.array(ref[2][0])
    widgets = wf["nodes"][2]["widgets_values"]
    for name, mod, x in (("jax2", hdrvae.NODE_CLASS_MAPPINGS, same),
                         ("port2", tcomfy.NODE_CLASS_MAPPINGS,
                          torch.from_numpy(same))):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / name))
        mod["LinearEXRExport"]().export_linear_exr(x, **widgets)
    with open(next((tmp_path / "jax2").rglob("*.exr")), "rb") as fa, \
            open(next((tmp_path / "port2").rglob("*.exr")), "rb") as fb:
        assert fa.read() == fb.read()


def _decode_export(tmp_path):
    return {"nodes": [
        {"id": 1, "type": "HDRVAEDecode",
         "inputs": {"samples": ["latent_in", 0], "vae": ["vae_in", 0]},
         "widgets_values": ["conservative", 1.5]},
        {"id": 2, "type": "LinearEXRExport",
         "inputs": {"hdr_image": [1, 0]},
         "widgets_values": {"filename_prefix": "graphtest",
                            "output_path": "", "format": "exr",
                            "bit_depth": "32bit", "compression": "zip",
                            "save_workflow": True}}]}


def test_decode_export_workflow(tmp_path, monkeypatch, vaes):
    """Positional widgets, a dict of widgets, hidden inputs (the sidecar)."""
    ref, got = _run_both(
        tmp_path, monkeypatch, _decode_export(tmp_path), vaes,
        {"latent_in": ({"samples": _latent(2, 4)},), "vae_in": "VAE"},
        hidden={"PROMPT": {"p": 1}, "EXTRA_PNGINFO": {"workflow": {}}})
    assert got[1][0].shape == (1, 8, 8, 3)
    assert np.abs(got[1][0].numpy() - np.asarray(ref[1][0])).max() <= 1e-4
    path = got[2][0]
    assert os.path.exists(path) and os.path.exists(
        os.path.splitext(path)[0] + ".json")
    np.testing.assert_array_equal(texr.read_exr(path), got[1][0][0].numpy())


def test_widget_converted_to_input_link_wins(vaes):
    """A widget turned into a linked input keeps its stale value in
    widgets_values; the link wins and the other widgets keep their
    positions, in both forms of widgets_values."""
    _, tvae = vaes
    z = _latent(3, 4)
    wf = {"nodes": [
        {"id": 1, "type": "HDRVAEDecode",
         "inputs": {"samples": ["latent_in", 0], "vae": ["vae_in", 0],
                    "hdr_mode": ["mode_in", 0]},
         "widgets_values": ["mathematical_recovery", 1.5]}]}
    ex = tgraph.GraphExecutor(external_inputs={
        "latent_in": ({"samples": z},), "vae_in": (tvae,),
        "mode_in": ("exposure",)})
    want = tnodes.HDRVAEDecode().simple_hdr_decode(
        {"samples": z}, tvae, hdr_mode="exposure",
        conservative_ev_multiplier=1.5)[0]
    torch.testing.assert_close(ex.run(wf)[1][0], want, rtol=0, atol=0)
    wf["nodes"][0]["widgets_values"] = {
        "hdr_mode": "mathematical_recovery",
        "conservative_ev_multiplier": 1.5}
    torch.testing.assert_close(ex.run(wf)[1][0], want, rtol=0, atol=0)


def test_example_workflow_satisfiable():
    with open(EXAMPLE) as f:
        wf = json.load(f)
    for node in wf["nodes"]:
        it = tcomfy.NODE_CLASS_MAPPINGS[node["type"]].INPUT_TYPES()
        names = set(it.get("required", {})) | set(it.get("optional", {}))
        if isinstance(node.get("widgets_values"), dict):
            assert set(node["widgets_values"]) <= names, node["type"]


@pytest.mark.parametrize("case", ["unknown", "cycle", "missing"])
def test_graph_errors_match_jax(case):
    wf = {
        "unknown": {"nodes": [{"id": 1, "type": "Bogus", "inputs": {}}]},
        "cycle": {"nodes": [
            {"id": 1, "type": "HDRVAEDecode",
             "inputs": {"samples": [2, 0], "vae": [2, 0]}},
            {"id": 2, "type": "HDRVAEDecode",
             "inputs": {"samples": [1, 0], "vae": [1, 0]}}]},
        "missing": {"nodes": [{"id": 1, "type": "HDRVAEDecode",
                               "inputs": {"samples": ["nope", 0],
                                          "vae": ["nope", 0]}}]},
    }[case]
    match = {"unknown": "unknown node type", "cycle": "cycle",
             "missing": "neither a node id nor"}[case]
    with pytest.raises(jgraph.GraphError, match=match) as ref:
        jgraph.GraphExecutor().run(wf)
    with pytest.raises(tgraph.GraphError, match=match) as got:
        tgraph.GraphExecutor().run(wf)
    assert str(got.value) == str(ref.value)


def _comfyui_graph():
    """A ComfyUI UI export: a links array, inputs as lists, loaders and a
    sampler the registry lacks (one type twice), the legacy 4-widget
    decode and 6-widget export, a builtin VAEDecode and a preview."""
    nodes = [
        {"id": 3, "type": "KSampler", "inputs": [
            {"name": "positive", "link": 5}, {"name": "negative",
                                              "link": 6}],
         "widgets_values": [1, "fixed", 20]},
        {"id": 4, "type": "CLIPTextEncode", "inputs": [],
         "widgets_values": ["a"]},
        {"id": 7, "type": "CLIPTextEncode", "inputs": [],
         "widgets_values": ["b"]},
        {"id": 8, "type": "VAELoader", "inputs": [],
         "widgets_values": ["ae.safetensors"]},
        {"id": 45, "type": "HDRVAEDecode", "inputs": [
            {"name": "samples", "link": 1}, {"name": "vae", "link": 2}],
         "widgets_values": ["conservative", 50, 1.5, False]},
        {"id": 10, "type": "VAEDecode", "inputs": [
            {"name": "samples", "link": 3}, {"name": "vae", "link": 4}]},
        {"id": 47, "type": "LinearEXRExport", "inputs": [
            {"name": "hdr_image", "link": 7}],
         "widgets_values": ["image", "/Test", 1, "exr", "32bit", "zip"]},
        {"id": 50, "type": "PreviewImage", "inputs": [
            {"name": "images", "link": 8}]},
    ]
    links = [[1, 3, 0, 45, 0, "LATENT"], [2, 8, 0, 45, 1, "VAE"],
             [3, 3, 0, 10, 0, "LATENT"], [4, 8, 0, 10, 1, "VAE"],
             [5, 4, 0, 3, 1, "CONDITIONING"],
             [6, 7, 0, 3, 2, "CONDITIONING"],
             [7, 45, 0, 47, 0, "IMAGE"], [8, 10, 0, 50, 0, "IMAGE"], None]
    return {"nodes": nodes, "links": links}


def test_comfyui_conversion_matches_jax(tmp_path, monkeypatch, vaes):
    wf = _comfyui_graph()
    assert tgraph.is_comfyui_format(wf) == jgraph.is_comfyui_format(wf)
    assert tgraph.is_comfyui_format(wf)
    assert not tgraph.is_comfyui_format(_decode_export(tmp_path))
    jreg = {**hdrvae.NODE_CLASS_MAPPINGS, **hdrvae.BUILTIN_NODE_MAPPINGS}
    treg = {**tcomfy.NODE_CLASS_MAPPINGS, **tcomfy.BUILTIN_NODE_MAPPINGS}
    got = tgraph.convert_comfyui_workflow(wf, treg)
    assert got == jgraph.convert_comfyui_workflow(wf, jreg)
    assert got["external_keys"] == ["KSampler", "VAELoader"]
    ref, out = _run_both(
        tmp_path, monkeypatch, wf, vaes,
        {"KSampler": ({"samples": _latent(5, 4)},), "VAELoader": "VAE"})
    _close(out[45][0], ref[45][0])
    np.testing.assert_allclose(out[10][0].numpy(), np.asarray(ref[10][0]),
                               atol=1e-4, rtol=0)
    assert out[50] == ref[50] == ()
    path = out[47][0]
    assert path.endswith(os.path.join("Test", "image_v001.exr")), path
    assert os.path.relpath(path, tmp_path / "port") == \
        os.path.relpath(ref[47][0], tmp_path / "jax")


def test_literal_two_int_list_is_not_a_link():
    class EchoNode:
        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"size": ("LIST",)}}
        RETURN_TYPES = ("LIST",)
        FUNCTION = "go"

        def go(self, size):
            return (size,)

    res = tgraph.GraphExecutor(registry={"Echo": EchoNode}).run(
        {"nodes": [{"id": "n1", "type": "Echo",
                    "inputs": {"size": [512, 512]}}]})
    assert res["n1"][0] == [512, 512]


def test_custom_socket_type_owns_no_widget_slot():
    class SamplerNode:
        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {"noise": ("NOISE",),
                                 "steps": ("INT", {"default": 10}),
                                 "cfg": ("FLOAT", {"default": 1.0})}}
        RETURN_TYPES = ("INT",)
        FUNCTION = "go"

        def go(self, noise, steps, cfg):
            return (steps,)

    class NoiseNode:
        @classmethod
        def INPUT_TYPES(cls):
            return {"required": {}}
        RETURN_TYPES = ("NOISE",)
        FUNCTION = "go"

        def go(self):
            return ("nz",)

    assert tgraph._widget_names_in_order(SamplerNode) == \
        jgraph._widget_names_in_order(SamplerNode) == ["steps", "cfg"]
    res = tgraph.GraphExecutor(registry={"Sampler": SamplerNode,
                                         "Noise": NoiseNode}).run(
        {"nodes": [{"id": "n0", "type": "Noise"},
                   {"id": "n1", "type": "Sampler",
                    "inputs": {"noise": ["n0", 0]},
                    "widgets_values": [20, 7.5]}]})
    assert res["n1"][0] == 20


def test_run_workflow_file(tmp_path, monkeypatch, vaes):
    _, tvae = vaes
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    path = tmp_path / "wf.json"
    path.write_text(json.dumps(_decode_export(tmp_path)))
    res = tgraph.run_workflow_file(str(path), external_inputs={
        "latent_in": ({"samples": _latent(6, 4)},), "vae_in": (tvae,)})
    assert os.path.exists(res[2][0])
