"""The port's CLI (``hdrvae_torch/cli/main.py``) against the JAX package's
(``hdrvae/cli/main.py``), driven in-process on the CPU (``--device cpu``)
at tiny sizes.

The parsers of decode, upscale, export, convert, inspect, run, serve and
bench must take the JAX flags with the same defaults, choices and types, except
what the port adds (``--device``, ``serve --mesh``) and ``serve
--bucket``'s default (None: the engine's own, 64 alone and no bucket with
``--sharded``, where the JAX CLI's 64 bypasses its engine's mesh
default).
``export`` writes
the JAX CLI's bytes; ``upscale`` its image within ``test_torch_upscale.py``'s
bounds; ``decode`` and ``run`` print the same JSON lines.
"""

import json
import os

import numpy as np
import pytest
import torch

from hdrvae.cli import main as jcli
from hdrvae.io import exr_py
from hdrvae_torch.cli import main as tcli
from hdrvae_torch.io import exr as texr
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port adds beyond --device, and the defaults it changes
ADDED = {"serve": {"mesh"}}
DEFAULTS = {"serve": {"bucket": None}}


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if a.__class__.__name__ == "_SubParsersAction"]
    return action.choices


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["decode", "upscale", "export", "run",
                                     "serve", "convert", "inspect", "bench"])
def test_parser_matches_jax(command):
    ref = _actions(_subparsers(jcli.build_parser())[command])
    got = _actions(_subparsers(tcli.build_parser())[command])
    for dest in ADDED.get(command, ()):
        assert got.pop(dest)[1] is None
    for dest, default in DEFAULTS.get(command, {}).items():
        assert got[dest][1] == default
        got[dest] = got[dest][:1] + ref[dest][1:2] + got[dest][2:]
    device = got.pop("device", None)
    if command not in ("export", "convert", "inspect"):
        assert device == (("--device",), "cuda", None, None, False, None,
                          "_StoreAction")
    assert got == ref


def _run(capsys, argv, cli=tcli):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out if line.startswith("{")]


def test_decode_cpu(tmp_path, monkeypatch, capsys):
    """Random Flux.1 weights, a 4 x 4 latent: the summary line, then the
    streamed EXR's line; the file reads back as the summary says."""
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    rc, outs = _run(capsys, ["decode", "--device", "cpu", "--size", "32",
                             "--prefix", "one", "--compression", "piz",
                             "--bit-depth", "16bit"])
    assert rc == 0 and len(outs) == 2
    assert {"input", "pre", "post", "output", "used_fallback",
            "normalization"} <= set(outs[0])
    files = list(tmp_path.glob("one*.exr"))
    assert [str(p) for p in files] == [outs[1]["filepath"]]
    header, _ = texr.read_exr_header(files[0].read_bytes())
    assert header["compression"] == "piz"
    img = texr.read_exr(str(files[0]))
    assert img.shape == (32, 32, 3)
    assert outs[1]["max"] == float(img.max())
    assert outs[0]["output"]["hdr_pixels"] == int((img > 1.0).sum())


def test_decode_pipelined_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    rc, outs = _run(capsys, ["decode", "--device", "cpu", "--size", "32",
                             "--batch", "2", "--pipelined", "--prefix",
                             "seq", "--bit-depth", "16bit"])
    assert rc == 0 and outs[-1]["frames"] == 2
    names = sorted(p.name for p in tmp_path.glob("seq_frame_*.exr"))
    assert names == ["seq_frame_1001.exr", "seq_frame_1002.exr"]
    assert outs[-1]["last"].endswith(names[-1])
    # each frame is the serial export of its own decode
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.core.config import ExportConfig, Precision
    from hdrvae_torch.decode.pipeline import hdr_decode
    from hdrvae_torch.io.export import export_linear
    vae = VAE.random_init(seed=0, device="cpu")
    z = np.random.default_rng(0).standard_normal(
        (2, 4, 4, 16)).astype(np.float32)
    for i, name in enumerate(names):
        image = hdr_decode(vae.decoder, torch.from_numpy(z[i:i + 1]),
                           precision=Precision.fast()).image
        res = export_linear(image, ExportConfig(
            filename_prefix=f"ser{i}", output_path="", bit_depth="16bit"),
            default_output_dir=str(tmp_path))
        assert (tmp_path / name).read_bytes() == \
            open(res.last, "rb").read()


def test_export_matches_jax(tmp_path, monkeypatch, capsys):
    src = tmp_path / "in.exr"
    img = (np.random.default_rng(1).standard_normal((9, 11, 3))
           * 5).astype(np.float32)
    exr_py.write_exr(str(src), img, pixel_type="float")
    args = ["export", "--image", str(src), "--prefix", "cli",
            "--compression", "rle", "--versioning"]
    lines = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / name))
        rc, outs = _run(capsys, args, cli)
        assert rc == 0
        lines[name] = outs[-1]
    j, t = lines["jax"], lines["port"]
    assert os.path.relpath(t.pop("filepath"), tmp_path / "port") == \
        os.path.relpath(j.pop("filepath"), tmp_path / "jax")
    assert t == j
    got = next((tmp_path / "port").glob("cli*.exr")).read_bytes()
    assert got == next((tmp_path / "jax").glob("cli*.exr")).read_bytes()
    np.testing.assert_array_equal(texr.read_exr(str(next(
        (tmp_path / "port").glob("cli*.exr")))), img)


def test_upscale_matches_jax(tmp_path, monkeypatch, capsys):
    model = str(tmp_path / "up.pth")
    torch.save(init_rrdbnet(RRDBNetConfig().with_small(), seed=3,
                            device="cpu").state_dict(), model)
    src = str(tmp_path / "in.npy")
    np.save(src, np.abs(np.random.default_rng(2).standard_normal(
        (10, 12, 3))).astype(np.float32))
    args = ["upscale", "--image", src, "--model", model, "--tile", "8",
            "--overlap", "2", "--prefix", "up"]
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / name))
        rc, outs = _run(capsys, args + extra, cli)
        assert rc == 0
        out[name] = outs
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0]["out_shape"] == [1, 20, 24, 3]
    got = texr.read_exr(out["port"][1]["filepath"])
    ref = texr.read_exr(out["jax"][1]["filepath"])
    d = np.abs(got - ref)
    assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-4


def _checkpoint_dir(tmp_path):
    mdir = tmp_path / "models" / "upscale_models"
    mdir.mkdir(parents=True)
    torch.save(init_rrdbnet(RRDBNetConfig().with_small(), seed=2,
                            device="cpu").state_dict(),
               str(mdir / "RealESRGAN_x4plus.pth"))
    return tmp_path / "models"


def test_run_example_workflow(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HDRVAE_MODELS_DIR", str(_checkpoint_dir(tmp_path)))
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / "out"))
    rc, outs = _run(capsys, ["run", os.path.join(
        REPO, "workflow_examples", "hdr_decode_export.json"), "--size", "32",
        "--device", "cpu"])
    assert rc == 0
    assert [o["node"] for o in outs] == [1, 2, 3]
    assert outs[0]["outputs"] == ["(1, 32, 32, 3)"]
    assert outs[1]["outputs"] == ["(1, 64, 64, 3)"]
    path = outs[2]["outputs"][0]
    assert path.endswith(os.path.join("HDR", "hdrvae_demo_v001.exr"))
    assert texr.read_exr(path).shape == (64, 64, 3)


def test_run_comfyui_workflow(tmp_path, monkeypatch, capsys):
    """A ComfyUI export: the sampler and the VAE loader supplied by the
    type of the node they replace."""
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    wf = {"nodes": [
        {"id": 3, "type": "KSampler", "inputs": []},
        {"id": 8, "type": "VAELoader", "inputs": []},
        {"id": 45, "type": "HDRVAEDecode", "inputs": [
            {"name": "samples", "link": 1}, {"name": "vae", "link": 2}],
         "widgets_values": ["conservative", 50, 1, False]},
        {"id": 47, "type": "LinearEXRExport", "inputs": [
            {"name": "hdr_image", "link": 3}],
         "widgets_values": ["image", "/Test", 1, "exr", "32bit", "zip"]}],
        "links": [[1, 3, 0, 45, 0, "LATENT"], [2, 8, 0, 45, 1, "VAE"],
                  [3, 45, 0, 47, 0, "IMAGE"]]}
    path = tmp_path / "wf.json"
    path.write_text(json.dumps(wf))
    rc, outs = _run(capsys, ["run", str(path), "--size", "32", "--device",
                             "cpu"])
    assert rc == 0
    assert outs[-1]["outputs"][0].endswith(
        os.path.join("Test", "image_v001.exr"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"graph": []}))
    with pytest.raises(SystemExit, match="no 'nodes'"):
        tcli.main(["run", str(bad), "--device", "cpu"])


def test_parity_flag_and_latent_files(tmp_path):
    args = tcli.build_parser().parse_args(
        ["decode", "--parity", "--precision", "mixed"])
    with pytest.raises(SystemExit, match="contradicts"):
        tcli._parse_precision(args)
    assert tcli._parse_precision(tcli.build_parser().parse_args(
        ["decode", "--parity"])).mode == "parity"
    with pytest.raises(ValueError, match="unsupported latent format"):
        tcli._load_latent(str(tmp_path / "x.txt"))
    from safetensors.numpy import save_file
    z = np.ones((1, 2, 2, 16), np.float32)
    save_file({"z": z}, str(tmp_path / "z.safetensors"))
    np.testing.assert_array_equal(
        tcli._load_latent(str(tmp_path / "z.safetensors")), z)
    save_file({"a": z, "b": z}, str(tmp_path / "two.safetensors"))
    with pytest.raises(ValueError, match="one tensor"):
        tcli._load_latent(str(tmp_path / "two.safetensors"))


def test_bench_starts_the_harness(monkeypatch):
    """``cli bench`` starts ``bench_torch.py`` (repository root) with
    ``--size`` and ``--device`` and returns its exit code, as the JAX CLI
    starts ``bench.py``."""
    import subprocess
    import sys
    calls = []

    def call(cmd):
        calls.append(cmd)
        return 3
    monkeypatch.setattr(subprocess, "call", call)
    assert tcli.main(["bench", "--size", "64", "--device", "cpu"]) == 3
    assert tcli.main(["bench"]) == 3
    harness = os.path.join(REPO, "bench_torch.py")
    assert os.path.isfile(harness)
    assert calls == [[sys.executable, harness, "--size", "64", "--device",
                      "cpu"],
                     [sys.executable, harness, "--device", "cuda"]]


def test_front_end_never_imports_jax():
    """A fresh interpreter imports the front end, reads the registry and
    parses every subcommand without JAX or the JAX package entering
    sys.modules; importing the package alone imports nothing else."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "import hdrvae_torch\n"
        "assert [m for m in sys.modules if m.startswith('hdrvae_torch')]"
        " == ['hdrvae_torch'], 'the package imported more'\n"
        "from hdrvae_torch.cli import main\n"
        "from hdrvae_torch.api import nodes, graph, comfy, folders\n"
        "from hdrvae_torch.io import pipeline, native_build, exr\n"
        "from hdrvae_torch.utils import progress, introspect, profiling\n"
        "from hdrvae_torch.sharding import mesh, multihost\n"
        "import bench_torch\n"
        "assert list(hdrvae_torch.NODE_CLASS_MAPPINGS) == "
        "['HDRVAEDecode', 'LinearEXRExport', 'HDRUpscaleWithModel']\n"
        "p = main.build_parser()\n"
        "for cmd in ('decode', 'upscale --image a --model b', 'export "
        "--image a', 'run w.json', 'serve', 'decode --tiled --mesh 2', "
        "'upscale --sharded --image a --model b', 'convert vae a b', "
        "'inspect', 'bench --size 64'):\n"
        "    p.parse_args(cmd.split())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'hdrvae' or m.startswith('hdrvae.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
