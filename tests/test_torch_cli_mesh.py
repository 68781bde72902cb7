"""The port's CLI commands across ranks and its host commands, against the
JAX package's CLI, in-process on the CPU (``--device cpu``) at tiny sizes.

- ``decode --tiled --mesh 2`` (also ``--pipelined``) and ``upscale
  --sharded`` (on 3 ranks: its rank count is one a card, so the test sets
  it) start gloo ranks on the CPU: one set of JSON lines (rank 0's), each
  rank's record logged, files that read back at the right shape and agree
  with the single-process command; a failed rank fails the command.
- ``convert vae`` writes the JAX CLI's keys and arrays; ``convert
  upscaler`` prints its JSON line and writes a file the port's zoo loads
  back to the same output.
- ``inspect --path`` prints the JAX CLI's text; ``inspect`` the built-in
  decoder with JAX's header.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import save_file

from hdrvae.cli import main as jcli
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.utils.introspect import describe_params as jdescribe_params
from hdrvae_torch.cli import main as tcli
from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.io import exr as texr
from hdrvae_torch.models import span, swinir, zoo
from hdrvae_torch.models.params import init_decoder
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet

torch.set_num_threads(2)


def _run(capsys, argv, cli=tcli):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out if line.startswith("{")]


def _small_vae(tmp_path):
    """A with_small() decoder (seed 5) as a Flux-style safetensors file."""
    dec = init_decoder(DecoderConfig().with_small(), seed=5, device="cpu")
    path = tmp_path / "vae.safetensors"
    save_file({f"decoder.{k}": v.contiguous()
               for k, v in dec.state_dict().items()}, str(path))
    return str(path)


def _esrgan(tmp_path):
    net = init_rrdbnet(RRDBNetConfig(nf=8, gc=4, nb=1, scale=2), seed=4,
                       device="cpu")
    path = tmp_path / "esrgan.pth"
    torch.save(net.state_dict(), str(path))
    return str(path)


def test_decode_tiled_on_ranks(tmp_path, monkeypatch, capsys, caplog):
    """``decode --tiled --mesh 2``: rank 0's two lines (the summary, the
    file), each rank's record logged with its launch counts, a 32-bit EXR
    that reads back at the latent's 2x and agrees with the single-process
    decode within the slab decode's 1e-4 (parity, conservative)."""
    caplog.set_level(logging.INFO, logger="hdrvae_torch.cli")
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    vae = _small_vae(tmp_path)
    z = np.random.default_rng(8).standard_normal((1, 12, 10, 4)) \
        .astype(np.float32)
    np.save(tmp_path / "z.npy", z)
    common = ["--device", "cpu", "--vae", vae, "--latent",
              str(tmp_path / "z.npy"), "--precision", "parity", "--mode",
              "conservative", "--compression", "none"]
    rc, outs = _run(capsys, ["decode", "--tiled", "--mesh", "2",
                             "--prefix", "tiled"] + common)
    assert rc == 0 and len(outs) == 2
    assert outs[0]["used_fallback"] is False
    recs = [r.rank_record for r in caplog.records
            if hasattr(r, "rank_record")]
    assert [r["backend"] for r in recs] == ["gloo", "gloo"]
    assert all(isinstance(r["counts"], dict) for r in recs)
    rc, ref = _run(capsys, ["decode", "--prefix", "whole"] + common)
    assert rc == 0
    tiled = texr.read_exr(outs[1]["filepath"])
    whole = texr.read_exr(ref[1]["filepath"])
    assert tiled.shape == whole.shape == (24, 20, 3)
    assert np.abs(tiled - whole).max() <= 1e-4
    for k in ("min", "max", "mean", "std"):
        assert abs(outs[0]["pre"][k] - ref[0]["pre"][k]) <= 1e-4 * max(
            1.0, abs(ref[0]["pre"][k]))


def test_decode_tiled_pipelined_on_ranks(tmp_path, monkeypatch, capsys):
    """``--pipelined --tiled``: a two-frame sequence decoded frame by frame
    across 2 ranks, one line, two files that read back."""
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    rc, outs = _run(capsys, [
        "decode", "--tiled", "--mesh", "2", "--pipelined", "--device",
        "cpu", "--vae", _small_vae(tmp_path), "--size", "16", "--batch",
        "2", "--precision", "parity", "--prefix", "seq"])
    assert rc == 0 and len(outs) == 1 and outs[0]["frames"] == 2
    files = sorted(tmp_path.glob("seq*.exr"))
    assert len(files) == 2
    for f in files:
        assert texr.read_exr(str(f)).shape == (16, 16, 3)


def test_upscale_sharded_on_ranks(tmp_path, monkeypatch, capsys):
    """``upscale --sharded`` on 3 ranks: rank 0's lines ("sharded": true),
    and a file within 1e-5 of the single-process upscale's."""
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path))
    monkeypatch.setattr(tcli, "_mesh_size", lambda args: 3)
    img = np.random.default_rng(2).uniform(-0.3, 2.0, (20, 24, 3)) \
        .astype(np.float32)
    np.save(tmp_path / "img.npy", img)
    common = ["--device", "cpu", "--image", str(tmp_path / "img.npy"),
              "--model", _esrgan(tmp_path), "--tile", "16", "--overlap",
              "4"]
    rc, outs = _run(capsys, ["upscale", "--sharded", "--prefix",
                             "sharded"] + common)
    assert rc == 0 and len(outs) == 2
    assert outs[0] == {"architecture": "RealESRGAN", "scale": 2,
                       "sharded": True, "out_shape": [1, 40, 48, 3]}
    rc, ref = _run(capsys, ["upscale", "--prefix", "one"] + common)
    assert ref[0]["sharded"] is False
    a = texr.read_exr(outs[1]["filepath"])
    b = texr.read_exr(ref[1]["filepath"])
    assert a.shape == (40, 48, 3)
    assert np.abs(a - b).max() <= 1e-5


def test_failed_rank_fails_the_command(tmp_path, monkeypatch):
    """A rank that fails (here: an overlap as wide as the tile, refused in
    every rank's tile plan) fails the command with a non-zero exit that
    carries the ranks' logs; nothing is written."""
    monkeypatch.setenv("HDRVAE_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tcli, "_mesh_size", lambda args: 2)
    np.save(tmp_path / "img.npy", np.zeros((20, 20, 3), np.float32))
    with pytest.raises(SystemExit) as e:
        tcli.main(["upscale", "--sharded", "--device", "cpu",
                   "--image", str(tmp_path / "img.npy"), "--model",
                   _esrgan(tmp_path), "--tile", "8", "--overlap", "8"])
    assert e.value.code not in (0, None)
    assert "overlap 8 must be < tile 8" in str(e.value.code)
    assert not (tmp_path / "out").exists()


def test_convert_vae_matches_jax(tmp_path, capsys):
    """``convert vae`` of an ldm .ckpt (weights under 'state_dict', the
    first_stage_model prefix, encoder keys beside): the JAX CLI's
    inferred_config line and the same keys and arrays."""
    dec = init_decoder(DecoderConfig().with_small(), seed=6, device="cpu")
    sd = {f"first_stage_model.decoder.{k}": v
          for k, v in dec.state_dict().items()}
    sd["first_stage_model.encoder.conv_in.weight"] = torch.zeros(8, 3, 3, 3)
    torch.save({"state_dict": sd}, str(tmp_path / "vae.ckpt"))
    rc, outs = _run(capsys, ["convert", "vae", str(tmp_path / "vae.ckpt"),
                             str(tmp_path / "port.safetensors")])
    rc_j, jouts = _run(capsys, ["convert", "vae", str(tmp_path / "vae.ckpt"),
                                str(tmp_path / "jax.safetensors")], jcli)
    assert rc == rc_j == 0 and outs == [
        jouts[0], {"output": str(tmp_path / "port.safetensors")}]
    got = np_load_file(str(tmp_path / "port.safetensors"))
    ref = np_load_file(str(tmp_path / "jax.safetensors"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def _upscalers():
    """(name, module) of three zoo families, from seeds."""
    return [
        ("esrgan", init_rrdbnet(RRDBNetConfig(nf=8, gc=4, nb=1, scale=2),
                                seed=1, device="cpu")),
        ("swinir", swinir.init_swinir(swinir.SwinIRConfig().with_small(),
                                      seed=2, device="cpu")),
        ("span", span.span_from_state_dict(span.official_state_dict(
            span.SPANConfig().with_small(), seed=3), device="cpu")[0]),
    ]


@pytest.mark.parametrize("family", ["esrgan", "swinir", "span"])
def test_convert_upscaler(tmp_path, capsys, family):
    """``convert upscaler`` prints the JAX CLI's JSON line for the same
    checkpoint, and the port's zoo loads the file it writes back to the
    same module output (JAX writes its own parameter paths instead: the
    two files differ by design)."""
    net = dict(_upscalers())[family]
    src = tmp_path / f"{family}.pth"
    torch.save(zoo.upscaler_state_dict(net), str(src))
    if family == "span":   # an official checkpoint, as a user has one
        torch.save(span.official_state_dict(span.SPANConfig().with_small(),
                                            seed=3), str(src))
    rc, outs = _run(capsys, ["convert", "upscaler", str(src),
                             str(tmp_path / "port.safetensors")])
    rc_j, jouts = _run(capsys, ["convert", "upscaler", str(src),
                                str(tmp_path / "jax.safetensors")], jcli)
    assert rc == rc_j == 0 and outs[0] == jouts[0]
    assert outs[1] == {"output": str(tmp_path / "port.safetensors")}
    back, _, arch = zoo.load_upscale_model(
        str(tmp_path / "port.safetensors"), device="cpu")
    assert arch == outs[0]["architecture"]
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 12, 12, 3)).astype(np.float32))
    prec = Precision.parity()
    torch.testing.assert_close(zoo.upscaler_apply(back, x, precision=prec),
                               zoo.upscaler_apply(net, x, precision=prec),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["safetensors", "pth"])
def test_inspect_path_matches_jax(tmp_path, capsys, kind):
    """``inspect --path`` prints the JAX CLI's text for the same file: a
    VAE decoder's safetensors (ldm layout, 138 tensors: the '... more'
    line) and an ESRGAN .pth under 'params_ema'."""
    if kind == "safetensors":
        path = _small_vae(tmp_path)
    else:
        path = str(tmp_path / "esrgan.pth")
        net = init_rrdbnet(RRDBNetConfig(nf=8, gc=4, nb=1, scale=2),
                           device="cpu")
        torch.save({"params_ema": net.state_dict()}, path)
    tcli.main(["inspect", "--path", path])
    got = capsys.readouterr().out
    jcli.main(["inspect", "--path", path])
    assert got == capsys.readouterr().out
    assert "schema:" in got.splitlines()[0]


def test_inspect_builtin_decoder(capsys):
    """``inspect``: the Flux.1 decoder as flux1-vae-decoder, with the JAX
    CLI's header (its tensor count and ~49.5M parameters); the port's rows
    are its own modules' names and OIHW shapes."""
    tcli.main(["inspect"])
    lines = capsys.readouterr().out.splitlines()
    ref = jdescribe_params(jinit(jax.random.PRNGKey(0), JDecoderConfig()),
                           name="flux1-vae-decoder").splitlines()
    assert lines[0] == ref[0]
    assert lines[0].startswith("flux1-vae-decoder: 138 tensors, 49.5")
    assert len(lines) == len(ref)
    assert lines[1].split()[:2] == ["conv_in.weight", "(512,"]
