"""The port's benchmark harness (``bench_torch.py``) against the JAX
package's (``bench.py``), on the CPU at tiny sizes.

Both harnesses run ``--size 64 --big-size 128 --runs 1 --warmup 1`` with
the 4096^2 rows off and every model at its ``with_small()`` config:
``bench.py`` in a subprocess whose script swaps the configs its ``main()``
imports (nothing in ``bench.py`` changes), the port in this process through
its test hook (``bench_torch._SMALL_MODELS``) with ``--device cpu`` and
``--full``.  The port's line must carry ``bench.py``'s default rows in the
same order with the same keys, then ``--full``'s nine rows, named here
(``bench.py --full`` takes ~100 s on the CPU, three times its default rows:
it is not run).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import bench_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--size", "64", "--big-size", "128", "--runs", "1", "--warmup",
         "1"]

# bench.py's main() with every model at its with_small() config (the port's
# where the JAX config has none: Compact, SPAN); its modules imported
# before the configs are swapped, so that only main()'s imports see them
_JAX_RUNNER = r"""
import dataclasses, sys
import jax
jax.config.update("jax_platforms", "cpu")
import hdrvae.decode.pipeline, hdrvae.decode.staged, hdrvae.io.export
import hdrvae.io.pipeline, hdrvae.serve.engine, hdrvae.sharding.mesh
from hdrvae.core import config
from hdrvae.models import hat, plksr, rrdbnet, span, srvgg, swin2sr, swinir
from hdrvae_torch.models import span as tspan, srvgg as tsrvgg


def small(mod, name, port_cls=None):
    cls = getattr(mod, name)
    if port_cls is None:
        made = lambda: cls().with_small()
    else:
        made = lambda: cls(**dataclasses.asdict(port_cls().with_small()))
    setattr(mod, name, made)


small(config, "DecoderConfig")
for mod, name in ((rrdbnet, "RRDBNetConfig"), (swinir, "SwinIRConfig"),
                  (swin2sr, "Swin2SRConfig"), (hat, "HATConfig"),
                  (plksr, "RealPLKSRConfig")):
    small(mod, name)
small(srvgg, "SRVGGConfig", tsrvgg.SRVGGConfig)
small(span, "SPANConfig", tspan.SPANConfig)
import bench
sys.argv = ["bench.py"] + sys.argv[1:]
sys.exit(bench.main())
"""

# the default rows at --size 64 / --big-size 128 without the 4K rows, then
# --full's nine
DEFAULT_ROWS = [
    "hdr_decode_mp_per_s_64", "hdr_decode_mp_per_s_128",
    "hdr_decode_mp_per_s_128_slab", "hdr_decode_export_mp_per_s_128",
    "hdr_decode_export_serial_mp_per_s_128",
    "hdr_decode_export_pipelined_mp_per_s_128",
    "hdr_decode_mixed_mp_per_s_64", "hdr_decode_mixed_mp_per_s_128",
    "hdr_decode_mixed_export_mp_per_s_128", "serve_decode_mp_per_s_64",
    "serve_decode_mixed_mp_per_s_64", "serve_decode_mixed_mp_per_s_128"]
FULL_ROWS = [
    "hdr_decode_mp_per_s_64_b4", "hdr_decode_mp_per_s_128_tile_grid",
    "esrgan_x4_upscale_mp_per_s_512tile",
    "swinir_x4_upscale_mp_per_s_512tile",
    "swin2sr_x4_upscale_mp_per_s_512tile",
    "hat_x4_upscale_mp_per_s_256tile",
    "compact_x4_upscale_mp_per_s_512tile",
    "span_x4_upscale_mp_per_s_512tile",
    "realplksr_x4_upscale_mp_per_s_512tile"]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, HDRVAE_BENCH_4K="0",
               HDRVAE_BENCH_PROBE_TIMEOUT="0", HDRVAE_NO_COMPILE_CACHE="1",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2", **extra)
    # one JAX device: the suite's eight virtual ones would shard the slab
    # rows eight ways
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    return env


def _rows(line: dict) -> list:
    return [{k: v for k, v in line.items() if k != "extra_metrics"}] + \
        line.get("extra_metrics", [])


def _last_json(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert lines, text[-2000:]
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def lines():
    """(bench.py's line at FLAGS, the port's at FLAGS + --full): the JAX
    harness in a subprocess while the port's runs here."""
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_RUNNER] + FLAGS, cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, redirect_stdout(out):
            mp.setenv("HDRVAE_BENCH_4K", "0")
            mp.setattr(bench_torch, "_SMALL_MODELS", True)
            rc = bench_torch.main(FLAGS + ["--full", "--device", "cpu"])
        jax_out, jax_err = jax_proc.communicate(timeout=600)
    finally:
        jax_proc.kill()
    assert rc == 0
    assert jax_proc.returncode == 0, jax_err[-3000:]
    return _last_json(jax_out), _last_json(out.getvalue())


def test_rows_match_bench_py(lines):
    """bench.py's default rows in its order, then --full's: 21 rows."""
    ref, got = (_rows(line) for line in lines)
    names = [r["metric"] for r in got]
    assert [r["metric"] for r in ref] == DEFAULT_ROWS
    assert names == DEFAULT_ROWS + FULL_ROWS


@pytest.mark.parametrize("kind", ["decode", "serve", "upscale"])
def test_row_keys_and_baseline(lines, kind):
    """Each row has bench.py's keys; unit MP/s; vs_baseline the value over
    0.024 MP/s rounded to 0.1, None on the upscaler rows."""
    ref, got = (_rows(line) for line in lines)
    # bench.py's keys: its own row of the name, else (--full) its headline's
    keys = {r["metric"]: list(r) for r in ref}
    picked = [g for g in got
              if kind == ("upscale" if "upscale" in g["metric"] else
                          "serve" if g["metric"].startswith("serve")
                          else "decode")]
    assert picked
    for g in picked:
        assert list(g) == keys.get(g["metric"], keys[ref[0]["metric"]]), \
            g["metric"]
        assert g["unit"] == "MP/s" and g["value"] > 0
        if kind == "upscale":
            assert g["vs_baseline"] is None     # bench.py's :468-471
        else:
            assert g["vs_baseline"] == round(
                g["value"] / bench_torch.REFERENCE_MP_PER_S, 1)
        if kind == "serve":
            assert 0 < g["p50_s"] <= g["p95_s"]


def test_headline_line_shape(lines):
    """One JSON object: the headline row's keys, then extra_metrics."""
    ref, got = lines
    assert list(got) == list(ref) == ["metric", "value", "unit",
                                      "vs_baseline", "extra_metrics"]


def test_bench_step_contract():
    """Warm-up steps, then two timed loops of ``runs`` steps each, every
    step fed the previous one's output; best <= mean."""
    calls = []

    def step(x):
        calls.append(x)
        return x + 1

    synced = []
    best, mean, warm = bench_torch.bench_step(step, 0, synced.append, runs=3,
                                              warmup=2)
    assert calls == [0, 1, 0, 1, 2, 0, 1, 2]
    assert synced == [2, 3, 3]
    assert 0 <= best <= mean and warm >= 0
    calls.clear()
    bench_torch.bench_step(step, 0, lambda x: None, runs=1, warmup=0)
    assert len(calls) == 1 + 2      # at least one warm-up step


def test_probe_without_card_exits_2():
    """``python bench_torch.py`` (--device cuda) on a host without a card:
    exit 2, no metric line."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the probe passes")
    env = _env()
    env.pop("HDRVAE_BENCH_PROBE_TIMEOUT")
    proc = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "probe failed" in proc.stderr


def test_cuda_without_card_raises(monkeypatch, capsys):
    """With the probe skipped, --device cuda without a card raises: no row
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    monkeypatch.setenv("HDRVAE_BENCH_PROBE_TIMEOUT", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--quick"])
    assert not capsys.readouterr().out.strip()


def test_slab_headline_on_ranks(monkeypatch, capsys):
    """More than one rank (a card each on a multi-card host; here two gloo
    ranks on the CPU): the slab headline runs on ranks started through
    ``sharding/multihost.py``, and the detail says how many."""
    monkeypatch.setattr(bench_torch, "_SMALL_MODELS", True)
    monkeypatch.setattr(bench_torch, "_rank_count", lambda device: 2)
    rc = bench_torch.main(["--size", "64", "--runs", "1", "--warmup", "1",
                           "--quick", "--tiled", "--extra", "--device",
                           "cpu"])
    assert rc == 0
    out, err = capsys.readouterr()
    line = _last_json(out)
    assert line["metric"] == "hdr_decode_mp_per_s_64_tiled"
    assert line["value"] > 0 and "extra_metrics" not in line
    detail = _last_json(err)
    assert detail["n_devices"] == 2 and detail["metric"] == line["metric"]


def test_configs_under_the_hook(monkeypatch):
    """The hook gives every model its with_small() config; unset, the
    published defaults."""
    from hdrvae_torch.core.config import DecoderConfig
    from hdrvae_torch.models.srvgg import SRVGGConfig
    assert bench_torch._config(DecoderConfig) == DecoderConfig()
    monkeypatch.setattr(bench_torch, "_SMALL_MODELS", True)
    assert bench_torch._config(DecoderConfig) == \
        DecoderConfig().with_small()
    assert dataclasses.asdict(bench_torch._config(SRVGGConfig)) == \
        dataclasses.asdict(SRVGGConfig().with_small())


@pytest.mark.cuda
def test_quick_rows_on_card(monkeypatch, capsys):
    """On the card: the fast and mixed headlines at 512^2 through the
    harness, launching K1, K2 and K3 bf16 (fast) and K3 3-pass with its
    split (mixed); the plain versions never run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m "
                    "pytest -m cuda tests/test_torch_bench.py --noconftest")
    from hdrvae_torch.kernels import attention, conv3x3
    wrappers = (conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
                attention.flash_attention_bf16,
                attention.flash_attention_3pass, attention.split_qkv)
    for precision, ran in (("fast", wrappers[:3]), ("mixed", wrappers[3:])):
        for fn in wrappers:
            monkeypatch.setattr(fn, "launches", 0)
        assert bench_torch.main(["--quick", "--size", "512", "--runs", "2",
                                 "--precision", precision]) == 0
        line = _last_json(capsys.readouterr().out)
        assert line["metric"] == "hdr_decode_mp_per_s_512"
        assert line["value"] > 0
        assert all(fn.launches > 0 for fn in ran), precision
        assert all(fn.launches == 0 for fn in wrappers if fn not in ran)
