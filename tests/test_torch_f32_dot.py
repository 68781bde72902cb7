"""The port's K12 (``hdrvae_torch/kernels/f32_dot.py``), its plain version
here, against the JAX package: "highest" against the JAX probe's
``pallas_dot`` at HIGHEST (``tools/perf/pallas_f32_dot_probe.py``, run in
interpret mode by patching ``pl.pallas_call`` inside the test), "high"
against ``hdrvae.kernels.attention._dot3``, "default" against ``jnp.dot``
of bf16-rounded operands with float32 sums; each within 1e-5 * max|ref|
(float32 sums in different orders).  Against a float64 product of the same
operands the modes keep their classes: highest <= 1e-5, high <= 1e-4,
default <= 2e-2 of max|exact|.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.kernels.attention import _dot3
from hdrvae_torch.kernels import f32_dot as tdot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}
SHAPES = [(64, 32, 64), (256, 256, 128), (512, 96, 64)]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO,
                                                                      path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(m, k, n, seed=0):
    """The JAX probe's scales: x ~ N(0, 1), w ~ N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.05).astype(np.float32))


def _port(x, w, precision):
    return tdot.f32_dot(torch.from_numpy(x), torch.from_numpy(w),
                        precision=precision).numpy()


def _rel(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


def test_highest_vs_pallas_probe(monkeypatch):
    """The JAX probe's own kernel at HIGHEST (its row blocks of BM = 512,
    M cut from 8192 to 1024), in interpret mode."""
    probe = _load("tools/perf/pallas_f32_dot_probe.py", "_f32_dot_probe")
    monkeypatch.setattr(probe, "M", 1024)
    monkeypatch.setattr(probe.pl, "pallas_call", functools.partial(
        probe.pl.pallas_call, interpret=True))
    x, w = _operands(probe.M, probe.K, probe.N)
    ref = np.asarray(probe.pallas_dot(jnp.asarray(x), jnp.asarray(w),
                                      jax.lax.Precision.HIGHEST))
    assert _rel(_port(x, w, "highest"), ref) <= 1e-5


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_high_vs_dot3(m, k, n):
    """bf16x3: hi.hi + hi.lo + lo.hi, as the mixed tier's 3-pass
    attention contracts."""
    x, w = _operands(m, k, n, seed=1)
    ref = np.asarray(_dot3(jnp.asarray(x), jnp.asarray(w),
                           (((1,), (0,)), ((), ()))))
    assert _rel(_port(x, w, "high"), ref) <= 1e-5


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_default_vs_bf16_dot(m, k, n):
    """One bf16 pass: each operand rounded to bf16 once, float32 sums."""
    x, w = _operands(m, k, n, seed=2)
    ref = np.asarray(jnp.dot(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    assert _rel(_port(x, w, "default"), ref) <= 1e-5


@pytest.mark.parametrize("m,k,n", SHAPES + [(8192, 256, 256)])
def test_error_classes_vs_float64(m, k, n):
    """Each mode within its class of a float64 product of the same
    operands (the probe's shape among them), and the modes in the order of
    their passes: default coarser than high, high coarser than highest."""
    x, w = _operands(m, k, n, seed=3)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    errs = {p: _rel(_port(x, w, p), exact) for p in tdot.PRECISIONS}
    for p, bound in CLASSES.items():
        assert errs[p] <= bound, (p, errs[p])
    assert errs["highest"] < errs["high"] < errs["default"], errs


def test_split_is_the_jax_split():
    """hi = bf16(v) and lo = bf16(v - hi), element for element."""
    x, _ = _operands(64, 32, 64, seed=4)
    hi, lo = tdot.split_bf16(torch.from_numpy(x))
    jhi = jnp.asarray(x).astype(jnp.bfloat16)
    jlo = (jnp.asarray(x) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))


def test_f32_dot_refuses_and_never_falls_back():
    """An unknown precision raises on any device; a tensor off the CPU
    goes to the kernel or raises (a meta tensor stands in for a device
    without a card), and no launch is counted."""
    x = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="precision"):
        tdot.f32_dot(x, torch.zeros(32, 64), precision="tf32")
    before = tdot.f32_dot.launches
    xm = torch.empty(64, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdot.f32_dot(xm, torch.empty(32, 64, device="meta"))
    assert tdot.f32_dot.launches == before == 0


@pytest.mark.parametrize("lo", [True, False])
def test_split_w_plain_version(lo):
    """split_w's plain version: w^T's bf16 hi (and lo) parts, [2 | 1, N,
    K]; the high mode's three products of x's parts and these are its
    plain version's."""
    x, w = _operands(64, 32, 128, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    parts = tdot.split_w(wt, lo=lo)
    assert parts.shape == (2 if lo else 1, 128, 32)
    assert parts.dtype == torch.bfloat16 and parts.is_contiguous()
    hi, low = tdot.split_bf16(wt.t())
    assert torch.equal(parts[0], hi)
    if lo:
        assert torch.equal(parts[1], low)
        xh, xl = tdot.split_bf16(xt)
        wh, wl = (p.float().t() for p in parts)
        three = xh.float() @ wh + xh.float() @ wl + xl.float() @ wh
        assert torch.equal(three, tdot.f32_dot(xt, wt, precision="high"))


def test_new_port_modules_never_import_jax():
    """A fresh interpreter imports K12, the Swin chain, the probe tool and
    the zoo with its Compact, SPAN and RealPLKSR families, and runs them on
    the CPU without JAX or the JAX package entering sys.modules."""
    code = (
        "import sys, torch, runpy\n"
        "from hdrvae_torch.kernels import f32_dot, swin_attention\n"
        "from hdrvae_torch.models import plksr, span, srvgg, swinir, zoo\n"
        "x = torch.rand(1, 8, 8, 3)\n"
        "for m, c in ((srvgg.init_srvgg, srvgg.SRVGGConfig),\n"
        "             (span.init_span, span.SPANConfig),\n"
        "             (plksr.init_realplksr, plksr.RealPLKSRConfig)):\n"
        "    zoo.upscaler_apply(m(c().with_small(), device='cpu'), x)\n"
        "runpy.run_path('tools/f32_dot_probe_torch.py')\n"
        "f32_dot.f32_dot(torch.ones(64, 32), torch.ones(32, 64),\n"
        "                precision='high')\n"
        "blk = swinir.SwinBlock(16, 2, 4, 2.0).requires_grad_(False)\n"
        "w = swinir.block_weights(blk, 2, 4, torch.float32)\n"
        "swinir.chain_block(torch.zeros(1, 8, 8, 16), w, 4, 2,\n"
        "                   swinir.Precision())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'hdrvae' or m.startswith('hdrvae.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
