"""The port's served decode (``api/vae.py``, ``serve/engine.py``,
``serve/http.py``, ``cli/main.py``) and its one-copy stats fetch, against
the JAX package's.

Weights: the JAX decoder's ``init_decoder(PRNGKey(0), with_small())``
carried across with ``state_dict_from_jax``; latents from numpy seeds.
The port runs on CPU tensors.

Tolerances: the port's engine against the JAX ``ServeEngine`` with the same
bucket, in the parity and mixed tiers, at the bar
``tests/test_torch_pipeline.py`` and ``tests/test_torch_buckets.py`` hold
``hdr_decode`` to there: the conservative image max-abs <= 1e-4,
summary statistics 1e-4 relative (1e-5 absolute).  The port's engine
against the port's own direct ``hdr_decode`` on the same route: equal.
"""

import http.client
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from hdrvae.api.vae import VAE as JVAE
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.decode.buckets import BucketPolicy as JBucketPolicy
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.serve.engine import ServeEngine as JServeEngine
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core import config as tconfig
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.core.stats import stats_to_host
from hdrvae_torch.decode import pipeline as tpipe
from hdrvae_torch.decode.buckets import BucketPolicy
from hdrvae_torch.io.exr import read_exr
from hdrvae_torch.io.hdr import read_hdr
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)
from hdrvae_torch.serve import engine as engine_mod
from hdrvae_torch.serve.engine import (EngineOverloaded, ServeEngine,
                                       ServeResponse)

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONS = HDRDecodeConfig(hdr_mode="conservative")
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg),
        cfg, device="cpu")
    return jcfg, params, dec


@pytest.fixture()
def vae(weights):
    return VAE(decoder=weights[2], precision=Precision.parity())


def _latent(seed, h=6, w=6, b=1, zc=4):
    return (np.random.default_rng(seed).standard_normal((b, h, w, zc))
            .astype(np.float32) * 2)


def _direct(vae, latent, cfg=HDRDecodeConfig(), pad_to=None,
            precision=None):
    return tpipe.hdr_decode(vae.decoder, torch.from_numpy(latent), cfg,
                            precision or vae.precision, pad_to=pad_to)


def _slow(engine, gate):
    """Hold the worker in its next dispatch until ``gate`` is set."""
    orig = engine._dispatch

    def slow_dispatch(latent, cfg, fetch_dtype=None):
        gate.wait(10)
        return orig(latent, cfg, fetch_dtype)
    engine._dispatch = slow_dispatch


# ---------------------------------------------------------------------------
# The VAE handle
# ---------------------------------------------------------------------------


def test_vae_handle_decodes_like_decoder_apply(weights, tmp_path):
    """decode() is decoder_apply on the handle's device; load() reads a
    checkpoint back bit for bit; random_init
    draws from a numpy seed."""
    from safetensors.torch import save_file

    from hdrvae_torch.models.decoder import decoder_apply
    _, _, dec = weights
    vae = VAE(decoder=dec, precision=Precision.parity())
    assert vae.config == dec.cfg and vae.device == torch.device("cpu")
    z = _latent(1)
    got = vae.decode(z)
    ref = decoder_apply(dec, torch.from_numpy(z), precision=Precision.parity())
    assert torch.equal(got.rgb, ref.rgb)
    assert torch.equal(vae.decode(z, apply_conv_out=False).pre_conv_out,
                       ref.pre_conv_out)
    path = tmp_path / "ae.safetensors"
    save_file({"decoder." + k: t.contiguous()
               for k, t in dec.state_dict().items()}, str(path))
    loaded = VAE.load(str(path), dec.cfg, Precision.mixed(), device="cpu")
    assert loaded.config == dec.cfg
    assert loaded.precision == Precision.mixed()
    assert all(torch.equal(a, b) for a, b in zip(
        loaded.decoder.state_dict().values(), dec.state_dict().values()))
    a = VAE.random_init(3, DecoderConfig().with_small(), device="cpu")
    b = VAE.random_init(3, DecoderConfig().with_small(), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        a.decoder.state_dict().values(), b.decoder.state_dict().values()))


# ---------------------------------------------------------------------------
# The engine against the JAX package's
# ---------------------------------------------------------------------------

TIERS = {"parity": (JPrecision.parity(), Precision.parity()),
         "mixed": (JPrecision.mixed(), Precision.mixed())}
# (JAX bucket, port bucket, latent (h, w), the bucket the response reports)
BUCKET_CASES = {
    "none": (None, None, (6, 6), (6, 6)),
    "int_at_bucket": (4, 4, (8, 8), (8, 8)),
    "int_off_bucket": (4, 4, (5, 6), (8, 8)),
    "policy": (JBucketPolicy((8, 12)), BucketPolicy((8, 12)), (5, 7),
               (8, 8)),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_engine_matches_jax_engine(weights, tier, case):
    jcfg, params, dec = weights
    jprec, tprec = TIERS[tier]
    jbucket, tbucket, (h, w), padded = BUCKET_CASES[case]
    z = _latent(11, h, w)
    jvae = JVAE(params=params, config=jcfg, precision=jprec)
    with JServeEngine(jvae, hdr_cfg=JHDRDecodeConfig(hdr_mode="conservative"),
                      bucket=jbucket) as je:
        ref = je.decode_sync(z)
    with ServeEngine(VAE(dec, tprec), hdr_cfg=CONS, bucket=tbucket) as te:
        got = te.decode_sync(z)
    assert got.padded_hw == ref.padded_hw == padded
    assert got.image.shape == ref.image.shape == (1, 2 * h, 2 * w, 3)
    assert got.image.dtype == np.float32
    np.testing.assert_allclose(got.image, ref.image, atol=TOL, rtol=0)
    assert set(got.summary) == set(ref.summary)
    assert got.summary["normalization"] == ref.summary["normalization"]
    assert got.summary["used_fallback"] == ref.summary["used_fallback"]
    for key in ("input", "pre", "post", "output"):
        assert set(got.summary[key]) == set(ref.summary[key]), key
        for stat, want in ref.summary[key].items():
            assert got.summary[key][stat] == pytest.approx(
                want, rel=TOL, abs=1e-5), (key, stat)


def test_engine_matches_direct_decode(vae):
    z = _latent(1)
    direct = _direct(vae, z)
    with ServeEngine(vae, bucket=None) as engine:
        resp = engine.decode_sync(z)
    assert isinstance(resp, ServeResponse)
    np.testing.assert_array_equal(resp.image, direct.image.numpy())
    assert resp.summary == tpipe.decode_summary(direct)
    assert resp.summary["normalization"] in ("SIGMOID", "TANH", "CUSTOM")
    assert resp.latency_s > 0 and resp.padded_hw == (6, 6)


def test_at_bucket_latent_takes_unbucketed_route(vae, monkeypatch):
    """A latent already at its bucket reaches hdr_decode with pad_to=None
    (on a card: the fast tier's chain, not the PadMask layers); one off
    its bucket is padded to it.  Both report the bucket, and each equals
    the direct decode on the route it took."""
    seen = []
    real = engine_mod.hdr_decode
    monkeypatch.setattr(engine_mod, "hdr_decode", lambda *a, **kw: (
        seen.append(kw["pad_to"]) or real(*a, **kw)))
    at, off = _latent(2, 8, 8), _latent(3, 5, 6)
    with ServeEngine(vae, bucket=4) as engine:
        r_at, r_off = engine.decode_sync(at), engine.decode_sync(off)
        shapes = engine.stats()["compiled_latent_shapes"]
    assert seen == [None, (8, 8)]
    assert r_at.padded_hw == r_off.padded_hw == (8, 8)
    assert shapes == {"8x8": 2}
    np.testing.assert_array_equal(r_at.image, _direct(vae, at).image.numpy())
    np.testing.assert_array_equal(
        r_off.image, _direct(vae, off, pad_to=(8, 8)).image.numpy())
    # the unbucketed route is the bucketed one to float noise
    np.testing.assert_allclose(
        r_at.image, _direct(vae, at, pad_to=(8, 8)).image.numpy(),
        atol=TOL, rtol=0)


def test_engine_int_bucket_and_stats(vae):
    with ServeEngine(vae, bucket=4) as engine:
        for seed, (h, w) in enumerate([(5, 6), (6, 5), (7, 7)]):
            engine.decode_sync(_latent(seed, h, w))
        stats = engine.stats()
    assert stats["requests"] == 3 and stats["errors"] == 0
    assert stats["pending"] == 0
    assert stats["compiled_latent_shapes"] == {"8x8": 3}
    assert stats["latency_p50_s"] > 0
    assert stats["latency_p95_s"] >= stats["latency_p50_s"]
    want = sum(2 * h * 2 * w for h, w in [(5, 6), (6, 5), (7, 7)]) / 1e6
    assert stats["megapixels"] == pytest.approx(want)


def test_engine_concurrent_submits(vae):
    """Requests from several threads at depth 2 each resolve to their own
    decode."""
    latents = [_latent(20 + i) for i in range(6)]
    futs = [None] * len(latents)
    with ServeEngine(vae, bucket=None, depth=2) as engine:
        def client(idx):
            for i in idx:
                futs[i] = engine.submit(latents[i])
        threads = [threading.Thread(target=client, args=(range(k, 6, 3),))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        images = [f.result(60).image for f in futs]
    for z, img in zip(latents, images):
        np.testing.assert_array_equal(img, _direct(vae, z).image.numpy())


def test_engine_error_propagates_and_engine_survives(vae, monkeypatch):
    with ServeEngine(vae, bucket=None) as engine:
        with pytest.raises(ValueError):
            engine.decode_sync(np.zeros((1, 6, 6, 3), np.float32))  # 3ch
        with pytest.raises(ValueError):
            engine.submit(np.zeros((6, 6), np.float32))   # 2D
        # a kernel that fails to launch fails its request, nothing else
        real = engine_mod.hdr_decode

        def broken(*a, **kw):
            raise RuntimeError("hdrvae_fused_conv3x3: CUDA launch failed")
        monkeypatch.setattr(engine_mod, "hdr_decode", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            engine.decode_sync(_latent(1))
        monkeypatch.setattr(engine_mod, "hdr_decode", real)
        ok = engine.decode_sync(_latent(1))
        assert ok.image.shape[-1] == 3
        assert engine.stats()["errors"] == 2   # the 2D one never queued
        assert engine.stats()["requests"] == 1


def test_engine_backpressure_and_close(vae):
    engine = ServeEngine(vae, bucket=None, max_pending=1)
    gate = threading.Event()
    _slow(engine, gate)
    try:
        first = engine.submit(_latent(1))     # the worker takes it
        deadline = time.monotonic() + 5
        queued = None
        while time.monotonic() < deadline:
            try:   # fill the 1-slot queue once the worker popped `first`
                queued = engine.submit(_latent(2), block=False)
                break
            except EngineOverloaded:
                time.sleep(0.01)
        assert queued is not None, "worker never picked up the first request"
        with pytest.raises(EngineOverloaded):
            engine.submit(_latent(3), block=False)
        with pytest.raises(EngineOverloaded):
            engine.submit(_latent(3), timeout=0.05)
        gate.set()
        assert first.result(30).image.shape[-1] == 3
        assert queued.result(30).image.shape[-1] == 3
    finally:
        gate.set()
        engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(_latent(4))
    assert not engine._worker.is_alive()


def test_engine_deadline_drops_queued_requests(vae):
    engine = ServeEngine(vae, bucket=None)
    gate = threading.Event()
    _slow(engine, gate)
    try:
        first = engine.submit(_latent(1))   # the worker blocks in it
        time.sleep(0.05)
        doomed = engine.submit(_latent(2), deadline_s=0.01)
        ok = engine.submit(_latent(3))
        time.sleep(0.05)                    # doomed expires while queued
        gate.set()
        assert first.result(30).image.shape[-1] == 3
        with pytest.raises(TimeoutError):
            doomed.result(30)
        assert ok.result(30).image.shape[-1] == 3
        assert engine.stats()["errors"] == 1
    finally:
        gate.set()
        engine.close()


def test_engine_default_deadline_and_warmup_exempt(vae):
    """The engine's deadline applies to submits that name none; warmup
    requests carry none."""
    engine = ServeEngine(vae, bucket=None, deadline_s=0.01)
    gate = threading.Event()
    _slow(engine, gate)
    try:
        first = engine.submit(_latent(1), deadline_s=None)
        time.sleep(0.05)
        doomed = engine.submit(_latent(2))
        time.sleep(0.05)
        gate.set()
        first.result(30)
        with pytest.raises(TimeoutError):
            doomed.result(30)
        engine.warmup([(4, 4)])
        assert engine.stats()["compiled_latent_shapes"]["4x4"] == 1
    finally:
        gate.set()
        engine.close()


def test_engine_blocking_submit_wakes(vae):
    engine = ServeEngine(vae, bucket=None, max_pending=1)
    gate = threading.Event()
    _slow(engine, gate)
    try:
        first = engine.submit(_latent(1))
        time.sleep(0.05)                     # the worker holds it
        second = engine.submit(_latent(2))   # fills the queue
        results = []
        t = threading.Thread(target=lambda: results.append(
            engine.submit(_latent(3), timeout=20)))
        t.start()
        time.sleep(0.1)
        assert t.is_alive()                  # blocked on a full queue
        gate.set()                           # the worker drains; it wakes
        t.join(20)
        assert not t.is_alive() and len(results) == 1
        for f in (first, second, results[0]):
            assert f.result(30).image.shape[-1] == 3
    finally:
        gate.set()
        engine.close()


def test_engine_fetch_dtype_half(vae):
    z = _latent(1)
    with ServeEngine(vae, bucket=None) as engine:
        full = engine.decode_sync(z)
        half = engine.submit(z, fetch_dtype=np.float16).result()
    assert half.image.dtype == np.float16
    np.testing.assert_array_equal(half.image, full.image.astype(np.float16))
    assert half.summary == full.summary


def test_engine_warmup_and_tensor_latents(vae):
    """warmup decodes one latent a size; a tensor latent (NCHW here) is
    served like its numpy array."""
    z = _latent(5)
    with ServeEngine(vae, bucket=None) as engine:
        engine.warmup([(6, 6), (8, 8)])
        assert engine.stats()["compiled_latent_shapes"] == {"6x6": 1,
                                                            "8x8": 1}
        a = engine.decode_sync(z)
        b = engine.decode_sync(torch.from_numpy(z).permute(0, 3, 1, 2))
        c = engine.decode_sync(z[0])          # [h, w, z]
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.image, c.image)
    assert engine.device == torch.device("cpu") and engine.z_channels == 4


def test_engine_cancelled_request_is_skipped(vae):
    engine = ServeEngine(vae, bucket=None)
    gate = threading.Event()
    _slow(engine, gate)
    try:
        first = engine.submit(_latent(1))
        time.sleep(0.05)
        cancelled = engine.submit(_latent(2))
        assert cancelled.cancel()
        gate.set()
        first.result(30)
        engine.decode_sync(_latent(3))
        assert engine.stats()["requests"] == 2
    finally:
        gate.set()
        engine.close()


# ---------------------------------------------------------------------------
# fp32_contractions across threads, and the packed stats fetch
# ---------------------------------------------------------------------------


def test_fp32_contractions_hold_across_threads():
    """Two threads enter and leave interleaved parity / mixed blocks: the
    TF32 flags read False while either is open, and come back when the
    last one closes."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = True, True
    steps = [threading.Event() for _ in range(4)]
    reads, errors = [], []

    def worker(prec, enter, inside, leave):
        try:
            steps[enter].wait(10) if enter is not None else None
            with tconfig.fp32_contractions(prec):
                reads.append((cudnn.allow_tf32, matmul.allow_tf32))
                steps[inside].set()
                steps[leave].wait(10)
                reads.append((cudnn.allow_tf32, matmul.allow_tf32))
        except Exception as e:   # surfaced by the main thread
            errors.append(e)

    try:
        # A opens, B opens, A closes (B still open), B closes
        a = threading.Thread(target=worker,
                             args=(Precision.parity(), None, 0, 2))
        b = threading.Thread(target=worker,
                             args=(Precision.mixed(), 0, 1, 3))
        a.start()
        b.start()
        steps[1].wait(10)
        steps[2].set()
        a.join(10)
        assert not a.is_alive()
        reads.append((cudnn.allow_tf32, matmul.allow_tf32))   # B open
        with tconfig.fp32_contractions(Precision.fast()):
            reads.append((cudnn.allow_tf32, matmul.allow_tf32))
        steps[3].set()
        b.join(10)
        assert not b.is_alive() and not errors
        assert reads == [(False, False)] * 6
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _stats_to_host_per_scalar(stats):
    """The per-scalar fetch the packed one replaced."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _stats_to_host_per_scalar(v)
        else:
            t = torch.as_tensor(v)
            out[k] = float(t) if t.is_floating_point() else int(t)
    return out


def test_packed_stats_to_host_equals_per_scalar(vae):
    """On a nested record of float32 values (NaN, inf, a float32 that is
    no float64 round number), int32 counts and a bool flag, and on a
    decode's full record, the packed fetch gives what one fetch a scalar
    gives, key order included."""
    rec = {"a": {"min": torch.tensor(-1.1, dtype=torch.float32),
                 "max": torch.tensor(float("inf")),
                 "mean": torch.tensor(float("nan")),
                 "count": torch.tensor(2 ** 31 - 1, dtype=torch.int32)},
           "flag": torch.tensor(True),
           "kind": torch.tensor(2, dtype=torch.int32),
           "b": {"c": {"std": torch.tensor(1e-30)}},
           "plain": 3.5}
    got, want = stats_to_host(rec), _stats_to_host_per_scalar(rec)
    assert list(got) == list(want)
    assert json.dumps(got) == json.dumps(want)
    assert isinstance(got["kind"], int) and isinstance(got["a"]["min"], float)
    assert got["a"]["min"] == float(np.float32(-1.1))
    assert math.isnan(got["a"]["mean"])
    res = _direct(vae, _latent(1), HDRDecodeConfig(full_analysis=True))
    want = _stats_to_host_per_scalar(res.stats)
    assert stats_to_host(res.stats) == want
    summary = tpipe.decode_summary(res)
    assert summary["used_fallback"] is bool(res.used_fallback)
    assert list(summary) == [k for k in want if k != "norm_kind"] + \
        ["used_fallback", "normalization"]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _serve(engine, **kw):
    from hdrvae_torch.serve.http import make_server
    srv = make_server(engine, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv, engine):
    srv.shutdown()
    srv.server_close()
    engine.close()


@pytest.fixture()
def server(vae):
    engine = ServeEngine(vae, bucket=None)
    srv = _serve(engine)
    yield srv
    _stop(srv, engine)


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=120)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_healthz_and_stats(server):
    status, _, body = _request(server, "GET", "/healthz")
    assert status == 200
    health = json.loads(body)
    assert health == {"ok": True, "backend": "cpu", "device": "cpu",
                      "device_count": 1}
    status, _, body = _request(server, "GET", "/v1/stats")
    assert status == 200 and "requests" in json.loads(body)
    status, _, _ = _request(server, "GET", "/nope")
    assert status == 404


def test_http_decode_exr_roundtrip(server, vae, tmp_path):
    z = _latent(1)
    status, headers, body = _request(
        server, "POST",
        "/v1/decode?format=exr&bit_depth=32bit&compression=none",
        body=_npy_bytes(z))
    assert status == 200, body
    assert headers["Content-Type"] == "image/x-exr"
    summary = json.loads(headers["X-HDRVAE-Summary"])
    assert summary["normalization"] in ("SIGMOID", "TANH", "CUSTOM")
    assert summary["padded_latent_hw"] == [6, 6]
    p = tmp_path / "resp.exr"
    p.write_bytes(body)
    np.testing.assert_array_equal(read_exr(str(p)),
                                  _direct(vae, z).image.numpy()[0])


def test_http_decode_hdr_format(server, vae, tmp_path):
    z = _latent(2)
    status, headers, body = _request(server, "POST",
                                     "/v1/decode?format=hdr",
                                     body=_npy_bytes(z))
    assert status == 200, body
    assert headers["Content-Type"] == "image/vnd.radiance"
    p = tmp_path / "resp.hdr"
    p.write_bytes(body)
    got = read_hdr(str(p))
    want = np.clip(_direct(vae, z).image.numpy()[0], 0, None)
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    scale = np.maximum(want.max(-1, keepdims=True), 1e-30)
    assert np.abs(got - want).max() <= (2.0 ** -7 * scale).max()


def test_http_decode_npy_batch_and_mode(server, vae):
    z = _latent(3, b=2)
    status, _, body = _request(
        server, "POST", "/v1/decode?format=npy&mode=conservative&ev=2.0",
        body=_npy_bytes(z))
    assert status == 200, body
    want = _direct(vae, z, HDRDecodeConfig(hdr_mode="conservative",
                                           conservative_ev_multiplier=2.0))
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  want.image.numpy())
    status, _, body = _request(server, "POST", "/v1/decode?format=exr",
                               body=_npy_bytes(z))
    assert status == 400 and b"batch" in body


BAD_REQUESTS = {
    "not_npy": ("/v1/decode", b"not an npy file"),
    "mode": ("/v1/decode?mode=nonsense", None),
    "format": ("/v1/decode?format=gif", None),
    "bit_depth": ("/v1/decode?bit_depth=8bit", None),
    "compression": ("/v1/decode?compression=lzma", None),
    "unwritten_compression": ("/v1/decode?compression=piz", None),
    "int_dtype": ("/v1/decode", _npy_bytes(np.zeros((6, 6, 4), np.int32))),
    "channels": ("/v1/decode",
                 _npy_bytes(np.zeros((1, 6, 6, 3), np.float32))),
    "rank": ("/v1/decode", _npy_bytes(np.zeros((6, 4), np.float32))),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_http_bad_requests(server, monkeypatch, case):
    path, body = BAD_REQUESTS[case]
    if case == "unwritten_compression":
        # piz is refused only where the native EXR codec is unavailable
        from hdrvae_torch.io import exr as texr
        monkeypatch.setattr(texr, "load_native", lambda: None)
    status, headers, resp = _request(server, "POST", path,
                                     body=body or _npy_bytes(_latent(1)))
    assert status == 400, (case, resp)
    # error replies may leave the body unread: the connection closes
    assert headers.get("Connection", "").lower() == "close", case
    if case == "unwritten_compression":
        assert b"'piz'" in resp and b"native" in resp


def test_http_unknown_post_path(server):
    status, _, _ = _request(server, "POST", "/v1/other", body=b"x")
    assert status == 404


def test_http_nonfinite_stats_header_is_strict_json(server):
    z = _latent(1)
    z[0, 0, 0, 0] = np.nan
    status, headers, _ = _request(server, "POST", "/v1/decode?format=npy",
                                  body=_npy_bytes(z))
    assert status == 200

    def reject(_):
        raise AssertionError("non-strict JSON constant in summary header")
    summary = json.loads(headers["X-HDRVAE-Summary"], parse_constant=reject)
    assert "input" in summary


@pytest.mark.parametrize("ev,ok", [("nan", False), ("inf", False),
                                   ("-1", False), ("0", False),
                                   ("0.05", False), ("11", False),
                                   ("1e30", False), ("0.1", True),
                                   ("10.0", True), ("2.5", True)])
def test_http_ev_validation(server, ev, ok):
    status, _, resp = _request(server, "POST",
                               f"/v1/decode?format=npy&ev={ev}",
                               body=_npy_bytes(_latent(1)))
    assert status == (200 if ok else 400), (ev, resp)
    if not ok:
        assert b"ev must be" in resp


def test_http_size_caps(vae):
    engine = ServeEngine(vae, bucket=None)
    srv = _serve(engine, max_latent_pixels=8 * 8, max_batch=2)
    try:
        status, _, _ = _request(srv, "POST", "/v1/decode?format=npy",
                                body=_npy_bytes(_latent(1, 8, 8)))
        assert status == 200
        status, _, resp = _request(srv, "POST", "/v1/decode?format=npy",
                                   body=_npy_bytes(_latent(1, 9, 8)))
        assert status == 400 and b"request cap" in resp
        # NCHW: the cap reads h and w from the right axes
        nchw = np.transpose(_latent(1, 9, 8), (0, 3, 1, 2))
        status, _, resp = _request(srv, "POST", "/v1/decode?format=npy",
                                   body=_npy_bytes(nchw))
        assert status == 400 and b"request cap" in resp
        status, _, resp = _request(srv, "POST", "/v1/decode?format=npy",
                                   body=_npy_bytes(_latent(1, b=3)))
        assert status == 400 and b"batch" in resp
    finally:
        _stop(srv, engine)


def test_http_result_timeout_returns_504(vae):
    engine = ServeEngine(vae, bucket=None)
    gate = threading.Event()
    _slow(engine, gate)
    srv = _serve(engine, request_timeout_s=0.3)
    try:
        status, headers, resp = _request(srv, "POST",
                                         "/v1/decode?format=npy",
                                         body=_npy_bytes(_latent(1)))
        assert status == 504, resp
        assert b"timed out" in resp and headers["Retry-After"] == "1"
    finally:
        gate.set()
        _stop(srv, engine)


def test_http_queue_full_returns_503(vae):
    engine = ServeEngine(vae, bucket=None, max_pending=1)
    gate = threading.Event()
    _slow(engine, gate)
    srv = _serve(engine)
    try:
        first = engine.submit(_latent(1))
        time.sleep(0.05)
        queued = engine.submit(_latent(2))    # fills the queue
        status, headers, resp = _request(srv, "POST",
                                         "/v1/decode?format=npy",
                                         body=_npy_bytes(_latent(3)))
        assert status == 503 and headers["Retry-After"] == "1", resp
        gate.set()
        first.result(30)
        queued.result(30)
    finally:
        gate.set()
        _stop(srv, engine)
    srv = _serve(engine)        # over the closed engine: shutting down
    try:
        status, _, resp = _request(srv, "POST", "/v1/decode?format=npy",
                                   body=_npy_bytes(_latent(3)))
        assert status == 503 and b"closed" in resp
    finally:
        _stop(srv, engine)


def test_http_decode_failure_returns_500(vae, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(engine_mod, "hdr_decode", broken)
    engine = ServeEngine(vae, bucket=None)
    srv = _serve(engine)
    try:
        status, _, resp = _request(srv, "POST", "/v1/decode?format=npy",
                                   body=_npy_bytes(_latent(1)))
        assert status == 500 and b"launch failed" in resp
    finally:
        _stop(srv, engine)


def test_http_16bit_exr_uses_half_fetch(server, vae, tmp_path, monkeypatch):
    """A 16-bit EXR response fetches float16 from the engine and reads
    back as the float32 decode rounded to half."""
    dtypes = []
    real = server.engine.submit
    monkeypatch.setattr(server.engine, "submit", lambda *a, **kw: (
        dtypes.append(kw.get("fetch_dtype")) or real(*a, **kw)))
    z = _latent(1)
    status, _, body = _request(server, "POST",
                               "/v1/decode?format=exr&bit_depth=16bit",
                               body=_npy_bytes(z))
    assert status == 200, body
    assert dtypes == [np.float16]
    p = tmp_path / "h.exr"
    p.write_bytes(body)
    want = _direct(vae, z).image.numpy()[0].astype(np.float16)
    np.testing.assert_array_equal(read_exr(str(p)), want.astype(np.float32))


# ---------------------------------------------------------------------------
# The CLI, and the import boundary
# ---------------------------------------------------------------------------


def test_cli_serve_parser_matches_jax():
    """`serve`'s options and defaults are the JAX CLI's, with --device
    (default: the card) and --mesh, and with --bucket omitted meaning the
    engine's default (JAX's 64 bypasses its engine's mesh default)."""
    from hdrvae.cli.main import build_parser as jparser
    from hdrvae_torch.cli.main import _parse_precision, build_parser
    got = vars(build_parser().parse_args(["serve"]))
    want = vars(jparser().parse_args(["serve"]))
    for d in (got, want):
        d.pop("func")
    assert got.pop("device") == "cuda"
    assert got.pop("mesh") is None
    assert got.pop("bucket") is None and want.pop("bucket") == 64
    assert got == want
    args = build_parser().parse_args(["serve", "--parity"])
    assert _parse_precision(args) == Precision.parity()
    args = build_parser().parse_args(["serve", "--precision", "mixed"])
    assert _parse_precision(args) == Precision.mixed()
    with pytest.raises(SystemExit):
        _parse_precision(build_parser().parse_args(
            ["serve", "--parity", "--precision", "mixed"]))
    args = build_parser().parse_args(["serve", "--sharded", "--mesh", "2",
                                      "--bucket", "0"])
    assert (args.sharded, args.mesh, args.bucket) == (True, 2, 0)


def test_served_path_never_imports_jax(tmp_path):
    """A fresh interpreter serves one HTTP request on the CPU through the
    CLI's parser, the VAE handle, the engine and the front end, and exports
    the image, without JAX or the JAX package entering sys.modules."""
    code = (
        "import sys, io, json, threading, http.client, numpy as np\n"
        "from hdrvae_torch.api.vae import VAE\n"
        "from hdrvae_torch.cli.main import build_parser\n"
        "from hdrvae_torch.core.config import DecoderConfig, ExportConfig\n"
        "from hdrvae_torch.io.export import export_linear\n"
        "from hdrvae_torch.serve.engine import ServeEngine\n"
        "from hdrvae_torch.serve.http import make_server\n"
        "build_parser().parse_args(['serve', '--device', 'cpu'])\n"
        "vae = VAE.random_init(0, DecoderConfig().with_small(), "
        "device='cpu')\n"
        "eng = ServeEngine(vae, bucket=4)\n"
        "srv = make_server(eng, port=0)\n"
        "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "buf = io.BytesIO(); np.save(buf, np.zeros((5, 6, 4), np.float32))\n"
        "c = http.client.HTTPConnection('127.0.0.1', srv.server_address[1])\n"
        "c.request('POST', '/v1/decode?format=npy', body=buf.getvalue())\n"
        "r = c.getresponse(); img = np.load(io.BytesIO(r.read()))\n"
        "assert r.status == 200 and img.shape == (1, 10, 12, 3)\n"
        "res = export_linear(img, ExportConfig(), "
        f"default_output_dir={str(tmp_path)!r})\n"
        "assert res.error is None and res.verified, res.error\n"
        "srv.shutdown(); srv.server_close(); eng.close()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'hdrvae' or m.startswith('hdrvae.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_engine_over_cuda_vae_needs_the_card(weights):
    """An engine takes its device from the VAE handle and runs nothing
    elsewhere: without a card, one over a CUDA handle cannot start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    class _CudaVAE:
        config = DecoderConfig().with_small()
        precision = Precision.fast()
        device = torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        ServeEngine(_CudaVAE())
