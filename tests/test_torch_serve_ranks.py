"""Serving across ranks (``serve/ranks.py``, ``ServeEngine(mesh=)``,
``cli serve --sharded``) against the JAX package's mesh engine.

- One ``multihost.RankGroup`` of 2 gloo ranks on the CPU for the module
  runs the scripted ``ServeCase`` engines and the direct
  ``sharded_slab_decode`` of the same latents by the same ranks; the JAX
  references (``ServeEngine(mesh=make_mesh(num_devices=2))``) are computed
  while the ranks run.
- A second group with a short timeout holds an idle follower; the CLI runs
  as a subprocess, once to serve and stop, once with a follower killed.

Bounds, as ``tests/test_torch_sharding.py``'s: the conservative image
max-abs 1e-4 in parity and 1e-3 in mixed against JAX's; the pre-map
statistics 1e-4 relative to max(|ref|, 1); the flags equal.  Rank 0's
response against the same ranks' direct slab decode: bit-equal.  Every
wait has its own timeout, so a deadlock fails one test.

Weights: the JAX decoder's ``init_decoder(PRNGKey(0), with_small())``
carried across with ``state_dict_from_jax``; latents from numpy seeds.
"""

import dataclasses
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.api.vae import VAE as JVAE
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.decode.pipeline import hdr_decode as jhdr_decode
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.serve.engine import ServeEngine as JServeEngine
from hdrvae.sharding.mesh import make_mesh
from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        infer_decoder_config, init_decoder,
                                        state_dict_from_jax)
from hdrvae_torch.serve.engine import ServeEngine
from hdrvae_torch.sharding import mesh as tmesh
from hdrvae_torch.sharding import multihost

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
CONS = HDRDecodeConfig(hdr_mode="conservative")
JCONS = JHDRDecodeConfig(hdr_mode="conservative")
TIERS = {"parity": (Precision.parity(), JPrecision.parity(), 1e-4),
         "mixed": (Precision.mixed(), JPrecision.mixed(), 1e-3)}
WAIT_S = 120          # any one wait of this file
IDLE_TIMEOUT_S = 3.0  # the idle group's timeout


def _latent(seed, h, w, zc=4):
    return (np.random.default_rng(seed).standard_normal((1, h, w, zc))
            .astype(np.float32) * 2)


A, B = _latent(1, 16, 16), _latent(2, 12, 20)
OFF = {(13, 11): _latent(4, 13, 11), (10, 14): _latent(5, 10, 14)}
BAD = _latent(3, 8, 8, zc=3)            # no 4-channel axis
FIRST3 = HDRDecodeConfig(hdr_mode="conservative", fallback_collapse="first3")


@pytest.fixture(scope="module")
def weights():
    jcfg = JDecoderConfig().with_small()
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = DecoderConfig().with_small()
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, params, cfg, sd


def _t(a):
    return torch.from_numpy(a)


def _cases():
    """The module's job: the direct slab decodes, then one engine a case
    (each closes before the next starts)."""
    S, R = multihost.SlabCase, multihost.ServeRequest
    par, mix = Precision.parity(), Precision.mixed()
    return [
        S("direct parity A", "small", _t(A), CONS, par),
        S("direct parity B", "small", _t(B), CONS, par),
        S("direct first3 B", "small", _t(B), FIRST3, par),
        S("direct mixed A", "small", _t(A), CONS, mix),
        S("direct mixed B", "small", _t(B), CONS, mix),
        S("direct bucket", "small", _t(OFF[(13, 11)]), CONS, par,
          pad_to=(16, 16)),
        S("profiled", "small", _t(A), CONS, par, profile=True),
        # two clients, interleaved shapes, modes and layouts; request 4
        # fails validation on rank 0; first3 changes the stitch's
        # collective, so it fails unless the followers got the settings
        multihost.ServeCase("parity", "small", [
            R(A, CONS), R(B, CONS),
            R(A, HDRDecodeConfig(hdr_mode="mathematical_recovery")),
            R(B, FIRST3), R(BAD, CONS),
            R(np.ascontiguousarray(B.transpose(0, 3, 1, 2)), CONS)],
            par),
        multihost.ServeCase("mixed", "small", [R(A, CONS), R(B, CONS)], mix),
        multihost.ServeCase("bucket", "small",
                            [R(z, CONS) for z in OFF.values()], par,
                            bucket=16),
        # one client: the second request expires while the first decodes
        multihost.ServeCase("deadline", "small", [
            R(A, CONS), R(B, CONS, deadline_s=1e-3), R(A, CONS)], par,
            threads=1),
        multihost.ServeCase("weights", "small", [R(A, CONS)],
                            follower_decoder="other"),
        multihost.ServeCase("after refusal", "small", [R(B, CONS)], par),
    ]


class _Ranks:
    """The module's rank group and its records by case name (rank 0
    first), fetched on first use."""

    def __init__(self, group):
        self.group = group
        self._records = None

    def __call__(self, name):
        if self._records is None:
            ranks = self.group.wait(timeout=WAIT_S)
            self._records = {rec["name"]: [r[i] for r in ranks]
                             for i, rec in enumerate(ranks[0])}
        return self._records[name]


@pytest.fixture(scope="module")
def ranks(weights):
    _, _, cfg, sd = weights
    other = init_decoder(cfg, seed=5, device="cpu").state_dict()
    group = multihost.RankGroup(
        RANKS, {"small": (cfg, sd), "other": (cfg, other)}, _cases(),
        device="cpu")
    with group:
        yield _Ranks(group)


def _jax_engine(weights, tier, **kw):
    jcfg, params, _, _ = weights
    return JServeEngine(JVAE(params=params, config=jcfg,
                             precision=TIERS[tier][1]),
                        hdr_cfg=JCONS, mesh=make_mesh(num_devices=RANKS),
                        **kw)


def _close_to_jax(got, ref, bound, label):
    img = got["image"].numpy()
    assert img.shape == ref.image.shape, label
    err = np.abs(img - ref.image).max()
    assert err <= bound, f"{label}: image {err:.3e} > {bound}"
    for key in ("normalization", "used_fallback"):
        assert got["summary"][key] == ref.summary[key], (label, key)
    for stat, want in ref.summary["pre"].items():
        assert abs(got["summary"]["pre"][stat] - want) <= 1e-4 * max(
            abs(want), 1.0), (label, stat, got["summary"]["pre"][stat], want)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_served_matches_jax_mesh_engine(weights, ranks, tier):
    """Rank 0's responses of the rank-group engine against the JAX mesh
    engine's on a 2-device CPU mesh (the counterpart of
    ``tests/test_serve.py::test_engine_mesh_matches_single_device``)."""
    with _jax_engine(weights, tier) as je:
        refs = [je.decode_sync(z) for z in (A, B)]
    got = ranks(tier)[0]["responses"]
    for i, ref in enumerate(refs):
        assert got[i]["ok"], got[i]
        assert got[i]["padded_hw"] == ref.padded_hw
        _close_to_jax(got[i], ref, TIERS[tier][2], f"{tier} {i}")


@pytest.mark.parametrize("case,index,direct", [
    ("parity", 0, "direct parity A"), ("parity", 1, "direct parity B"),
    ("parity", 3, "direct first3 B"), ("parity", 5, "direct parity B"),
    ("mixed", 0, "direct mixed A"), ("mixed", 1, "direct mixed B"),
    ("bucket", 0, "direct bucket")])
def test_served_bit_equal_to_direct_slab(ranks, case, index, direct):
    """A served response is the same ranks' direct ``sharded_slab_decode``
    of its latent, bit for bit (the NCHW request included)."""
    got = ranks(case)[0]["responses"][index]
    want = ranks(direct)
    assert got["ok"], got
    assert all(r["digest"] == want[0]["digest"] for r in want)
    assert got["digest"] == want[0]["digest"]
    assert torch.equal(got["image"], want[0]["image"])


def test_mesh_buckets_match_jax(weights, ranks):
    """With bucket 16, latents (13, 11) and (10, 14) snap to (16, 16) and
    decode padded (``pad_to``), as the JAX mesh engine's
    (``tests/test_serve.py::test_engine_mesh_buckets``)."""
    with _jax_engine(weights, "parity", bucket=16) as je:
        refs = [je.decode_sync(z) for z in OFF.values()]
        jstats = je.stats()
    rec = ranks("bucket")[0]
    for i, ref in enumerate(refs):
        got = rec["responses"][i]
        assert got["ok"], got
        assert got["padded_hw"] == ref.padded_hw == (16, 16)
        _close_to_jax(got, ref, TIERS["parity"][2], f"bucket {i}")
    assert rec["stats"]["compiled_latent_shapes"] \
        == jstats["compiled_latent_shapes"] == {"16x16": 2}


def test_mesh_engine_buckets_nothing_by_default(weights, ranks):
    """Without a bucket argument a mesh engine buckets nothing, as the JAX
    engine's sentinel default; the one-device default stays 64."""
    with _jax_engine(weights, "parity") as je:
        jhw = je.decode_sync(B).padded_hw
    rec = ranks("parity")[0]
    assert rec["responses"][1]["padded_hw"] == jhw == (12, 20)
    assert rec["stats"]["compiled_latent_shapes"] == {"12x20": 3,
                                                      "16x16": 2}
    vae = VAE(decoder_from_state_dict(weights[3], weights[2], device="cpu"),
              Precision.parity())
    with ServeEngine(vae) as engine:
        assert engine.decode_sync(B).padded_hw == (64, 64)


def test_interleaved_clients_keep_the_ranks_in_step(ranks):
    """Two client threads submit interleaved shapes, modes, layouts and a
    first3 collapse; each valid request is decoded once on every rank, and
    the follower stops with the engine."""
    rank0, rank1 = ranks("parity")
    ok = [r["ok"] for r in rank0["responses"]]
    assert ok == [True, True, True, True, False, True]
    # the mode override reached the epilogue: the same latent, another
    # image
    assert not torch.equal(rank0["responses"][2]["image"],
                           rank0["responses"][0]["image"])
    assert rank0["stats"]["requests"] == 5
    assert rank0["stats"]["errors"] == 1
    assert rank1["served"] == 5 and "refused" not in rank1


def test_invalid_request_fails_on_rank0_alone(ranks):
    """A latent without the decoder's channel axis fails validation on
    rank 0, is never sent, and the request after it still succeeds."""
    rank0, rank1 = ranks("parity")
    bad = rank0["responses"][4]
    assert bad["error"].startswith("ValueError") and "4-channel" in \
        bad["error"]
    assert rank0["responses"][5]["ok"]
    assert rank1["served"] == sum(r["ok"] for r in rank0["responses"])


def test_deadline_expired_request_never_sent(ranks):
    """A request whose deadline expires while it is queued fails with
    TimeoutError on rank 0 and never reaches the follower."""
    rank0, rank1 = ranks("deadline")
    assert [r["ok"] for r in rank0["responses"]] == [True, False, True]
    assert rank0["responses"][1]["error"].startswith("TimeoutError")
    assert rank1["served"] == 2


def test_mismatched_weights_refused(ranks):
    """Ranks that hold different weights refuse to serve, every one of
    them, and the group serves the next engine."""
    rank0, rank1 = ranks("weights")
    assert "rank(s) [1]" in rank0["refused"]
    assert "rank(s) [0]" in rank1["refused"]
    assert "responses" not in rank0
    after = ranks("after refusal")
    assert after[0]["responses"][0]["ok"] and after[1]["served"] == 1


def test_close_stops_every_rank(ranks):
    """Every engine's close sent STOP: every follower returned from each
    case in turn and both ranks exited 0 (``wait`` raises otherwise)."""
    for name in ("parity", "mixed", "bucket", "deadline", "after refusal"):
        rank0, rank1 = ranks(name)
        assert rank0["rank"] == 0 and rank1["rank"] == 1
        assert rank1["backend"] == "gloo" and rank1["world_size"] == RANKS
        assert rank1["served"] == rank0["stats"]["requests"], name


def test_profiled_slab_case_records_kernels_and_collectives(ranks):
    """A profiled ``SlabCase`` on each rank: at most five sorted (name,
    count, ms) op rows (the CPU's ops here), the time of all of them, and
    the collectives' rows (gloo's all-reduces and the stitch's
    all-gather, each timed with its wait); the image is the unprofiled
    one's."""
    for rec, plain in zip(ranks("profiled"), ranks("direct parity A")):
        top = rec["top"]
        assert 1 <= len(top) <= 5
        assert [ms for _, _, ms in top] == sorted(
            (ms for _, _, ms in top), reverse=True)
        assert rec["kernel_ms"] >= sum(ms for _, _, ms in top) > 0
        names = {name: n for name, n, _ in rec["collectives"]}
        assert names.get("gloo:all_reduce", 0) > 0
        assert names.get("gloo:all_gather", 0) >= 1
        assert [ms for _, _, ms in rec["collectives"]] == sorted(
            (ms for _, _, ms in rec["collectives"]), reverse=True)
        assert rec["digest"] == plain["digest"]


def test_idle_follower_outlives_group_timeout(weights):
    """A group whose collectives time out after IDLE_TIMEOUT_S: the engine
    idles for twice that, its heartbeats keep the follower's wait short,
    and the next request is served."""
    _, _, cfg, sd = weights
    R = multihost.ServeRequest
    case = multihost.ServeCase(
        "idle", "small", [R(A, CONS), R(B, CONS, after_s=2 * IDLE_TIMEOUT_S)],
        Precision.parity(), threads=1)
    with multihost.RankGroup(RANKS, {"small": (cfg, sd)}, [case],
                             device="cpu", timeout_s=IDLE_TIMEOUT_S) as group:
        (rank0,), (rank1,) = group.wait(timeout=WAIT_S)
    assert [r["ok"] for r in rank0["responses"]] == [True, True]
    assert rank1["served"] == 2
    # one heartbeat every IDLE_TIMEOUT_S / 4 of the idle 2 * IDLE_TIMEOUT_S
    assert rank1["heartbeats"] >= 4


def test_one_rank_mesh_engine(weights):
    """A one-rank mesh without a process group: the engine serves the slab
    decode (the whole image) and refuses, before anything is sent, an
    empty latent, an unknown mode and a bucketed chain; the next request
    still succeeds."""
    _, _, cfg, sd = weights
    dec = decoder_from_state_dict(sd, cfg, device="cpu")
    chain = Precision(compute_dtype=torch.float32,
                      storage_dtype=torch.float32, mode="fast",
                      upstack="pallas")
    mesh = tmesh.Mesh("cpu")
    with ServeEngine(VAE(dec, Precision.parity()), mesh=mesh,
                     hdr_cfg=CONS) as engine:
        assert engine.mesh is mesh and engine.healthy
        with pytest.raises(ValueError, match="empty"):
            engine.submit(np.zeros((1, 0, 4, 4), np.float32)).result(WAIT_S)
        with pytest.raises(ValueError, match="hdr_mode"):
            engine.submit(A, HDRDecodeConfig(hdr_mode="nope")).result(WAIT_S)
        got = engine.submit(A).result(WAIT_S)
    want = tmesh.sharded_slab_decode(dec, _t(A), CONS, mesh=mesh,
                                     precision=Precision.parity())
    np.testing.assert_array_equal(got.image, want.image.numpy())
    with ServeEngine(VAE(dec, chain), mesh=mesh, bucket=16) as engine:
        with pytest.raises(ValueError, match="pallas"):
            engine.submit(OFF[(13, 11)]).result(WAIT_S)
        assert engine.submit(_latent(6, 16, 16)).result(WAIT_S).padded_hw \
            == (16, 16)


# ---------------------------------------------------------------------------
# cli serve --sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    from safetensors.torch import save_file
    path = tmp_path_factory.mktemp("vae") / "ae.safetensors"
    save_file({"decoder." + k: v.contiguous()
               for k, v in weights[3].items()}, str(path))
    return str(path)


class _Server:
    """``cli serve --sharded --mesh 2 --device cpu`` as a subprocess: its
    port and the other ranks' process ids from its first two lines."""

    def __init__(self, checkpoint, cwd, *extra):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hdrvae_torch.cli.main", "serve",
             "--sharded", "--mesh", str(RANKS), "--device", "cpu",
             "--port", "0", "--vae", checkpoint, "--precision", "parity",
             *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=REPO), cwd=cwd)
        self.lines = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        deadline = time.monotonic() + WAIT_S
        while len(self.lines) < 2:
            assert time.monotonic() < deadline and self.proc.poll() is None, \
                f"cli serve did not start: {self.lines}"
            time.sleep(0.05)
        self.group, serving = (json.loads(x) for x in self.lines[:2])
        self.port = int(serving["serving"].rsplit(":", 1)[1])

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=WAIT_S)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def stop(self):
        """SIGTERM; the exit code and standard error."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            _, err = self.proc.communicate(timeout=WAIT_S)
        finally:
            self.proc.kill()
        return self.proc.returncode, err

    def ranks_alive(self):
        alive = []
        for pid in self.group["pids"]:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        return alive


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_cli_serve_sharded_http(weights, checkpoint, tmp_path):
    """``serve --sharded --mesh 2 --bucket 16``: two POSTs, each within
    1e-3 relative of the JAX ``hdr_decode`` of its latent (as
    ``tests/test_serve.py::test_http_mesh_bucketed_serving``; JAX's
    config the one the checkpoint's loader infers), /healthz with the
    group's size, and after SIGTERM every rank gone."""
    _, params, _, sd = weights
    jcfg = JDecoderConfig(**dataclasses.asdict(infer_decoder_config(sd)))
    srv = _Server(checkpoint, str(tmp_path), "--bucket", "16", "--mode",
                  "conservative")
    try:
        assert srv.group["ranks"] == RANKS and srv.group["backend"] == "gloo"
        for z in OFF.values():
            status, body = srv.request("POST", "/v1/decode?format=npy",
                                       _npy(z))
            assert status == 200, body[:300]
            img = np.load(io.BytesIO(body))
            ref = np.asarray(jhdr_decode(params, jnp.asarray(z), jcfg, JCONS,
                                         precision=JPrecision.parity()).image)
            err = np.abs(img - ref).max() / max(1.0, float(np.abs(ref).max()))
            assert err < 1e-3, f"cli serve --sharded error {err:.2e}"
        status, body = srv.request("GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ok"] is True
        assert health["device_count"] == RANKS
        status, body = srv.request("GET", "/v1/stats")
        assert json.loads(body)["compiled_latent_shapes"] == {"16x16": 2}
    finally:
        code, err = srv.stop()
    assert code == 0, err[-2000:]
    assert "served 2" in err
    assert srv.ranks_alive() == []


def test_killed_follower_fails_requests_and_health(checkpoint, tmp_path):
    """A follower killed while the server runs: requests in flight and
    queued behind them fail with 5xx within a bounded time, /healthz turns
    false (503), and SIGTERM then ends the server (non-zero) with no rank
    left."""
    srv = _Server(checkpoint, str(tmp_path), "--mode", "conservative")
    try:
        status, _ = srv.request("POST", "/v1/decode?format=npy", _npy(A))
        assert status == 200
        os.kill(srv.group["pids"][0], signal.SIGKILL)
        statuses = [None] * 3

        def post(i):
            statuses[i] = srv.request("POST", "/v1/decode?format=npy",
                                      _npy(B))[0]

        t0 = time.monotonic()
        clients = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(WAIT_S)
            assert not t.is_alive()
        assert time.monotonic() - t0 < WAIT_S
        assert all(s in (500, 503) for s in statuses), statuses
        status, body = srv.request("GET", "/healthz")
        assert status == 503 and json.loads(body)["ok"] is False
    finally:
        code, err = srv.stop()
    assert code != 0 and "the rank group broke" in err, err[-2000:]
    assert srv.ranks_alive() == []

