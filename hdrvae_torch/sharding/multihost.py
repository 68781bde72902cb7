"""Process groups for the sharded decode, upscale and serving, as
``hdrvae/sharding/multihost.py``.

The JAX package runs one program over a global device mesh; the port runs
one process a rank, joined by ``torch.distributed``.  Each rank needs three
things: :func:`initialize` the process group (an explicit backend: NCCL
where every rank has a card of its own, gloo where ranks share one card or
run on the CPU; an explicit timeout on every collective), the same weights
and the same input.  Then the executors of ``sharding/mesh.py`` run
unchanged on every rank.

:class:`RankGroup` starts N real OS processes on this host (the worker is
``python -m hdrvae_torch.sharding.multihost JOB_DIR RANK``), each running
every case of one job, in order, and returns each rank's records with its
kernel launch counts.  The cases: :class:`SlabCase`
(``sharded_slab_decode``), :class:`TiledCase` (``sharded_tiled_decode``),
:class:`UpscaleCase` (``sharded_hdr_upscale``), :class:`CommandCase`
(a CLI command's work on the ranks, ``cli/main.py``) and
:class:`ServeCase` (a ``ServeEngine(mesh=)`` on rank 0 serving scripted
requests, ``serve/ranks.py::follow`` on the others).  With ``lead=True``
the calling process is rank 0 (:meth:`RankGroup.join`) and the group
starts the others, as ``cli serve --sharded`` does.  The launcher writes
the decoders' state dicts, the upscalers' state dicts with their zoo
families, and the inputs once, into a temporary job directory, and each
rank loads them onto its own device, then waits for every rank to be
ready before it joins the group, so that the group's timeout need not
cover a rank's start.  The ranks meet through a ``file://`` store in that
directory, so concurrent launchers never contend for a port.  With
``device="cuda"`` the CUDA library is built in the launcher before any
rank starts, so ranks never race ``nvcc``.  A rank that fails or outlives
the timeout fails the whole group: every rank is killed and
:meth:`RankGroup.wait` raises.

:func:`launch_localhost_dryrun` is the no-cluster check of JAX's dryrun: a
small decoder decoded across N processes, which must agree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      MeshConfig, Precision, UpscaleConfig)

_REPO = Path(__file__).resolve().parent.parent.parent

# The longest one collective may wait for the other ranks before it fails
# (gloo's default is 30 minutes).
GROUP_TIMEOUT_S = 300.0


def pick_backend(device: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (ranks on the
    CPU, or sharing a card: NCCL refuses two ranks on one device).  The
    NCCL route has run with one rank on one card
    (``tests/test_torch_cuda.py::test_slab_decode_one_rank_nccl``), never
    with several cards."""
    if device == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(init_method: str, world_size: int, rank: int,
               backend: str, timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join the process group: call before any collective, with the same
    ``init_method`` (``tcp://host:port`` or ``file://path``) on every
    rank.  A collective that waits longer than ``timeout_s`` for the
    other ranks fails."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass
class SlabCase:
    """One ``sharded_slab_decode`` every rank runs: ``decoder`` names one
    of the job's decoders; the last of ``requests`` is the one timed and
    counted (the earlier ones warm the libraries up).  With ``profile``
    each request runs under ``torch.profiler`` and the record holds the
    top 5 kernels of the last by device time ("top"), the time of all its
    kernels ("kernel_ms") and its collectives' rows ("collectives",
    ``utils.profiling.collective_rows``): its times are the profiled
    ones."""

    name: str
    decoder: str
    latent: torch.Tensor                  # on the CPU
    cfg: HDRDecodeConfig = HDRDecodeConfig()
    precision: Precision = Precision()
    tail_levels: Optional[int] = None
    pad_to: Optional[Tuple[int, int]] = None
    requests: int = 1
    profile: bool = False     # each request under torch.profiler


@dataclasses.dataclass
class TiledCase:
    """One ``sharded_tiled_decode`` every rank runs, as :class:`SlabCase`
    (``profile`` too); rank 0's record holds the image, every record its
    digest."""

    name: str
    decoder: str
    latent: torch.Tensor                  # on the CPU
    cfg: HDRDecodeConfig = HDRDecodeConfig()
    precision: Precision = Precision()
    latent_tile: int = 64
    latent_overlap: int = 8
    norm_stats: str = "global"
    requests: int = 1
    profile: bool = False     # each request under torch.profiler


@dataclasses.dataclass
class UpscaleCase:
    """One ``sharded_hdr_upscale`` every rank runs: ``model`` names one of
    the job's upscalers (its zoo family picks the reversal); rank 0's
    record holds the image, every record its digest."""

    name: str
    model: str
    image: torch.Tensor                   # [B, H, W, 3] on the CPU
    cfg: UpscaleConfig = UpscaleConfig()
    precision: Precision = Precision()
    requests: int = 1


@dataclasses.dataclass
class CommandCase:
    """A CLI command's work on every rank (``cli.main.run_on_rank``):
    ``command`` "decode" or "upscale", ``args`` its parsed arguments,
    ``data`` the latent or image, ``model`` the job's decoder or upscaler.
    Rank 0 alone writes the files; its record holds the lines it
    printed."""

    name: str
    command: str
    args: Dict[str, Any]
    data: torch.Tensor
    model: str
    requests: int = 1


@dataclasses.dataclass
class ServeRequest:
    """One request of a :class:`ServeCase`: its client waits ``after_s``
    seconds, then submits ``latent`` with ``cfg`` (None: the engine's)
    and ``deadline_s`` (None: none)."""

    latent: Any                           # a CPU tensor or numpy array
    cfg: Optional[HDRDecodeConfig] = None
    deadline_s: Optional[float] = None
    after_s: float = 0.0


@dataclasses.dataclass
class ServeCase:
    """A ``ServeEngine(mesh=)`` on rank 0 (``decoder``, ``precision``,
    ``bucket``: "default" for the engine's own, ``depth``) that warms up on
    ``warmup``'s latent shapes, then takes ``requests`` from ``threads``
    client threads (thread k submits requests k, k + threads, ... in
    order) and closes, which stops the followers; every other rank runs
    ``serve.ranks.follow`` on ``follower_decoder`` (default: the same
    decoder; another one makes the ranks refuse to serve).  Rank 0's
    record: one entry a request (``ok``, and the image, its digest, the
    summary, ``padded_hw`` and latency, or the error), the engine's
    ``stats()`` and the burst's wall seconds; a follower's: its requests
    served and heartbeats.  A refusal is recorded on every rank as
    ``refused``.  The case runs once: an engine's lifetime."""

    name: str
    decoder: str
    submits: List[ServeRequest] = dataclasses.field(default_factory=list)
    precision: Precision = Precision()
    bucket: Union[str, int, None] = "default"
    depth: int = 2
    threads: int = 2
    warmup: Tuple[Tuple[int, int], ...] = ()
    follower_decoder: Optional[str] = None


def _wrappers():
    """The kernel wrappers the sharded paths can launch."""
    from hdrvae_torch.kernels import (attention, conv3x3, dense_conv,
                                      epilogue, ocab, swin_attention)
    return (conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
            conv3x3.upconv_gn_conv3x3, attention.flash_attention_bf16,
            attention.flash_attention_3pass, attention.flash_attention_f32,
            attention.split_qkv, epilogue.collapse_and_stats_fused,
            dense_conv.dense_conv3x3, swin_attention.swin_block_fused,
            ocab.ocab_attention)


_COUNTERS = ("launches", "launches_masked", "stats_only_launches",
             "owned_launches")


def kernel_counts() -> Dict[str, int]:
    """Every launch counter of the sharded paths' kernels, as
    ``{"<wrapper>.<counter>": n}``."""
    return {f"{fn.__name__}.{c}": getattr(fn, c) for fn in _wrappers()
            for c in _COUNTERS if hasattr(fn, c)}


def reset_kernel_counts() -> None:
    for fn in _wrappers():
        for c in _COUNTERS:
            if hasattr(fn, c):
                setattr(fn, c, 0)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's dtype, shape and bytes: equal on two ranks iff
    their tensors are bit-equal."""
    t = t.detach().cpu().contiguous()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _timed(fn, cuda: bool) -> Tuple[Any, dict]:
    """``fn()`` once with the launch counters reset before it: its result
    and a record of the launches it made, its wall ms and (on a card)
    device ms and peak bytes."""
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        end.record()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return out, {
        "counts": kernel_counts(), "wall_ms": wall_ms,
        "device_ms": start.elapsed_time(end) if cuda else None,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def _measured(fn, cuda: bool, profile: bool) -> Tuple[Any, dict]:
    """:func:`_timed`, under ``torch.profiler`` with ``profile``: then the
    record also holds the top 5 kernels by device time ("top"), all
    kernels' time ("kernel_ms") and the collectives ("collectives")."""
    if not profile:
        return _timed(fn, cuda)
    from hdrvae_torch.utils.profiling import collective_rows, kernel_rows
    with torch.profiler.profile() as prof:
        out, rec = _timed(fn, cuda)
    rows = kernel_rows(prof, top=None)
    return out, {**rec, "top": rows[:5],
                 "kernel_ms": sum(ms for _, _, ms in rows),
                 "collectives": collective_rows(prof)}


def _serve(case: ServeCase, models: dict, mesh, rank: int,
           heartbeat_s: float) -> dict:
    """One :class:`ServeCase` on this rank: its record (less the
    counts)."""
    from hdrvae_torch.serve import ranks
    if rank > 0:
        try:
            return ranks.follow(models[case.follower_decoder or case.decoder],
                                mesh)
        except ranks.WeightsDiffer as e:
            return {"refused": str(e)}
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.serve.engine import ServeEngine
    kw = {} if case.bucket == "default" else {"bucket": case.bucket}
    try:
        engine = ServeEngine(VAE(models[case.decoder], case.precision),
                             mesh=mesh, depth=case.depth,
                             heartbeat_s=heartbeat_s, **kw)
    except ranks.WeightsDiffer as e:
        return {"refused": str(e)}
    n = len(case.submits)
    futures: List[Any] = [None] * n

    def client(k: int) -> None:
        for i in range(k, n, case.threads):
            req = case.submits[i]
            time.sleep(req.after_s)
            try:
                futures[i] = engine.submit(req.latent, req.cfg,
                                           deadline_s=req.deadline_s)
            except Exception as e:     # refused at submit: recorded
                futures[i] = e

    with engine:
        engine.warmup(list(case.warmup))
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(case.threads)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        results = []
        for f in futures:
            try:
                if isinstance(f, Exception):
                    raise f
                results.append(f.result())
            except Exception as e:
                results.append(e)
        burst_s = time.perf_counter() - t0
        stats = engine.stats()
    responses = []
    for r in results:
        if isinstance(r, Exception):
            responses.append({"ok": False,
                              "error": f"{type(r).__name__}: {r}"})
            continue
        image = torch.from_numpy(r.image)
        responses.append({"ok": True, "image": image, "digest": digest(image),
                          "summary": r.summary, "padded_hw": r.padded_hw,
                          "latency_s": r.latency_s})
    return {"responses": responses, "stats": stats, "burst_s": burst_s}


def _decode_record(res, name: str, rank: int, full: bool) -> dict:
    """A decode result's record: the summary and the image's digest; the
    image and the standard decode on every rank with ``full``, else on rank
    0 alone."""
    from hdrvae_torch.decode.pipeline import decode_summary
    keep = full or rank == 0
    return {"name": name, "summary": decode_summary(res),
            "digest": digest(res.image),
            "image": res.image.cpu() if keep else None,
            "standard": (None if res.standard is None or not keep
                         else res.standard.cpu())}


def _run_case(case, models: dict, mesh, rank: int, cuda: bool,
              timeout_s: float = GROUP_TIMEOUT_S) -> dict:
    """One timed request of ``case`` on this rank: its record."""
    from hdrvae_torch.sharding import mesh as shard
    if isinstance(case, SlabCase):
        z = case.latent.to(mesh.device)
        res, rec = _measured(lambda: shard.sharded_slab_decode(
            models[case.decoder], z, case.cfg, mesh=mesh,
            tail_levels=case.tail_levels, pad_to=case.pad_to,
            precision=case.precision), cuda, case.profile)
        return {**_decode_record(res, case.name, rank, True), **rec}
    if isinstance(case, TiledCase):
        z = case.latent.to(mesh.device)
        res, rec = _measured(lambda: shard._tiled_result(
            models[case.decoder], z, case.cfg, mesh, case.latent_tile,
            case.latent_overlap, case.norm_stats, case.precision), cuda,
            case.profile)
        return {**_decode_record(res, case.name, rank, False), **rec}
    if isinstance(case, ServeCase):
        # the heartbeat well inside the group's timeout
        out, rec = _timed(lambda: _serve(case, models, mesh, rank,
                                         timeout_s / 4), cuda)
        return {"name": case.name, **out, **rec}
    if isinstance(case, UpscaleCase):
        net, arch = models[case.model]
        image = case.image.to(mesh.device)
        res, rec = _timed(lambda: shard.sharded_hdr_upscale(
            net, image, case.cfg, architecture=arch, mesh=mesh,
            precision=case.precision), cuda)
        return {"name": case.name, "digest": digest(res.image),
                "image": res.image.cpu() if rank == 0 else None, **rec}
    from hdrvae_torch.cli.main import run_on_rank
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _, rec = _timed(lambda: run_on_rank(case, models[case.model], mesh),
                        cuda)
    return {"name": case.name, "lines": text.getvalue(), **rec}


def _load_models(job: dict, device: torch.device) -> dict:
    """The job's decoders (by name) and upscalers (by name: the module and
    its architecture name) on ``device``."""
    from hdrvae_torch.models.params import decoder_from_state_dict
    from hdrvae_torch.models.zoo import upscaler_from_state_dict
    models: Dict[str, Any] = {
        name: decoder_from_state_dict(sd, cfg, device=device)
        for name, (cfg, sd) in job["decoders"].items()}
    for name, (family, sd) in job["upscalers"].items():
        net, _, arch = upscaler_from_state_dict(sd, device=device)
        # an ESRGAN checkpoint's module holds RealESRGAN's key schema
        if arch != family and {arch, family} != {"ESRGAN", "RealESRGAN"}:
            raise ValueError(f"upscaler {name!r} written as {family} loads "
                             f"as {arch}")
        models[name] = (net, family)
    return models


def _meet(job_dir: Path, rank: int, world_size: int,
          alive=lambda: None) -> None:
    """Mark this rank ready, then wait until every rank is; ``alive()``
    raises to give up (a rank that died first)."""
    (job_dir / f"ready{rank}").touch()
    while not all((job_dir / f"ready{r}").exists()
                  for r in range(world_size)):
        alive()
        time.sleep(0.02)


def _run_rank(job_dir: Path, rank: int) -> None:
    """Run every case of the job on this rank; save the records."""
    from hdrvae_torch.sharding.mesh import Mesh
    job = torch.load(job_dir / "job.pt", weights_only=False)
    torch.set_num_threads(1)
    cuda = job["device"] == "cuda"
    if cuda:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    models = _load_models(job, device)
    _meet(job_dir, rank, job["world_size"])
    initialize((job_dir / "store").as_uri(), job["world_size"], rank,
               job["backend"], job["timeout_s"])
    try:
        mesh = Mesh(device, MeshConfig(num_devices=job["world_size"]))
        records = []
        for case in job["cases"]:
            for _ in range(getattr(case, "requests", 1)):
                rec = _run_case(case, models, mesh, rank, cuda,
                                job["timeout_s"])
            records.append({**rec, "rank": rank, "device": str(device),
                            "backend": job["backend"],
                            "world_size": job["world_size"]})
        torch.save(records, job_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class RankGroup:
    """N worker processes on this host running one job (module
    docstring): ``decoders`` {name: (config, state dict)}, ``upscalers``
    {name: (zoo family, state dict)}, ``cases`` run in order on every rank
    (in ``cwd``, default the repository), each collective bounded by
    ``timeout_s``.  With ``lead`` the caller is rank 0 (:meth:`join`) and
    the group starts ranks 1 to N - 1.  :meth:`wait` returns the records
    of the ranks it started, in rank order.  Use it as a context manager,
    or call :meth:`close`: every process it started is killed and its job
    directory removed."""

    def __init__(self, num_processes: int,
                 decoders: Dict[str, Tuple[DecoderConfig, dict]],
                 cases: list, *,
                 upscalers: Optional[Dict[str, Tuple[str, dict]]] = None,
                 device: str = "cuda", cwd: Optional[str] = None,
                 timeout_s: float = GROUP_TIMEOUT_S, lead: bool = False):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        if device == "cuda":
            from hdrvae_torch.kernels import _build
            _build.build()
        self.backend = pick_backend(device, num_processes)
        self.world_size, self.timeout_s = num_processes, timeout_s
        self.ranks = list(range(1 if lead else 0, num_processes))
        self.dir = Path(tempfile.mkdtemp(prefix="hdrvae_ranks_"))
        self.procs: List[subprocess.Popen] = []
        torch.save({
            "world_size": num_processes, "backend": self.backend,
            "device": device, "cases": list(cases), "timeout_s": timeout_s,
            "decoders": {name: (cfg, {k: v.detach().cpu()
                                      for k, v in sd.items()})
                         for name, (cfg, sd) in decoders.items()},
            "upscalers": {name: (family, {k: v.detach().cpu()
                                          for k, v in sd.items()})
                          for name, (family, sd) in
                          (upscalers or {}).items()}},
            self.dir / "job.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
        # one CPU thread a rank: ranks on the CPU share its cores
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            env[var] = "1"
        try:
            for rank in self.ranks:
                with open(self.dir / f"rank{rank}.log", "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "hdrvae_torch.sharding.multihost", str(self.dir),
                         str(rank)], env=env, stdout=log,
                        stderr=subprocess.STDOUT, cwd=cwd or _REPO))
        except BaseException:
            self.close()
            raise

    def _log_tail(self, rank: int) -> str:
        return (self.dir / f"rank{rank}.log").read_text()[-3000:]

    def _check_started(self) -> None:
        """Raise ``RuntimeError`` with its log if a started rank exited."""
        for rank, p in zip(self.ranks, self.procs):
            if p.poll() is not None:
                raise RuntimeError(f"rank {rank} exited {p.returncode}:\n"
                                   f"{self._log_tail(rank)}")

    def join(self) -> None:
        """Join the group as rank 0 (made with ``lead=True``), once every
        started rank is ready; raises if one of them exits first."""
        _meet(self.dir, 0, self.world_size, self._check_started)
        initialize((self.dir / "store").as_uri(), self.world_size, 0,
                   self.backend, self.timeout_s)

    def wait(self, timeout: float = 600.0) -> List[List[dict]]:
        """Each started rank's records, once every one has exited 0.  A
        rank that exits non-zero, or a group that outlives ``timeout``
        seconds, kills every rank and raises ``RuntimeError`` with the
        logs' tails."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = dict(zip(self.ranks, (p.poll() for p in self.procs)))
                failed = [r for r, c in codes.items() if c not in (None, 0)]
                if failed:
                    self.kill()
                    raise RuntimeError("ranks failed:\n" + "\n".join(
                        f"rank {r} exited {codes[r]}:\n{self._log_tail(r)}"
                        for r in failed))
                if all(c == 0 for c in codes.values()):
                    break
                if time.monotonic() > deadline:
                    self.kill()
                    raise RuntimeError(
                        f"ranks timed out after {timeout:.0f} s:\n" +
                        "\n".join(f"rank {r}:\n{self._log_tail(r)}"
                                   for r in self.ranks))
                time.sleep(0.05)
            return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                    for r in self.ranks]
        finally:
            self.close()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self) -> None:
        self.kill()
        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch_localhost_dryrun(num_processes: int = 2, *,
                            device: str = "cuda",
                            timeout: float = 600.0) -> List[dict]:
    """A small seeded decoder's parity slab decode of a 16 x 16 latent
    across ``num_processes`` ranks; returns one record a rank (checksum,
    finiteness, world size) after checking that every rank holds the same
    finite image.  The decoder is JAX's dryrun's ``with_small()`` at the
    narrowest widths the card's attention kernels take (64 and 128
    channels, 32 groups)."""
    import numpy as np

    from hdrvae_torch.models.params import init_decoder
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    sd = init_decoder(cfg, seed=0, device="cpu").state_dict()
    latent = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, 16, cfg.z_channels)).astype(np.float32))
    ranks = RankGroup(
        num_processes, {"small": (cfg, sd)},
        [SlabCase("dryrun", "small", latent,
                  precision=Precision.parity())], device=device).wait(timeout)
    records = [{"process": r[0]["rank"], "world_size": r[0]["world_size"],
                "checksum": float(r[0]["image"].double().sum()),
                "finite": bool(torch.isfinite(r[0]["image"]).all())}
               for r in ranks]
    if not all(r["finite"] for r in records):
        raise RuntimeError(f"non-finite decode: {records}")
    if any(not torch.equal(r[0]["image"], ranks[0][0]["image"])
           for r in ranks):
        raise RuntimeError(f"ranks disagree: {records}")
    return records


if __name__ == "__main__":
    # the cases were pickled with this module's classes under its package
    # name; run under that name, so that isinstance sees them
    from hdrvae_torch.sharding import multihost
    multihost._run_rank(Path(sys.argv[1]), int(sys.argv[2]))
