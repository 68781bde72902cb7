"""Process groups for the sharded decode, as ``hdrvae/sharding/multihost.py``.

The JAX package runs one program over a global device mesh; the port runs
one process a rank, joined by ``torch.distributed``.  Each rank needs three
things: :func:`initialize` the process group (an explicit backend: NCCL
where every rank has a card of its own, gloo where ranks share one card or
run on the CPU), the same weights and the same latent.  Then
``sharding.mesh.sharded_slab_decode`` runs unchanged on every rank.

:class:`RankGroup` starts N real OS processes on this host (the worker is
``python -m hdrvae_torch.sharding.multihost JOB_DIR RANK``), each running
every :class:`SlabCase` of one job through ``sharded_slab_decode``, and
returns each rank's results with its kernel launch counts.  The launcher
writes the decoders' state dicts and the latents once, into a temporary
job directory, and each rank loads them onto its own device.  The ranks
meet through a ``file://`` store in that directory, so concurrent
launchers never contend for a port.  With ``device="cuda"`` the CUDA
library is built in the launcher before any rank starts, so ranks never
race ``nvcc``.  A rank that fails or outlives the timeout fails the whole
group: every rank is killed and :meth:`RankGroup.wait` raises.

:func:`launch_localhost_dryrun` is the no-cluster check of JAX's dryrun: a
small decoder decoded across N processes, which must agree.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      MeshConfig, Precision)

_REPO = Path(__file__).resolve().parent.parent.parent


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
               backend: str) -> None:
    """Join the process group: call before any collective, with the same
    ``init_method`` (``tcp://host:port`` or ``file://path``) on every
    rank."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


@dataclasses.dataclass
class SlabCase:
    """One ``sharded_slab_decode`` every rank runs: ``decoder`` names one
    of the job's decoders; the last of ``requests`` is the one timed and
    counted (the earlier ones warm the libraries up)."""

    name: str
    decoder: str
    latent: torch.Tensor                  # on the CPU
    cfg: HDRDecodeConfig = HDRDecodeConfig()
    precision: Precision = Precision()
    tail_levels: Optional[int] = None
    pad_to: Optional[Tuple[int, int]] = None
    requests: int = 1


def _wrappers():
    """The kernel wrappers the decode can launch."""
    from hdrvae_torch.kernels import attention, conv3x3, epilogue
    return (conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
            conv3x3.upconv_gn_conv3x3, attention.flash_attention_bf16,
            attention.flash_attention_3pass, attention.flash_attention_f32,
            attention.split_qkv, epilogue.collapse_and_stats_fused)


_COUNTERS = ("launches", "launches_masked", "stats_only_launches",
             "owned_launches")


def kernel_counts() -> Dict[str, int]:
    """Every launch counter of the decode's kernels, as
    ``{"<wrapper>.<counter>": n}``."""
    return {f"{fn.__name__}.{c}": getattr(fn, c) for fn in _wrappers()
            for c in _COUNTERS if hasattr(fn, c)}


def reset_kernel_counts() -> None:
    for fn in _wrappers():
        for c in _COUNTERS:
            if hasattr(fn, c):
                setattr(fn, c, 0)


def _decode(dec, z, case: SlabCase, mesh, cuda: bool) -> dict:
    """One timed request of ``case``: its result on the CPU, the launches
    it made, its wall ms and (on a card) device ms and peak bytes."""
    from hdrvae_torch.decode.pipeline import decode_summary
    from hdrvae_torch.sharding.mesh import sharded_slab_decode
    kw = dict(mesh=mesh, tail_levels=case.tail_levels, pad_to=case.pad_to,
              precision=case.precision)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    reset_kernel_counts()
    t0 = time.perf_counter()
    res = sharded_slab_decode(dec, z, case.cfg, **kw)
    if cuda:
        end.record()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return {
        "name": case.name, "image": res.image.cpu(),
        "standard": None if res.standard is None else res.standard.cpu(),
        "summary": decode_summary(res), "counts": kernel_counts(),
        "wall_ms": wall_ms,
        "device_ms": start.elapsed_time(end) if cuda else None,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def _run_rank(job_dir: Path, rank: int) -> None:
    """Run every case of the job on this rank; save the records."""
    from hdrvae_torch.models.params import decoder_from_state_dict
    from hdrvae_torch.sharding.mesh import Mesh
    job = torch.load(job_dir / "job.pt", weights_only=False)
    torch.set_num_threads(1)
    cuda = job["device"] == "cuda"
    if cuda:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    initialize((job_dir / "store").as_uri(), job["world_size"], rank,
               job["backend"])
    try:
        decoders = {name: decoder_from_state_dict(sd, cfg, device=device)
                    for name, (cfg, sd) in job["decoders"].items()}
        mesh = Mesh(device, MeshConfig(num_devices=job["world_size"]))
        records = []
        for case in job["cases"]:
            z = case.latent.to(device)
            for _ in range(case.requests):
                rec = _decode(decoders[case.decoder], z, case, mesh, cuda)
            records.append({**rec, "rank": rank, "device": str(device),
                            "backend": job["backend"],
                            "world_size": job["world_size"]})
        torch.save(records, job_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class RankGroup:
    """N worker processes on this host running one job (module
    docstring); :meth:`wait` returns each rank's records, rank 0 first.
    Use it as a context manager, or call :meth:`close`: every process it
    started is killed and its job directory removed."""

    def __init__(self, num_processes: int,
                 decoders: Dict[str, Tuple[DecoderConfig, dict]],
                 cases: List[SlabCase], *, device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{device!r}")
        if device == "cuda":
            from hdrvae_torch.kernels import _build
            _build.build()
        self.backend = pick_backend(device, num_processes)
        self.dir = Path(tempfile.mkdtemp(prefix="hdrvae_ranks_"))
        self.procs: List[subprocess.Popen] = []
        torch.save({
            "world_size": num_processes, "backend": self.backend,
            "device": device, "cases": list(cases),
            "decoders": {name: (cfg, {k: v.detach().cpu()
                                      for k, v in sd.items()})
                         for name, (cfg, sd) in decoders.items()}},
            self.dir / "job.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
        # one CPU thread a rank: ranks on the CPU share its cores
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            env[var] = "1"
        try:
            for rank in range(num_processes):
                with open(self.dir / f"rank{rank}.log", "w") as log:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "hdrvae_torch.sharding.multihost", str(self.dir),
                         str(rank)], env=env, stdout=log,
                        stderr=subprocess.STDOUT, cwd=_REPO))
        except BaseException:
            self.close()
            raise

    def _log_tail(self, rank: int) -> str:
        return (self.dir / f"rank{rank}.log").read_text()[-3000:]

    def wait(self, timeout: float = 600.0) -> List[List[dict]]:
        """Each rank's records, once every rank has exited 0.  A rank that
        exits non-zero, or a group that outlives ``timeout`` seconds,
        kills every rank and raises ``RuntimeError`` with the logs'
        tails."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    self.kill()
                    raise RuntimeError("ranks failed:\n" + "\n".join(
                        f"rank {r} exited {codes[r]}:\n{self._log_tail(r)}"
                        for r in failed))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    self.kill()
                    raise RuntimeError(
                        f"ranks timed out after {timeout:.0f} s:\n" +
                        "\n".join(f"rank {r}:\n{self._log_tail(r)}"
                                  for r in range(len(self.procs))))
                time.sleep(0.05)
            return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                    for r in range(len(self.procs))]
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
    _run_rank(Path(sys.argv[1]), int(sys.argv[2]))
