"""Online serving engine, as ``hdrvae/serve/engine.py``: queued HDR
decodes with shape buckets and device / host overlap.

A deployment sees a stream of latents at mixed resolutions; this engine is
the request-level executor for it:

  - **Buckets**: a request's latent is snapped up to a shape bucket
    (``decode.buckets.BucketPolicy``, or a plain multiple) and decoded with
    the pad masked out of every statistic (``layers.PadMask``), so the
    result is the unpadded decode's to float noise.  A latent already at
    its bucket takes the unbucketed route (see :meth:`ServeEngine._dispatch`).
  - **Device / host overlap**: one worker thread owns the device.  It
    launches every decode on its own compute stream and records an event
    after the request's last operation; the fetch of request N runs on a
    copy stream that waits on N's event alone, into pinned host memory,
    after request N+1's decode was launched.  So N's response never waits
    for N+1's kernels, and the device does not idle behind N's fetch.
  - **Backpressure**: a bounded queue; ``submit(block=False)`` raises
    :class:`EngineOverloaded` instead of letting requests pile up.
  - **A rank group** (``mesh=``): every request runs the exact
    slab-sharded decode (``sharding/mesh.py::sharded_slab_decode``) on
    every rank of the process group, the worker thread sending each one to
    the other ranks first (``serve/ranks.py``, which says why the ranks
    stay in step).  A failure after a request went out breaks the group:
    that request, every queued one and every later submit fail
    (:class:`GroupBroken`), and :attr:`ServeEngine.healthy` turns false.

Requests are not batched together: the decode's analysis and acceptance
statistics span the whole request tensor, so stacking two users' latents
into one batch would couple their results.  One request is one
``hdr_decode`` call; the frames of one request decode together.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from hdrvae_torch.core.config import HDRDecodeConfig, Precision
from hdrvae_torch.decode.buckets import BucketPolicy
from hdrvae_torch.decode.pipeline import (_to_nhwc, hdr_decode,
                                          pack_summary, summary_from_host)
from hdrvae_torch.serve.ranks import (HEARTBEAT, REQUEST, STOP, GroupBroken,
                                      Link, check_request, check_weights)
from hdrvae_torch.sharding.mesh import Mesh, sharded_slab_decode

__all__ = ["EngineOverloaded", "GroupBroken", "ServeEngine",
           "ServeResponse"]


class EngineOverloaded(RuntimeError):
    """The request queue is full (non-blocking submit)."""


@dataclasses.dataclass
class ServeResponse:
    """One completed decode."""

    image: np.ndarray            # [B, H, W, 3] linear HDR; float32, or
                                 # the submit()'s fetch_dtype (float16
                                 # for 16-bit EXR responses)
    summary: Dict[str, Any]      # decode_summary record (stats, mode, ...)
    latency_s: float             # submit -> result, wall clock
    padded_hw: Tuple[int, int]   # the latent's bucket (h, w)


@dataclasses.dataclass
class _Launched:
    """A dispatched request's device tensors: the image in its fetch dtype,
    the packed summary and its layout, and the event recorded on the
    compute stream after the last of them (None on the CPU)."""

    image: torch.Tensor
    stats: torch.Tensor
    layout: list
    padded_hw: Tuple[int, int]
    done: Optional[torch.cuda.Event]


_STOP = object()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class ServeEngine:
    """Queued decode executor over one loaded :class:`api.vae.VAE`.

    Thread-safe: any number of threads may ``submit``; one worker thread
    owns the device (and, with a mesh, calls every collective).  Use as a
    context manager or call :meth:`close`.
    """

    _DEFAULT_BUCKET = object()   # 64 without a mesh, None with one

    def __init__(self, vae, *,
                 hdr_cfg: HDRDecodeConfig = HDRDecodeConfig(),
                 precision: Optional[Precision] = None,
                 bucket: Union[BucketPolicy, int, None] = _DEFAULT_BUCKET,
                 max_pending: int = 32,
                 depth: int = 2,
                 mesh: Optional[Mesh] = None,
                 deadline_s: Optional[float] = None,
                 heartbeat_s: float = 30.0):
        """
        Args:
          vae: a loaded :class:`hdrvae_torch.api.vae.VAE` handle; every
            request runs on its device.
          hdr_cfg: the default decode config; per-request overrides via
            ``submit(cfg=...)``.
          precision: defaults to the VAE handle's precision.
          bucket: a :class:`BucketPolicy`, a plain multiple (int, latent
            pixels), or None for no buckets.  Defaults to 64 without a
            mesh and to None with one, as the JAX engine's; an explicit
            bucket composes with the mesh (``pad_to``: the layers with
            ``SlabPadGNReducer``).
          max_pending: the request queue's bound (backpressure).
          depth: decodes kept launched ahead of the host fetch (2 =
            double buffering).
          mesh: a :class:`hdrvae_torch.sharding.mesh.Mesh` on this
            process's rank, which must be rank 0 of its group while every
            other rank runs ``serve.ranks.follow`` with the same weights
            (checked at start: :class:`serve.ranks.WeightsDiffer`).  Every
            request then runs ``sharded_slab_decode`` on all the ranks.
          deadline_s: the default per-request deadline.  A request still
            queued when its deadline expires fails with TimeoutError
            instead of dispatching; one already dispatched is kept.
          heartbeat_s: with a mesh, the worker sends the other ranks a
            heartbeat whenever its queue has been empty this long; keep it
            well under the process group's timeout.
        """
        if bucket is ServeEngine._DEFAULT_BUCKET:
            bucket = None if mesh is not None else 64
        self._vae = vae
        self.hdr_cfg = hdr_cfg
        self._precision = precision if precision is not None \
            else vae.precision
        self._bucket = bucket
        self._deadline_s = deadline_s
        self._depth = max(1, depth)
        self._device = torch.device(vae.device)
        if mesh is not None and mesh.device.type != self._device.type:
            raise ValueError(f"mesh on {mesh.device}, VAE on {self._device}")
        self._mesh = mesh
        self._heartbeat_s = heartbeat_s
        self._link: Optional[Link] = None
        if self._device.type == "cuda":
            self._compute = torch.cuda.Stream(self._device)
            self._copy = torch.cuda.Stream(self._device)
        else:
            self._compute = self._copy = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()
        # submit() blocks on this instead of poll-sleeping; the worker
        # notifies after every get, and waiters wake in wait() order
        self._space = threading.Condition(self._lock)
        self._closed = False
        self._broken: Optional[BaseException] = None
        self._n_done = 0
        self._n_errors = 0
        self._megapixels = 0.0
        self._latencies: deque = deque(maxlen=256)
        self._shape_counts: Counter = Counter()
        self._started = time.monotonic()
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="hdrvae-serve")
        self._worker.start()
        # with a mesh the worker first compares the ranks' weights
        self._ready.wait()
        if self._start_error is not None:
            self._worker.join()
            raise self._start_error

    # -- client side --------------------------------------------------

    _USE_DEFAULT = object()

    def submit(self, latent, cfg: Optional[HDRDecodeConfig] = None, *,
               block: bool = True, timeout: Optional[float] = None,
               deadline_s=_USE_DEFAULT, fetch_dtype=None) -> cf.Future:
        """Enqueue one decode; returns a ``concurrent.futures.Future``
        resolving to a :class:`ServeResponse`.

        latent: [h, w, z], [B, h, w, z] (NHWC) or [B, z, h, w] (NCHW,
        detected by ``hdr_decode``); a numpy array or a tensor.  A tensor
        on the card is read once the work queued on the submitting
        thread's current stream is done, without blocking that thread.

        ``deadline_s`` (default: the engine's; None for no deadline): a
        request still queued this many seconds after submit fails with
        TimeoutError instead of dispatching.

        ``fetch_dtype``: a numpy dtype for the image's device-to-host
        fetch.  float16 (the HTTP front end's 16-bit EXR responses) casts
        on the device and moves half the bytes; the response's ``image``
        then has that dtype.
        """
        if not isinstance(latent, torch.Tensor):
            latent = np.asarray(latent)
        if latent.ndim == 3:
            latent = latent[None]
        if latent.ndim != 4:
            raise ValueError(f"latent must be 3D/4D, got "
                             f"{tuple(latent.shape)}")
        ready = None
        if isinstance(latent, torch.Tensor) and latent.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(latent.device))
        fut: cf.Future = cf.Future()
        t0 = time.monotonic()
        if deadline_s is ServeEngine._USE_DEFAULT:
            deadline_s = self._deadline_s
        drop_at = None if deadline_s is None else t0 + deadline_s
        item = (fut, latent, cfg if cfg is not None else self.hdr_cfg,
                t0, drop_at, fetch_dtype, ready)
        # the closed check and the enqueue are one step under the lock: a
        # put that raced past a bare closed check could land after the
        # worker took _STOP, leaving a future that never resolves
        deadline = None if timeout is None else t0 + timeout
        with self._space:
            while True:
                if self._closed:
                    raise RuntimeError("engine is closed")
                if self._broken is not None:
                    raise GroupBroken(
                        f"the rank group is broken: {self._broken}")
                try:
                    self._queue.put_nowait(item)
                    return fut
                except queue.Full:
                    pass
                if not block:
                    raise EngineOverloaded(
                        f"{self._queue.maxsize} requests already pending")
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    raise EngineOverloaded(
                        f"{self._queue.maxsize} requests already pending")
                self._space.wait(wait)

    def decode_sync(self, latent, cfg: Optional[HDRDecodeConfig] = None
                    ) -> ServeResponse:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(latent, cfg).result()

    @property
    def device(self) -> torch.device:
        """The device every request runs on (the VAE handle's)."""
        return self._device

    @property
    def mesh(self) -> Optional[Mesh]:
        """The rank group's mesh, or None for a one-device engine."""
        return self._mesh

    @property
    def healthy(self) -> bool:
        """False once the engine's rank group broke (with a mesh)."""
        return self._broken is None

    @property
    def z_channels(self) -> int:
        """Latent channel count of the loaded VAE (front ends size their
        request caps by it)."""
        return self._vae.config.z_channels

    def warmup(self, latent_hw_list, batch: int = 1) -> None:
        """Build the kernels (on a card) and decode one zero latent of each
        (h, w), which also primes cuDNN's plans and the caching allocator.
        Warmup requests carry no deadline."""
        if self._device.type == "cuda":
            from hdrvae_torch.kernels import _build
            _build.library()
        zc = self._vae.config.z_channels
        futs = [self.submit(np.zeros((batch, h, w, zc), np.float32),
                            deadline_s=None)
                for h, w in latent_hw_list]
        for f in futs:
            f.result()

    def stats(self) -> Dict[str, Any]:
        """Counters and recent-latency quantiles (host-side, cheap)."""
        with self._lock:
            lat = sorted(self._latencies)
            done, err = self._n_done, self._n_errors
            mp = self._megapixels
            shapes = dict(self._shape_counts)
        q = (lambda p: float(lat[min(len(lat) - 1,
                                     int(p * len(lat)))]) if lat else None)
        return {
            "requests": done,
            "errors": err,
            "pending": self._queue.qsize(),
            "megapixels": round(mp, 6),
            "uptime_s": round(time.monotonic() - self._started, 3),
            "latency_p50_s": q(0.50),
            "latency_p95_s": q(0.95),
            "compiled_latent_shapes": {f"{h}x{w}": n
                                       for (h, w), n in
                                       sorted(shapes.items())},
        }

    def close(self, timeout: float = 30.0) -> None:
        """Drain in-flight work and stop the worker (with a mesh, after it
        sent the other ranks STOP)."""
        with self._space:
            if self._closed:
                return
            self._closed = True
            self._space.notify_all()   # wake blocked submitters -> closed
        # every item enqueued (under the lock) before _closed flipped is
        # ahead of _STOP in FIFO order, so the worker drains it first
        self._queue.put(_STOP)
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ---------------------------------------------------

    def _pad_target(self, h: int, w: int) -> Optional[Tuple[int, int]]:
        b = self._bucket
        if isinstance(b, BucketPolicy):
            return b.snap_hw(h, w)
        if isinstance(b, int) and b > 0:
            return (-(-h // b) * b, -(-w // b) * b)
        return None

    def _to_device(self, latent) -> torch.Tensor:
        """The latent as float32 on the VAE's device; from the host through
        pinned memory, so the copy does not wait for the stream's queued
        decodes."""
        if isinstance(latent, torch.Tensor):
            return latent.to(self._device, torch.float32)
        host = torch.from_numpy(np.ascontiguousarray(latent, np.float32))
        if self._device.type != "cuda":
            return host
        return host.pin_memory().to(self._device, non_blocking=True)

    @torch.no_grad()
    def _dispatch(self, latent, cfg: HDRDecodeConfig,
                  fetch_dtype=None) -> _Launched:
        """Launch one decode, the image's cast to ``fetch_dtype`` and the
        summary's packing on the current (the worker's compute) stream,
        and record an event after them."""
        # NCHW detection mirrors hdr_decode's (for the bucket only)
        zc = self._vae.config.z_channels
        if latent.shape[-1] != zc and latent.shape[1] == zc:
            h, w = int(latent.shape[2]), int(latent.shape[3])
        else:
            h, w = int(latent.shape[1]), int(latent.shape[2])
        target = self._pad_target(h, w)
        # A latent already at its bucket decodes unbucketed: a full-valid
        # PadMask is the plain decode, so the result is the same to float
        # noise, while pad_to would send it down the PadMask layer path,
        # off the fast tier's K1 / K2 / K3 chain (at 1024^2 the bucketed
        # layers took ~3x the chain's time).  The JAX package buckets it
        # anyway, to bound its XLA compiles; eager PyTorch compiles
        # nothing.  padded_hw still reports the bucket.
        pad_to = target if target is not None and target != (h, w) else None
        if self._link is None:
            result = hdr_decode(self._vae.decoder, self._to_device(latent),
                                cfg, self._precision, pad_to=pad_to)
        else:
            result = self._sharded(latent, cfg, pad_to)
        image = result.image
        if fetch_dtype is not None:
            image = image.to(_torch_dtype(fetch_dtype))
        stats, layout = pack_summary(result)
        done = None
        if self._compute is not None:
            done = torch.cuda.Event()
            done.record(self._compute)
        return _Launched(image, stats, layout, target or (h, w), done)

    def _sharded(self, latent, cfg: HDRDecodeConfig,
                 pad_to: Optional[Tuple[int, int]]):
        """The slab decode of one request on every rank: validated here,
        sent to the other ranks, then decoded on this one.  A failure after
        the send raises :class:`GroupBroken`."""
        if not isinstance(latent, torch.Tensor):
            latent = torch.from_numpy(np.ascontiguousarray(latent,
                                                           np.float32))
        z = _to_nhwc(latent.float(), self._vae.config.z_channels)
        check_request(z, cfg, self._precision, pad_to,
                      self._vae.config.num_levels)
        self._link.send(REQUEST, z, cfg, self._precision, pad_to)
        try:
            return sharded_slab_decode(self._vae.decoder,
                                       z.to(self._device), cfg,
                                       mesh=self._mesh, pad_to=pad_to,
                                       precision=self._precision)
        except Exception as e:
            raise GroupBroken(f"the slab decode failed after the request "
                              f"went to the ranks: {e}") from e

    def _fetch(self, work: _Launched):
        """The image and the packed summary on the host.  On a card: on
        the copy stream, after the request's own event, into pinned
        memory."""
        if work.done is None:
            return work.image.numpy(), work.stats
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(work.done)
            image = torch.empty(work.image.shape, dtype=work.image.dtype,
                                pin_memory=True)
            stats = torch.empty(work.stats.shape, dtype=work.stats.dtype,
                                pin_memory=True)
            # the copy stream reads tensors the compute stream allocated:
            # keep their blocks from reuse until the copies are done
            work.image.record_stream(self._copy)
            work.stats.record_stream(self._copy)
            image.copy_(work.image, non_blocking=True)
            stats.copy_(work.stats, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(self._copy)
        fetched.synchronize()
        return image.numpy(), stats

    def _finalize(self, entry) -> None:
        fut, work, t0 = entry
        try:
            image, stats = self._fetch(work)
            summary = summary_from_host(stats, work.layout)
            latency = time.monotonic() - t0
            with self._lock:
                self._n_done += 1
                self._megapixels += image.shape[0] * image.shape[1] \
                    * image.shape[2] / 1e6
                self._latencies.append(latency)
                self._shape_counts[work.padded_hw] += 1
            fut.set_result(ServeResponse(image=image, summary=summary,
                                         latency_s=latency,
                                         padded_hw=work.padded_hw))
        except Exception as e:
            with self._lock:
                self._n_errors += 1
            fut.set_exception(e)

    def _fail(self, fut: cf.Future, e: BaseException) -> None:
        with self._lock:
            self._n_errors += 1
        fut.set_exception(e)

    def _break(self, e: GroupBroken) -> None:
        """The group is out of step: refuse every later submit, and fail
        every queued request (each was queued under the lock before the
        flag turned)."""
        with self._space:
            self._broken = e
            self._space.notify_all()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP and item[0].set_running_or_notify_cancel():
                self._fail(item[0], GroupBroken(
                    f"the rank group broke before this request: {e}"))

    def _idle_get(self):
        """The next queue item, blocking; with a mesh, a heartbeat to the
        ranks whenever none came for ``heartbeat_s``."""
        if self._link is None:
            return self._queue.get()
        while True:
            try:
                return self._queue.get(timeout=self._heartbeat_s)
            except queue.Empty:
                self._link.send(HEARTBEAT)

    def _start(self) -> None:
        if self._compute is not None:
            # the current device and stream are per thread: this thread
            # launches every decode on its own compute stream
            torch.cuda.set_device(self._device)
            torch.cuda.set_stream(self._compute)
        if self._mesh is not None:
            check_weights(self._vae.decoder, self._mesh)
            self._link = Link(self._mesh)

    def _run(self) -> None:
        try:
            self._start()
        except Exception as e:
            self._start_error = e
            return
        finally:
            self._ready.set()
        inflight: deque = deque()
        stopping = False
        while True:
            # Prefer dispatching new work (keeps the device busy); only
            # when the queue is momentarily empty, finalize the oldest
            # in-flight decode (its fetch overlaps the next decode)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                if inflight:
                    self._finalize(inflight.popleft())
                    continue
                if stopping or self._broken is not None:
                    if self._link is not None and self._broken is None:
                        try:
                            self._link.send(STOP)
                        except GroupBroken as e:
                            self._broken = e
                    return
                try:
                    item = self._idle_get()
                except GroupBroken as e:
                    self._break(e)
                    continue
            with self._space:
                self._space.notify()   # one queue slot freed
            if item is _STOP:
                stopping = True
                continue
            fut, latent, cfg, t0, drop_at, fetch_dtype, ready = item
            if not fut.set_running_or_notify_cancel():
                continue   # client cancelled while queued
            if drop_at is not None and time.monotonic() > drop_at:
                # expired while queued: fail fast instead of spending the
                # device on a result nobody waits for (with a mesh it was
                # never sent to the other ranks)
                self._fail(fut, TimeoutError(
                    "request deadline expired before dispatch"))
                continue
            try:
                if ready is not None:
                    # a latent the caller made on another stream: wait for
                    # it there, and keep its block from reuse until this
                    # stream's reads are done
                    torch.cuda.current_stream(latent.device).wait_event(
                        ready)
                    latent.record_stream(
                        torch.cuda.current_stream(latent.device))
                work = self._dispatch(latent, cfg, fetch_dtype)
            except GroupBroken as e:
                self._fail(fut, e)
                self._break(e)
                continue
            except Exception as e:
                self._fail(fut, e)
                continue
            inflight.append((fut, work, t0))
            while len(inflight) > self._depth:
                self._finalize(inflight.popleft())
