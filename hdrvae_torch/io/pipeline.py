"""The streamed export, as ``hdrvae/io/pipeline.py``: decode, the copy off
the card and the EXR encode overlap.

- :func:`export_frame_streamed`: one frame, in scanline bands; band k+1
  is copied into pinned host memory on a copy stream while band k
  encodes on host threads, so the wall time approaches max(copy, encode)
  instead of their sum.
- :func:`export_stream`: a frame sequence; frame N+1 decodes on the card
  while frame N is fetched and frame N-1 encodes and writes.

For 16-bit output a CUDA frame is cast to float16 on the card, on the
stream that made it, and half the bytes are copied: the file stores
halves anyway, so it is the same file.  The copy stream waits on an event
recorded after that cast and on nothing else, so a fetch never waits for
work queued behind its frame (a ``.cpu()`` on the compute stream would).
Files are byte-identical to the serial :func:`io.export.export_linear`'s
of the same pixels; the naming, versioning, sidecar and verify rules are
the same functions.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import logging
import os
from collections import deque
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Union

import numpy as np
import torch

from hdrvae_torch.core.config import ExportConfig
from hdrvae_torch.io.export import (ExportResult, _save_one, _write_sidecar,
                                    export_linear, plan_output, verify_save)
from hdrvae_torch.io.exr import ExrBandWriter

logger = logging.getLogger(__name__)

Frame = Union[np.ndarray, torch.Tensor, Callable[[], Any]]


class _Staged(NamedTuple):
    """A CUDA frame in its fetch dtype and the event recorded after the
    cast on the stream that made it."""

    tensor: torch.Tensor
    ready: torch.cuda.Event


def _half_like_numpy(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float16 with numpy's bits: the card's cast rounds finite
    values as numpy does but turns every NaN into 0x7FFF; numpy (and the
    EXR codecs) keep the sign and the payload's top ten bits, forcing
    one bit where they would read as inf."""
    bits = t.view(torch.int32)
    nan = (((bits >> 16) & 0x8000) | 0x7C00
           | ((bits & 0x7FFFFF) >> 13).clamp_min(1))
    return torch.where(torch.isnan(t), nan.to(torch.int16),
                       t.half().view(torch.int16)).view(torch.float16)


def _stage(frame, want_half: bool):
    """Cast a CUDA frame to its fetch dtype on the current stream (float16
    for 16-bit output, with numpy's NaN bits; else float32) and record an
    event after the cast; anything else comes back as it is."""
    if not (isinstance(frame, torch.Tensor) and frame.is_cuda):
        return frame
    t = frame.detach().float().contiguous()
    if want_half:
        t = _half_like_numpy(t)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    return _Staged(t, ready)


def _copy_rows(staged: _Staged, spans, host: torch.Tensor,
               stream: torch.cuda.Stream) -> torch.cuda.Event:
    """Queue the copies of rows ``spans`` of the staged frame into
    ``host`` (pinned) on ``stream``, after the frame's event; returns an
    event recorded after them."""
    with torch.cuda.stream(stream):
        stream.wait_event(staged.ready)
        for y0, y1 in spans:
            host[y0 - spans[0][0]:y1 - spans[0][0]].copy_(
                staged.tensor[y0:y1], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return done


def _fetch(frame, want_half: bool, fetch_workers: int) -> np.ndarray:
    """One frame on the host: a numpy array as it is (cast to float16 for
    16-bit output), a CPU tensor as numpy, a CUDA frame (or a staged one)
    copied into pinned memory on a copy stream in ``fetch_workers`` row
    bands."""
    if isinstance(frame, np.ndarray):
        return frame.astype(np.float16) if want_half else frame
    if isinstance(frame, torch.Tensor) and not frame.is_cuda:
        arr = frame.detach().float().numpy()
        return arr.astype(np.float16) if want_half else arr
    staged = frame if isinstance(frame, _Staged) else _stage(frame,
                                                             want_half)
    t = staged.tensor
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h = t.shape[0]
    bands = max(1, min(fetch_workers, h))
    edges = np.linspace(0, h, bands + 1).astype(int)
    spans = [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]
    _copy_rows(staged, spans, host,
               torch.cuda.Stream(t.device)).synchronize()
    return host.numpy()


def export_frame_streamed(frame: Frame,
                          cfg: ExportConfig = ExportConfig(),
                          *, default_output_dir: str = "output",
                          prompt: Optional[dict] = None,
                          extra_pnginfo: Optional[dict] = None,
                          band_rows: int = 256,
                          workers: int = 0) -> ExportResult:
    """Single-frame EXR export with the copy of band k+1 overlapping the
    encode of band k.  The frame never exists whole on the host, and the
    file is byte-identical to the serial exporter's.

    frame: one [H, W, C] image (a CUDA tensor: the intended use; a CPU
    tensor or numpy array), or a zero-argument callable returning one.
    Non-EXR formats and other shapes go to the serial exporter (the same
    contract).  ``workers``: the encoder's chunk threads (0 = auto).
    """
    if callable(frame):
        frame = frame()
    if cfg.format != "exr" or getattr(frame, "ndim", 0) != 3:
        return export_linear(frame, cfg,
                             default_output_dir=default_output_dir,
                             prompt=prompt, extra_pnginfo=extra_pnginfo)

    result = ExportResult()
    try:
        h, w, c = frame.shape
        output_dir, template, sequenced = plan_output(
            cfg, default_output_dir, 1)
        filename = template % cfg.start_frame if sequenced else template
        filepath = os.path.join(output_dir, filename)
        pixel_type = "float" if cfg.bit_depth == "32bit" else "half"
        staged = _stage(frame, pixel_type == "half")
        writer = ExrBandWriter(filepath, h, w, c, pixel_type=pixel_type,
                               compression=cfg.compression,
                               workers=workers)
        rows = writer.band_rows(band_rows)
        spans = [(y0, min(y0 + rows, h)) for y0 in range(0, h, rows)]
        if isinstance(staged, _Staged):
            # two pinned band buffers: band k+1 lands in one while band k
            # encodes from the other.  The HDR and negative counts run on
            # the copy stream too, behind the same event.
            t = staged.tensor
            bufs = [torch.empty((rows, w, c), dtype=t.dtype,
                                pin_memory=True) for _ in range(2)]
            stream = torch.cuda.Stream(t.device)
            counted = torch.empty(2, dtype=torch.int64, pin_memory=True)
            with torch.cuda.stream(stream):
                stream.wait_event(staged.ready)
                counted.copy_(torch.stack([(t > 1.0).sum(),
                                           (t < 0.0).sum()]),
                              non_blocking=True)

            def issue(i):
                return _copy_rows(staged, [spans[i]], bufs[i % 2], stream)

            def band(i, pending):
                pending.synchronize()
                return bufs[i % 2][:spans[i][1] - spans[i][0]].numpy()
        else:
            host = (frame.detach().float().numpy()
                    if isinstance(frame, torch.Tensor) else frame)
            counted = [int((host > 1.0).sum()), int((host < 0.0).sum())]

            def issue(i):
                return None

            def band(i, pending):
                return host[spans[i][0]:spans[i][1]]

        with writer:
            pending = issue(0)
            for i in range(len(spans)):
                rows_i = band(i, pending)
                if i + 1 < len(spans):
                    pending = issue(i + 1)
                writer.write_rows(rows_i)
        hdr_pixels, negatives = (int(v) for v in counted)
        logger.info("export (streamed): %s hdr_pixels=%d negatives=%d",
                    filepath, hdr_pixels, negatives)
        if cfg.save_workflow:
            _write_sidecar(filepath, prompt, extra_pnginfo)
        result.filepaths = [filepath]
        try:
            result.verify_stats = verify_save(filepath)
            result.verified = True
        except Exception as e:   # diagnostic, not gating
            logger.warning("read-back verification failed: %s", e)
        return result
    except Exception as e:   # the node contract: report, don't raise
        logger.error("streamed export failed: %s", e, exc_info=True)
        result.error = f"ERROR: {e}"
        return result


def export_stream(frames: Iterable[Frame],
                  cfg: ExportConfig = ExportConfig(),
                  *, default_output_dir: str = "output",
                  prompt: Optional[dict] = None,
                  extra_pnginfo: Optional[dict] = None,
                  pbar=None,
                  depth: int = 2,
                  fetch_workers: int = 1,
                  reduced_precision_fetch: bool = True) -> ExportResult:
    """Export a frame sequence with decode, fetch and write overlapped.

    frames: an iterable of [H, W, C] images (CUDA or CPU tensors, numpy
    arrays) or zero-argument callables returning one.  It is consumed
    lazily, with at most ``depth`` frames in flight: a callable that
    launches a decode starts frame N+1 on the card while frame N is still
    being fetched and written.  Returns :func:`export_linear`'s
    :class:`ExportResult` contract (errors reported, not raised; the last
    file read back and verified).
    """
    result = ExportResult()
    # a generator of device frames must not be drawn whole up front: that
    # would launch every decode and hold every output on the card.  One
    # frame of lookahead tells a sequence from a single frame.
    frames_it = iter(frames)
    try:
        first = next(frames_it)
    except StopIteration:
        result.error = "ERROR: no frames"
        return result
    try:
        second = next(frames_it)
        n_hint = 2
        frames_it = itertools.chain([first, second], frames_it)
    except StopIteration:
        n_hint = 1
        frames_it = iter([first])
    want_half = (reduced_precision_fetch and cfg.format == "exr"
                 and cfg.bit_depth == "16bit")
    paths: Dict[int, str] = {}

    try:
        output_dir, template, sequenced = plan_output(
            cfg, default_output_dir, n_hint)

        def write_one(i: int, image: np.ndarray) -> str:
            frame_number = cfg.start_frame + i
            filename = template % frame_number if sequenced else template
            filepath = os.path.join(output_dir, filename)
            _save_one(filepath, image, cfg.format, cfg.bit_depth,
                      cfg.compression)
            if i == 0 and cfg.save_workflow:
                _write_sidecar(filepath, prompt, extra_pnginfo)
            if pbar is not None:
                pbar.update(1)
            paths[i] = filepath   # on the one writer thread, so that a
            return filepath       # failure reports the files before it

        fetcher = cf.ThreadPoolExecutor(1)
        writer = cf.ThreadPoolExecutor(1)
        try:
            fetch_q: deque = deque()
            write_q: deque = deque()

            def drain_write():
                write_q.popleft()[1].result()   # write errors, in order

            def drain_fetch():
                i, fut = fetch_q.popleft()
                write_q.append((i, writer.submit(write_one, i,
                                                 fut.result())))
                # fetched frames wait for the writer in a bounded queue
                # too (each is a whole frame on the host)
                while len(write_q) > depth:
                    drain_write()

            for i, frame in enumerate(frames_it):
                if callable(frame):
                    frame = frame()   # launches the frame's device work
                # the cast and its event on this thread's stream, right
                # behind the frame's own work
                frame = _stage(frame, want_half)
                fetch_q.append((i, fetcher.submit(_fetch, frame, want_half,
                                                  fetch_workers)))
                while len(fetch_q) >= depth:
                    drain_fetch()
            while fetch_q:
                drain_fetch()
            while write_q:
                drain_write()
        finally:
            # on a failure, cancel the queued work: a sequence stops at its
            # first failed write instead of going on past a hole
            fetcher.shutdown(wait=True, cancel_futures=True)
            writer.shutdown(wait=True, cancel_futures=True)

        result.filepaths = [paths[i] for i in sorted(paths)]
        if result.filepaths:
            try:
                result.verify_stats = verify_save(result.filepaths[-1])
                result.verified = True
            except Exception as e:   # diagnostic, not gating
                logger.warning("read-back verification failed: %s", e)
        return result
    except Exception as e:   # the node contract: report, don't raise
        logger.error("pipelined export failed: %s", e, exc_info=True)
        result.error = f"ERROR: {e}"
        # the frames written before the failure are on disk: report them
        result.filepaths = [paths[i] for i in sorted(paths)]
        return result
