"""Stdlib HTTP front end over :class:`hdrvae_torch.serve.engine.ServeEngine`,
as ``hdrvae/serve/http.py``.

Endpoints:

  GET  /healthz      -> {"ok": true, "backend": "cuda" | "cpu", "device":
                        the card's name, "device_count": N (a rank
                        group's size with a mesh)}; 503 with "ok": false
                        once the engine's rank group broke
  GET  /v1/stats     -> engine.stats()
  POST /v1/decode    -> body: one ``.npy`` array (the latent, [h,w,z] /
                        [B,h,w,z] NHWC or [B,z,h,w] NCHW, float).
                        Query params:
                          mode=<hdr mode or alias>   (default: engine cfg)
                          ev=<float>                 (conservative_ev_multiplier;
                                                      finite, 0.1-10.0, the
                                                      node widget's bounds)
                          format=exr|hdr|npy         (default exr)
                          bit_depth=16bit|32bit      (exr only; 16bit
                                                      responses fetch f16
                                                      from the device:
                                                      half the bytes, the
                                                      same file)
                          compression=none|rle|zip|zips|piz|pxr24
                                                     (piz: 400 without
                                                      the native codec)
                        Response: the encoded file bytes; the decode's
                        stats record rides in the ``X-HDRVAE-Summary``
                        header (JSON).  ``format=npy`` returns the raw
                        [B,H,W,3] array and allows B > 1; the image
                        formats require B == 1.
                        Errors: 400 (validation, incl. the latent-size /
                        batch caps), 503 + Retry-After (queue full or
                        shutting down), 504 (engine deadline expired in
                        queue, or the server's bounded result wait), 500
                        (the decode failed).

One ``.npy`` body keeps the wire format dependency-free;
``ThreadingHTTPServer`` accepts concurrent clients while the engine
serializes device work and provides the backpressure (503 when its queue is
full).  The handler threads touch no device tensor: the engine's worker
owns the device.  One engine serves one host; several hosts sit behind any
load balancer.
"""

from __future__ import annotations

import concurrent.futures as _futures
import io
import json
import logging
import os
import tempfile
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from hdrvae_torch.serve.engine import EngineOverloaded, ServeEngine

logger = logging.getLogger(__name__)

__all__ = ["make_server", "serve_forever"]

_MAX_BODY = 1 << 30   # 1 GiB latent cap: a 4096^2-output Flux latent is
#                       512*512*16*4 = 16 MiB; anything near the cap is abuse

# Default request-size limits (overridable via make_server): one
# unauthenticated request must not be able to run the device out of
# memory.  512*512 latent pixels == a 4096^2-pixel output.
_MAX_LATENT_PIXELS = 512 * 512
_MAX_BATCH = 8
# The node widget's bounds for the EV multiplier (min 0.1, max 10.0).
_EV_MIN, _EV_MAX = 0.1, 10.0

_CONTENT_TYPES = {
    "exr": "image/x-exr",
    "hdr": "image/vnd.radiance",
    "npy": "application/octet-stream",
}


def _json_safe(obj):
    """Replace non-finite floats with strings: a NaN-laden input latent
    yields NaN decode stats, and bare ``NaN``/``Infinity`` tokens are not
    valid JSON (strict clients fail to parse the summary header)."""
    import math
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)   # 'nan' / 'inf' / '-inf'
    return obj


def _encode_image(image: np.ndarray, fmt: str, bit_depth: str,
                  compression: str) -> bytes:
    """Encode one [H, W, C] frame with the port's codecs (through a temp
    file: the codecs are path-based; the extra read-back is noise next to
    the encode itself)."""
    from hdrvae_torch.io.export import _save_one
    suffix = ".exr" if fmt == "exr" else ".hdr"
    fd, path = tempfile.mkstemp(suffix=suffix, prefix="hdrvae_serve_")
    os.close(fd)
    try:
        _save_one(path, image, fmt, bit_depth, compression)
        with open(path, "rb") as f:
            return f.read()
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _device_info(engine: ServeEngine) -> dict:
    """The engine's device for /healthz: its backend, the card's name and
    the device count: a mesh engine's ranks, else the card count (a CPU
    engine reports one CPU device)."""
    import torch
    device = engine.device
    if engine.mesh is not None:
        count = engine.mesh.size
    else:
        count = torch.cuda.device_count() if device.type == "cuda" else 1
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return {"backend": device.type, "device": name, "device_count": count}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "hdrvae-serve"
    # Socket read timeout: a client that sends headers then stalls the
    # body otherwise pins a ThreadingHTTPServer thread forever
    # (BaseHTTPRequestHandler closes the connection when rfile times out).
    timeout = 60.0

    # -- plumbing ------------------------------------------------------

    @property
    def engine(self) -> ServeEngine:
        return self.server.engine   # type: ignore[attr-defined]

    def log_message(self, fmt, *args):   # route to logging, not stderr
        logger.info("%s - %s", self.address_string(), fmt % args)

    def _reply(self, code: int, body: bytes, content_type: str,
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if code != 200:
            # error replies may be sent before the request body was
            # drained; on a keep-alive connection the unread bytes would
            # be parsed as the next request — close instead (the header
            # tells the client; the flag stops handle_one_request)
            self.send_header("Connection", "close")
            self.close_connection = True
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, message: str) -> None:
        self._reply_json(code, {"error": message})

    # -- endpoints -----------------------------------------------------

    def do_GET(self):
        path = urllib.parse.urlparse(self.path).path
        if path == "/healthz":
            ok = self.engine.healthy
            self._reply_json(200 if ok else 503,
                             {"ok": ok, **_device_info(self.engine)})
        elif path == "/v1/stats":
            self._reply_json(200, self.engine.stats())
        else:
            self._error(404, f"unknown path {path!r}")

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        if url.path != "/v1/decode":
            self._error(404, f"unknown path {url.path!r}")
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._error(400, "bad Content-Length")
            return
        if n <= 0 or n > _MAX_BODY:
            self._error(400, f"Content-Length must be in (0, {_MAX_BODY}]")
            return
        body = self.rfile.read(n)
        try:
            latent = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception as e:
            self._error(400, f"body is not a .npy array: {e}")
            return
        if not np.issubdtype(latent.dtype, np.floating):
            self._error(400, f"latent dtype {latent.dtype} is not float")
            return
        if latent.ndim not in (3, 4):
            self._error(400, f"latent must be 3D/4D, got {latent.shape}")
            return
        # size caps before touching the engine: the shape comes from the
        # request, and an oversized one costs device memory
        zc = getattr(self.engine, "z_channels", 16)
        shp = latent.shape[-3:]
        if latent.ndim == 4 and shp[-1] != zc and latent.shape[1] == zc:
            shp = latent.shape[2:] + latent.shape[1:2]   # NCHW -> (h, w, z)
        h_lat, w_lat = int(shp[0]), int(shp[1])
        max_px = self.server.max_latent_pixels   # type: ignore[attr-defined]
        if h_lat * w_lat > max_px:
            self._error(400, f"latent {h_lat}x{w_lat} exceeds the "
                             f"{max_px}-latent-pixel request cap")
            return
        batch = latent.shape[0] if latent.ndim == 4 else 1
        max_b = self.server.max_batch   # type: ignore[attr-defined]
        if batch > max_b:
            self._error(400, f"batch {batch} exceeds the cap of {max_b}")
            return

        q = urllib.parse.parse_qs(url.query)

        def param(name: str, default: str) -> str:
            return q.get(name, [default])[0]

        fmt = param("format", "exr")
        if fmt not in _CONTENT_TYPES:
            self._error(400, f"format must be one of "
                             f"{sorted(_CONTENT_TYPES)}")
            return
        bit_depth = param("bit_depth", "16bit")
        if bit_depth not in ("16bit", "32bit"):
            self._error(400, "bit_depth must be '16bit' or '32bit'")
            return
        compression = param("compression", "zip").lower()
        # validate everything knowable up front: a request rejected after
        # the decode already spent the device
        if fmt == "exr":
            from hdrvae_torch.io.exr import COMPRESSION_IDS, check_writable
            if compression not in COMPRESSION_IDS:
                self._error(400, f"compression must be one of "
                                 f"{sorted(COMPRESSION_IDS)}")
                return
            try:
                check_writable(compression)
            except ValueError as e:
                self._error(400, str(e))
                return
        if fmt != "npy" and latent.ndim == 4 and latent.shape[0] != 1:
            self._error(400, f"format={fmt} requires batch 1, got "
                             f"{latent.shape[0]} (use format=npy for "
                             f"batches)")
            return

        import dataclasses

        cfg = self.engine.hdr_cfg
        try:
            if "mode" in q:
                cfg = dataclasses.replace(cfg, hdr_mode=param("mode", ""))
            if "ev" in q:
                import math
                ev = float(param("ev", "1"))
                # the widget's bounds; nan / inf / <= 0 would go
                # straight into the image
                if not math.isfinite(ev) or not _EV_MIN <= ev <= _EV_MAX:
                    raise ValueError(
                        f"ev must be a finite float in "
                        f"[{_EV_MIN}, {_EV_MAX}], got {param('ev', '1')}")
                cfg = dataclasses.replace(
                    cfg, conservative_ev_multiplier=ev)
            cfg.canonical_mode()   # validate eagerly -> 400, not 500
        except (ValueError, KeyError) as e:
            self._error(400, str(e))
            return

        # 16-bit EXR responses only need half-precision pixels: cast on
        # the device and fetch half the bytes (the same file bytes: the EXR
        # stores halves either way).  npy / 32-bit responses fetch float32.
        fetch_dtype = (np.float16
                       if fmt == "exr" and bit_depth == "16bit" else None)
        try:
            fut = self.engine.submit(latent, cfg, block=False,
                                     fetch_dtype=fetch_dtype)
        except EngineOverloaded as e:
            self._reply(503, json.dumps({"error": str(e)}).encode(),
                        "application/json", {"Retry-After": "1"})
            return
        except RuntimeError as e:   # engine closed (shutting down) or its
            #                         rank group broken
            self._reply(503, json.dumps({"error": str(e)}).encode(),
                        "application/json", {"Retry-After": "1"})
            return
        except ValueError as e:
            self._error(400, str(e))
            return

        try:
            # hard response bound: even a wedged worker (or a future
            # orphaned by a BaseException in it) cannot hang the
            # connection past this
            resp = fut.result(timeout=self.server.request_timeout_s)  # type: ignore[attr-defined]
        except ValueError as e:           # bad shapes/channels etc.
            self._error(400, str(e))
            return
        except (TimeoutError, _futures.TimeoutError) as e:
            # engine deadline (expired while queued) or result-wait bound
            fut.cancel()
            self._reply(504, json.dumps(
                {"error": f"decode timed out: {e or 'deadline exceeded'}"}
            ).encode(), "application/json", {"Retry-After": "1"})
            return
        except Exception as e:
            logger.error("decode failed: %s", e, exc_info=True)
            self._error(500, f"decode failed: {e}")
            return

        summary = json.dumps(_json_safe({
            **resp.summary,
            "latency_s": round(resp.latency_s, 4),
            "padded_latent_hw": list(resp.padded_hw)}), allow_nan=False)
        try:
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, resp.image)
                payload = buf.getvalue()
            else:
                payload = _encode_image(resp.image[0], fmt, bit_depth,
                                        compression)
        except ValueError as e:           # codec-level rejection
            self._error(400, str(e))
            return
        self._reply(200, payload, _CONTENT_TYPES[fmt],
                    {"X-HDRVAE-Summary": summary})


def make_server(engine: ServeEngine, host: str = "127.0.0.1",
                port: int = 8475, *,
                max_latent_pixels: int = _MAX_LATENT_PIXELS,
                max_batch: int = _MAX_BATCH,
                request_timeout_s: float = 600.0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]`` has the bound one).

    ``max_latent_pixels`` / ``max_batch`` bound a single request's decode
    size (400 on violation); ``request_timeout_s`` bounds the wait on the
    engine future (504 on expiry; generous by default: it is the
    last-resort hang guard, while the engine's ``deadline_s`` is the
    queue-health policy)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.engine = engine   # type: ignore[attr-defined]
    server.max_latent_pixels = max_latent_pixels   # type: ignore[attr-defined]
    server.max_batch = max_batch                   # type: ignore[attr-defined]
    server.request_timeout_s = request_timeout_s   # type: ignore[attr-defined]
    server.daemon_threads = True
    return server


def serve_forever(engine: ServeEngine, host: str, port: int) -> None:
    server = make_server(engine, host, port)
    bound = server.server_address
    print(json.dumps({"serving": f"http://{bound[0]}:{bound[1]}",
                      "endpoints": ["/healthz", "/v1/stats",
                                    "/v1/decode"]}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        engine.close()
