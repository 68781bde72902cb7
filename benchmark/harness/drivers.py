"""The three kinds of traffic, each driving the program through its public
entry points: a closed loop of HDR decodes, a closed loop of HDR
upscales, and an open loop of requests to the serving engine.

Each driver makes the weights and inputs from the seed, loads the weights
through the program's loader, warms up the cell's own shapes, measures
for ``seconds`` (with ``trace``, a profiler span in the middle of the
window), and returns a :class:`Measured`: what the metric readers read,
and a ``check`` that runs the reference once the program's state is
freed and returns the numbers compared."""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import models, trace, traffic, work
from benchmark.harness.compare import decode_numbers, gaps_vs

TRACE_S = 10.0     # the longest profiler span of a traced run
CHECK_SLOTS = 4    # a closed loop's checked inputs are among its first 4


@dataclasses.dataclass
class Measured:
    kind: str
    attempted: int
    failed: int
    window_s: float
    megapixels: float                     # output finished in the window
    peak_bytes: int
    work: work.Work                       # the model's work an item
    span: Optional[trace.Span] = None
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    check: Optional[Callable[[], Dict[str, float]]] = None
    started: float = 0.0                  # perf_counter at the window's start


class Device:
    """Synchronization and memory readings of the run's device (on the
    CPU, which only the harness's tests use, each is trivial)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda \
            else 0

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def _span_window(seconds: float):
    """(start, length) of the profiler span in seconds: it starts at the
    middle min(seconds, TRACE_S) of the window and records for that
    long from when the profiler is ready (starting it takes seconds),
    or to the window's end."""
    length = min(seconds, TRACE_S)
    return (seconds - length) / 2, length


def _warm_span(dev: Device, traced: bool):
    """A traced run's profiler span, its tracer started once already (in
    set-up), or None."""
    if not traced:
        return None
    span = trace.Span(dev.device)
    span.warm()
    return span


def _precision(tier: str):
    from hdrvae_torch.core.config import Precision
    return {"fast": Precision.fast, "mixed": Precision.mixed,
            "parity": Precision.parity}[tier]()


ELSIZE = {"fast": 2, "mixed": 4, "parity": 4}


def _decoder_config(m: models.FluxDecoder):
    from hdrvae_torch.core.config import DecoderConfig
    base = m.widths[0]
    return DecoderConfig(z_channels=m.z, ch=base,
                         ch_mult=tuple(w // base for w in m.widths),
                         num_res_blocks=m.blocks - 1, out_channels=m.out,
                         attn_mid=m.attn, num_groups=m.groups,
                         scale_factor=m.scale, shift_factor=m.shift)


def _load_decoder(m, seed, dev):
    from hdrvae_torch.models.params import decoder_from_state_dict
    sd = models.published_keys(m, models.make_weights(m, seed, dev))
    return decoder_from_state_dict(sd, _decoder_config(m), device=dev)


def _closed_loop(dev: Device, seconds: float, in_flight: int, span,
                 step: Callable[[int], None]) -> tuple:
    """Run ``step(n)`` for n = 0, 1, ... until ``seconds`` have passed,
    with at most ``in_flight`` steps on the device; returns (steps,
    window seconds) from the window's start to the last step's end."""
    s_start, length = _span_window(seconds)
    s_stop = math.inf
    pending = collections.deque()
    t0 = time.perf_counter()
    n = 0
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if span is not None:
            if span.prof is None and now >= s_start:
                span.start()
                first = n
                s_stop = span.t0 - t0 + length
            elif span.running and now >= s_stop:
                span.stop()
                span.items = n - first
        while len(pending) >= in_flight:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
        step(n)
        pending.append(dev.event())
        n += 1
    if span is not None and span.running:
        span.stop()
        span.items = n - first
    dev.sync()
    return n, time.perf_counter() - t0, t0


def decode_inputs(cell, seed: int, device):
    """(model, the pool of latents [pool, b, h, w, z] on the device, the
    pool slots checked), from the seed."""
    t = cell.traffic
    m = models.FluxDecoder.from_config(cell.config)
    b, (h, w), pool = int(t["batch"]), t["latent_hw"], int(t["pool"])
    latents = torch.randn(
        (pool, b, h, w, m.z), device=device,
        generator=models.generator(seed, models.INPUTS, device))
    # drawn among the first slots, which every window reaches
    rng = np.random.default_rng(models.stream_seed(seed, models.SAMPLES))
    checked = sorted(rng.choice(min(pool, CHECK_SLOTS),
                                int(t["check_frames"]),
                                replace=False).tolist())
    return m, latents, checked


def upscale_inputs(cell, seed: int, device):
    """(model, the pool of HDR images on the device, the pool slots
    checked), from the seed."""
    t = cell.traffic
    m = models.RRDBNet.from_config(cell.config)
    b, (h, w), pool = int(t["batch"]), t["image_hw"], int(t["pool"])
    images = [_hdr_image(models.stream_seed(seed, k), b, h, w, device)
              for k in range(pool)]
    rng = np.random.default_rng(models.stream_seed(seed, models.SAMPLES))
    checked = sorted(rng.choice(pool, int(t["check_requests"]),
                                replace=False).tolist())
    return m, images, checked


def decode_closed(cell, seed: int, seconds: float, traced: bool,
                  device) -> Measured:
    """Closed loop of ``hdr_decode`` over a pool of seeded latents on the
    device, at most ``in_flight`` frames launched ahead; the images stay
    on the device."""
    from hdrvae_torch.core.config import HDRDecodeConfig
    from hdrvae_torch.decode import pipeline

    t = cell.traffic
    dev = Device(device)
    precision = _precision(t["tier"])
    hcfg = HDRDecodeConfig()
    b, (h, w), pool = int(t["batch"]), t["latent_hw"], int(t["pool"])
    m, latents, checked = decode_inputs(cell, seed, dev.device)
    dec = _load_decoder(m, seed, dev.device)
    kept: Dict[int, Any] = {}

    def step(n):
        res = pipeline.hdr_decode(dec, latents[n % pool], hcfg, precision)
        if n % pool in checked:
            kept[n % pool] = res

    for n in range(int(t["warmup_frames"])):
        step(n)
    span = _warm_span(dev, traced)
    dev.sync()
    kept.clear()
    dev.reset_peak()
    n, window_s, started = _closed_loop(dev, seconds, int(t["in_flight"]),
                                        span, step)
    peak = dev.peak()
    out_h, out_w = h * m.factor, w * m.factor
    results = {k: (r.image, r.standard, int(r.stats["norm_kind"]),
                   bool(r.used_fallback)) for k, r in kept.items()}
    del kept, dec
    dev.free()

    def check():
        sd = models.make_weights(m, seed, dev.device)
        numbers = [decode_numbers(sd, m, latents[k], *results[k])
                   for k in checked if k in results]
        if len(numbers) < len(checked):
            return {"missing": float(len(checked) - len(numbers))}
        return {key: max(nb[key] for nb in numbers) for key in numbers[0]}

    return Measured(kind="decode", attempted=n, failed=0, window_s=window_s,
                    megapixels=n * b * out_h * out_w / 1e6, peak_bytes=peak,
                    work=work.decoder_work(m, b, h, w, ELSIZE[t["tier"]]),
                    span=span, check=check, started=started,
                    notes={"frames": n, "checked_slots": checked})


def _hdr_image(seed: int, b: int, h: int, w: int, device) -> torch.Tensor:
    """A seeded HDR image [b, h, w, 3]: log-normal values (median 0.25,
    about 6 % of them above 1) over structure at 1/16 of the size, plus
    pixel noise; made on the device."""
    g = models.generator(seed, models.INPUTS, device)
    coarse = torch.randn((b, 3, max(1, h // 16), max(1, w // 16)),
                         device=device, generator=g)
    fine = torch.randn((b, 3, h, w), device=device, generator=g)
    field = torch.nn.functional.interpolate(coarse, size=(h, w),
                                            mode="bilinear",
                                            align_corners=False)
    return (0.25 * torch.exp(0.9 * field + 0.3 * fine)).permute(
        0, 2, 3, 1).contiguous()


def upscale_closed(cell, seed: int, seconds: float, traced: bool,
                   device) -> Measured:
    """Closed loop of ``hdr_upscale`` over a pool of seeded HDR images on
    the device, at most ``in_flight`` requests launched ahead."""
    from hdrvae_torch.core.config import TilingConfig, UpscaleConfig
    from hdrvae_torch.models.zoo import upscaler_from_state_dict
    from hdrvae_torch.upscale import pipeline

    t = cell.traffic
    dev = Device(device)
    precision = _precision(t["tier"])
    b, (h, w), pool = int(t["batch"]), t["image_hw"], int(t["pool"])
    ucfg = UpscaleConfig(tiling=TilingConfig(tile=int(t["tile"]),
                                             overlap=int(t["overlap"])))
    m, images, checked = upscale_inputs(cell, seed, dev.device)
    sd = models.published_keys(m, models.make_weights(m, seed, dev.device))
    net, _, arch = upscaler_from_state_dict(sd, device=dev.device)
    del sd
    kept: Dict[int, torch.Tensor] = {}

    def step(n):
        res = pipeline.hdr_upscale(net, images[n % pool], ucfg,
                                   architecture=arch, precision=precision)
        if n % pool in checked:
            kept[n % pool] = res.image

    for n in range(int(t["warmup_requests"])):
        step(n)
    span = _warm_span(dev, traced)
    dev.sync()
    kept.clear()
    dev.reset_peak()
    n, window_s, started = _closed_loop(dev, seconds, int(t["in_flight"]),
                                        span, step)
    peak = dev.peak()
    del net
    dev.free()

    def check():
        from benchmark.reference import upscale as ref
        sd = models.make_weights(m, seed, dev.device)
        numbers = []
        for k in checked:
            if k not in kept:
                return {"missing": 1.0}
            want = ref.hdr_upscale(sd, m, images[k], int(t["tile"]),
                                   int(t["overlap"]))
            yard = ref.hdr_upscale(sd, m, images[k], int(t["tile"]),
                                   int(t["overlap"]), "bf16")
            numbers.append(gaps_vs(kept[k], want, yard))
        return {key: max(nb[key] for nb in numbers) for key in numbers[0]}

    return Measured(kind="upscale", attempted=n, failed=0,
                    window_s=window_s,
                    megapixels=n * b * h * w * m.scale ** 2 / 1e6,
                    peak_bytes=peak,
                    work=work.scaled(work.rrdbnet_work(
                        m, b, h, w, ELSIZE[t["tier"]]), 2.0),
                    span=span, check=check, started=started,
                    notes={"requests": n, "architecture": arch})


def _pools(mix, pool_per_shape: int, z: int, seed: int) -> Dict:
    """The latents of every shape of the mix, numpy float32 from the
    seed, ``pool_per_shape`` a shape."""
    rng = np.random.default_rng(models.stream_seed(seed, models.INPUTS))
    out = {}
    for e in mix:
        shape = tuple(int(v) for v in e["latent_hw"])
        out[shape] = [rng.standard_normal((1, *shape, z), np.float32)
                      for _ in range(pool_per_shape)]
    return out


def p_rank(values: List[float], q: float) -> float:
    """The nearest-rank q-quantile (q in (0, 1])."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def serve_open(cell, seed: int, seconds: float, traced: bool,
               device) -> Measured:
    """Open loop of requests to ``ServeEngine`` over a ``VAE`` handle:
    Poisson arrivals at the mix's fixed rate, each request timed from
    when it was due to when its response was ready."""
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.serve.engine import ServeEngine

    t = cell.traffic
    dev = Device(device)
    m = models.FluxDecoder.from_config(cell.config)
    precision = _precision(t["tier"])
    pool_n = int(t["pool_per_shape"])
    pools = _pools(t["mix"], pool_n, m.z, seed)
    reqs = traffic.schedule(float(t["rate_per_s"]), seconds, t["mix"],
                            pool_n, int(t.get("schedule_seed", seed)))
    fetch = np.dtype(t["fetch_dtype"])
    engine = ServeEngine(VAE(_load_decoder(m, seed, dev.device), precision),
                         bucket=int(t["bucket"]), depth=int(t["depth"]),
                         max_pending=int(t["max_pending"]))
    rng = np.random.default_rng(models.stream_seed(seed, models.SAMPLES))
    # the sample checked: the first request of the largest shape, the
    # first of a padded shape, and the rest drawn from the seed
    order = rng.permutation(len(reqs)).tolist()
    area = lambda i: reqs[i].shape[0] * reqs[i].shape[1]  # noqa: E731
    bucket = int(t["bucket"])
    padded = [i for i in order if reqs[i].shape[0] % bucket
              or reqs[i].shape[1] % bucket]
    checked = [max(order, key=area)] + padded[:1]
    checked += [i for i in order if i not in checked][
        :max(0, int(t["check_requests"]) - len(checked))]
    checked = set(checked)
    try:
        for lat in pools.values():
            engine.submit(lat[0], fetch_dtype=fetch).result()
        span = _warm_span(dev, traced)
        dev.sync()
        dev.reset_peak()
        done_at = [None] * len(reqs)
        errors: List[Any] = [None] * len(reqs)
        padded_hw: List[Any] = [None] * len(reqs)
        futs: List[Any] = [None] * len(reqs)
        lateness = []
        all_done = threading.Event()
        remaining = [len(reqs)]
        lock = threading.Lock()

        def on_done(i, fut):
            done_at[i] = time.monotonic()
            errors[i] = fut.exception()
            if errors[i] is None:
                padded_hw[i] = fut.result().padded_hw
            if i not in checked:
                futs[i] = None
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    all_done.set()

        s_start, length = _span_window(seconds)
        s_stop = math.inf
        latencies = [math.inf] * len(reqs)
        t0 = time.monotonic()
        started = time.perf_counter()
        for i, r in enumerate(reqs):
            while True:
                now = time.monotonic() - t0
                if span is not None:
                    if span.prof is None and now >= s_start:
                        span.start(sync=False)
                        s_stop = span.t0 - started + length
                    elif span.running and now >= s_stop:
                        span.stop(sync=False)
                nxt = r.due_s
                if span is not None and span.prof is None:
                    nxt = min(nxt, s_start)
                elif span is not None and span.running:
                    nxt = min(nxt, s_stop)
                if now >= r.due_s:
                    break
                time.sleep(max(0.0, nxt - now))
            lateness.append(time.monotonic() - t0 - r.due_s)
            fut = engine.submit(pools[r.shape][r.slot], fetch_dtype=fetch)
            futs[i] = fut
            fut.add_done_callback(lambda f, i=i: on_done(i, f))
        while time.monotonic() - t0 < seconds:
            time.sleep(max(0.0, seconds - (time.monotonic() - t0)))
        if span is not None and span.running:
            span.stop(sync=False)
        pending_at_close = remaining[0]
        all_done.wait(timeout=float(t["late_s"]))
        peak = dev.peak()
        failed, responses = 0, {}
        padded_px = real_px = 0
        for i, r in enumerate(reqs):
            if done_at[i] is None or errors[i] is not None:
                failed += 1
                continue
            f = futs[i]
            latencies[i] = (done_at[i] - t0 - r.due_s) * 1e3
            if f is not None:
                responses[i] = f.result()
        # the padding count, from every response's bucket; a request
        # that never came counts its shape unpadded
        for i, r in enumerate(reqs):
            real = r.shape[0] * r.shape[1]
            real_px += real
            hw = padded_hw[i]
            padded_px += real if hw is None else hw[0] * hw[1]
    finally:
        engine.close()
    del engine
    dev.free()
    megapixels = sum(r.shape[0] * r.shape[1] * m.factor ** 2
                     for i, r in enumerate(reqs)
                     if math.isfinite(latencies[i])) / 1e6

    def check():
        from benchmark.harness.compare import serve_numbers
        sd = models.make_weights(m, seed, dev.device)
        numbers = []
        for i in sorted(checked):
            if i not in responses:
                continue      # failed: counted in ``failed``
            lat = torch.from_numpy(pools[reqs[i].shape][reqs[i].slot]).to(
                dev.device)
            numbers.append(serve_numbers(sd, m, lat, responses[i]))
        if not numbers:
            return {"missing": float(len(checked))}
        return {key: max(nb[key] for nb in numbers) for key in numbers[0]}

    n_req = len(reqs)
    return Measured(kind="serve", attempted=n_req, failed=failed,
                    window_s=seconds, megapixels=megapixels, peak_bytes=peak,
                    work={}, span=span, latencies_ms=latencies,
                    counters={"padded_latent_px": float(padded_px),
                              "real_latent_px": float(real_px)},
                    notes={"requests": n_req,
                           "rate_per_s": n_req / seconds,
                           "lateness_p50_ms": p_rank(lateness, 0.5) * 1e3,
                           "lateness_max_ms": max(lateness) * 1e3,
                           "pending_at_close": pending_at_close,
                           "checked": sorted(checked)},
                    check=check, started=started)


DRIVERS = {"decode_closed": decode_closed, "upscale_closed": upscale_closed,
           "serve_open": serve_open}


def control_numbers(cell, seed: int, device, rounding: str
                    ) -> Dict[str, float]:
    """The numbers of the control: the reference computed with operands
    rounded by ``rounding`` put in the program's place, on the inputs
    that a run of ``seed`` checks (a served cell: the first latent of
    each shape of the mix), at the cell's own sizes."""
    from benchmark.harness import compare
    from benchmark.reference import decoder as rd, upscale as ru
    t = cell.traffic
    numbers = []
    if t["kind"] == "decode_closed":
        m, latents, checked = decode_inputs(cell, seed, device)
        sd = models.make_weights(m, seed, device)
        for k in checked:
            want = rd.hdr_decode(sd, m, latents[k])
            got = rd.hdr_decode(sd, m, latents[k], rounding)
            numbers.append(compare.decode_compare(
                got.image, got.rgb, got.norm_kind, got.used_fallback, want))
    elif t["kind"] == "upscale_closed":
        m, images, checked = upscale_inputs(cell, seed, device)
        sd = models.make_weights(m, seed, device)
        for k in checked:
            want = ru.hdr_upscale(sd, m, images[k], int(t["tile"]),
                                  int(t["overlap"]))
            got = ru.hdr_upscale(sd, m, images[k], int(t["tile"]),
                                 int(t["overlap"]), rounding)
            yard = ru.hdr_upscale(sd, m, images[k], int(t["tile"]),
                                  int(t["overlap"]), "bf16")
            numbers.append(compare.gaps_vs(got, want, yard))
    else:
        m = models.FluxDecoder.from_config(cell.config)
        pools = _pools(t["mix"], int(t["pool_per_shape"]), m.z, seed)
        sd = models.make_weights(m, seed, device)
        for lat in pools.values():
            z = torch.from_numpy(lat[0]).to(device)
            want = rd.hdr_decode(sd, m, z)
            got = rd.hdr_decode(sd, m, z, rounding)
            out = compare.decode_compare(got.image, got.rgb, got.norm_kind,
                                         got.used_fallback, want)
            out["shape_differs"] = 0.0
            numbers.append(out)
    return {key: max(nb[key] for nb in numbers) for key in numbers[0]}
