"""Benchmark harness of the PyTorch port: prints ONE JSON line with the
tracked metrics, as ``bench.py`` does for the JAX package.

Headline metric: HDR decode throughput in megapixels a second at 1024x1024
output (a 128x128 Flux.1 latent through ``hdr_decode``: the decoder and the
HDR epilogue), on one NVIDIA GPU.  Baseline: the reference GPU node's
derived 0.024 MP/s (``README.md``: ~41 s for a 0.999 MP image).

The rows, their names, keys and order are ``bench.py``'s, each on the
port's public entry points (random weights and inputs from numpy seeds):
the whole-image decode (``decode/pipeline.py::hdr_decode``, no summary
fetched inside the timed step), the slab decode
(``sharding/mesh.py::sharded_slab_decode``), the tile grid
(``sharded_tiled_decode(norm_stats="per_tile")``), the exports
(``io/pipeline.py::export_frame_streamed``, ``io/export.py::export_linear``,
``io/pipeline.py::export_stream``), the mixed tier (the 4096^2 row through
``decode/staged.py::staged_hdr_decode``), ``serve/engine.py::ServeEngine``
over an ``api/vae.py::VAE`` handle, and with ``--full`` the seven upscaler
families (``models/zoo.py::upscaler_apply``).  The slab and tile-grid rows
run in this process on the one-rank ``Mesh()`` where one card is visible,
else on one rank a card started through ``sharding/multihost.py``.

Timing: a decode or upscale loop is timed on the card by CUDA events
recorded before its first step and after its last (then one
``torch.cuda.synchronize()``); the export and serve rows by the host clock
after a synchronize, since their work ends on the host.  The first call
builds the kernels, so ``warmup_s`` (``--extra``) includes the build.

Usage: python bench_torch.py [--size 1024] [--runs 5]
                             [--precision fast|mixed|parity] [--quick]
                             [--full] [--batch N] [--tiled]
                             [--device cuda|cpu]

``--device cuda`` (the default) needs a card: without one the harness
exits 2 with no metric line.  ``--device cpu`` runs the kernels' plain
versions.  ``HDRVAE_BENCH_4K=0`` skips the two 4096^2 rows;
``HDRVAE_BENCH_PROBE_TIMEOUT`` bounds the device probe (0 skips it).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REFERENCE_MP_PER_S = 0.024  # BASELINE.md derived throughput

# Test hook: True builds every model at its config's ``with_small()`` (the
# CPU tests' sizes); the card's runs leave it False.
_SMALL_MODELS = False

# the card probe: CUDA initialized and one kernel run, in a subprocess
_PROBE = ("import torch; torch.cuda.init(); "
          "torch.ones(1, device='cuda').sum().item()")


def _time_loop(step, x0, sync, runs: int, events: bool = False) -> float:
    """Average seconds a step over one loop of ``runs`` steps chained by
    data dependency.  ``events``: timed on the card by CUDA events
    recorded before the first step and after the last; else by the host
    clock up to ``sync``."""
    if events:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    x = x0
    for _ in range(runs):
        x = step(x)
    if events:
        end.record()
    sync(x)
    if events:
        return start.elapsed_time(end) / 1e3 / runs
    return (time.perf_counter() - t0) / runs


def bench_step(step, x0, sync, runs: int, warmup: int, events: bool = False):
    """Returns (best_s, mean_s, warmup_s): warm-up steps (the first builds
    the kernels), then two independent timed loops of ``runs`` steps."""
    t0 = time.perf_counter()
    x = x0
    for _ in range(max(1, warmup)):
        x = step(x)
    sync(x)
    warmup_s = time.perf_counter() - t0

    loops = [_time_loop(step, x0, sync, runs, events) for _ in range(2)]
    return min(loops), sum(loops) / len(loops), warmup_s


def _rank_count(device) -> int:
    """Ranks of the slab and tile-grid rows: one a visible card, one on
    the CPU."""
    if device.type != "cuda":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def _on_ranks(n: int, decoder_cfg, dec, case_cls, latent, runs: int,
              warmup: int, device, **case_kw):
    """``bench_step``'s (best_s, mean_s, warmup_s) of a slab or tile-grid
    row on ``n`` ranks started here (``sharding/multihost.py``): a case of
    ``warmup`` requests, then two loops of ``runs`` requests, each request
    timed on its rank (CUDA events on a card) and a loop's time its
    slowest rank's sum.  ``warmup_s`` is the group's wall time less the
    timed requests': the ranks' start, the model load and the warm-up."""
    from hdrvae_torch.sharding import multihost
    z = latent.cpu()
    cases = [case_cls("warmup", "bench", z, requests=max(1, warmup),
                      **case_kw)]
    cases += [case_cls(f"loop{k}.{i}", "bench", z, **case_kw)
              for k in range(2) for i in range(runs)]
    t0 = time.perf_counter()
    ranks = multihost.RankGroup(
        n, {"bench": (decoder_cfg, dec.state_dict())}, cases,
        device=device.type).wait(timeout=3600.0)
    wall_s = time.perf_counter() - t0
    key = "device_ms" if device.type == "cuda" else "wall_ms"
    loops = [max(sum(recs[1 + k * runs + i][key] for i in range(runs))
                 for recs in ranks) / 1e3 / runs for k in range(2)]
    timed_s = max(sum(r["wall_ms"] for r in recs[1:]) for recs in ranks) / 1e3
    return min(loops), sum(loops) / 2, wall_s - timed_s


def _free() -> None:
    """Drop unreferenced device buffers: the next row's programs start from
    an empty cache."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _config(cls):
    """``cls()``, or its ``with_small()`` under the test hook."""
    return cls().with_small() if _SMALL_MODELS else cls()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=1024,
                        help="headline output image edge in pixels")
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--precision", choices=("fast", "mixed", "parity"),
                        default="fast")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--tiled", action="store_true",
                        help="headline uses the sharded slab decode path")
    parser.add_argument("--quick", action="store_true",
                        help="headline metric only (skip extra rows)")
    parser.add_argument("--big-size", type=int, default=2048,
                        help="edge for the extra (2048-class) rows")
    parser.add_argument("--full", action="store_true",
                        help="also run batch-4 and tile-grid rows")
    parser.add_argument("--extra", action="store_true",
                        help="print per-row detail to stderr")
    parser.add_argument("--fetch-workers", type=int, default=1,
                        help="concurrent device->host fetch streams for "
                             "the pipelined export row")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card; cpu runs "
                             "the kernels' plain versions)")
    args = parser.parse_args(argv)

    import torch
    device = torch.device(args.device)

    # Fail fast if the card cannot be reached: probe it in a subprocess
    # with a timeout and exit non-zero with NO metric line rather than
    # hanging or emitting a bogus value.
    probe_s = float(os.environ.get("HDRVAE_BENCH_PROBE_TIMEOUT", "600"))
    if device.type == "cuda" and probe_s > 0:
        try:
            subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, timeout=probe_s, check=True)
        except subprocess.TimeoutExpired:
            print(f"bench: CUDA device unreachable (the probe exceeded "
                  f"{probe_s:.0f}s); no metrics emitted", file=sys.stderr)
            return 2
        except subprocess.CalledProcessError as e:
            print("bench: CUDA device probe failed:\n"
                  + e.stderr.decode(errors="replace")[-500:],
                  file=sys.stderr)
            return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: --device cuda but no CUDA device; "
                           "--device cpu runs the plain versions")

    tmpdir = tempfile.mkdtemp(prefix="hdrvae-bench-")
    try:
        with torch.no_grad():
            result = _bench(args, device, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(json.dumps(result))
    return 0


def _bench(args, device, tmpdir: str) -> dict:
    """Every row of the run ``args`` asks for: the headline row, with the
    others under ``extra_metrics``."""
    import numpy as np
    import torch

    from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                          Precision)
    from hdrvae_torch.decode.pipeline import hdr_decode
    from hdrvae_torch.models.params import init_decoder
    from hdrvae_torch.sharding import multihost
    from hdrvae_torch.sharding.mesh import (Mesh, sharded_slab_decode,
                                            sharded_tiled_decode)

    cuda = device.type == "cuda"
    decoder_cfg = _config(DecoderConfig)
    cfg = HDRDecodeConfig()
    precision = {"fast": Precision.fast, "mixed": Precision.mixed,
                 "parity": Precision.parity}[args.precision]()
    dec = init_decoder(decoder_cfg, seed=0, device=device)
    n_ranks = _rank_count(device)
    mesh = Mesh(device)

    def latent_for(size: int, batch: int = 1):
        edge = size // decoder_cfg.spatial_scale
        return torch.from_numpy(np.random.default_rng(1).standard_normal(
            (batch, edge, edge, decoder_cfg.z_channels)).astype(
                np.float32)).to(device)

    def sync(x):
        if cuda:
            torch.cuda.synchronize(device)

    def whole_step(x):
        res = hdr_decode(dec, x, cfg, precision)
        return x + res.image.mean() * 1e-6

    def slab_step(x):
        res = sharded_slab_decode(dec, x, cfg, mesh=mesh,
                                  precision=precision)
        return x + res.image.mean() * 1e-6

    def tile_grid_step(x):
        img = sharded_tiled_decode(dec, x, cfg, mesh=mesh,
                                   norm_stats="per_tile",
                                   precision=precision)
        return x + img.mean() * 1e-6

    # the rows that run across ranks when more than one card is visible
    ranked = {slab_step: (multihost.SlabCase, {}),
              tile_grid_step: (multihost.TiledCase,
                               {"norm_stats": "per_tile"})}

    detail = {"device": (torch.cuda.get_device_name(device) if cuda
                         else str(device)),
              "precision": args.precision, "n_devices": n_ranks}

    def row(name, mp, best):
        # vs_baseline from the value as printed, so that a reader gets it
        # back from the line (bench.py's, from the unrounded value, can
        # differ by 0.1)
        value = round(mp / best, 3)
        return {"metric": name, "value": value, "unit": "MP/s",
                "vs_baseline": round(value / REFERENCE_MP_PER_S, 1)}

    def log_extra(record):
        if args.extra:
            print(json.dumps({**detail, **record}), file=sys.stderr)

    def run_row(name, step, size, batch=1, runs=None):
        x0, runs = latent_for(size, batch), runs or args.runs
        if step in ranked and n_ranks > 1:
            case_cls, kw = ranked[step]
            best, mean, warm = _on_ranks(
                n_ranks, decoder_cfg, dec, case_cls, x0, runs, args.warmup,
                device, precision=precision, **kw)
        else:
            best, mean, warm = bench_step(step, x0, sync, runs, args.warmup,
                                          events=cuda)
        log_extra({"metric": name, "best_s": round(best, 4),
                   "mean_s": round(mean, 4), "warmup_s": round(warm, 1)})
        return row(name, batch * size * size / 1e6, best)

    headline_step = slab_step if args.tiled else whole_step
    headline_name = (f"hdr_decode_mp_per_s_{args.size}"
                     + ("_tiled" if args.tiled else "")
                     + (f"_b{args.batch}" if args.batch > 1 else ""))
    if args.batch > 1:
        headline_step = whole_step
    result = run_row(headline_name, headline_step, args.size, args.batch)

    extra_rows = []
    if not args.quick:
        big = args.big_size
        extra_rows.append(run_row(f"hdr_decode_mp_per_s_{big}", whole_step,
                                  big, runs=3))
        extra_rows.append(run_row(f"hdr_decode_mp_per_s_{big}_slab",
                                  slab_step, big, runs=3))

        # 4K whole-image EXACT decode (global GroupNorm statistics, the
        # full mid attention over 512^2 = 262k tokens).
        # HDRVAE_BENCH_4K=0 skips the 4K rows.
        want_4k = os.environ.get("HDRVAE_BENCH_4K", "1") != "0"
        if want_4k:
            extra_rows.append(run_row("hdr_decode_mp_per_s_4096_exact",
                                      whole_step, 4096, runs=2))
            _free()

        # decode -> linear EXR on disk (+ verify)
        from hdrvae_torch.core.config import ExportConfig
        from hdrvae_torch.io.export import export_linear
        from hdrvae_torch.io.pipeline import (export_frame_streamed,
                                              export_stream)
        lat_big = latent_for(big)
        export_cfg = ExportConfig(filename_prefix="bench",
                                  output_path=tmpdir,
                                  bit_depth="32bit", compression="zip")

        def checked(res):
            if res.error is not None:
                raise RuntimeError(res.error)

        def export_step(x):
            # the STREAMED single-frame export: band k+1 copies off the
            # card while band k encodes on host threads
            image = hdr_decode(dec, x, cfg, precision).image
            checked(export_frame_streamed(image[0], export_cfg,
                                          default_output_dir=tmpdir))
            return x

        def export_step_serial(x):
            # the serial path: whole-frame fetch, then encode, then write
            image = hdr_decode(dec, x, cfg, precision).image
            checked(export_linear(image.cpu().numpy(), export_cfg,
                                  default_output_dir=tmpdir))
            return x

        mp = big * big / 1e6
        for name, step in ((f"hdr_decode_export_mp_per_s_{big}",
                            export_step),
                           (f"hdr_decode_export_serial_mp_per_s_{big}",
                            export_step_serial)):
            best, mean, warm = bench_step(step, lat_big, sync, runs=2,
                                          warmup=1)
            extra_rows.append(row(name, mp, best))

        # a PIPELINED 4-frame sequence, 16-bit EXR: frame N+1 decodes on
        # the card while frame N is fetched (float16 on the card) and
        # frame N-1 encodes and writes on host threads
        def make_frame(i):
            def thunk():
                return hdr_decode(dec, lat_big + i * 1e-4, cfg,
                                  precision).image[0]
            return thunk

        n_frames = 4
        pipe_cfg = ExportConfig(filename_prefix="pipe", output_path=tmpdir,
                                bit_depth="16bit", compression="zip",
                                frame_sequence=True)
        # warm the float16 fetch path once
        export_stream([make_frame(0)], pipe_cfg, default_output_dir=tmpdir,
                      fetch_workers=args.fetch_workers)
        best_p = None
        for _ in range(2):
            sync(None)
            t0 = time.perf_counter()
            res = export_stream([make_frame(i) for i in range(n_frames)],
                                pipe_cfg, default_output_dir=tmpdir,
                                fetch_workers=args.fetch_workers)
            dt = time.perf_counter() - t0
            checked(res)
            best_p = dt if best_p is None else min(best_p, dt)
        extra_rows.append(row(f"hdr_decode_export_pipelined_mp_per_s_{big}",
                              n_frames * mp, best_p))
        log_extra({"metric": "export_pipelined", "frames": n_frames,
                   "total_s": round(best_p, 3),
                   "fetch_workers": args.fetch_workers})

        # the mixed (contract) tier: float32 activations, the 3-pass
        # attention
        mixed = Precision.mixed()

        def mixed_step(x):
            res = hdr_decode(dec, x, cfg, mixed)
            return x + res.image.mean() * 1e-6

        extra_rows.append(run_row(
            f"hdr_decode_mixed_mp_per_s_{args.size}", mixed_step,
            args.size))
        extra_rows.append(run_row(
            f"hdr_decode_mixed_mp_per_s_{big}", mixed_step, big, runs=3))

        # the north star as one composition: mixed decode -> streamed
        # 32-bit zip EXR on disk -> read-back verify
        def export_step_mixed(x):
            image = hdr_decode(dec, x, cfg, mixed).image
            checked(export_frame_streamed(image[0], export_cfg,
                                          default_output_dir=tmpdir))
            return x

        best, mean, warm = bench_step(export_step_mixed, lat_big, sync,
                                      runs=2, warmup=1)
        extra_rows.append(row(f"hdr_decode_mixed_export_mp_per_s_{big}",
                              mp, best))

        # the mixed tier at 4K: the staged executor (row slabs in bounded
        # memory, the same function)
        from hdrvae_torch.decode.staged import staged_hdr_decode

        def staged_step(x):
            res = staged_hdr_decode(dec, x, cfg, mixed)
            return x + res.image.mean() * 1e-6

        if want_4k:
            extra_rows.append(run_row("hdr_decode_mixed_mp_per_s_4096",
                                      staged_step, 4096, runs=1))

        # the serve rows below hold 2048-class decodes: drop every device
        # buffer earlier rows left alive first
        del lat_big
        _free()

        # the serving layer: a mixed-resolution request stream through
        # ServeEngine, in the headline tier and in the mixed tier at two
        # request scales; p50 / p95 over the timed requests in the row
        from hdrvae_torch.api.vae import VAE
        from hdrvae_torch.serve.engine import ServeEngine

        scale = decoder_cfg.spatial_scale

        def serve_row(serve_prec, label, size, n_round, uniform=False):
            e1 = size // scale
            if uniform:
                # exact single-shape serving (no bucket)
                req_shapes = [(e1, e1)] * 4
                bucket = None
            else:
                req_shapes = [(e1, e1), (e1 - e1 // 4, e1),
                              (e1, e1 - e1 // 4), (e1, e1)]
                bucket = e1 // 2
            with ServeEngine(VAE(dec, serve_prec), bucket=bucket,
                             max_pending=64) as engine:
                engine.warmup(sorted(set(req_shapes)))
                base_lat = latent_for(size).cpu().numpy()
                lat_np = {s: np.ascontiguousarray(base_lat[:, :s[0], :s[1]])
                          for s in set(req_shapes)}
                reqs = req_shapes * n_round
                sync(None)
                t0 = time.perf_counter()
                # float16 fetch: the 16-bit EXR responses' representative
                # serving config, half the device-to-host bytes
                futs = [engine.submit(lat_np[s], fetch_dtype=np.float16)
                        for s in reqs]
                resps = [f.result() for f in futs]
                serve_s = time.perf_counter() - t0
            mp_served = sum(r.image.shape[1] * r.image.shape[2]
                            for r in resps) / 1e6
            _free()
            # quantiles over the TIMED requests only
            lats = sorted(r.latency_s for r in resps)
            out = {**row(f"serve_decode{label}_mp_per_s_{size}", mp_served,
                         serve_s),
                   "p50_s": round(lats[len(lats) // 2], 3),
                   "p95_s": round(lats[max(0, -(-len(lats) * 95 // 100)
                                           - 1)], 3)}
            log_extra({"metric": f"serve{label}", "size": size,
                       "requests": len(reqs), "total_s": round(serve_s, 3),
                       "p50_s": out["p50_s"], "p95_s": out["p95_s"]})
            return out

        # one failing serve variant must not wipe the whole record
        for srow in (lambda: serve_row(precision, "", args.size, 2),
                     lambda: (serve_row(Precision.mixed(), "_mixed",
                                        args.size, 2)
                              if args.precision != "mixed" else None),
                     lambda: serve_row(Precision.mixed(), "_mixed", big, 1,
                                       uniform=True)):
            try:
                srow_out = srow()
            except Exception as e:   # noqa: BLE001 - record and move on
                print(f"bench: serve row failed: {e!r}", file=sys.stderr)
                srow_out = None
                _free()
            if srow_out is not None:
                extra_rows.append(srow_out)

        if args.full:
            extra_rows.append(run_row(f"hdr_decode_mp_per_s_{args.size}_b4",
                                      whole_step, args.size, batch=4,
                                      runs=2))
            extra_rows.append(run_row(
                f"hdr_decode_mp_per_s_{big}_tile_grid", tile_grid_step,
                big, runs=2))
            _free()
            extra_rows += _upscale_rows(args, device, precision, sync,
                                        log_extra)

    if extra_rows:
        result["extra_metrics"] = extra_rows
    return result


def _upscale_rows(args, device, precision, sync, log_extra) -> list:
    """The seven upscaler families' x4 rows (``--full``): one tile forward
    a step through ``upscaler_apply``, MP/s of output pixels, no reference
    baseline (the reference publishes no upscaler timing)."""
    import numpy as np
    import torch

    from hdrvae_torch.models import hat, plksr, rrdbnet, span, srvgg, \
        swin2sr, swinir
    from hdrvae_torch.models.zoo import upscaler_apply

    def tile(seed, edge):
        return torch.from_numpy((np.random.default_rng(seed).standard_normal(
            (1, edge, edge, 3)) * 0.3).astype(np.float32)).to(device)

    # (metric, config class, init, weight seed, (tile seed, edge), runs)
    # in bench.py's order: ESRGAN, SwinIR-M and Swin2SR on one 512^2 tile,
    # HAT on a 256^2 tile (the heaviest), Compact, SPAN and RealPLKSR on
    # 512^2
    families = (
        ("esrgan_x4_upscale_mp_per_s_512tile", rrdbnet.RRDBNetConfig,
         rrdbnet.init_rrdbnet, 2, (3, 512), 3),
        ("swinir_x4_upscale_mp_per_s_512tile", swinir.SwinIRConfig,
         swinir.init_swinir, 4, (3, 512), 2),
        ("swin2sr_x4_upscale_mp_per_s_512tile", swin2sr.Swin2SRConfig,
         swin2sr.init_swin2sr, 9, (3, 512), 2),
        ("hat_x4_upscale_mp_per_s_256tile", hat.HATConfig, hat.init_hat, 5,
         (6, 256), 2),
        ("compact_x4_upscale_mp_per_s_512tile", srvgg.SRVGGConfig,
         srvgg.init_srvgg, 7, (3, 512), 3),
        ("span_x4_upscale_mp_per_s_512tile", span.SPANConfig,
         span.init_span, 8, (3, 512), 3),
        ("realplksr_x4_upscale_mp_per_s_512tile", plksr.RealPLKSRConfig,
         plksr.init_realplksr, 9, (3, 512), 3))
    rows = []
    for metric, cls, init, seed, (tile_seed, edge), runs in families:
        up_cfg = _config(cls)
        net = init(up_cfg, seed, device=device)

        def step(x):
            y = upscaler_apply(net, x, precision=precision)
            return x + y.mean() * 1e-6

        best, mean, warm = bench_step(step, tile(tile_seed, edge), sync,
                                      runs=runs, warmup=1,
                                      events=device.type == "cuda")
        mp_out = (edge * up_cfg.scale) ** 2 / 1e6
        rows.append({"metric": metric, "value": round(mp_out / best, 3),
                     "unit": "MP/s", "vs_baseline": None})
        log_extra({"metric": metric.replace("_mp_per_s", ""),
                   "best_s": round(best, 4), "warmup_s": round(warm, 1)})
        del net, step
        _free()
    return rows


if __name__ == "__main__":
    sys.exit(main())
