"""hdrvae_torch command-line interface, as ``hdrvae/cli/main.py``.

Subcommands:
  decode   latent (.npy / .safetensors, or a random one) -> HDR decode ->
           EXR / HDR file (a single-frame EXR streamed off the card);
           ``--tiled`` the exact slab-sharded decode across ``--mesh``
           ranks
  upscale  EXR / HDR / .npy image -> HDR upscale -> EXR / HDR file;
           ``--sharded`` its tiles dealt across ranks
  export   re-export an image file through the export pipeline
  convert  torch VAE / upscaler checkpoint -> safetensors of the port's
           modules (host only)
  inspect  print a checkpoint's or the built-in decoder's structure (host
           only)
  run      execute a workflow JSON graph (``api/graph.py``)
  serve    HTTP decode service (POST .npy latents to /v1/decode, get
           EXR / HDR / npy back), over one ServeEngine on one card;
           ``--sharded`` the exact slab-sharded decode on ``--mesh`` ranks,
           this process rank 0 and the HTTP front end
  bench    the benchmark harness ``bench_torch.py`` (repository root,
           ``bench.py``'s rows on the card), one JSON line

Every subcommand takes the JAX CLI's flags, defaults and choices, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions), and prints the same JSON lines.  ``--tiled`` and ``--sharded``
start their ranks from this one command (``sharding/multihost.py``):
one a visible card, as JAX's mesh takes every device (one on the CPU),
or ``--mesh`` of them (decode, serve), ranks beyond the card count sharing
a card on gloo, and with ``--device cpu`` gloo ranks on the CPU.  Rank 0
alone writes the files and prints the JSON lines; a failed rank fails the
command; each rank's record is logged at INFO.  ``serve`` stops on SIGINT
or SIGTERM: the engine drains, tells the other ranks to stop and waits
for them.  ``serve --bucket`` omitted takes the engine's default: 64, and
no bucket with ``--sharded`` (the JAX CLI passes 64 there too, which
bypasses its engine's mesh default).

    python -m hdrvae_torch.cli.main decode --size 1024 --bit-depth 16bit
    python -m hdrvae_torch.cli.main decode --tiled --mesh 2 --size 2048
    python -m hdrvae_torch.cli.main serve --sharded --mesh 2 --port 8475
    python -m hdrvae_torch.cli.main bench --size 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import sys

import numpy as np

logger = logging.getLogger("hdrvae_torch.cli")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the longest a command's ranks may run before the group is stopped
RANK_TIMEOUT_S = 3600.0


def _load_latent(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        sd = load_file(path)
        if len(sd) != 1:
            raise ValueError(
                f"latent safetensors must hold one tensor, found "
                f"{sorted(sd)}")
        return next(iter(sd.values()))
    raise ValueError(f"unsupported latent format: {path}")


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".exr"):
        from hdrvae_torch.io import exr
        return exr.read_exr(path)
    if path.endswith(".hdr"):
        from hdrvae_torch.io import hdr
        return hdr.read_hdr(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise ValueError(f"unsupported image format: {path}")


def _add_export_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--prefix", default="hdrvae")
    p.add_argument("--output-path", default="")
    p.add_argument("--format", choices=("exr", "hdr"), default="exr")
    p.add_argument("--bit-depth", choices=("16bit", "32bit"),
                   default="32bit")
    p.add_argument("--compression",
                   choices=("none", "rle", "zip", "piz", "pxr24"),
                   default="zip")
    p.add_argument("--versioning", action="store_true")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (default: the card)")


def _parse_precision(args):
    """--precision's tier and the legacy --parity override.  --parity with
    an explicit non-parity --precision is a contradiction and exits instead
    of silently running parity."""
    from hdrvae_torch.core.config import Precision
    if getattr(args, "parity", False):
        if args.precision not in ("fast", "parity"):
            # "fast" is the argparse default, so a bare --parity still
            # works; anything else was asked for and clashes
            raise SystemExit(
                f"--parity contradicts --precision {args.precision}; "
                "pass only one (--parity is the legacy spelling of "
                "--precision parity)")
        return Precision.parity()
    return {"fast": Precision.fast, "mixed": Precision.mixed,
            "parity": Precision.parity}[args.precision]()


def _export_cfg(args, **kw):
    from hdrvae_torch.core.config import ExportConfig
    return ExportConfig(filename_prefix=args.prefix,
                        output_path=args.output_path,
                        format=args.format, bit_depth=args.bit_depth,
                        compression=args.compression,
                        versioning=args.versioning, **kw)


def _print_export(res) -> str:
    if res.error:
        raise SystemExit(res.error)
    print(json.dumps({"filepath": res.last, **res.verify_stats}))
    return res.last


def _output_dir() -> str:
    from hdrvae_torch.api import folders
    return folders.get_output_directory()


def _export(image, args) -> str:
    from hdrvae_torch.io.export import export_linear
    return _print_export(export_linear(
        image, _export_cfg(args), default_output_dir=_output_dir()))


def _vae(args, precision=None):
    """The decoder: ``--vae``'s checkpoint (topology inferred from its
    shapes), else random Flux.1 weights from seed 0, on ``--device``."""
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.core.config import DecoderConfig, Precision
    precision = precision or Precision()
    if args.vae:
        return VAE.load(args.vae, precision=precision, device=args.device)
    logger.warning("no --vae checkpoint given; using random weights")
    return VAE.random_init(seed=0, config=DecoderConfig(),
                           precision=precision, device=args.device)


def _latent(args, cfg, batch: int) -> np.ndarray:
    if args.latent:
        latent = _load_latent(args.latent)
    else:
        rng = np.random.default_rng(args.seed)
        edge = args.size // cfg.spatial_scale
        latent = rng.standard_normal(
            (batch, edge, edge, cfg.z_channels)).astype(np.float32)
    return latent[None] if latent.ndim == 3 else latent


def _hdr_cfg(args):
    from hdrvae_torch.core.config import HDRDecodeConfig
    return HDRDecodeConfig(hdr_mode=args.mode,
                           conservative_ev_multiplier=args.ev_multiplier)


def _finish_decode(result, args) -> None:
    """Print a decode's summary and export its image: a single-frame EXR
    streamed off the card in scanline bands while earlier bands encode
    (the same file as the serial export), anything else serially."""
    from hdrvae_torch.decode.pipeline import decode_summary
    print(json.dumps(decode_summary(result)))
    if result.image.shape[0] == 1 and args.format == "exr":
        from hdrvae_torch.io.pipeline import export_frame_streamed
        _print_export(export_frame_streamed(
            result.image[0], _export_cfg(args),
            default_output_dir=_output_dir()))
    else:
        _export(result.image, args)


def _export_frames(decode_frame, n: int, args) -> None:
    """A frame sequence: frame N+1 decodes on the card while frame N is
    fetched and frame N-1 encodes and writes (io/pipeline.py);
    ``decode_frame(i)`` is frame i's [H, W, 3] image."""
    from hdrvae_torch.io.pipeline import export_stream

    def make_frame(i):
        return lambda: decode_frame(i)

    res = export_stream([make_frame(i) for i in range(n)],
                        _export_cfg(args, frame_sequence=n > 1),
                        default_output_dir=_output_dir())
    if res.error:
        raise SystemExit(res.error)
    print(json.dumps({"frames": len(res.filepaths),
                      "last": res.last, **res.verify_stats}))


def _device_type(args) -> str:
    import torch
    return torch.device(args.device).type


def _mesh_size(args) -> int:
    """``--mesh`` (decode, serve), else one rank a visible card (one on
    the CPU)."""
    if getattr(args, "mesh", None) is not None:
        if args.mesh < 1:
            raise SystemExit(f"--mesh must be >= 1, got {args.mesh}")
        return args.mesh
    if _device_type(args) == "cpu":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def _on_ranks(args, data, decoders=None, upscalers=None) -> int:
    """Run this command's work on :func:`_mesh_size` ranks started here
    (``sharding/multihost.py``), print what rank 0 printed, and fail with
    the ranks' logs if any rank failed.  Each rank's record (backend,
    times, kernel launches) is logged at INFO, the record itself in the
    log record's ``rank_record``."""
    from hdrvae_torch.sharding import multihost
    fields = {k: v for k, v in vars(args).items() if k != "func"}
    case = multihost.CommandCase("cli", args.command, fields, data, "cli")
    try:
        # the ranks in this directory: relative output paths stay the
        # user's
        ranks = multihost.RankGroup(
            _mesh_size(args), decoders or {}, [case], upscalers=upscalers,
            device=_device_type(args), cwd=os.getcwd()
        ).wait(timeout=RANK_TIMEOUT_S)
    except RuntimeError as e:
        raise SystemExit(f"{args.command} on ranks failed: {e}") from None
    for rank, (rec,) in enumerate(ranks):
        logger.info("rank %d (%s): %.1f ms, launches %s", rank,
                    rec["backend"], rec["wall_ms"],
                    {k: v for k, v in rec["counts"].items() if v},
                    extra={"rank_record": rec})
    sys.stdout.write(ranks[0][0]["lines"])
    return 0


def run_on_rank(case, model, mesh) -> None:
    """A :class:`multihost.CommandCase` on one rank: the decode (the slab
    decode across the ranks, a frame sequence frame by frame with
    ``--pipelined``) or the sharded upscale of ``case.data`` with
    ``model``; rank 0 alone prints and writes the files."""
    from hdrvae_torch.sharding.mesh import (sharded_hdr_upscale,
                                            sharded_slab_decode)
    args = argparse.Namespace(**case.args)
    lead = mesh.rank == 0
    precision = _parse_precision(args)
    if case.command == "upscale":
        net, arch = model
        result = sharded_hdr_upscale(net, case.data.to(mesh.device),
                                     _upscale_cfg(args), architecture=arch,
                                     mesh=mesh, precision=precision)
        if lead:
            _finish_upscale(result, arch, net.cfg.scale, True, args)
        return
    latent = case.data.to(mesh.device)
    hdr_cfg = _hdr_cfg(args)

    def decode(z):
        return sharded_slab_decode(model, z, hdr_cfg, mesh=mesh,
                                   precision=precision)

    if args.pipelined:
        done = []

        def decode_frame(i):
            done.append(i)
            return decode(latent[i:i + 1]).image[0]
        try:
            if lead:
                _export_frames(decode_frame, latent.shape[0], args)
        finally:
            # every frame on every rank, also after a failed write on rank
            # 0: the other ranks wait on it in their collectives
            for i in range(len(done), latent.shape[0]):
                decode_frame(i)
        return
    result = decode(latent)
    if lead:
        _finish_decode(result, args)


def cmd_decode(args) -> int:
    import torch

    from hdrvae_torch.decode.pipeline import hdr_decode

    precision = _parse_precision(args)
    if args.tiled:
        # the exact slab decode across ranks: the weights on the host,
        # written once for the ranks
        vae = _vae(argparse.Namespace(**{**vars(args), "device": "cpu"}),
                   precision)
        latent = torch.from_numpy(_latent(args, vae.config, args.batch))
        return _on_ranks(args, latent, decoders={
            "cli": (vae.config, vae.decoder.state_dict())})
    vae = _vae(args, precision)
    latent = _latent(args, vae.config, args.batch)
    hdr_cfg = _hdr_cfg(args)
    if args.pipelined:
        def decode_frame(i):
            one = torch.from_numpy(latent[i:i + 1]).to(vae.device)
            return hdr_decode(vae.decoder, one, hdr_cfg, precision).image[0]
        _export_frames(decode_frame, latent.shape[0], args)
        return 0
    _finish_decode(hdr_decode(vae.decoder,
                              torch.from_numpy(latent).to(vae.device),
                              hdr_cfg, precision), args)
    return 0


def _upscale_cfg(args):
    from hdrvae_torch.core.config import TilingConfig, UpscaleConfig
    return UpscaleConfig(small_blur=args.small_blur,
                         local_fix=args.local_fix,
                         upscale_method=args.upscale_method,
                         tiling=TilingConfig(tile=args.tile,
                                             overlap=args.overlap))


def _finish_upscale(result, arch: str, scale: int, sharded: bool,
                    args) -> None:
    print(json.dumps({"architecture": arch, "scale": scale,
                      "sharded": sharded,
                      "out_shape": list(result.image.shape)}))
    _export(result.image, args)


def cmd_upscale(args) -> int:
    import torch

    from hdrvae_torch.models.zoo import (load_upscale_model,
                                         upscaler_state_dict)
    from hdrvae_torch.upscale.pipeline import hdr_upscale

    # the batch axis added by torch: numpy's new axis has stride 0
    image = torch.from_numpy(np.asarray(_load_image(args.image),
                                        np.float32))
    if image.dim() == 3:
        image = image[None]
    if args.sharded:
        # the tiles dealt across ranks: the weights on the host, written
        # once for the ranks with their family
        net, _, arch = load_upscale_model(args.model, device="cpu")
        return _on_ranks(args, image, upscalers={
            "cli": (arch, upscaler_state_dict(net))})
    net, model_cfg, arch = load_upscale_model(args.model,
                                              device=args.device)
    result = hdr_upscale(net, image.to(args.device), _upscale_cfg(args),
                         architecture=arch, precision=_parse_precision(args))
    _finish_upscale(result, arch, model_cfg.scale, False, args)
    return 0


def cmd_export(args) -> int:
    _export(_load_image(args.image), args)
    return 0


def cmd_convert(args) -> int:
    """A torch checkpoint as safetensors of the port's modules: ``vae``
    writes ``decoder.`` + the decoder's state dict (the JAX CLI's keys and
    arrays), ``upscaler`` the loaded module's state dict
    (``zoo.upscaler_state_dict``), which the port's zoo loads back (JAX's
    writes its own parameter paths instead)."""
    import torch
    from safetensors.torch import save_file

    if args.kind == "vae":
        from hdrvae_torch.models.params import (decoder_from_state_dict,
                                                decoder_weights,
                                                infer_decoder_config)
        if args.input.endswith(".safetensors"):
            from safetensors.torch import load_file
            sd = load_file(args.input)
        else:
            sd = torch.load(args.input, map_location="cpu",
                            weights_only=True)
        # nested containers (an ldm .ckpt keeps its weights under
        # 'state_dict'), unwrapped as ``inspect`` unwraps them
        for container in ("params_ema", "params", "state_dict"):
            if isinstance(sd.get(container), dict):
                sd = sd[container]
                break
        cfg = infer_decoder_config(sd)
        print(json.dumps({"inferred_config": {
            "z_channels": cfg.z_channels, "ch": cfg.ch,
            "ch_mult": list(cfg.ch_mult),
            "num_res_blocks": cfg.num_res_blocks,
            "attn_mid": cfg.attn_mid,
            "scale_factor": cfg.scale_factor,
            "shift_factor": cfg.shift_factor}}))
        dec = decoder_from_state_dict(decoder_weights(sd, cfg), cfg,
                                      device="cpu")
        save_file({f"decoder.{k}": v.contiguous()
                   for k, v in dec.state_dict().items()}, args.output)
    else:   # any family of the zoo
        from hdrvae_torch.models.zoo import (load_upscale_model,
                                             upscaler_state_dict)
        net, cfg, arch = load_upscale_model(args.input, device="cpu")
        save_file({k: v.contiguous()
                   for k, v in upscaler_state_dict(net).items()},
                  args.output)
        print(json.dumps({"architecture": arch, "scale": cfg.scale,
                          "config": {k: v for k, v in
                                     dataclasses.asdict(cfg).items()
                                     if isinstance(v, (int, float, str,
                                                       bool))}}))
    print(json.dumps({"output": args.output}))
    return 0


def cmd_inspect(args) -> int:
    from hdrvae_torch.utils.introspect import (describe_params,
                                               describe_state_dict)
    if args.path:
        print(describe_state_dict(args.path))
    else:
        import torch

        from hdrvae_torch.core.config import DecoderConfig
        from hdrvae_torch.models.decoder import Decoder
        with torch.device("meta"):     # shapes alone
            dec = Decoder(DecoderConfig())
        print(describe_params(dec, name="flux1-vae-decoder"))
    return 0


def cmd_run(args) -> int:
    """Execute a workflow JSON graph: the latent and the VAE are supplied
    as the external inputs ``latent_source`` and ``vae_loader`` (or, for a
    ComfyUI export, by the type of the node they replace)."""
    from hdrvae_torch.api.comfy import (BUILTIN_NODE_MAPPINGS,
                                        NODE_CLASS_MAPPINGS)
    from hdrvae_torch.api.graph import (GraphExecutor,
                                        convert_comfyui_workflow,
                                        is_comfyui_format)
    from hdrvae_torch.api.nodes import HDRUpscaleWithModel

    # parse the graph before building any model, so a bad file fails fast
    with open(args.workflow) as f:
        workflow = json.load(f)
    if "nodes" not in workflow:
        raise SystemExit(f"{args.workflow}: no 'nodes' list in workflow")

    vae = _vae(args)
    latent = _latent(args, vae.config, 1)
    externals = {"latent_source": ({"samples": latent},),
                 "vae_loader": (vae,)}
    if is_comfyui_format(workflow):
        converted = convert_comfyui_workflow(workflow,
                                             dict(NODE_CLASS_MAPPINGS))
        for key in converted.get("external_keys", []):
            low = key.lower()
            if "vae" in low:
                externals[key] = (vae,)
            elif "sampler" in low or "latent" in low:
                externals[key] = ({"samples": latent},)
            else:
                raise SystemExit(
                    f"workflow needs external input {key!r}; only VAE "
                    "and latent/sampler sources can be auto-supplied")

    # the upscale node on --device (it has no device socket)
    upscale = type("HDRUpscaleWithModel", (HDRUpscaleWithModel,),
                   {"device": args.device})
    registry = {**NODE_CLASS_MAPPINGS, **BUILTIN_NODE_MAPPINGS,
                "HDRUpscaleWithModel": upscale}
    results = GraphExecutor(registry, externals).run(workflow)
    for node_id, outputs in results.items():
        desc = [tuple(o.shape) if hasattr(o, "shape") else o
                for o in outputs]
        print(json.dumps({"node": node_id,
                          "outputs": [str(d) for d in desc]}))
    return 0


def _sigterm_stops() -> None:
    """SIGTERM stops ``serve`` as SIGINT does (``serve_forever`` closes
    the engine on KeyboardInterrupt)."""
    def stop(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, stop)


def _warmup(engine, args, scale: int) -> None:
    if args.warmup:
        sizes = [int(s) // scale for s in args.warmup.split(",") if s]
        logger.info("warming up latent sizes %s ...", sizes)
        engine.warmup([(s, s) for s in sizes])


def cmd_serve(args) -> int:
    from hdrvae_torch.core.config import HDRDecodeConfig
    from hdrvae_torch.serve.engine import ServeEngine
    from hdrvae_torch.serve.http import serve_forever

    vae = _vae(args, _parse_precision(args))
    kw = dict(hdr_cfg=HDRDecodeConfig(hdr_mode=args.mode),
              max_pending=args.max_pending,
              deadline_s=args.deadline if args.deadline > 0 else None)
    if args.bucket is not None:      # else the engine's default
        kw["bucket"] = args.bucket if args.bucket > 0 else None
    _sigterm_stops()
    if args.sharded:
        return _serve_on_ranks(args, vae, kw)
    engine = ServeEngine(vae, **kw)
    _warmup(engine, args, vae.config.spatial_scale)
    serve_forever(engine, args.host, args.port)
    return 0


def _serve_on_ranks(args, vae, engine_kw: dict) -> int:
    """``serve --sharded``: this process is rank 0 of :func:`_mesh_size`
    ranks started here (the others run ``serve.ranks.follow`` on the same
    weights) and serves HTTP over ``ServeEngine(mesh=)``.  It prints the
    group's backend and the other ranks' process ids, logs each one's
    record at INFO once it stopped, and fails if one failed or the group
    broke (then the other ranks are killed)."""
    import torch.distributed as dist

    from hdrvae_torch.core.config import MeshConfig
    from hdrvae_torch.serve.engine import ServeEngine
    from hdrvae_torch.serve.http import serve_forever
    from hdrvae_torch.sharding import multihost
    from hdrvae_torch.sharding.mesh import Mesh

    n = _mesh_size(args)
    sd = {k: v.cpu() for k, v in vae.decoder.state_dict().items()}
    with multihost.RankGroup(
            n, {"cli": (vae.config, sd)}, [multihost.ServeCase("cli", "cli")],
            device=_device_type(args), cwd=os.getcwd(), lead=True) as group:
        try:
            group.join()
            engine = ServeEngine(
                vae, mesh=Mesh(vae.device, MeshConfig(num_devices=n)),
                heartbeat_s=group.timeout_s / 4, **engine_kw)
            logger.info("serving through the exact slab-sharded decode on "
                        "%d %s ranks", n, group.backend)
            print(json.dumps({"ranks": n, "backend": group.backend,
                              "pids": [p.pid for p in group.procs]}),
                  flush=True)
            _warmup(engine, args, vae.config.spatial_scale)
            serve_forever(engine, args.host, args.port)
            if not engine.healthy:
                # the ranks are out of step: stop them, do not wait
                raise RuntimeError("the rank group broke")
            ranks = group.wait(timeout=group.timeout_s)
        except RuntimeError as e:
            raise SystemExit(f"serve on ranks failed: {e}") from None
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    for rank, (rec,) in zip(group.ranks, ranks):
        logger.info("rank %d (%s): served %s, launches %s", rank,
                    rec["backend"], rec.get("served"),
                    {k: v for k, v in rec["counts"].items() if v},
                    extra={"rank_record": rec})
    return 0


def cmd_bench(args) -> int:
    """Start the benchmark harness (``bench_torch.py``) with ``--size`` and
    ``--device``; its exit code."""
    import subprocess
    cmd = [sys.executable, os.path.join(_REPO, "bench_torch.py")]
    if args.size:
        cmd += ["--size", str(args.size)]
    return subprocess.call(cmd + ["--device", args.device])


_MODES = ("conservative", "exposure", "adaptive_recovery",
          "mathematical_recovery")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hdrvae_torch",
        description="HDR VAE decode on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("decode", help="HDR-decode a latent to EXR/HDR")
    p.add_argument("--latent", help=".npy or single-tensor .safetensors")
    p.add_argument("--vae", help="Flux.1 ae.safetensors checkpoint")
    p.add_argument("--mode", default="mathematical_recovery",
                   choices=_MODES)
    p.add_argument("--ev-multiplier", type=float, default=1.0)
    p.add_argument("--size", type=int, default=1024,
                   help="output edge when generating a random latent")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parity", action="store_true",
                   help="full float32 numerics (alias for "
                        "--precision parity)")
    p.add_argument("--precision", default="fast",
                   choices=("fast", "mixed", "parity"),
                   help="numerics tier: fast (bf16), mixed (f32 "
                        "activations + 3-pass attention dots), parity "
                        "(exact f32)")
    p.add_argument("--batch", type=int, default=1,
                   help="frames when generating a random latent")
    p.add_argument("--tiled", action="store_true",
                   help="exact slab-sharded decode across --mesh ranks "
                        "started by this command")
    p.add_argument("--mesh", type=int, default=None,
                   help="ranks for --tiled (default: one a visible card)")
    p.add_argument("--pipelined", action="store_true",
                   help="overlap decode, device->host fetch, and EXR "
                        "write across the frame sequence (composes "
                        "with --tiled)")
    _add_export_args(p)
    _add_device_arg(p)
    p.set_defaults(func=cmd_decode)

    p = sub.add_parser("upscale", help="HDR-upscale an EXR/HDR image")
    p.add_argument("--image", required=True)
    p.add_argument("--model", required=True,
                   help="ESRGAN-family, SwinIR, Swin2SR or HAT checkpoint")
    p.add_argument("--small-blur", action="store_true")
    p.add_argument("--local-fix", action="store_true")
    p.add_argument("--upscale-method", default="bislerp",
                   choices=("nearest-exact", "bilinear", "area", "bicubic",
                            "bislerp"))
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("--overlap", type=int, default=64)
    p.add_argument("--sharded", action="store_true",
                   help="deal the tile grid across ranks started by this "
                        "command, one a visible card")
    p.add_argument("--precision", default="parity",
                   choices=("fast", "mixed", "parity"),
                   help="numerics tier (default parity, the float32 "
                        "contract; fast runs bf16 tile passes)")
    _add_export_args(p)
    _add_device_arg(p)
    p.set_defaults(func=cmd_upscale)

    p = sub.add_parser("export", help="re-export an image file")
    p.add_argument("--image", required=True)
    _add_export_args(p)
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("convert",
                       help="torch checkpoint -> safetensors of the port's "
                            "modules")
    p.add_argument("kind", choices=("vae", "upscaler"))
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(func=cmd_convert)

    p = sub.add_parser("inspect", help="describe a model/checkpoint")
    p.add_argument("--path", help="checkpoint to describe (default: "
                                  "built-in Flux.1 decoder topology)")
    p.set_defaults(func=cmd_inspect)

    p = sub.add_parser("bench", help="run the benchmark harness")
    p.add_argument("--size", type=int)
    _add_device_arg(p)
    p.set_defaults(func=cmd_bench)

    p = sub.add_parser("serve", help="HTTP decode service (POST .npy "
                                     "latents to /v1/decode, get EXR/HDR)")
    p.add_argument("--vae", help="Flux.1 ae.safetensors checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8475)
    p.add_argument("--mode", default="mathematical_recovery",
                   choices=_MODES)
    p.add_argument("--parity", action="store_true",
                   help="full float32 numerics (alias for "
                        "--precision parity)")
    p.add_argument("--precision", default="fast",
                   choices=("fast", "mixed", "parity"),
                   help="numerics tier: fast (bf16), mixed (f32 "
                        "activations + 3-pass attention dots), parity "
                        "(exact f32)")
    p.add_argument("--bucket", type=int, default=None,
                   help="latent shape-bucket multiple (0 = no buckets; "
                        "default 64, none with --sharded, with which an "
                        "explicit bucket composes)")
    p.add_argument("--max-pending", type=int, default=32,
                   help="request-queue bound (503 beyond it)")
    p.add_argument("--sharded", action="store_true",
                   help="serve the exact slab-sharded decode from --mesh "
                        "ranks started by this command")
    p.add_argument("--mesh", type=int, default=None,
                   help="ranks for --sharded (default: one a visible "
                        "card)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request queue deadline in seconds (0 = "
                        "none); expired-in-queue requests fail fast "
                        "with 504")
    p.add_argument("--warmup", default="",
                   help="comma-separated output edges to decode once "
                        "before serving (builds the kernels), e.g. "
                        "1024,2048")
    _add_device_arg(p)
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("run", help="execute a workflow JSON graph")
    p.add_argument("workflow")
    p.add_argument("--latent", help="latent fed as external input "
                                    "'latent_source'")
    p.add_argument("--vae", help="VAE checkpoint fed as 'vae_loader'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=512)
    _add_device_arg(p)
    p.set_defaults(func=cmd_run)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
