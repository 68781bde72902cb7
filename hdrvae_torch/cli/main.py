"""hdrvae_torch command-line interface, as ``hdrvae/cli/main.py``.

Subcommands:
  serve    HTTP decode service (POST .npy latents to /v1/decode, get
           EXR / HDR / npy back), over one ServeEngine on one card

    python -m hdrvae_torch.cli.main serve [--vae ae.safetensors] [--port N]
"""

from __future__ import annotations

import argparse
import logging
import sys

logger = logging.getLogger("hdrvae_torch.cli")


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


def cmd_serve(args) -> int:
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig
    from hdrvae_torch.serve.engine import ServeEngine
    from hdrvae_torch.serve.http import serve_forever

    precision = _parse_precision(args)
    if args.vae:
        vae = VAE.load(args.vae, precision=precision, device=args.device)
    else:
        logger.warning("no --vae checkpoint given; using random weights")
        vae = VAE.random_init(seed=0, config=DecoderConfig(),
                              precision=precision, device=args.device)
    engine = ServeEngine(
        vae, hdr_cfg=HDRDecodeConfig(hdr_mode=args.mode),
        bucket=args.bucket if args.bucket > 0 else None,
        max_pending=args.max_pending,
        deadline_s=args.deadline if args.deadline > 0 else None)
    if args.warmup:
        scale = vae.config.spatial_scale
        sizes = [int(s) // scale for s in args.warmup.split(",") if s]
        logger.info("warming up latent sizes %s ...", sizes)
        engine.warmup([(s, s) for s in sizes])
    serve_forever(engine, args.host, args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hdrvae_torch",
        description="HDR VAE decode on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("serve", help="HTTP decode service (POST .npy "
                                     "latents to /v1/decode, get EXR/HDR)")
    p.add_argument("--vae", help="Flux.1 ae.safetensors checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8475)
    p.add_argument("--mode", default="mathematical_recovery",
                   choices=("conservative", "exposure", "adaptive_recovery",
                            "mathematical_recovery"))
    p.add_argument("--parity", action="store_true",
                   help="full float32 numerics (alias for "
                        "--precision parity)")
    p.add_argument("--precision", default="fast",
                   choices=("fast", "mixed", "parity"),
                   help="numerics tier: fast (bf16), mixed (f32 "
                        "activations + 3-pass attention dots), parity "
                        "(exact f32)")
    p.add_argument("--bucket", type=int, default=64,
                   help="latent shape-bucket multiple (0 = no buckets)")
    p.add_argument("--max-pending", type=int, default=32,
                   help="request-queue bound (503 beyond it)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request queue deadline in seconds (0 = "
                        "none); expired-in-queue requests fail fast "
                        "with 504")
    p.add_argument("--warmup", default="",
                   help="comma-separated output edges to decode once "
                        "before serving (builds the kernels), e.g. "
                        "1024,2048")
    p.add_argument("--device", default="cuda",
                   help="torch device of the decoder (default: the card)")
    p.set_defaults(func=cmd_serve)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
