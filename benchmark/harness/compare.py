"""The numbers that decide ``correct``: what the timed path produced set
against the plain reference, computed from the same weights and inputs.

- ``rel_rms``: the L2 norm of the difference over the reference's L2 norm
  (the whole image, every channel);
- ``p90_rel``: the 90th percentile of the absolute differences over the
  90th percentile of the reference's magnitudes: steady where a few
  pixels near the ends of an inverse activation (the logit of a decode,
  the atanh of an upscale) amplify rounding by orders of magnitude;
- ``p90_vs_bf16``, ``p999_vs_bf16`` (upscales): the 90th and the 99.9th
  percentile of the absolute differences over those of the reference
  computed with bf16 operands: how the bf16 tier's gap compares with the
  gap bf16 rounding alone opens on the seed's weights and image, which
  vary tenfold from seed to seed; the 99.9th weighs the HDR highlights
  and the tile seams that the 90th leaves out;
- ``rgb_max_err`` (decodes): the largest absolute difference of the
  standard decode, an image in [0, 1];
- ``flags_differ`` (decodes): how many of the normalization kind and the
  fallback flag differ from the reference's;
- ``shape_differs`` (served decodes): 1 if the response is not the
  latent's size times the decoder's factor.
"""

from __future__ import annotations

from typing import Dict

import torch

NORM_KINDS = {"SIGMOID": 0, "TANH": 1, "CUSTOM": 2}


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile (nearest rank) of every element of x."""
    flat = x.reshape(-1)
    k = max(1, min(flat.numel(), int(round(q * flat.numel()))))
    return flat.kthvalue(k).values


def image_numbers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    if tuple(got.shape) != tuple(want.shape):
        return {name: float("inf") for name in ("rel_rms", "p90_rel")}
    got = got.to(want.device, torch.float32)
    diff = (got - want).abs_()
    return {
        "rel_rms": float(torch.linalg.vector_norm(diff)
                         / torch.linalg.vector_norm(want)),
        "p90_rel": float(_quantile(diff, 0.9)
                         / _quantile(want.abs(), 0.9)),
    }


def gaps_vs(got: torch.Tensor, want: torch.Tensor,
            yardstick: torch.Tensor) -> Dict[str, float]:
    """The gap |got - want| as a multiple of the one that rounding every
    operand of the reference to bf16 opens on the same seed, |yardstick -
    want|, at the 90th and at the 99.9th percentile."""
    if tuple(got.shape) != tuple(want.shape):
        return {"p90_vs_bf16": float("inf"), "p999_vs_bf16": float("inf")}
    gap = (got.to(want.device, torch.float32) - want).abs_()
    yard = (yardstick - want).abs_()
    return {
        "p90_vs_bf16": float(_quantile(gap, 0.9) / _quantile(yard, 0.9)),
        "p999_vs_bf16": float(_quantile(gap, 0.999)
                              / _quantile(yard, 0.999)),
    }


def decode_compare(image, rgb, norm_kind: int, used_fallback: bool,
                   want) -> Dict[str, float]:
    """The numbers of one decode's outputs against ``want``, a
    ``reference.decoder.Decoded``."""
    out = image_numbers(image, want.image)
    if rgb is None or tuple(rgb.shape) != tuple(want.rgb.shape):
        out["rgb_max_err"] = float("inf")
    else:
        out["rgb_max_err"] = float(
            (rgb.to(want.rgb.device, torch.float32) - want.rgb).abs().max())
    out["flags_differ"] = float(int(norm_kind) != want.norm_kind) + float(
        bool(used_fallback) != want.used_fallback)
    return out


def decode_numbers(sd, m, latent, image, rgb, norm_kind,
                   used_fallback) -> Dict[str, float]:
    from benchmark.reference import decoder as ref
    want = ref.hdr_decode(sd, m, latent)
    return decode_compare(image, rgb, norm_kind, used_fallback, want)


def serve_numbers(sd, m, latent: torch.Tensor, response) -> Dict[str, float]:
    """A served response (image in the fetch dtype, summary) against the
    reference decode of the unpadded latent."""
    from benchmark.reference import decoder as ref
    want = ref.hdr_decode(sd, m, latent)
    got = torch.from_numpy(response.image.astype("float32"))
    out = image_numbers(got, want.image)
    out["shape_differs"] = float(tuple(got.shape) != tuple(want.image.shape))
    summ = response.summary
    out["flags_differ"] = float(
        NORM_KINDS.get(summ.get("normalization"), -1) != want.norm_kind) \
        + float(bool(summ.get("used_fallback")) != want.used_fallback)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> tuple:
    """(correct, [(name, value, limit)]) of the numbers the check file
    holds limits for; a number missing from ``numbers`` fails."""
    rows, ok = [], True
    for name, spec in limits.items():
        value = numbers.get(name, float("inf"))
        limit = float(spec["limit"])
        rows.append((name, value, limit))
        ok &= value <= limit
    if "missing" in numbers:
        rows.append(("missing", numbers["missing"], 0.0))
        ok = False
    return ok, rows
