"""Small sizes of the benchmark's cells for the CPU tests: the same
traffic kinds, drivers, references and checks, at widths and shapes a
test run holds."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark.harness import spec

SMALL_CONFIGS = {
    "autoencoderkl_decoder": {
        "model": "autoencoderkl_decoder", "latent_channels": 4,
        "block_out_channels": [16, 32], "layers_per_block": 1,
        "norm_num_groups": 4, "out_channels": 3,
        "mid_block_add_attention": True, "scaling_factor": 0.3611,
        "shift_factor": 0.1159},
    "rrdbnet": {
        "model": "rrdbnet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 8,
        "num_block": 2, "num_grow_ch": 4, "scale": 4},
}

SMALL_TRAFFIC = {
    # pools no larger than the frames checked, so that a short window on
    # a busy CPU reaches every checked slot
    "decode_closed": {"latent_hw": [12, 16], "pool": 2},
    "upscale_closed": {"image_hw": [40, 48], "tile": 24, "overlap": 8},
    "serve_open": {"rate_per_s": 20.0, "bucket": 8, "pool_per_shape": 2,
                   "mix": [{"latent_hw": [16, 16], "weight": 0.4},
                           {"latent_hw": [13, 19], "weight": 0.3},
                           {"latent_hw": [19, 13], "weight": 0.3}]},
}

SECONDS = {"decode_closed": 3.0, "upscale_closed": 3.0, "serve_open": 2.0}


def cell_names():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


def small_cell(name: str) -> spec.Cell:
    """The cell ``name`` with its configuration and traffic cut to the
    test sizes (its limits and metrics as they are)."""
    cell = spec.load_cell(name)
    kind = cell.traffic["kind"]
    return dataclasses.replace(
        cell, config=SMALL_CONFIGS[cell.config["model"]],
        traffic={**cell.traffic, **SMALL_TRAFFIC[kind]})


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, when
    the test runs, never when the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m cuda "
                    "benchmark/tests)")
    return torch.device("cuda", 0)
