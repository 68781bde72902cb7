"""The work arithmetic against torch's own count of the reference's
operations, and the published sizes it gives."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import models, spec, work
from benchmark.reference import decoder as rd, upscale as ru
from benchmark.tests.bench_small import SMALL_CONFIGS


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("hw", [(6, 8), (8, 8)])
def test_decoder_work_is_the_references_flops(hw):
    m = models.model_of(SMALL_CONFIGS["autoencoderkl_decoder"])
    sd = models.make_weights(m, 1, "cpu")
    z = torch.randn((2, *hw, m.z))
    counted = _counted(lambda: rd.forward(sd, m, z))
    assert work.total_flops(work.decoder_work(m, 2, *hw, 4)) == counted


def test_rrdbnet_work_is_the_references_flops():
    m = models.model_of(SMALL_CONFIGS["rrdbnet"])
    sd = models.make_weights(m, 1, "cpu")
    x = torch.rand((1, 10, 12, 3))
    counted = _counted(lambda: ru.forward(sd, m, x))
    assert work.total_flops(work.rrdbnet_work(m, 1, 10, 12, 2)) == counted


def _config(name):
    cfg = {c["name"]: c for c in spec.load_benchmark()["configs"]}[name]
    return models.model_of(json.loads((spec.ROOT / cfg["file"]).read_text()))


def test_published_sizes():
    dec = _config("flux1-vae-decoder")
    w = work.decoder_work(dec, 1, 256, 256, 2)
    assert abs(work.total_flops(w) / 1e12 - 48.486) < 1e-3
    assert abs(w["attn"]["flops"] / 1e12 - 8.796) < 1e-3
    esr = _config("realesrgan-x4plus")
    assert abs(work.total_flops(work.rrdbnet_work(esr, 1, 1024, 1024, 2))
               / 1e12 - 37.595) < 1e-3
    params = lambda m: sum(int(torch.Size(s).numel())  # noqa: E731
                           for _, s in models.layout_of(m))
    assert params(dec) == 49_545_475 and params(esr) == 16_697_987


def test_bound_reads_operations_or_bytes():
    t, by = work.bound_s({"flops": 989e12, "bytes": 1.0})
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = work.bound_s({"flops": 1.0, "bytes": 3.35e12 * 2})
    assert t == pytest.approx(2.0) and by == "bytes"
