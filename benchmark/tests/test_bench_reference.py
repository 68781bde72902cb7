"""The plain references agree with hdrvae_torch's CPU path at small
sizes: the parity tier to float32 rounding, the fast tier within its
stated budget."""

import pytest
import torch

from benchmark.harness import drivers, models
from benchmark.harness.compare import decode_compare, image_numbers
from benchmark.reference import decoder as rd, upscale as ru
from benchmark.tests.bench_small import SMALL_CONFIGS


@pytest.mark.parametrize("tier,tol", [("parity", 1e-5), ("mixed", 1e-4),
                                      ("fast", 5e-2)])
def test_decode_agrees(tier, tol):
    from hdrvae_torch.decode.pipeline import hdr_decode
    m = models.model_of(SMALL_CONFIGS["autoencoderkl_decoder"])
    dec = drivers._load_decoder(m, 5, "cpu")
    z = torch.randn((1, 10, 12, m.z),
                    generator=models.generator(5, models.INPUTS, "cpu"))
    got = hdr_decode(dec, z, precision=drivers._precision(tier))
    want = rd.hdr_decode(models.make_weights(m, 5, "cpu"), m, z)
    nb = decode_compare(got.image, got.standard,
                        int(got.stats["norm_kind"]),
                        bool(got.used_fallback), want)
    assert nb["flags_differ"] == 0
    assert nb["rgb_max_err"] < tol and nb["p90_rel"] < 10 * tol


@pytest.mark.parametrize("tier,tol", [("parity", 1e-5), ("fast", 5e-2)])
def test_upscale_agrees(tier, tol):
    from hdrvae_torch.core.config import TilingConfig, UpscaleConfig
    from hdrvae_torch.models.zoo import upscaler_from_state_dict
    from hdrvae_torch.upscale.pipeline import hdr_upscale
    m = models.model_of(SMALL_CONFIGS["rrdbnet"])
    sd = models.make_weights(m, 6, "cpu")
    net, _, arch = upscaler_from_state_dict(models.published_keys(m, sd),
                                            device="cpu")
    img = drivers._hdr_image(6, 1, 40, 48, "cpu")
    got = hdr_upscale(net, img, UpscaleConfig(
        tiling=TilingConfig(tile=24, overlap=8)), architecture=arch,
        precision=drivers._precision(tier)).image
    want = ru.hdr_upscale(sd, m, img, 24, 8)
    assert arch == "RealESRGAN"
    assert image_numbers(got, want)["p90_rel"] < tol


def test_tile_plan_covers_the_image():
    plan = ru.tile_plan(1024, 1024, 512, 64)
    assert [(y, th) for y, _, th, _ in plan[::3]] == [(0, 512), (448, 512),
                                                     (896, 128)]
    assert ru.tile_plan(300, 200, 512, 64) == [(0, 0, 300, 200)]


@pytest.mark.parametrize("rounding", ["tf32", "fp8"])
def test_rounding_loses_precision(rounding):
    from benchmark.reference.numerics import rounder
    x = torch.randn(4096)
    err = (rounder(rounding)(x) - x).abs().max() / x.abs().max()
    assert 0 < err < {"tf32": 1e-3, "fp8": 7e-2}[rounding]
    assert rounder("fp32")(x) is x
