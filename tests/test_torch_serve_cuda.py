"""The served decode on the card: ``ServeEngine`` responses against the
direct ``hdr_decode`` of the same latent on the same route, the order of
the worker's streams (a request's fetch does not wait for the decode
launched behind it), and a rank-group engine (``mesh=``, two gloo ranks
sharing the card) against the same ranks' direct slab decode.

Every test needs an NVIDIA GPU and skips without one.  The card's host has
no JAX, so run this file there without the suite's conftest:

    python -m pytest -m cuda tests/test_torch_serve_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from hdrvae_torch.api.vae import VAE
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.core.stats import stats_to_host
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import attention, conv3x3
from hdrvae_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.cuda

CONS = HDRDecodeConfig(hdr_mode="conservative")
# a narrow decoder the kernels take (widths 64 / 128, 32 groups)
NARROW = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2), num_res_blocks=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m "
                    "pytest -m cuda tests/test_torch_serve_cuda.py "
                    "--noconftest")
    return torch.device("cuda")


def _latent(seed, h, w, zc):
    return np.random.default_rng(seed).standard_normal(
        (1, h, w, zc)).astype(np.float32)


def _direct(vae, z, cfg, pad_to=None):
    res = hdr_decode(vae.decoder, torch.from_numpy(z).cuda(), cfg,
                     vae.precision, pad_to=pad_to)
    return res.image.cpu().numpy(), decode_summary(res)


@pytest.mark.parametrize("tier", ["fast", "mixed"])
def test_served_response_equals_direct_decode(dev, tier):
    """A narrow decoder in the fast and mixed tiers: a latent at its bucket
    (fast: the fused chain, K1) and one off it (K3 masked) served at depth
    2, each bit-equal to the direct decode on its route, and a float16
    fetch equal to the float32 image's cast."""
    prec = Precision.fast() if tier == "fast" else Precision.mixed()
    vae = VAE.random_init(0, NARROW, prec, device=dev)
    at, off = _latent(1, 16, 24, 4), _latent(2, 13, 21, 4)
    with ServeEngine(vae, bucket=8, depth=2) as engine:
        engine.warmup([(16, 24)])
        k1 = conv3x3.fused_conv3x3.launches
        masked = {k: getattr(attention, k).launches_masked
                  for k in ("flash_attention_bf16", "flash_attention_3pass")}
        r_at = engine.submit(at, CONS)
        r_off = engine.submit(off, CONS)
        r_half = engine.submit(at, CONS, fetch_dtype=np.float16)
        r_at, r_off, r_half = (f.result(120) for f in (r_at, r_off, r_half))
        k1 = conv3x3.fused_conv3x3.launches - k1
        masked = {k: getattr(attention, k).launches_masked - v
                  for k, v in masked.items()}
    assert r_at.padded_hw == (16, 24) and r_off.padded_hw == (16, 24)
    for resp, want in ((r_at, _direct(vae, at, CONS)),
                       (r_off, _direct(vae, off, CONS, pad_to=(16, 24)))):
        np.testing.assert_array_equal(resp.image, want[0])
        assert resp.summary == want[1]
    assert r_half.image.dtype == np.float16
    np.testing.assert_array_equal(r_half.image,
                                  r_at.image.astype(np.float16))
    kernel = ("flash_attention_bf16" if tier == "fast"
              else "flash_attention_3pass")
    assert masked[kernel] == 1
    assert (k1 > 0) == (tier == "fast")


def test_engine_stream_order(dev):
    """At depth 2 a 512^2 request with a 2048^2 one submitted behind it:
    the worker launches the second before fetching the first, and the
    first's latency stays under half the second's device time."""
    vae = VAE.random_init(0, DecoderConfig(), Precision.fast(), device=dev)
    small = _latent(3, 64, 64, 16)
    big = torch.from_numpy(_latent(4, 256, 256, 16)).cuda()
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        hdr_decode(vae.decoder, big, CONS, vae.precision)
        end.record()
        torch.cuda.synchronize()
    big_ms = start.elapsed_time(end)
    with ServeEngine(vae, bucket=64, depth=2) as engine:
        engine.warmup([(64, 64), (256, 256)])
        order = []
        dispatch, finalize = engine._dispatch, engine._finalize

        def logged_dispatch(z, cfg, fetch_dtype=None):
            order.append(("dispatch", z.shape[1]))
            return dispatch(z, cfg, fetch_dtype)

        def logged_finalize(entry):
            order.append(("finalize", entry[1].padded_hw[0]))
            return finalize(entry)
        engine._dispatch, engine._finalize = logged_dispatch, logged_finalize
        f_small, f_big = engine.submit(small, CONS), engine.submit(big, CONS)
        r_small, r_big = f_small.result(120), f_big.result(120)
    assert order[:3] == [("dispatch", 64), ("dispatch", 256),
                         ("finalize", 64)], order
    assert 1e3 * r_small.latency_s < 0.5 * big_ms, \
        (1e3 * r_small.latency_s, big_ms)
    assert r_big.image.shape == (1, 2048, 2048, 3)


def test_packed_stats_on_the_card(dev):
    """The packed fetch of a decode's stats from the card equals one fetch
    a scalar."""
    vae = VAE.random_init(0, NARROW, Precision.fast(), device=dev)
    res = hdr_decode(vae.decoder, torch.from_numpy(_latent(5, 8, 8, 4))
                     .cuda(), HDRDecodeConfig(full_analysis=True),
                     vae.precision)

    def per_scalar(stats):
        return {k: per_scalar(v) if isinstance(v, dict) else
                (float(v) if v.is_floating_point() else int(v))
                for k, v in stats.items()}
    assert stats_to_host(res.stats) == per_scalar(res.stats)


def test_rank_group_engine_equals_direct_slab_decode(dev):
    """Two gloo ranks sharing this card: a fast ``ServeEngine(mesh=)``
    serving one full-width 2048^2 request (latent 256^2, at its shape: the
    fused chain with K1 / K2 ``owned_rows`` on both ranks), bit-equal to
    the same ranks' direct ``sharded_slab_decode`` of the latent."""
    from hdrvae_torch.models.params import init_decoder
    from hdrvae_torch.sharding import multihost
    cfg = DecoderConfig()
    sd = init_decoder(cfg, seed=0, device="cpu").state_dict()
    z = torch.from_numpy(_latent(4, 256, 256, cfg.z_channels))
    cases = [multihost.SlabCase("direct", "flux", z, CONS, Precision.fast(),
                                requests=2),
             multihost.ServeCase("served", "flux",
                                 [multihost.ServeRequest(z, CONS)],
                                 Precision.fast())]
    ranks = multihost.RankGroup(2, {"flux": (cfg, sd)}, cases,
                                device="cuda").wait(timeout=600)
    direct, served = ([r[i] for r in ranks] for i in range(2))
    assert all(r["backend"] == "gloo" for r in served)
    (resp,) = served[0]["responses"]
    assert resp["ok"], resp
    assert resp["padded_hw"] == (256, 256)
    assert resp["digest"] == direct[0]["digest"] == direct[1]["digest"]
    assert served[1]["served"] == 1
    for r in served:
        assert r["counts"]["fused_conv3x3.owned_launches"] > 0
        assert r["counts"]["upsample_conv3x3.owned_launches"] > 0
