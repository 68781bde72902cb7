"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes that ``chip_smoke.py`` (the decode's own shapes)
does not reach: batch 2, image sizes that are not tile multiples, token
counts that are not block multiples, and a small decoder end to end.

Every test needs an NVIDIA GPU and skips without one.  The card's host has
no JAX, so run this file there without the suite's conftest:

    python -m pytest -m cuda tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode.pipeline import hdr_decode
from hdrvae_torch.kernels import attention, conv3x3
from hdrvae_torch.models.decoder import decoder_head, decoder_tail
from hdrvae_torch.models.params import init_decoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m "
                    "pytest -m cuda tests/test_torch_cuda.py --noconftest")
    return torch.device("cuda")


def _rand(dev, shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


def _ulp_bound(ref):
    """One bf16 ulp of the largest output: kernel and plain version round
    the same float32 sums, taken in different orders, to bf16."""
    return 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)


@pytest.mark.parametrize("res", ["none", "add", "proj"])
def test_fused_conv3x3_ragged(dev, res):
    b, h, w, cin, cout = 2, 10, 40, 32, 64
    x = _rand(dev, (b, h, w, cin))
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    gamma = _rand(dev, (b, cin), 0.3, torch.float32, seed=3) + 1.0
    beta = _rand(dev, (b, cin), 0.3, torch.float32, seed=4)
    kw = dict(gamma=gamma, beta=beta, emit_stats=True, num_groups=32)
    if res == "add":
        kw["residual"] = _rand(dev, (b, h, w, cout), 0.5, seed=5)
    elif res == "proj":
        kw["residual"] = _rand(dev, (b, h, w, 48), seed=6)
        kw["res_kernel"] = _rand(dev, (48, cout), 48 ** -0.5, seed=7)
    before = conv3x3.fused_conv3x3.launches
    y, (s, sq) = conv3x3.fused_conv3x3(x, kern, bias, **kw)
    assert conv3x3.fused_conv3x3.launches == before + 1
    ry, (rs, rsq) = conv3x3.fused_conv3x3_reference(x, kern, bias, **kw)
    torch.cuda.synchronize()
    assert (y.float() - ry.float()).abs().max().item() <= 2 * _ulp_bound(ry)
    torch.testing.assert_close(sq, rsq, rtol=1e-3, atol=0)
    torch.testing.assert_close(s, rs, rtol=0,
                               atol=1e-3 * ry.float().abs().sum().item())


def test_fused_conv3x3_plain_conv(dev):
    """No prologue, no residual, no statistics: a bare bf16 conv."""
    x = _rand(dev, (1, 17, 16, 16))
    kern = _rand(dev, (3, 3, 16, 128), 0.1, seed=1)
    bias = torch.zeros(128, device=dev)
    y = conv3x3.fused_conv3x3(x, kern, bias)
    ry = conv3x3.fused_conv3x3_reference(x, kern, bias)
    assert (y.float() - ry.float()).abs().max().item() <= 2 * _ulp_bound(ry)


def test_upsample_conv3x3_ragged(dev):
    b, h, w, cin, cout = 2, 5, 20, 32, 64
    x = _rand(dev, (b, h, w, cin), 0.5)
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    y, (s, sq) = conv3x3.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                          num_groups=16)
    ry, (rs, rsq) = conv3x3.upsample_conv3x3_reference(
        x, kern, bias, emit_stats=True, num_groups=16)
    torch.cuda.synchronize()
    assert y.shape == (b, 2 * h, 2 * w, cout)
    # the phase weights are rounded to bf16 after summing: a few ulps more
    assert (y.float() - ry.float()).abs().max().item() <= 4 * _ulp_bound(ry)
    torch.testing.assert_close(sq, rsq, rtol=1e-2, atol=0)


@pytest.mark.parametrize("hw,c", [((10, 13), 64), ((7, 9), 512)])
def test_flash_attention_ragged(dev, hw, c):
    q, k, v = (_rand(dev, (2, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    ref = attention.spatial_attention_reference(q, k, v)
    got = attention.flash_attention_f32(q, k, v)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    refb = attention.spatial_attention_reference(qb, kb, vb)
    gotb = attention.flash_attention_bf16(qb, kb, vb)
    # p is rounded to bf16 for its product with v; those errors take both
    # signs and average down over the keys, so one ulp of the largest output
    assert (gotb - refb).abs().max().item() <= _ulp_bound(refb)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros(1, 8, 16, 16, device=dev)      # float32, not bf16
    k = torch.zeros(3, 3, 16, 64, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        conv3x3.fused_conv3x3(x, k, torch.zeros(64, device=dev))
    xb, kb = x.bfloat16(), torch.zeros(3, 3, 16, 48, device=dev).bfloat16()
    with pytest.raises(ValueError, match="Cout"):
        conv3x3.upsample_conv3x3(xb, kb, torch.zeros(48, device=dev))
    q = torch.zeros(1, 4, 4, 48, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        attention.flash_attention_f32(q, q, q)


def test_small_decoder_on_card(dev):
    """A narrow decoder the kernels take (widths 64/128, 32 groups): the
    fused fast decode against the unfused fast path on the card, and the
    parity decode on the card against the same decode on the CPU."""
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec_cpu = init_decoder(cfg, seed=3)
    dec = init_decoder(cfg, seed=3, device=dev)
    z = _rand("cpu", (1, 12, 12, 4), 2.0, torch.float32, seed=8)
    fast = hdr_decode(dec, z.to(dev), HDRDecodeConfig(), Precision.fast())
    unfused = decoder_tail(dec, decoder_head(dec, z.to(dev),
                                             precision=Precision.fast()),
                           precision=Precision.fast())
    assert (fast.standard - unfused.rgb).abs().max().item() <= 5e-2
    parity = hdr_decode(dec, z.to(dev), HDRDecodeConfig(hdr_mode="conservative"),
                        Precision.parity())
    ref = hdr_decode(dec_cpu, z, HDRDecodeConfig(hdr_mode="conservative"),
                     Precision.parity())
    torch.testing.assert_close(parity.standard.cpu(), ref.standard, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(parity.image.cpu(), ref.image, rtol=0,
                               atol=1e-4)
