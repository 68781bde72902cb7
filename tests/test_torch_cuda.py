"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes that ``chip_smoke.py`` (the decode's and the
upscaler's own shapes) does not reach: batch 2, image sizes that are not
tile multiples, token counts that are not block multiples, odd channel
counts, and a small decoder and upscaler end to end.

Every test needs an NVIDIA GPU and skips without one.  The card's host has
no JAX, so run this file there without the suite's conftest:

    python -m pytest -m cuda tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      Precision, TilingConfig, UpscaleConfig)
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import (attention, conv3x3, dense_conv, epilogue,
                                  f32_dot, ocab, swin_attention)
from hdrvae_torch.models import hat, swin2sr, swinir
from hdrvae_torch.models.decoder import decoder_head, decoder_tail
from hdrvae_torch.models.params import init_decoder
from hdrvae_torch.models.rrdbnet import (RRDBNetConfig, init_rrdbnet,
                                         rrdbnet_layers)
from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply
from hdrvae_torch.upscale.pipeline import hdr_upscale, upscale_progress_total

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


# the edges of K1's tile (4 rows x 64 pixels, 64-channel K chunks, 64 or
# 128 output channels a block): (b, h, w, cin, cout, residual, Cr)
K1_EDGES = {
    "width 100 (a part 64-pixel run)": (2, 9, 100, 64, 128, "add", 0),
    "Cin 48 (a part K chunk)": (2, 7, 70, 48, 64, "proj", 48),
    "Cin 512 at a small map (deep K)": (1, 6, 10, 512, 128, "proj", 512),
    "Cout 64": (2, 5, 66, 128, 64, "add", 0),
    "Cout 192 (an N-tile edge)": (2, 5, 66, 64, 192, "none", 0),
}


@pytest.mark.parametrize("case", list(K1_EDGES))
def test_fused_conv3x3_tile_edges(dev, case):
    """K1 at its tile's edges, batch 2 with per-sample gamma/beta: y
    within two bf16 ulps of the largest output, as above."""
    b, h, w, cin, cout, res, cr = K1_EDGES[case]
    x = _rand(dev, (b, h, w, cin))
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    gamma = _rand(dev, (b, cin), 0.3, torch.float32, seed=3) + 1.0
    beta = _rand(dev, (b, cin), 0.3, torch.float32, seed=4)
    kw = dict(gamma=gamma, beta=beta, emit_stats=True, num_groups=32)
    if res == "add":
        kw["residual"] = _rand(dev, (b, h, w, cout), 0.5, seed=5)
    elif res == "proj":
        kw["residual"] = _rand(dev, (b, h, w, cr), seed=6)
        kw["res_kernel"] = _rand(dev, (cr, cout), cr ** -0.5, seed=7)
    y, (s, sq) = conv3x3.fused_conv3x3(x, kern, bias, **kw)
    ry, (rs, rsq) = conv3x3.fused_conv3x3_reference(x, kern, bias, **kw)
    torch.cuda.synchronize()
    assert (y.float() - ry.float()).abs().max().item() <= 2 * _ulp_bound(ry)
    torch.testing.assert_close(sq, rsq, rtol=1e-3, atol=0)
    torch.testing.assert_close(s, rs, rtol=0,
                               atol=1e-3 * ry.float().abs().sum().item())


def test_fused_conv3x3_out_aliases_residual(dev):
    """``out=residual``: each element's residual is read before the same
    thread writes it, so y over its own residual equals y elsewhere."""
    b, h, w, c = 2, 9, 100, 128
    x = _rand(dev, (b, h, w, c))
    kern = _rand(dev, (3, 3, c, c), (9 * c) ** -0.5, seed=1)
    bias = _rand(dev, (c,), 0.1, torch.float32, seed=2)
    gamma = _rand(dev, (b, c), 0.3, torch.float32, seed=3) + 1.0
    beta = _rand(dev, (b, c), 0.3, torch.float32, seed=4)
    r = _rand(dev, (b, h, w, c), 0.5, seed=5)
    kw = dict(gamma=gamma, beta=beta, emit_stats=True, num_groups=32)
    y, s = conv3x3.fused_conv3x3(x, kern, bias, residual=r, **kw)
    r2 = r.clone()
    y2, s2 = conv3x3.fused_conv3x3(x, kern, bias, residual=r2, out=r2, **kw)
    torch.cuda.synchronize()
    assert y2.data_ptr() == r2.data_ptr()
    assert torch.equal(y2, y)
    assert torch.equal(s2[0], s[0]) and torch.equal(s2[1], s[1])


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


def test_upsample_conv3x3_act(dev):
    """K2 with act="lrelu": y and its statistics (taken after the act, of
    y as stored) as in test_upsample_conv3x3_ragged."""
    b, h, w, cin, cout = 2, 5, 20, 32, 64
    x = _rand(dev, (b, h, w, cin), 0.5)
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    kw = dict(emit_stats=True, num_groups=16, act="lrelu")
    y, (s, sq) = conv3x3.upsample_conv3x3(x, kern, bias, **kw)
    ry, (rs, rsq) = conv3x3.upsample_conv3x3_reference(x, kern, bias, **kw)
    plain = conv3x3.upsample_conv3x3(x, kern, bias)
    torch.cuda.synchronize()
    assert (y.float() - ry.float()).abs().max().item() <= 4 * _ulp_bound(ry)
    assert (ry < 0).any() and not torch.equal(y, plain)
    torch.testing.assert_close(sq, rsq, rtol=1e-2, atol=0)
    with pytest.raises(ValueError, match="unknown act"):
        conv3x3.upsample_conv3x3(x, kern, bias, act="relu")


def test_upsample_conv3x3_stats_only(dev):
    """K2's stats_only launch: its own counter, and the sums of the launch
    that writes y, bit for bit."""
    b, h, w, cin, cout = 2, 5, 20, 32, 64
    x = _rand(dev, (b, h, w, cin), 0.5)
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    _, (s, sq) = conv3x3.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                          num_groups=16)
    before = (conv3x3.upsample_conv3x3.launches,
              conv3x3.upsample_conv3x3.stats_only_launches)
    so, sqo = conv3x3.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                       num_groups=16, stats_only=True)
    assert (conv3x3.upsample_conv3x3.launches,
            conv3x3.upsample_conv3x3.stats_only_launches) == (
                before[0], before[1] + 1)
    assert torch.equal(so, s) and torch.equal(sqo, sq)


@pytest.mark.parametrize("cin,cout", [(48, 192), (512, 128)])
def test_upsample_conv3x3_tile_edges(dev, cin, cout):
    """K2 at a ragged 13 x 100 map (a part 4-row tile and a part 64-pixel
    run) with a part K chunk and Cout 192, or a deep K: y within four bf16
    ulps as above, and its stats_only sums bit-equal to these."""
    b, h, w = 2, 13, 100
    x = _rand(dev, (b, h, w, cin), 0.5)
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    kw = dict(emit_stats=True, num_groups=32)
    y, (s, sq) = conv3x3.upsample_conv3x3(x, kern, bias, **kw)
    so, sqo = conv3x3.upsample_conv3x3(x, kern, bias, stats_only=True, **kw)
    ry, (rs, rsq) = conv3x3.upsample_conv3x3_reference(x, kern, bias, **kw)
    torch.cuda.synchronize()
    assert (y.float() - ry.float()).abs().max().item() <= 4 * _ulp_bound(ry)
    torch.testing.assert_close(sq, rsq, rtol=1e-2, atol=0)
    assert torch.equal(so, s) and torch.equal(sqo, sq)


# K1 / K2 owned_rows: output-row intervals of a ragged 13 x 100 map (K2:
# 26 rows out) that cut K1's 4-row tiles and K2's phase rows; one empty
OWNED_CUTS = {"K1": [(0, 5), (5, 11), (11, 13)],
              "K2": [(0, 7), (7, 7), (7, 19), (19, 26)]}


@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_owned_rows(dev, kind):
    """K1 / K2 (K2 in both modes) with owned_rows, batch 2: y bit-equal to
    the unrestricted launch's, each interval's sums those of the plain
    version with the same owned_rows (1e-3, as the unrestricted sums), the
    intervals' sums adding up to the unrestricted ones (float32 reordering,
    1e-5), its own counter."""
    b, h, w, cin, cout = 2, 13, 100, 64, 128
    x = _rand(dev, (b, h, w, cin), 0.5)
    kern = _rand(dev, (3, 3, cin, cout), (9 * cin) ** -0.5, seed=1)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=2)
    kw = dict(emit_stats=True, num_groups=32)
    if kind == "K1":
        fn, plain = conv3x3.fused_conv3x3, conv3x3.fused_conv3x3_reference
        kw.update(gamma=_rand(dev, (b, cin), 0.3, torch.float32, seed=3)
                  + 1.0, beta=_rand(dev, (b, cin), 0.3, torch.float32,
                                    seed=4))
    else:
        fn = conv3x3.upsample_conv3x3
        plain = conv3x3.upsample_conv3x3_reference
    y, (s, sq) = fn(x, kern, bias, **kw)
    sums = [torch.zeros_like(s), torch.zeros_like(sq)]
    before = fn.owned_launches
    for lo, hi in OWNED_CUTS[kind]:
        yo, (so, sqo) = fn(x, kern, bias, owned_rows=(lo, hi), **kw)
        ry, (rs, rsq) = plain(x, kern, bias, owned_rows=(lo, hi), **kw)
        torch.cuda.synchronize()
        assert torch.equal(yo, y)
        if kind == "K2":
            st = fn(x, kern, bias, owned_rows=(lo, hi), stats_only=True,
                    **kw)
            assert torch.equal(st[0], so) and torch.equal(st[1], sqo)
        torch.testing.assert_close(sqo, rsq, rtol=1e-3, atol=0)
        torch.testing.assert_close(
            so, rs, rtol=0,
            atol=1e-3 * ry[:, lo:hi].float().abs().sum().item() + 1e-30)
        sums[0] += so
        sums[1] += sqo
    assert fn.owned_launches == before + len(OWNED_CUTS[kind]) * (
        2 if kind == "K2" else 1)
    torch.testing.assert_close(sums[1], sq, rtol=1e-5, atol=0)
    torch.testing.assert_close(sums[0], s, rtol=0,
                               atol=1e-5 * y.float().abs().sum().item())


K5_PAIRS = [(256, 128), (256, 64), (128, 128), (128, 64)]


def _k5_case(dev, b, h, w, cin, cm, cout):
    """K5 on x [b, h, w, cin] with per-sample GroupNorm affines against its
    plain version: y within four bf16 ulps of the largest output (z and
    the band are rounded to bf16 from phase weights rounded after summing,
    as K2's output is), sumsq within 1e-2; one launch."""
    args = (_rand(dev, (b, h, w, cin), 0.5),
            _rand(dev, (3, 3, cin, cm), (9 * cin) ** -0.5, seed=1),
            _rand(dev, (cm,), 0.1, torch.float32, seed=2),
            _rand(dev, (b, cm), 0.3, torch.float32, seed=3) + 1.0,
            _rand(dev, (b, cm), 0.3, torch.float32, seed=4),
            _rand(dev, (3, 3, cm, cout), (9 * cm) ** -0.5, seed=5),
            _rand(dev, (cout,), 0.1, torch.float32, seed=6))
    before = conv3x3.upconv_gn_conv3x3.launches
    y, (s, sq) = conv3x3.upconv_gn_conv3x3(*args, num_groups=32)
    assert conv3x3.upconv_gn_conv3x3.launches == before + 1
    ry, (rs, rsq) = conv3x3.upconv_gn_conv3x3_reference(*args,
                                                        num_groups=32)
    torch.cuda.synchronize()
    assert y.shape == (b, 2 * h, 2 * w, cout) and y.dtype == torch.bfloat16
    assert (y.float() - ry.float()).abs().max().item() <= 4 * _ulp_bound(ry)
    torch.testing.assert_close(sq, rsq, rtol=1e-2, atol=0)


@pytest.mark.parametrize("cm,cout", K5_PAIRS)
def test_upconv_gn_conv3x3_ragged(dev, cm, cout):
    """K5 at batch 2 and an 18 x 40 output (rows and columns end in part
    work items), for every (Cm, Cout) it takes."""
    _k5_case(dev, 2, 9, 20, 48, cm, cout)


# (B, H, W, Cin) of K5's low-resolution x against its 4 x 64 output work
# item: an output width no multiple of 64 (the row's second item partial),
# a height no multiple of 4, a map smaller than one item at batch 2, a
# slab of two Cin chunks (the second partial) at batch 2, and Cin 512 (the
# slab in eight chunks, a two-stage weight ring)
K5_EDGES = [(1, 9, 50, 48), (1, 7, 40, 64), (2, 1, 3, 48), (2, 6, 36, 80),
            (1, 5, 33, 512)]


@pytest.mark.parametrize("cm,cout", K5_PAIRS)
@pytest.mark.parametrize("shape", K5_EDGES)
def test_upconv_gn_conv3x3_item_edges(dev, shape, cm, cout):
    """K5 at the edges of its work item, for every (Cm, Cout) it takes."""
    _k5_case(dev, *shape, cm, cout)


def test_upconv_gn_conv3x3_refuses(dev):
    x = torch.zeros(1, 4, 8, 32, device=dev, dtype=torch.bfloat16)
    upk = torch.zeros(3, 3, 32, 96, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 96, 64, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(96, device=dev)
    with pytest.raises(ValueError, match="Cm must be"):
        conv3x3.upconv_gn_conv3x3(x, upk, v, v, v, k,
                                  torch.zeros(64, device=dev))


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


# (h, w), C, q's scale: ragged N (130 and 63 tokens: no multiple of the 64
# queries or 32 keys of a step), C = 512, and scores of std ~8, where the
# softmax is peaked and the order of scale and split shows
@pytest.mark.parametrize("hw,c,qscale", [((10, 13), 64, 1.0),
                                         ((7, 9), 512, 1.0),
                                         ((10, 13), 128, 8.0)])
def test_flash_attention_3pass(dev, hw, c, qscale):
    """K3's 3-pass mode against its plain version on the same bf16 parts:
    they differ by float32 sum order and by where P is split (the running
    row max against the final one), each p's hi + lo off by up to 2^-16 of
    p, so within 2^-16 of the largest output; against exact float32 within
    the 3-pass budget, 1e-4, at unit-scale scores."""
    q, k, v = (_rand(dev, (2, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    q = q * qscale
    before = (attention.flash_attention_3pass.launches,
              attention.split_qkv.launches)
    got = attention.flash_attention_3pass(q, k, v)
    assert (attention.flash_attention_3pass.launches,
            attention.split_qkv.launches) == (before[0] + 1, before[1] + 1)
    ref = attention.spatial_attention_3pass_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    bar = 2.0 ** -16 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= bar
    if qscale == 1.0:
        exact = attention.spatial_attention_reference(q, k, v)
        torch.testing.assert_close(got, exact, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,hw,c", [(2, (10, 13), 64), (2, (7, 9), 512),
                                     (1, (33, 47), 128)])
def test_split_qkv(dev, b, hw, c):
    """The 3-pass kernel's split, once a launch, bit-equal to its plain
    version (q scaled by C^-1/2 in float32 before its split)."""
    q, k, v = (_rand(dev, (b, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    before = attention.split_qkv.launches
    got = attention.split_qkv(q, k, v)
    assert attention.split_qkv.launches == before + 1
    want = attention.split_qkv_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (3, 2, b, *hw, c) and torch.equal(got, want)


# key_valid masks as (grid, live rows, live columns): a bucketed grid's
# live rectangle (11 x 13 of 16 x 16), the first 64 keys dead (the first
# key step of every mode sees no live key), the first 256 of 32 x 32 dead
KEY_MASKS = {"live 11 x 13": ((16, 16), slice(0, 11), slice(0, 13)),
             "first 64 dead": ((16, 16), slice(4, None), slice(None)),
             "first 256 dead": ((32, 32), slice(8, None), slice(None))}


@pytest.mark.parametrize("case", sorted(KEY_MASKS))
@pytest.mark.parametrize("c", [64, 512])
def test_flash_attention_key_valid(dev, case, c):
    """K3's key_valid mode in its three dot modes against their plain
    versions with the same mask, each at its unmasked bar: exact float32
    1e-5, 3-pass 2^-16 of the largest output, bf16 one ulp of it; finite
    where the first key steps are all dead; each a masked launch."""
    hw, rows, cols = KEY_MASKS[case]
    mask = np.zeros(hw, bool)
    mask[rows, cols] = True
    kv = torch.from_numpy(mask).to(dev)
    q, k, v = (_rand(dev, (2, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    modes = (
        (attention.flash_attention_f32, attention.spatial_attention_reference,
         (q, k, v), lambda r: 1e-5),
        (attention.flash_attention_3pass,
         attention.spatial_attention_3pass_reference, (q, k, v),
         lambda r: 2.0 ** -16 * r.abs().max().item()),
        (attention.flash_attention_bf16, attention.spatial_attention_reference,
         (qb, kb, vb), _ulp_bound))
    for fn, plain, args, bar in modes:
        before = (fn.launches, fn.launches_masked)
        got = fn(*args, key_valid=kv)
        assert (fn.launches, fn.launches_masked) == (before[0] + 1,
                                                     before[1] + 1)
        ref = plain(*args, key_valid=kv)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), fn.__name__
        err = (got - ref).abs().max().item()
        assert err <= bar(ref), (fn.__name__, err)


# K3 bf16 at its edges: (grid, C, batch, q's scale, key_valid). N = 1, 63,
# 64, 65, 127 and 4,097 (one 64-query block and 64-key step, one either
# side of it, and a long ragged run); C from one 64-column box a consumer
# warpgroup (the second's a zero box) to 512; batch 1 and 2; unit and
# peaked (q x 8) scores; no mask, a live rectangle, the first 256 keys
# dead (the first four steps see no live key) and a single live key
BF16_EDGES = [
    ((1, 1), 64, 1, 1.0, "none"),
    ((1, 1), 512, 2, 8.0, "one live key"),
    ((7, 9), 128, 2, 1.0, "none"),
    ((7, 9), 320, 1, 8.0, "live rectangle"),
    ((8, 8), 320, 1, 8.0, "none"),
    ((8, 8), 512, 2, 1.0, "one live key"),
    ((5, 13), 512, 2, 1.0, "live rectangle"),
    ((5, 13), 128, 1, 8.0, "none"),
    ((127, 1), 64, 2, 8.0, "one live key"),
    ((127, 1), 512, 1, 1.0, "none"),
    ((17, 241), 512, 1, 8.0, "first 256 dead"),
    ((17, 241), 64, 2, 1.0, "live rectangle"),
    ((17, 241), 128, 2, 8.0, "none"),
    ((17, 241), 320, 2, 1.0, "first 256 dead"),
]


def _bf16_edge_mask(hw, case):
    """[H, W] bool key_valid of a BF16_EDGES case, or None."""
    n = hw[0] * hw[1]
    if case == "none":
        return None
    if case == "live rectangle":
        live = np.zeros(hw, bool)
        live[:max(1, 7 * hw[0] // 10), :max(1, 4 * hw[1] // 5)] = True
        return live
    live = np.zeros(n, bool)
    if case == "first 256 dead":
        live[256:] = True
    else:                                   # one live key
        live[n // 2] = True
    return live.reshape(hw)


@pytest.mark.parametrize("hw,c,b,qscale,mask", BF16_EDGES)
def test_flash_attention_bf16_edges(dev, hw, c, b, qscale, mask):
    """K3's bf16 kernel against the exact plain version on the same bf16
    values, within one bf16 ulp of the largest output (p is rounded to bf16
    for its product with v; those errors take both signs and average
    down), finite everywhere, one launch each."""
    live = _bf16_edge_mask(hw, mask)
    kv = None if live is None else torch.from_numpy(live).to(dev)
    q, k, v = (_rand(dev, (b, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    q, k, v = (q * qscale).bfloat16(), k.bfloat16(), v.bfloat16()
    before = attention.flash_attention_bf16.launches
    got = attention.flash_attention_bf16(q, k, v, key_valid=kv)
    assert attention.flash_attention_bf16.launches == before + 1
    ref = attention.spatial_attention_reference(q, k, v, key_valid=kv)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= _ulp_bound(ref)


# K3 f32 at its edges: (grid, C, batch, q's scale, key_valid). N = 1, 63,
# 130, 256 (one 256-key step) and 4,097 (no multiple of the step or of
# a V stage's 8 keys, a ragged last step; 65 query blocks); C from one
# 64-column box to 512; batch 1 and 2; unit and peaked (q x 8) scores; no
# mask, a live rectangle, the first 256 keys dead (the whole first step
# sees no live key) and a single live key
F32_EDGES = [
    ((1, 1), 512, 2, 1.0, "none"),
    ((7, 9), 64, 2, 8.0, "none"),
    ((7, 9), 512, 1, 1.0, "one live key"),
    ((10, 13), 128, 2, 1.0, "none"),
    ((10, 13), 512, 2, 8.0, "one live key"),
    ((10, 13), 64, 1, 1.0, "live rectangle"),
    ((16, 16), 512, 2, 8.0, "none"),
    ((17, 241), 512, 1, 8.0, "first 256 dead"),
    ((17, 241), 64, 2, 1.0, "first 256 dead"),
    ((17, 241), 128, 2, 8.0, "one live key"),
    ((17, 241), 320, 1, 1.0, "none"),
]


@pytest.mark.parametrize("hw,c,b,qscale,mask", F32_EDGES)
def test_flash_attention_f32_edges(dev, hw, c, b, qscale, mask):
    """K3's exact float32 kernel against the plain version within 1e-5
    (both take float32 products and sums, in other orders), finite
    everywhere, one launch each."""
    live = _bf16_edge_mask(hw, mask)
    kv = None if live is None else torch.from_numpy(live).to(dev)
    q, k, v = (_rand(dev, (b, *hw, c), 1.0, torch.float32, seed=s)
               for s in range(3))
    q = q * qscale
    before = attention.flash_attention_f32.launches
    got = attention.flash_attention_f32(q, k, v, key_valid=kv)
    assert attention.flash_attention_f32.launches == before + 1
    ref = attention.spatial_attention_reference(q, k, v, key_valid=kv)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_flash_attention_key_valid_refused(dev):
    q = torch.zeros(1, 4, 4, 64, device=dev)
    with pytest.raises(ValueError, match="key_valid"):
        attention.flash_attention_f32(q, q, q, torch.ones(4, 3, device=dev,
                                                          dtype=torch.bool))
    with pytest.raises(ValueError, match="key_valid"):
        attention.flash_attention_bf16(q.bfloat16(), q.bfloat16(),
                                       q.bfloat16(),
                                       torch.ones(4, 4, dtype=torch.bool))


def test_mixed_tier_attention_routes(dev):
    """On the card the mixed tier launches the 3-pass kernel, parity the
    exact float32 one, a mixed head with fast_head_levels the bf16 one."""
    q = _rand(dev, (1, 8, 8, 64), 1.0, torch.float32)
    kernels = (attention.flash_attention_bf16, attention.flash_attention_3pass,
               attention.flash_attention_f32)
    for prec, want in ((Precision.mixed(), (0, 1, 0)),
                       (Precision.parity(), (0, 0, 1)),
                       (Precision.mixed(1).head_precision(), (1, 0, 0))):
        before = [fn.launches for fn in kernels]
        attention.spatial_attention(q, q, q, precision=prec)
        assert tuple(fn.launches - b for fn, b in zip(kernels, before)) == want


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
    with pytest.raises(ValueError, match="multiple of 64"):
        attention.flash_attention_3pass(q, q, q)
    with pytest.raises(ValueError, match="float32"):
        q64 = torch.zeros(1, 4, 4, 64, device=dev)
        attention.flash_attention_3pass(q64.bfloat16(), q64, q64)


def test_small_decoder_on_card(dev):
    """A narrow decoder the kernels take (widths 64/128, 32 groups): the
    fused fast decode against the unfused fast path on the card, and the
    parity decode on the card against the same decode on the CPU."""
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec_cpu = init_decoder(cfg, seed=3, device="cpu")
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


def test_slab_decode_one_rank_on_card(dev):
    """The narrow decoder's fast slab decode on a one-rank mesh runs the
    chain with owned_rows (every row owned): its rgb equals the
    whole-image fast decode's bit for bit (the same launches on the same
    inputs), its image within 1e-5 (the pre-map statistics are summed in
    another order)."""
    from hdrvae_torch.sharding.mesh import Mesh, sharded_slab_decode
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec = init_decoder(cfg, seed=3, device=dev)
    z = _rand(dev, (1, 12, 16, 4), 2.0, torch.float32, seed=8)
    whole = hdr_decode(dec, z, HDRDecodeConfig(), Precision.fast())
    before = (conv3x3.fused_conv3x3.owned_launches,
              conv3x3.upsample_conv3x3.owned_launches)
    slab = sharded_slab_decode(dec, z, mesh=Mesh(dev), tail_levels=1,
                               precision=Precision.fast())
    torch.cuda.synchronize()
    assert conv3x3.fused_conv3x3.owned_launches > before[0]
    assert torch.equal(slab.standard, whole.standard)
    torch.testing.assert_close(slab.image, whole.image, rtol=0, atol=1e-5)


def test_slab_dryrun_two_ranks_on_card(dev):
    """The launcher's dryrun: two ranks on this card (gloo), the parity
    slab decode of a small decoder, every rank's image the same."""
    from hdrvae_torch.sharding import multihost
    records = multihost.launch_localhost_dryrun(2, device="cuda",
                                                timeout=300)
    assert [r["process"] for r in records] == [0, 1]
    assert all(r["world_size"] == 2 and r["finite"] for r in records)


def test_slab_decode_one_rank_nccl(dev):
    """A one-rank group on this card takes the NCCL backend (every rank has
    a card of its own), so the slab decode's collectives run under NCCL:
    the sum and min all-reduces and the stitch's CUDA all_gather.  The
    fast chain's rgb equals the whole-image fast decode's bit for bit, its
    image within 1e-5, as in the in-process one-rank test."""
    from hdrvae_torch.sharding import multihost
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec = init_decoder(cfg, seed=3, device=dev)
    z = _rand(dev, (1, 12, 16, 4), 2.0, torch.float32, seed=8)
    whole = hdr_decode(dec, z, HDRDecodeConfig(), Precision.fast())
    case = multihost.SlabCase("nccl", "narrow", z.cpu(), tail_levels=1,
                              precision=Precision.fast())
    [[rec]] = multihost.RankGroup(1, {"narrow": (cfg, dec.state_dict())},
                                  [case], device="cuda").wait(timeout=300)
    assert rec["backend"] == "nccl" and rec["device"] == "cuda:0"
    assert rec["counts"]["fused_conv3x3.owned_launches"] > 0
    assert torch.equal(rec["standard"], whole.standard.cpu())
    torch.testing.assert_close(rec["image"], whole.image.cpu(), rtol=0,
                               atol=1e-5)


def test_small_decoder_large_frame_routes(dev, monkeypatch):
    """The same narrow decoder through the large-frame routes, their
    thresholds lowered: the fast decode with the streamed top level (one
    K5 and one K2 stats_only launch) against the whole-image one, <= 5e-2
    rgb; the staged mixed decode against the whole-image mixed one,
    <= 1e-4 rgb and conservative image."""
    from hdrvae_torch.decode import pipeline
    from hdrvae_torch.models import fused_tail
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec = init_decoder(cfg, seed=3, device=dev)
    z = _rand(dev, (1, 12, 20, 4), 2.0, torch.float32, seed=8)
    cons = HDRDecodeConfig(hdr_mode="conservative")
    whole = hdr_decode(dec, z, cons, Precision.fast())
    monkeypatch.setattr(fused_tail, "LOWMEM_MIN_PIXELS", 1)
    before = (conv3x3.upconv_gn_conv3x3.launches,
              conv3x3.upsample_conv3x3.stats_only_launches)
    low = hdr_decode(dec, z, cons, Precision.fast())
    assert (conv3x3.upconv_gn_conv3x3.launches,
            conv3x3.upsample_conv3x3.stats_only_launches) == (
                before[0] + 1, before[1] + 1)
    assert (low.standard - whole.standard).abs().max().item() <= 5e-2
    mixed = hdr_decode(dec, z, cons, Precision.mixed())
    monkeypatch.setattr(pipeline, "_STAGED_MIN_PIXELS_OVERRIDE", 1)
    staged = hdr_decode(dec, z, cons, Precision.mixed())
    torch.testing.assert_close(staged.standard, mixed.standard, rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(staged.image, mixed.image, rtol=0, atol=1e-4)


# (input widths, Cout, act, residual scale or None, float32 out): one to
# five inputs as in a dense block, conv_first's 3, 12 and 48 (unshuffle 1,
# 2, 4) channels, conv_last's 3 outputs in float32, narrow widths (4 and 12
# are no multiple of 8: gathered, not loaded by TMA; 8 and 24 end in a half
# K chunk), a 32-channel input after a narrow one, and each wgmma N
DENSE_CASES = [((64,), 32, "lrelu", None, False),
               ((64, 32), 32, "lrelu", None, False),
               ((64, 32, 32), 32, "lrelu", None, False),
               ((64, 32, 32, 32), 32, "lrelu", None, False),
               ((64, 32, 32, 32, 32), 64, None, 0.2, False),
               ((3,), 64, None, None, False),
               ((12,), 64, None, None, False),
               ((64,), 3, None, None, True),
               ((64,), 64, None, 1.0, False),
               ((8, 4, 4), 8, "lrelu", 0.2, False),
               ((24,), 128, "lrelu", None, True),
               ((48,), 64, None, None, False),
               ((24, 32), 32, "lrelu", 0.2, False),
               ((32, 12, 4), 16, None, 0.2, False),
               ((16, 8), 100, "lrelu", None, False)]


@pytest.mark.parametrize("cins,cout,act,res_scale,out_f32", DENSE_CASES)
def test_dense_conv3x3(dev, cins, cout, act, res_scale, out_f32):
    """Batch 2 at 10 x 37 (ragged in both tile dimensions): bf16 output
    within two bf16 ulps of the largest value (kernel and plain version
    round the same float32 sums, taken in different orders), float32
    output within 1e-5 of it."""
    b, h, w = 2, 10, 37
    xs = [_rand(dev, (b, h, w, c), seed=i) for i, c in enumerate(cins)]
    kern = _rand(dev, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5,
                 seed=7)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=8)
    kw = dict(act=act, out_dtype=torch.float32 if out_f32 else None)
    if res_scale is not None:
        kw.update(residual=_rand(dev, (b, h, w, cout), seed=9),
                  res_scale=res_scale)
    before = dense_conv.dense_conv3x3.launches
    y = dense_conv.dense_conv3x3(xs, kern, bias, **kw)
    assert dense_conv.dense_conv3x3.launches == before + 1
    ref = dense_conv.dense_conv3x3_reference(xs, kern, bias, **kw)
    torch.cuda.synchronize()
    assert y.dtype == ref.dtype and y.shape == (b, h, w, cout)
    err = (y.float() - ref.float()).abs().max().item()
    if out_f32:
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
    else:
        assert err <= 2 * _ulp_bound(ref), err


# (B, H, W, input widths, Cout, float32 out): H and W no multiple of the
# kernel's tile (16 x 64 pixels at Cout <= 32, 8 x 64 at 64, 4 x 64 at 128)
DENSE_EDGES = [(2, 17, 65, (64,), 3, True),
               (2, 17, 130, (64, 32), 32, False),
               (1, 9, 129, (64, 32, 32, 32, 32), 64, False),
               (2, 5, 67, (64,), 128, False)]


@pytest.mark.parametrize("b,h,w,cins,cout,out_f32", DENSE_EDGES)
def test_dense_conv3x3_tile_edges(dev, b, h, w, cins, cout, out_f32):
    """Ragged tiles in both dimensions with prepared weights, as the chain
    passes them, and a residual: within the bounds of
    test_dense_conv3x3."""
    xs = [_rand(dev, (b, h, w, c), seed=i) for i, c in enumerate(cins)]
    kern = _rand(dev, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5,
                 seed=7)
    bias = _rand(dev, (cout,), 0.1, torch.float32, seed=8)
    res = _rand(dev, (b, h, w, cout), seed=9)
    kw = dict(act="lrelu", residual=res, res_scale=0.2,
              out_dtype=torch.float32 if out_f32 else None)
    pw = dense_conv.prepare_weights(kern, bias, cins)
    y = dense_conv.dense_conv3x3(xs, pw, **kw)
    ref = dense_conv.dense_conv3x3_reference(xs, kern, bias, **kw)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if out_f32:
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
    else:
        assert err <= 2 * _ulp_bound(ref), err


@pytest.mark.parametrize("small", [True, False])
def test_rrdbnet_chain_launches_once_per_conv(dev, small):
    """A with_small() and a full-width RRDBNetConfig() tile through the K6
    chain: one dense_conv3x3 launch per conv (15 a RRDB, conv_first,
    conv_body, the upsample convs, conv_hr, conv_last: 351 at full width)
    and the weights prepared once per conv across two forwards."""
    cfg = RRDBNetConfig().with_small() if small else RRDBNetConfig()
    net = init_rrdbnet(cfg, seed=2, device=dev)
    x = _rand(dev, (1, 20, 28, 3), 0.5, torch.float32, seed=5)
    convs = 15 * cfg.nb + 4 + cfg.num_upsamples
    assert small or convs == 351
    prepared = dense_conv.prepare_weights.preparations
    for _ in range(2):
        before = dense_conv.dense_conv3x3.launches
        y = rrdbnet_fused_apply(net, x, precision=Precision.fast())
        assert dense_conv.dense_conv3x3.launches == before + convs
    assert dense_conv.prepare_weights.preparations == prepared + convs
    torch.cuda.synchronize()
    assert y.shape == (1, 20 * cfg.scale, 28 * cfg.scale, 3)
    assert torch.isfinite(y).all()


def test_dense_conv3x3_refuses_what_it_does_not_take(dev):
    x = _rand(dev, (1, 8, 16, 16))
    k = _rand(dev, (3, 3, 16, 16))
    bias = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        dense_conv.dense_conv3x3([x.float()], k, bias)
    with pytest.raises(ValueError, match="contiguous"):
        dense_conv.dense_conv3x3([x[:, :, ::2]],
                                 _rand(dev, (3, 3, 16, 16)), bias)
    with pytest.raises(ValueError, match="Cout"):
        dense_conv.dense_conv3x3([x], _rand(dev, (3, 3, 16, 144)),
                                 torch.zeros(144, device=dev))
    with pytest.raises(ValueError, match="inputs"):
        dense_conv.dense_conv3x3([x] * 6, _rand(dev, (3, 3, 96, 16)), bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,shift,scale", [
    ((2, 33, 47, 128), 0.5, 2.0), ((1, 9, 7, 12), 0.0, 2.0),
    ((1, 64, 64, 128), 10.0, 1e-3), ((1, 67, 71, 128), 1e3, 1.0),
    ((1, 67, 71, 20), 1e3, 1.0), ((1, 600, 600, 128), 0.5, 2.0)])
def test_collapse_and_stats(dev, dtype, shape, shift, scale):
    """M = 3,102, 63 and 4,757 rows (no multiple of the 32-row chunk a warp
    takes), maps with |mean| >> std (10 +- 1e-3; 1e3 with unit spread,
    which bf16's step of 4 there keeps, at C = 128 and at C = 20, whose
    thirds end inside the kernel's vectors)
    and M = 360,000 rows (more than one wave of the persistent grid): the
    collapse and min / max exact, mean within 1e-5 relative, std within
    1e-5 relative (1e-3 where std is 1e-4 of the mean, the JAX package's
    bar for that case)."""
    pre = (_rand(dev, shape, scale, torch.float32, seed=4) + shift).to(dtype)
    before = epilogue.collapse_and_stats_fused.launches
    col, got = epilogue.collapse_and_stats_fused(pre)
    assert epilogue.collapse_and_stats_fused.launches == before + 1
    rcol, ref = epilogue.collapse_and_stats_reference(pre)
    torch.cuda.synchronize()
    assert col.dtype == dtype and torch.equal(col, rcol)
    assert got["min"].item() == ref["min"].item()
    assert got["max"].item() == ref["max"].item()
    torch.testing.assert_close(got["mean"], ref["mean"], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["std"], ref["std"],
                               rtol=1e-3 if shift == 10.0 else 1e-5, atol=0)


def test_fused_epilogue_decode_on_card(dev):
    """A small decoder's fast and parity decodes with the fused epilogue
    equal the default path's: the same image and summary."""
    cfg = DecoderConfig(z_channels=4, ch=64, ch_mult=(1, 2),
                        num_res_blocks=1)
    dec = init_decoder(cfg, seed=3, device=dev)
    z = _rand(dev, (1, 12, 12, 4), 2.0, torch.float32, seed=8)
    for prec in (Precision.fast(), Precision.parity()):
        base = hdr_decode(dec, z, HDRDecodeConfig(hdr_mode="conservative"),
                          prec)
        before = epilogue.collapse_and_stats_fused.launches
        fused = hdr_decode(dec, z, HDRDecodeConfig(
            hdr_mode="conservative", use_fused_epilogue=True), prec)
        assert epilogue.collapse_and_stats_fused.launches == before + 1
        torch.testing.assert_close(fused.image, base.image, rtol=0,
                                   atol=1e-5)
        a, b = decode_summary(fused), decode_summary(base)
        for key in ("min", "max", "mean", "std"):
            assert abs(a["pre"][key] - b["pre"][key]) <= \
                1e-5 * abs(b["pre"][key]) + 1e-7, key


@pytest.mark.parametrize("unshuffle,scale", [(1, 2), (2, 2)])
def test_small_upscaler_on_card(dev, unshuffle, scale):
    """A narrow RRDBNet (nf 8, gc 4: every channel count odd for the
    kernel's vector path) through the K6 chain against the card's own
    unfused fast layers, and a fast two-pass upscale end to end."""
    cfg = RRDBNetConfig(nf=8, nb=2, gc=4, scale=scale, unshuffle=unshuffle)
    net = init_rrdbnet(cfg, seed=2, device=dev)
    x = _rand(dev, (1, 13, 22, 3), 0.5, torch.float32, seed=5)
    fused = rrdbnet_fused_apply(net, x, precision=Precision.fast())
    layers = rrdbnet_layers(net, x, precision=Precision.fast()).float()
    assert fused.shape == layers.shape == (1, 13 * scale, 22 * scale, 3)
    err = (fused - layers).abs().max().item()
    assert err <= 5e-2 * max(1.0, layers.abs().max().item()), err
    before = dense_conv.dense_conv3x3.launches
    img = _rand(dev, (1, 24, 40, 3), 1.5, torch.float32, seed=6)
    res = hdr_upscale(net, img, UpscaleConfig(
        tiling=TilingConfig(tile=16, overlap=4)), precision=Precision.fast())
    assert res.image.shape == (1, 24 * scale, 40 * scale, 3)
    assert torch.isfinite(res.image).all()
    assert dense_conv.dense_conv3x3.launches > before


def _swin_block(dev, dim, heads, ws, seed):
    """A Swin block with weights from numpy: linears N(0, 1/fan_in),
    biases, LayerNorm affines and the bias table non-trivial."""
    rng = np.random.default_rng(seed)
    blk = swinir.SwinBlock(dim, heads, ws, 2.0)
    sd = {}
    for k, v in blk.state_dict().items():
        shape = tuple(v.shape)
        if k.startswith("norm") and k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("weight"):
            a = rng.standard_normal(shape) * shape[1] ** -0.5
        else:
            a = rng.standard_normal(shape) * 0.5
        sd[k] = torch.from_numpy(a.astype(np.float32))
    blk.load_state_dict(sd)
    return blk.requires_grad_(False).to(dev)


# (batch, H, W, C, heads, window, shift, extra): n = 16, 49 (padded to 64
# rows), 64, 100, 144 and 256 tokens; 3 and 5 windows across (odd grids the JAX
# kernel refuses); C 48, 180 (no multiple of 16: padded to 192) and 240
# (SwinIR-L's: K7 on one warpgroup a block); 105
# windows at batch 3 (odd: the last pair's second warpgroup has no window;
# and no multiple of the 132 SMs); one row of two 256-token windows
SWIN_CASES = [(2, 8, 12, 48, 2, 4, 0, False),
              (2, 8, 12, 48, 2, 4, 2, True),
              (1, 14, 21, 48, 3, 7, 3, False),
              (1, 24, 40, 180, 6, 8, 4, False),
              (2, 32, 48, 180, 6, 16, 8, True),
              (3, 40, 56, 180, 6, 8, 4, True),
              (1, 16, 32, 180, 6, 16, 8, True),
              # windows of 100 and 144 tokens: two row blocks, the last
              # ragged (n16 112), and three (n16 144), on shifted 2 x 3
              # grids (corner windows), batch 2 at ws 10
              (2, 20, 30, 96, 3, 10, 5, False),
              (1, 24, 36, 180, 6, 12, 6, True),
              # SwinIR-L's width: C 240 (CK 256), 8 heads, shifted, extra
              (1, 24, 40, 240, 8, 8, 4, True)]


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,extra", SWIN_CASES)
def test_swin_block_fused(dev, b, h, w, c, heads, ws, shift, extra):
    """K7 against its plain version: within two bf16 ulps of the largest
    output, over the whole image and over the last window row and column,
    where the shifted grid's masks act."""
    blk = _swin_block(dev, c, heads, ws, seed=ws + shift)
    wts = swinir.block_weights(blk, heads, ws, torch.bfloat16)
    x = _rand(dev, (b, h, w, c), seed=1)
    e = _rand(dev, (b, h, w, c), 0.5, seed=2) if extra else None
    kw = dict(ws=ws, shift=shift, extra=e, precision=Precision.fast())
    before = swin_attention.swin_block_fused.launches
    y = swin_attention.swin_block_fused(x, wts, **kw)
    assert swin_attention.swin_block_fused.launches == before + 1
    ref = swin_attention.swin_block_fused_reference(x, wts, **kw)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    d = (y.float() - ref.float()).abs()
    bound = 2 * _ulp_bound(ref)
    assert d.max().item() <= bound, d.max().item()
    assert d[:, -ws:].max().item() <= bound
    assert d[:, :, -ws:].max().item() <= bound


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,extra", SWIN_CASES)
def test_swin_block_fused_v2(dev, b, h, w, c, heads, ws, shift, extra):
    """K7's SwinV2 body (Swin2SR: cosine attention with per-head scales up
    to the clamp's 100, a continuous-position bias in [0, 16], LayerNorm on
    the branch outputs) against its plain version: within 5e-2 * max(1,
    max|ref|) (the scales multiply a q rounding difference by up to 100),
    over the whole image and over the last window row and column."""
    blk = _swin_block(dev, c, heads, ws, seed=ws + shift + 1)
    n = ws * ws
    qkv_bias = _rand(dev, (3 * c,), 0.5, torch.float32, seed=3)
    qkv_bias[c:2 * c] = 0.0          # SwinV2: no k bias
    scale = torch.linspace(1.0, 100.0, heads, device=dev)
    bias = 16.0 * torch.sigmoid(_rand(dev, (heads, n, n), 2.0, torch.float32,
                                      seed=4))
    wts = swin_attention.prepare_block(
        blk.attn, blk.norm1, blk.norm2, blk.mlp, heads, bias, torch.bfloat16,
        qkv_bias=qkv_bias, post_norm=True, qk_scale=scale)
    x = _rand(dev, (b, h, w, c), seed=1)
    e = _rand(dev, (b, h, w, c), 0.5, seed=2) if extra else None
    kw = dict(ws=ws, shift=shift, extra=e, precision=Precision.fast())
    before = swin_attention.swin_block_fused.launches
    y = swin_attention.swin_block_fused(x, wts, **kw)
    assert swin_attention.swin_block_fused.launches == before + 1
    ref = swin_attention.swin_block_fused_reference(x, wts, **kw)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    d = (y.float() - ref.float()).abs()
    bound = 5e-2 * max(1.0, ref.float().abs().max().item())
    assert d.max().item() <= bound, d.max().item()
    assert d[:, -ws:].max().item() <= bound
    assert d[:, :, -ws:].max().item() <= bound


@pytest.mark.parametrize("nwb,heads,nq,nk,peak", [
    (3, 2, 16, 36, 1.0), (2, 3, 20, 36, 1.0), (2, 2, 64, 144, 1.0),
    (2, 6, 256, 576, 1.0),
    (2, 6, 256, 576, 16.0),    # peaked: one key a row dominates
    (5, 40, 32, 80, 1.0),      # 5 windows: runs cross heads in a block
    (3, 1, 256, 576, 1.0),     # one head
    (7, 6, 256, 576, 1.0),     # HAT-M's shape, 7 windows
    (3, 2, 144, 624, 1.0),     # three slices, the most keys: two warpgroups
])
def test_ocab_attention(dev, nwb, heads, nq, nk, peak):
    """K8 against its plain version, token counts padded to 16 around the
    launch (36 keys, 20 queries) or not, windows split unevenly over the
    blocks, and with a peaked bias (where the kernel's rounding of the
    unnormalized P differs most from the plain version's normalized one):
    within two bf16 ulps of the largest output."""
    q = _rand(dev, (nwb, heads, nq, 32), 0.2, seed=1)
    k, v = (_rand(dev, (nwb, heads, nk, 32), seed=s) for s in (2, 3))
    bias = _rand(dev, (heads, nq, nk), peak, torch.float32, seed=4)
    kw = dict(compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16)
    before = ocab.ocab_attention.launches
    o = ocab.ocab_attention(q, k, v, bias, **kw)
    assert ocab.ocab_attention.launches == before + 1
    ref = ocab.ocab_attention_reference(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert (o.float() - ref.float()).abs().max().item() <= \
        2 * _ulp_bound(ref)


def test_swin_kernels_refuse_what_they_do_not_take(dev):
    """A fast CUDA request launches or raises, never falls back: float32
    operands, a window grid that does not divide the image, keys past the
    shared-memory bound."""
    blk = _swin_block(dev, 48, 2, 4, seed=0)
    w32 = swinir.block_weights(blk, 2, 4, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        swin_attention.swin_block_fused(
            torch.zeros(1, 8, 8, 48, device=dev), w32, ws=4, shift=0)
    wb = swinir.block_weights(blk, 2, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        swin_attention.swin_block_fused(
            torch.zeros(1, 8, 10, 48, device=dev, dtype=torch.bfloat16), wb,
            ws=4, shift=0)
    q = torch.zeros(1, 2, 16, 32, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 880, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="keys"):
        ocab.ocab_attention(q, k, k, torch.zeros(2, 16, 880, device=dev),
                            compute_dtype=torch.bfloat16,
                            storage_dtype=torch.bfloat16)


@pytest.mark.parametrize("family", ["SwinIR", "HAT", "Swin2SR"])
def test_small_swin_upscaler_on_card(dev, family):
    """A with_small() SwinIR / HAT / Swin2SR: the fused fast forward (K7,
    its v2 body for Swin2SR, and K8 for HAT's OCAB) against the card's own
    unfused fast layers, then a fast two-pass upscale whose launches are
    one K7 per block and one K8 per OCAB of every tile run."""
    if family == "SwinIR":
        cfg = swinir.SwinIRConfig().with_small()
        net, apply = swinir.init_swinir(cfg, seed=2, device=dev), \
            swinir.swinir_apply
    elif family == "Swin2SR":
        cfg = swin2sr.Swin2SRConfig().with_small()
        net, apply = swin2sr.init_swin2sr(cfg, seed=2, device=dev), \
            swin2sr.swin2sr_apply
    else:
        cfg = hat.HATConfig().with_small()
        net, apply = hat.init_hat(cfg, seed=2, device=dev), hat.hat_apply
    x = _rand(dev, (1, 13, 22, 3), 0.5, torch.float32, seed=5)
    fused = apply(net, x, precision=Precision.fast())
    layers = apply(net, x, precision=Precision(
        compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16,
        mode="fast", swin_attn="xla"))
    assert fused.shape == layers.shape == (1, 26, 44, 3)
    err = (fused - layers).abs().max().item()
    assert err <= 5e-2 * max(1.0, layers.abs().max().item()), err
    img = _rand(dev, (1, 24, 40, 3), 1.5, torch.float32, seed=6)
    ucfg = UpscaleConfig(tiling=TilingConfig(tile=16, overlap=4))
    runs = upscale_progress_total(img, cfg, ucfg)
    k7, k8 = (swin_attention.swin_block_fused.launches,
              ocab.ocab_attention.launches)
    res = hdr_upscale(net, img, ucfg, architecture=family,
                      precision=Precision.fast())
    assert res.image.shape == (1, 48, 80, 3)
    assert torch.isfinite(res.image).all()
    assert swin_attention.swin_block_fused.launches - k7 == \
        sum(cfg.depths) * runs
    assert ocab.ocab_attention.launches - k8 == \
        (len(cfg.depths) * runs if family == "HAT" else 0)


def _window_edges(d, b, h, w, ws):
    """Max of a per-window error d [nwin, ...] over the windows of the last
    window row and column (where a shifted grid's masks act)."""
    e = d.reshape(b, h // ws, w // ws, -1).amax(dim=-1)
    return max(e[:, -1].max().item(), e[:, :, -1].max().item())


@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,extra", SWIN_CASES)
def test_swin_chain(dev, b, h, w, c, heads, ws, shift, extra):
    """The staged chain's kernels, each against its plain version on the
    same input (K9 and K11 on the kernel's own qkv and o): within two bf16
    ulps of the largest output, K9 also over the windows of the last window
    row and column; the chain's output equals K7's (they round at the same
    points), within one ulp."""
    blk = _swin_block(dev, c, heads, ws, seed=ws + shift)
    wts = swinir.block_weights(blk, heads, ws, torch.bfloat16)
    x = _rand(dev, (b, h, w, c), seed=1)
    e = _rand(dev, (b, h, w, c), 0.5, seed=2) if extra else None
    fast = Precision.fast()
    sa = swin_attention
    before = (sa.ln_qkv.launches, sa.window_attention_core.launches,
              sa.proj_mlp.launches)
    qkv = sa.ln_qkv(x, wts, ws=ws, precision=fast)
    kw = dict(heads=heads, ws=ws, shift=shift, grid=(h // ws, w // ws))
    o = sa.window_attention_core(qkv, wts.bias, **kw)
    y = sa.proj_mlp(o, x, wts, ws=ws, extra=e, precision=fast)
    assert (sa.ln_qkv.launches, sa.window_attention_core.launches,
            sa.proj_mlp.launches) == tuple(n + 1 for n in before)
    ref_qkv = sa.ln_qkv_reference(x, wts, ws=ws, precision=fast)
    ref_o = sa.window_attention_core_reference(qkv, wts.bias, **kw)
    ref_y = sa.proj_mlp_reference(o, x, wts, ws=ws, extra=e, precision=fast)
    torch.cuda.synchronize()
    n16 = -(-ws * ws // 16) * 16
    assert qkv.shape == ref_qkv.shape == (b * (h // ws) * (w // ws), n16,
                                          heads * 96)
    assert o.shape == ref_o.shape and y.shape == x.shape
    assert all(t.dtype == torch.bfloat16 for t in (qkv, o, y))
    for got, ref in ((qkv, ref_qkv), (o, ref_o), (y, ref_y)):
        d = (got.float() - ref.float()).abs()
        assert d.max().item() <= 2 * _ulp_bound(ref), d.max().item()
    d = (o.float() - ref_o.float()).abs()
    assert _window_edges(d, b, h, w, ws) <= 2 * _ulp_bound(ref_o)
    k7 = sa.swin_block_fused(x, wts, ws=ws, shift=shift, extra=e,
                             precision=fast)
    assert (y.float() - k7.float()).abs().max().item() <= _ulp_bound(k7)


def test_swin_chain_refuses_what_it_does_not_take(dev):
    """float32 operands, the SwinV2 body, a qkv of the wrong layout and a
    shift past the window raise; nothing falls back."""
    blk = _swin_block(dev, 48, 2, 4, seed=0)
    wb = swinir.block_weights(blk, 2, 4, torch.bfloat16)
    x = torch.zeros(1, 8, 8, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        swin_attention.ln_qkv(x.float(), wb, ws=4,
                              precision=Precision.fast())
    with pytest.raises(ValueError, match="bf16"):
        swin_attention.ln_qkv(x, wb, ws=4, precision=Precision.parity())
    with pytest.raises(ValueError, match="v1 body"):
        swin_attention.proj_mlp(
            torch.zeros(4, 16, 64, device=dev, dtype=torch.bfloat16), x,
            wb._replace(post_norm=True), ws=4, precision=Precision.fast())
    qkv = torch.zeros(4, 16, 2 * 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="qkv must be"):
        swin_attention.window_attention_core(qkv[:, :8], wb.bias, heads=2,
                                             ws=4, shift=0, grid=(2, 2))
    with pytest.raises(ValueError, match="shift"):
        swin_attention.window_attention_core(qkv, wb.bias, heads=2, ws=4,
                                             shift=4, grid=(2, 2))
    with pytest.raises(ValueError, match="grids"):
        swin_attention.window_attention_core(qkv, wb.bias, heads=2, ws=4,
                                             shift=0, grid=(3, 1))


@pytest.mark.parametrize("precision", f32_dot.PRECISIONS)
@pytest.mark.parametrize("m,k,n", [(64, 32, 64), (192, 96, 128),
                                   (1024, 256, 256), (320, 96, 192),
                                   (192, 32, 448), (8192, 256, 256)])
def test_f32_dot(dev, m, k, n, precision):
    """K12 against its plain version within 1e-5 * max|ref| (float32 sums
    in another order), and within its class of a float64 product: highest
    1e-5, high 1e-4, default 2e-2 of max|exact|."""
    x = _rand(dev, (m, k), 1.0, torch.float32, seed=1)
    w = _rand(dev, (k, n), 0.05, torch.float32, seed=2)
    before = f32_dot.f32_dot.launches
    y = f32_dot.f32_dot(x, w, precision=precision)
    assert f32_dot.f32_dot.launches == before + 1
    ref = f32_dot.f32_dot_reference(x, w, precision=precision)
    exact = x.double() @ w.double()
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.dtype == torch.float32
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    bound = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}[precision]
    assert (y.double() - exact).abs().max().item() <= \
        bound * exact.abs().max().item()


@pytest.mark.parametrize("precision", f32_dot.PRECISIONS)
def test_f32_dot_splits_w_once_a_call(dev, precision):
    """The tensor-core modes split w once a call (two parts for high, one
    for default), bit-equal to the plain split; highest reads w itself."""
    x = _rand(dev, (128, 64), 1.0, torch.float32, seed=1)
    w = _rand(dev, (64, 192), 0.05, torch.float32, seed=2)
    before = f32_dot.split_w.launches
    f32_dot.f32_dot(x, w, precision=precision)
    assert f32_dot.split_w.launches == before + (precision != "highest")
    lo = precision == "high"
    parts = f32_dot.split_w(w, lo=lo)
    assert torch.equal(parts, f32_dot.split_w_reference(w, lo=lo))


def test_f32_dot_refuses_what_it_does_not_take(dev):
    x = torch.zeros(64, 32, device=dev)
    with pytest.raises(ValueError, match="multiples"):
        f32_dot.f32_dot(x[:48], torch.zeros(32, 64, device=dev))
    with pytest.raises(ValueError, match="float32"):
        f32_dot.f32_dot(x.double(), torch.zeros(32, 64, device=dev).double())
    with pytest.raises(ValueError, match="contiguous"):
        f32_dot.f32_dot(x, torch.zeros(64, 32, device=dev).t())


def test_debug_nans_sees_a_kernel_nan(dev):
    """K6 writes a NaN (zero inputs times inf weights) through its ctypes
    launch, which the scope's dispatch hook never sees: its wrapper raises
    inside ``utils.profiling.debug_nans``; outside it the NaN comes
    back."""
    from hdrvae_torch.utils.profiling import debug_nans
    w = dense_conv.prepare_weights(
        torch.full((3, 3, 64, 64), float("inf"), device=dev,
                   dtype=torch.bfloat16),
        torch.zeros(64, device=dev), (64,))
    x = torch.zeros(1, 16, 16, 64, device=dev, dtype=torch.bfloat16)
    assert torch.isnan(dense_conv.dense_conv3x3([x], w)).any()
    with debug_nans():
        with pytest.raises(FloatingPointError, match="dense_conv3x3"):
            dense_conv.dense_conv3x3([x], w)


def test_op_profile_rows_are_kernels(dev):
    """On the card ``op_profile``'s rows are device kernels alone, which
    partition the device time (an op's device time is its kernels', so
    counting both would count it twice): K6's kernel is among them and no
    ``aten::`` op is."""
    from hdrvae_torch.utils.profiling import op_profile
    g = torch.Generator(device=dev).manual_seed(0)
    w = dense_conv.prepare_weights(
        0.05 * torch.randn(3, 3, 64, 64, device=dev, generator=g)
        .to(torch.bfloat16), torch.zeros(64, device=dev), (64,))
    x = torch.randn(1, 32, 32, 64, device=dev, generator=g) \
        .to(torch.bfloat16)
    rows = op_profile(lambda: dense_conv.dense_conv3x3([x], w).float() * 2,
                      top=50)
    names = [n for n, _, _ in rows]
    assert any("dense_wgmma_kernel" in n for n in names), names
    assert not any(n.startswith("aten::") for n in names), names
