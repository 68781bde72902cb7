"""The port's upscale path against the JAX package: colour, filters,
resize, tiling, RRDBNet (layers and loaders), the model zoo and the
two-pass ``hdr_upscale``.

Weights move across with ``rrdbnet_state_dict_from_jax``; images are made
with numpy from a seed.  Everything runs at ``with_small()`` (nf 8, nb 2,
gc 4, x2) on CPU tensors.  Images after the reversal (atanh, slope ~5e5
near its 1 - 1e-6 clip) are compared by the mean and 99.9th percentile of
|difference| and by max-abs only where |raw| < 0.99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core import color as jcolor
from hdrvae.core.config import Precision as JPrecision
from hdrvae.core.config import TilingConfig as JTilingConfig
from hdrvae.core.config import UpscaleConfig as JUpscaleConfig
from hdrvae.models import rrdbnet as jrrdb
from hdrvae.models import zoo as jzoo
from hdrvae.tiling import tiled as jtiled
from hdrvae.upscale import filters as jfilters
from hdrvae.upscale import pipeline as jpipe
from hdrvae.upscale import resize as jresize
from hdrvae_torch.core import color as tcolor
from hdrvae_torch.core.config import Precision, TilingConfig, UpscaleConfig
from hdrvae_torch.models import zoo as tzoo
from hdrvae_torch.models.params import rrdbnet_state_dict_from_jax
from hdrvae_torch.models.rrdbnet import (RRDBNet, RRDBNetConfig,
                                         init_rrdbnet, rrdbnet_apply,
                                         rrdbnet_from_state_dict)
from hdrvae_torch.tiling import tiled as ttiled
from hdrvae_torch.upscale import filters as tfilters
from hdrvae_torch.upscale import pipeline as tpipe
from hdrvae_torch.upscale import resize as tresize

torch.set_num_threads(2)


def _np(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# colour and filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["rgb_to_ycbcr", "ycbcr_to_rgb", "luma"])
def test_color(fn):
    """Elementwise BT.601 maths on HDR values (> 1, < 0): <= 1e-6."""
    x = _np(0, (1, 5, 7, 3), 2.0)
    ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(tcolor, fn)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_gaussian_blur():
    """Reflect padding, the node's k = 3, sigma = 0.1 and a wider
    kernel: <= 1e-6."""
    x = _np(1, (2, 6, 9, 3), 3.0)
    for k, s in ((3, 0.1), (5, 1.2)):
        ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), k, s))
        got = tfilters.gaussian_blur(_t(x), k, s).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_median_blur_zero_padding():
    """Order statistics pick the same value: exact, borders included
    (zero padding, kornia's)."""
    x = _np(2, (1, 6, 9, 3), 2.0, 1.0)
    for k in (3, 5):
        ref = np.asarray(jfilters.median_blur(jnp.asarray(x), k))
        got = tfilters.median_blur(_t(x), k).numpy()
        np.testing.assert_array_equal(got, ref)
    # the corner of an all-positive image counts its five padded zeros
    assert got[0, 0, 0, 0] == 0.0


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["nearest-exact", "bilinear", "area",
                                    "bicubic", "bislerp"])
@pytest.mark.parametrize("size", [(14, 18), (16, 27), (5, 4)])
def test_common_upscale(method, size):
    """Each node method, on a whole-factor upscale, a ragged one and a
    downscale: <= 1e-5 (bislerp's arccos / sin ratios: <= 1e-4)."""
    x = _np(3, (1, 7, 9, 3), 1.0, 0.5)
    h, w = size
    ref = np.asarray(jresize.common_upscale(jnp.asarray(x), w, h, method))
    got = tresize.common_upscale(_t(x), w, h, method).numpy()
    assert got.shape == ref.shape == (1, h, w, 3)
    tol = 1e-4 if method == "bislerp" else 1e-5
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_common_upscale_refuses_unknown_method():
    with pytest.raises(ValueError, match="unknown upscale method"):
        tresize.common_upscale(torch.zeros(1, 2, 2, 3), 4, 4, "lanczos")


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------

# (H, W, tile, overlap): the 1024^2 default grid (512-, 512- and 128-wide
# tiles), a 513-wide image (sliver columns), a 512 x 600 image (both axes
# tile), one that fits one tile, and the test image of hdr_upscale
PLANS = [(1024, 1024, 512, 64), (300, 513, 512, 64), (512, 600, 512, 64),
         (100, 80, 512, 64), (24, 40, 16, 4)]


@pytest.mark.parametrize("h,w,tile,overlap", PLANS)
def test_comfy_plan(h, w, tile, overlap):
    ref = jtiled.plan_tiles_comfy(h, w, tile, overlap)
    got = ttiled.plan_tiles_comfy(h, w, tile, overlap)
    assert got.tiles == ref.tiles
    assert ttiled.num_tiles(h, w, tile, overlap, mode="comfy") == \
        jtiled.num_tiles(h, w, tile, overlap, mode="comfy")
    for mode in ("feather", "crop"):
        assert ttiled.plan_tiles(h, w, tile, overlap).positions == \
            jtiled.plan_tiles(h, w, tile, overlap).positions
        assert ttiled.num_tiles(h, w, tile, overlap, mode=mode) == \
            jtiled.num_tiles(h, w, tile, overlap, mode=mode)


def test_comfy_default_grid_is_nine_tiles():
    plan = ttiled.plan_tiles_comfy(1024, 1024, 512, 64)
    assert plan.num_tiles == 9
    assert sorted({t[2] for t in plan.tiles}) == [128, 512]


@pytest.mark.parametrize("th,tw,feather", [(16, 20, 8), (6, 40, 8),
                                           (12, 12, 4)])
def test_comfy_feather_mask(th, tw, feather):
    np.testing.assert_array_equal(
        ttiled.comfy_feather_mask(th, tw, feather),
        jtiled.comfy_feather_mask(th, tw, feather))


def _tile_fn(x):
    """A stand-in model: a position-independent 2x upscale whose output
    differs from tile to tile near the tile edges (a 3x3 box filter with
    zero padding), so seams show if the blend is wrong."""
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2) + 0.1 * \
        torch.nn.functional.avg_pool2d(
            x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1) \
        .repeat_interleave(2, 1).repeat_interleave(2, 2)


def _jtile_fn(x):
    return jnp.asarray(_tile_fn(_t(np.asarray(x))).numpy())


@pytest.mark.parametrize("mode", ["comfy", "feather", "crop"])
@pytest.mark.parametrize("h,w,tile,overlap", [(24, 40, 16, 4),
                                              (12, 14, 16, 4),
                                              (20, 17, 16, 4)])
def test_tiled_apply_matches_jax(mode, h, w, tile, overlap):
    """Every seam mode on a multi-tile grid, a single tile (the comfy
    early-out returns the model output as it is) and a grid with a
    sliver tile (17 = 12 + 5): <= 1e-6."""
    x = _np(4, (2, h, w, 3))
    ref = np.asarray(jtiled.tiled_apply(_jtile_fn, jnp.asarray(x), tile=tile,
                                        overlap=overlap, scale=2, mode=mode,
                                        pbar=_Count()))
    count = _Count()
    got = ttiled.tiled_apply(_tile_fn, _t(x), tile=tile, overlap=overlap,
                             scale=2, mode=mode, pbar=count)
    assert got.shape == ref.shape == (2, 2 * h, 2 * w, 3)
    assert count.n == ttiled.num_tiles(h, w, tile, overlap, mode=mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_blend_tiles_comfy_matches_jax():
    """The accumulation itself on arbitrary per-tile outputs (no model):
    weighted add and the divide with no epsilon, <= 1e-6."""
    plan_j = jtiled.plan_tiles_comfy(20, 17, 16, 4)
    plan_t = ttiled.plan_tiles_comfy(20, 17, 16, 4)
    outs = [_np(10 + i, (1, 2 * th, 2 * tw, 3))
            for i, (_, _, th, tw) in enumerate(plan_t.tiles)]
    ref = np.asarray(jtiled.blend_tiles_comfy([jnp.asarray(o) for o in outs],
                                              plan_j, scale=2))
    got = ttiled.blend_tiles_comfy((_t(o) for o in outs), plan_t, scale=2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


class _Count:
    n = 0

    def update(self, k):
        self.n += k


def test_select_tile_size():
    for args in ((4096, 4096, 1e3, 2 ** 28), (300, 200, 500.0, 2 ** 20),
                 (2048, 1024, 1e5, 2 ** 30)):
        kw = dict(bytes_per_pixel=args[2], hbm_budget_bytes=args[3])
        assert ttiled.select_tile_size(args[0], args[1], **kw) == \
            jtiled.select_tile_size(args[0], args[1], **kw)


# ---------------------------------------------------------------------------
# RRDBNet layers and loaders
# ---------------------------------------------------------------------------


def _pair(jcfg, seed=0):
    params = jrrdb.init_rrdbnet(jax.random.PRNGKey(seed), jcfg)
    net, cfg = rrdbnet_from_state_dict(rrdbnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    return params, net, cfg


@pytest.mark.parametrize("unshuffle,scale,hw", [(1, 2, (7, 9)),
                                                (2, 2, (7, 10)),
                                                (4, 1, (9, 8))])
def test_rrdbnet_parity(unshuffle, scale, hw):
    """``rrdbnet_apply`` in parity against the JAX package's on the same
    weights: the x2 net and the RealESRGAN unshuffle variants (odd sizes
    reflect-padded and cropped back): <= 1e-5."""
    jcfg = jrrdb.RRDBNetConfig(nf=8, nb=2, gc=4, scale=scale,
                               unshuffle=unshuffle)
    params, net, cfg = _pair(jcfg)
    assert cfg == RRDBNetConfig(nf=8, nb=2, gc=4, scale=scale,
                                unshuffle=unshuffle)
    x = _np(5, (1, *hw, 3), 0.5)
    ref = np.asarray(jrrdb.rrdbnet_apply(params, jnp.asarray(x), jcfg,
                                         precision=JPrecision.parity()))
    got = rrdbnet_apply(net, _t(x), precision=Precision.parity())
    assert got.shape == ref.shape == (1, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def _old_schema(sd, nb):
    """A new-schema state dict renamed to the old ESRGAN schema (x2: one
    upsample conv at model.3, conv_hr model.5, conv_last model.7)."""
    out = {}
    for k, v in sd.items():
        name, p = k.rsplit(".", 1)
        if name.startswith("body."):
            _, i, rdb, conv = name.split(".")
            out[f"model.1.sub.{i}.RDB{rdb[3]}.{conv}.0.{p}"] = v
        else:
            idx = {"conv_first": "0", "conv_body": f"1.sub.{nb}",
                   "conv_up1": "3", "conv_hr": "5", "conv_last": "7"}[name]
            out[f"model.{idx}.{p}"] = v
    return out


def test_both_schemas_load_the_same_network():
    """Old-arch (``model.N``) and new-arch (``conv_first/body``) keys give
    the same config, the same parameters and the same output; numpy
    values load as tensors do, and the JAX loader agrees on the config."""
    cfg = RRDBNetConfig().with_small()
    net = init_rrdbnet(cfg, seed=3, device="cpu")
    sd = net.state_dict()
    old = _old_schema(sd, cfg.nb)
    net_new, cfg_new = rrdbnet_from_state_dict(sd, device="cpu")
    net_old, cfg_old = rrdbnet_from_state_dict(
        {k: v.numpy() for k, v in old.items()}, device="cpu")
    assert cfg_new == cfg_old == cfg
    _, jcfg = jrrdb.rrdbnet_from_state_dict(old)
    assert jcfg == jrrdb.RRDBNetConfig().with_small()
    for k, v in net_old.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    x = _t(_np(6, (1, 5, 6, 3)))
    torch.testing.assert_close(rrdbnet_apply(net_old, x),
                               rrdbnet_apply(net_new, x), rtol=0, atol=0)


def test_init_rrdbnet_is_seeded():
    """numpy-seeded U(+-sqrt(1/fan_in)) weights: one seed, one network."""
    cfg = RRDBNetConfig().with_small()
    a, b = (init_rrdbnet(cfg, seed=7, device="cpu") for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.conv_first.weight
    assert w.abs().max() <= (3 * 9) ** -0.5
    assert not any(p.requires_grad for p in a.parameters())


# ---------------------------------------------------------------------------
# model zoo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrap", [None, "params_ema", "params"])
def test_load_upscale_model_pth_round_trip(tmp_path, wrap):
    """A .pth written with torch.save (bare, or in BasicSR's wrappers)
    loads to the same network, named RealESRGAN; the old schema is
    named ESRGAN."""
    cfg = RRDBNetConfig().with_small()
    net = init_rrdbnet(cfg, seed=1, device="cpu")
    sd = net.state_dict()
    path = tmp_path / "model.pth"
    torch.save(sd if wrap is None else {wrap: sd}, path)
    got, got_cfg, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert (got_cfg, arch) == (cfg, "RealESRGAN")
    assert isinstance(got, RRDBNet)
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    torch.save(_old_schema(sd, cfg.nb), path)
    _, _, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert arch == "ESRGAN"


@pytest.mark.parametrize("family,keys", [
    ("HAT", ["layers.0.residual_group.blocks.0.conv_block.cab.0.weight"]),
    ("Swin2SR", ["layers.0.residual_group.blocks.0.attn.logit_scale"]),
    ("SwinIR", ["layers.0.residual_group.blocks.0.attn.qkv.weight"]),
    ("RealPLKSR", ["feats.0.weight", "feats.1.lk.conv.weight",
                   "feats.1.norm.weight"]),
    ("SPAN", ["block_1.c1_r.sk.weight", "conv_cat.weight"]),
    ("Compact", ["body.0.weight", "body.1.weight"]),
])
def test_unported_families_raise(tmp_path, family, keys):
    """Every family the JAX package runs is ported: a family's fingerprint
    alone is detected as that family and refused as an incomplete
    checkpoint of it, never run as another model (tests/test_torch_swin.py,
    tests/test_torch_swin2sr.py and tests/test_torch_upscale_families.py
    load whole ones)."""
    sd = {k: torch.zeros(4, 3, 3, 3) for k in keys}
    path = tmp_path / "m.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match=family):
        tzoo.load_upscale_model(str(path), device="cpu")


def test_zoo_sizing_matches_jax():
    jcfg, cfg = jrrdb.RRDBNetConfig(), RRDBNetConfig()
    for jp, tp in ((JPrecision.fast(), Precision.fast()),
                   (JPrecision.parity(), Precision.parity())):
        assert tzoo.working_set_bytes_per_pixel(cfg, tp) == \
            jzoo.working_set_bytes_per_pixel(jcfg, jp)
    x = torch.zeros(1, 1024, 1024, 3)
    ucfg = UpscaleConfig()
    assert tpipe.upscale_progress_total(x, cfg, ucfg) == \
        jpipe.upscale_progress_total(jnp.zeros((1, 1024, 1024, 3)), jcfg,
                                     JUpscaleConfig()) == 18


def test_reversal_by_architecture():
    for arch in ("ESRGAN", "RealESRGAN", "SwinIR", "HAT", "MyVAE",
                 "Compact", "SPAN"):
        assert tpipe.get_reversal_fn(arch).__name__ == \
            jpipe.get_reversal_fn(arch).__name__


# ---------------------------------------------------------------------------
# hdr_upscale end to end
# ---------------------------------------------------------------------------


def _close_after_reversal(got, ref, calm):
    """The reversal hazard: mean and p99.9 of |difference| everywhere,
    max-abs only where ``calm`` (|raw| < 0.99 in both passes, where
    atanh's slope is < 50)."""
    d = np.abs(got - ref)
    assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-4, \
        (d.mean(), np.percentile(d, 99.9))
    assert d[calm].max() <= 1e-4


@pytest.mark.parametrize("options", [
    {}, {"small_blur": True, "local_fix": True},
    {"local_fix": True, "upscale_method": "bicubic"}])
def test_hdr_upscale_parity(options):
    """The two-pass upscale of a 24 x 40 HDR image (values > 1 and < 0),
    tile 16, overlap 4 (a 2 x 4 comfy grid), parity tier on both sides."""
    jcfg = jrrdb.RRDBNetConfig().with_small()
    params, net, _ = _pair(jcfg, seed=2)
    img = _np(7, (1, 24, 40, 3), 1.5, 0.3)
    jucfg = JUpscaleConfig(tiling=JTilingConfig(tile=16, overlap=4),
                           **options)
    ucfg = UpscaleConfig(tiling=TilingConfig(tile=16, overlap=4), **options)
    ref = jpipe.hdr_upscale(params, jnp.asarray(img), jcfg, jucfg,
                            precision=JPrecision.parity())
    count = _Count()
    got = tpipe.hdr_upscale(net, _t(img), ucfg,
                            precision=Precision.parity(), pbar=count)
    assert count.n == tpipe.upscale_progress_total(_t(img), net.cfg, ucfg)
    assert got.image.shape == (1, 48, 80, 3) and got.image.dtype == \
        torch.float32
    assert torch.isfinite(got.image).all()
    # the raw model output of each pass on the whole image, as the mask
    calm = np.ones(got.image.shape, bool)
    for x in (img, np.clip(img, -1.0, 1.0)):
        raw = jrrdb.rrdbnet_apply(params, jnp.asarray(x), jcfg,
                                  precision=JPrecision.parity())
        calm &= np.abs(np.asarray(raw)) < 0.99
    for name in ("unclamped", "clamped", "image"):
        _close_after_reversal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name)), calm)
