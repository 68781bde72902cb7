"""The port's slab-sharded decode and K1 / K2's ``owned_rows`` mode against
the JAX package.

- ``plan_slabs`` and ``tail_receptive_radius`` equal JAX's.
- K1 / K2 with ``owned_rows`` (their plain versions here; the CUDA kernels
  are held to those on the card by ``chip_smoke.py``) against the Pallas
  kernels under ``pltpu.force_tpu_interpret_mode``, and K1's per-tile
  partials over a partition of the rows.
- ``sharded_slab_decode`` across 4 gloo ranks on the CPU, started once for
  the module through the port's launcher (``multihost.RankGroup``), against
  JAX's ``sharded_slab_decode`` on a 4-device CPU mesh; the JAX references
  are computed while the ranks run.  Every rank must return the same image.
- One rank: the slab decode equals the port's whole-image decode.

Weights cross over with ``state_dict_from_jax``; inputs are made with numpy
from seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.kernels import conv3x3 as jconv
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.models.decoder import tail_receptive_radius as jradius
from hdrvae.sharding import mesh as jmesh
from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      MeshConfig, Precision)
from hdrvae_torch.decode.pipeline import hdr_decode
from hdrvae_torch.kernels import conv3x3 as tconv
from hdrvae_torch.models.decoder import tail_receptive_radius
from hdrvae_torch.models.params import init_decoder, state_dict_from_jax
from hdrvae_torch.sharding import mesh as tmesh
from hdrvae_torch.sharding import multihost

torch.set_num_threads(2)

RANKS = 4
CONSERVATIVE = "conservative"
# the fast tier with float32 compute and storage: the chain's algorithm
# without its bf16 roundings (JAX's counterpart: the same dtypes)
F32_FAST = Precision(compute_dtype=torch.float32,
                     storage_dtype=torch.float32, mode="fast",
                     upstack="pallas")
J_F32_FAST = JPrecision(compute_dtype=jnp.float32, storage_dtype=jnp.float32,
                        mode="fast", upstack="xla")


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,n,halo", [(13, 4, 3), (16, 8, 2), (37, 5, 6),
                                      (8, 8, 1), (64, 4, 10), (1024, 2, 10)])
def test_plan_slabs_matches_jax(h, n, halo):
    """The slab geometry is JAX's, field for field, and the owned rows
    partition the image."""
    got = tmesh.plan_slabs(h, n, halo)
    ref = jmesh.plan_slabs(h, n, halo)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    cover = np.zeros(h, np.int32)
    for (o0, o1), s in zip(got.owned, got.starts):
        assert 0 <= s <= s + got.slab_h <= h and s <= o0 <= o1 <= s + got.slab_h
        cover[o0:o1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("small", [True, False], ids=["small", "flux"])
def test_tail_receptive_radius_matches_jax(small):
    jcfg, cfg = JDecoderConfig(), DecoderConfig()
    if small:
        jcfg, cfg = jcfg.with_small(), cfg.with_small()
    for levels in range(cfg.num_levels + 1):
        assert tail_receptive_radius(cfg, levels) == jradius(jcfg, levels)


# ---------------------------------------------------------------------------
# K1 / K2 owned_rows: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _sums_close(got, ref, y, lo, hi, rtol=1e-5):
    """(sum, sumsq) [B, G] of y's rows [lo, hi): sumsq within ``rtol``
    relative, the signed sum within ``rtol`` of the rows' sum of |y| per
    group (a signed sum may cancel); an empty interval sums to 0."""
    g = ref[0].shape[-1]
    rows = y[:, max(lo, 0):max(hi, 0)]
    b, h, w, c = rows.shape
    abs_sum = np.abs(rows).reshape(b, h * w, g, c // g).sum(axis=(1, 3))
    np.testing.assert_array_less(np.abs(got[0] - ref[0]),
                                 rtol * abs_sum + 1e-30)
    np.testing.assert_allclose(got[1], ref[1], rtol=rtol, atol=1e-30)


# K1's tiles are 4 rows (tconv._TR): (3, 10) straddles the first and last
# tile of a 12-row map, (5, 5) is empty, (0, 12) the whole map
K1_BOUNDS = [(0, 12), (3, 10), (5, 5)]


@pytest.mark.parametrize("lo,hi", K1_BOUNDS)
def test_k1_owned_rows_matches_pallas(lo, hi):
    """K1 (prologue, residual, statistics) with owned_rows, float32: y as
    without it and the statistics of rows [lo, hi), both within 1e-5
    (summation order only)."""
    h, w, cin, cout = 12, 16, 16, 32
    x, kern = _np(30, (1, h, w, cin)), _np(31, (3, 3, cin, cout), 0.2)
    bias, gamma, beta = _np(32, (cout,)), _np(33, (cin,), 0.5), \
        _np(34, (cin,), 0.5)
    res = _np(35, (1, h, w, cout))
    with pltpu.force_tpu_interpret_mode():
        ry, rs = jconv.fused_conv3x3(
            jnp.asarray(x[0]), jnp.asarray(kern), jnp.asarray(bias),
            gamma=jnp.asarray(gamma), beta=jnp.asarray(beta),
            residual=jnp.asarray(res[0]), emit_stats=True, num_groups=4,
            block_rows=4, owned_rows=jnp.asarray([lo, hi], jnp.int32))
    gy, gs = tconv.fused_conv3x3(
        _t(x), _t(kern), _t(bias), gamma=_t(gamma), beta=_t(beta),
        residual=_t(res), emit_stats=True, num_groups=4,
        owned_rows=(lo, hi))
    ry = np.asarray(ry)[None]
    np.testing.assert_allclose(gy.numpy(), ry, atol=1e-5, rtol=0)
    _sums_close((gs[0].numpy(), gs[1].numpy()),
                (np.asarray(rs[0])[None], np.asarray(rs[1])[None]), ry,
                lo, hi)


# output rows of a 6-row low-resolution map (12 rows out): odd bounds cut
# phase rows 2 i + 1 from 2 i, (0, 0) is empty
K2_CASES = [(3, 9, False), (0, 0, False), (5, 12, True)]


@pytest.mark.parametrize("lo,hi,stats_only", K2_CASES)
def test_k2_owned_rows_matches_pallas(lo, hi, stats_only):
    """K2 with owned_rows at the output's resolution, in the y and the
    stats_only mode, float32: the statistics of output rows [lo, hi) (and
    y) within 1e-5 (summation order only)."""
    h, w, c = 6, 8, 16
    x, kern, bias = _np(40, (1, h, w, c)), _np(41, (3, 3, c, c), 0.2), \
        _np(42, (c,))
    kw = dict(emit_stats=True, num_groups=4)
    with pltpu.force_tpu_interpret_mode():
        full_y = np.asarray(jconv.upsample_conv3x3(
            jnp.asarray(x[0]), jnp.asarray(kern), jnp.asarray(bias),
            block_rows=2))[None]
        ref = jconv.upsample_conv3x3(
            jnp.asarray(x[0]), jnp.asarray(kern), jnp.asarray(bias),
            block_rows=2, stats_only=stats_only,
            owned_rows=jnp.asarray([lo, hi], jnp.int32), **kw)
    got = tconv.upsample_conv3x3(_t(x), _t(kern), _t(bias),
                                 stats_only=stats_only, owned_rows=(lo, hi),
                                 **kw)
    rs, gs = (ref, got) if stats_only else (ref[1], got[1])
    if not stats_only:
        np.testing.assert_allclose(got[0].numpy(), full_y, atol=1e-5, rtol=0)
    _sums_close((gs[0].numpy(), gs[1].numpy()),
                (np.asarray(rs[0])[None], np.asarray(rs[1])[None]), full_y,
                lo, hi)


@pytest.mark.parametrize("upsampled", [False, True], ids=["k1", "k2"])
def test_owned_partials_partition(upsampled):
    """The per-tile partials (``conv_partials``, the layout K1 / K2
    write) over three intervals that cut tiles and phases add up to the
    whole map's (float32 reordering, 1e-6 relative), and each interval's
    reduced to groups equals the plain statistics of its rows."""
    y = torch.from_numpy(_np(50, (1, 14, 20, 8)))
    whole = tconv.conv_partials(y, upsampled)
    parts = [tconv.conv_partials(y, upsampled, owned_rows=b)
             for b in ((0, 5), (5, 11), (11, 14))]
    torch.testing.assert_close(sum(parts), whole, rtol=1e-6, atol=1e-6)
    for (lo, hi), p in zip(((0, 5), (5, 11), (11, 14)), parts):
        ref = tconv._group_sums(y, 2, (lo, hi))
        got = p.sum(dim=1).reshape(1, 2, 2, 4).sum(dim=-1)
        torch.testing.assert_close(got[:, 0], ref[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[:, 1], ref[1], rtol=1e-6, atol=1e-6)


def test_owned_rows_needs_stats():
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="owned_rows needs emit_stats"):
        tconv.fused_conv3x3(x, torch.zeros(3, 3, 16, 16), torch.zeros(16),
                            owned_rows=(0, 2))


# ---------------------------------------------------------------------------
# The slab decode across 4 gloo ranks against JAX's 4-device mesh
# ---------------------------------------------------------------------------


def _latent(seed, h, w, zc):
    return _np(seed, (1, h, w, zc), 2.0)


def _decoders():
    """(JAX params, JAX config, port state dict, port config) of the
    with_small() decoder (key 0) and the full-width one (key 42)."""
    out = {}
    for name, jcfg, cfg, key in (
            ("small", JDecoderConfig().with_small(),
             DecoderConfig().with_small(), 0),
            ("flux", JDecoderConfig(), DecoderConfig(), 42)):
        params = jinit(jax.random.PRNGKey(key), jcfg)
        sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 cfg)
        out[name] = (params, jcfg, sd, cfg)
    return out


# name: (decoder, latent (seed, h, w), tier, tail_levels, pad_to,
#        (rgb bound, image bound)) -- both max-abs against JAX's 4-device
# slab decode.  Parity: float32 sums in another order (conv, GroupNorm,
# all-reduce) against XLA's, ~1e-6 of rgb; the bound 1e-5.  Mixed: the
# port's exact float32 convs against JAX's 3-pass HIGH ones: the mixed
# tier's port-vs-JAX bound of 1e-4 on rgb.  The float32 fast chain
# against JAX's XLA slab path in the same precision: 5e-5 on rgb, 5e-4 on
# the image (tests/test_sharding.py's kernel-vs-XLA slab bounds).  Images
# in the conservative mode, which is linear in rgb and the pre map (the
# EV / logit modes amplify near-saturation differences ~8000x): bounds
# ten times rgb's where the modes' curve steepens.
CASES = {
    "parity_t1": ("small", (1, 16, 16), "parity", 1, None, (1e-5, 1e-4)),
    "parity_t2": ("small", (1, 16, 16), "parity", 2, None, (1e-5, 1e-4)),
    "mixed_t1": ("small", (2, 16, 16), "mixed", 1, None, (1e-4, 1e-3)),
    "mixed_t2": ("small", (2, 16, 16), "mixed", 2, None, (1e-4, 1e-3)),
    "fast_f32_chain": ("small", (3, 16, 16), "f32fast", 2, None,
                       (5e-5, 5e-4)),
    "bucketed": ("small", (4, 13, 11), "parity", 1, (16, 16),
                 (1e-5, 1e-4)),
    "full_width": ("flux", (5, 8, 10), "parity", 2, None, (1e-5, 1e-4)),
}
TIERS = {"parity": (Precision.parity(), JPrecision.parity()),
         "mixed": (Precision.mixed(), JPrecision.mixed()),
         "f32fast": (F32_FAST, J_F32_FAST)}


class _Ranks:
    """The module's rank group and its records, fetched on first use (the
    JAX references of the first test are computed while the ranks run)."""

    def __init__(self, group, decoders):
        self.group, self.decoders = group, decoders
        self._records = None

    def records(self, name):
        if self._records is None:
            ranks = self.group.wait(timeout=300)
            self._records = {rec["name"]: [r[i] for r in ranks]
                             for i, rec in enumerate(ranks[0])}
        return self._records[name]


@pytest.fixture(scope="module")
def ranks():
    decoders = _decoders()
    cases = []
    for name, (dname, (seed, h, w), tier, tl, pad_to, _) in CASES.items():
        cfg = decoders[dname][3]
        cases.append(multihost.SlabCase(
            name, dname, _t(_latent(seed, h, w, cfg.z_channels)),
            HDRDecodeConfig(hdr_mode=CONSERVATIVE), TIERS[tier][0],
            tail_levels=tl, pad_to=pad_to))
    group = multihost.RankGroup(
        RANKS, {n: (d[3], d[2]) for n, d in decoders.items()}, cases,
        device="cpu")
    with group:
        yield _Ranks(group, decoders)


@pytest.mark.parametrize("name", list(CASES))
def test_slab_decode_matches_jax(ranks, name):
    """4 gloo ranks against JAX's 4-device slab decode: every rank holds
    the same image; rgb and the conservative image within the case's
    bounds (CASES); the fallback flag and the pre-map statistics agree."""
    dname, (seed, h, w), tier, tl, pad_to, (b_rgb, b_img) = CASES[name]
    params, jcfg = ranks.decoders[dname][:2]
    latent = _latent(seed, h, w, jcfg.z_channels)
    ref = jmesh.sharded_slab_decode(
        params, jnp.asarray(latent), jcfg,
        JHDRDecodeConfig(hdr_mode=CONSERVATIVE),
        mesh=jmesh.make_mesh(num_devices=RANKS), tail_levels=tl,
        pad_to=pad_to, precision=TIERS[tier][1])
    recs = ranks.records(name)
    assert [r["rank"] for r in recs] == list(range(RANKS))
    assert all(r["backend"] == "gloo" and r["world_size"] == RANKS
               for r in recs)
    for r in recs[1:]:
        assert torch.equal(r["image"], recs[0]["image"])
    got = recs[0]
    assert got["image"].shape == np.asarray(ref.image).shape
    e_rgb = np.abs(got["standard"].numpy() - np.asarray(ref.standard)).max()
    e_img = np.abs(got["image"].numpy() - np.asarray(ref.image)).max()
    assert e_rgb <= b_rgb, f"{name}: rgb {e_rgb:.3e} > {b_rgb}"
    assert e_img <= b_img, f"{name}: image {e_img:.3e} > {b_img}"
    assert got["summary"]["used_fallback"] == bool(ref.used_fallback)
    jpre = ref.stats["pre"]
    for k in ("min", "max", "mean", "std"):
        # the pre map's statistics: 1e-4 relative to max(|ref|, 1)
        want = float(jpre[k])
        assert abs(got["summary"]["pre"][k] - want) <= 1e-4 * max(
            abs(want), 1.0), (name, k, got["summary"]["pre"][k], want)


def test_one_rank_is_whole_image():
    """On a one-rank mesh the slab decode is the whole-image decode: the
    head and a tail of every row, with no halo; parity at with_small(),
    within 1e-6 (the same ops, the statistics summed over a row slice)."""
    cfg = DecoderConfig().with_small()
    dec = init_decoder(cfg, seed=3, device="cpu")
    z = _t(_latent(6, 12, 12, cfg.z_channels))
    hcfg = HDRDecodeConfig()
    whole = hdr_decode(dec, z, hcfg, Precision.parity())
    slab = tmesh.sharded_slab_decode(dec, z, hcfg,
                                     mesh=tmesh.Mesh("cpu"),
                                     precision=Precision.parity())
    torch.testing.assert_close(slab.image, whole.image, rtol=0, atol=1e-6)
    torch.testing.assert_close(slab.standard, whole.standard, rtol=0,
                               atol=1e-6)
    assert bool(slab.used_fallback) == bool(whole.used_fallback)


@pytest.mark.parametrize("num_devices,ok", [(None, True), (1, True),
                                             (2, False)])
def test_mesh_config_checks_the_group_size(num_devices, ok):
    """A Mesh takes its size from the process group (none here: one rank)
    and refuses a MeshConfig that asks for another."""
    cfg = MeshConfig(num_devices=num_devices)
    if ok:
        mesh = tmesh.Mesh("cpu", cfg)
        assert (mesh.size, mesh.rank, mesh.joined) == (1, 0, False)
    else:
        with pytest.raises(ValueError, match="num_devices=2"):
            tmesh.Mesh("cpu", cfg)


def test_pallas_outside_the_chain_raises():
    """upstack="pallas" needs the chain: the fast tier, no bucket."""
    cfg = DecoderConfig().with_small()
    dec = init_decoder(cfg, seed=4, device="cpu")
    z = _t(_latent(7, 8, 8, cfg.z_channels))
    bad = dataclasses.replace(Precision.parity(), upstack="pallas")
    with pytest.raises(ValueError, match="upstack='pallas'"):
        tmesh.sharded_slab_decode(dec, z, mesh=tmesh.Mesh("cpu"),
                                  precision=bad)
    with pytest.raises(ValueError, match="upstack='pallas'"):
        tmesh.sharded_slab_decode(dec, z, mesh=tmesh.Mesh("cpu"),
                                  precision=F32_FAST, pad_to=(8, 8))
    with pytest.raises(ValueError, match="smaller than latent"):
        tmesh.sharded_slab_decode(dec, z, mesh=tmesh.Mesh("cpu"),
                                  pad_to=(4, 8))


def test_failed_rank_fails_the_group():
    """A rank that exits non-zero fails the whole group: every rank is
    stopped and ``wait`` raises with the failing rank's log."""
    z = torch.zeros(1, 8, 8, 4)
    group = multihost.RankGroup(2, {}, [multihost.SlabCase("x", "absent", z)],
                                device="cpu")
    with pytest.raises(RuntimeError, match="rank [01] exited"):
        group.wait(timeout=120)
    assert all(p.poll() is not None for p in group.procs)
