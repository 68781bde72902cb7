"""The port's tile-grid decode and the GroupNorm tape against the JAX
package.

- ``extract_tiles`` and ``_crop_boxes`` equal JAX's; the boxes partition
  every pixel once (``tests/test_sharding.py``'s four irregular grids).
- ``GNTape``: a collect-then-inject decode equals the decode without a
  tape, and the collected (mean, var) entries match JAX's ``GNTape``.
- ``sharded_tiled_decode`` across 4 gloo ranks on the CPU, started once for
  the module through ``multihost.RankGroup``, against JAX's
  ``sharded_tiled_decode`` on a 4-device CPU mesh, for ``norm_stats``
  "global" and "per_tile": conservative images by max-abs, the default
  (logit) mode by mean and p99.9; both sides within
  ``tests/test_sharding.py``'s seam bounds against the whole-image decode;
  the first3 fallback taken; one rank equal to four.

Weights cross over with ``state_dict_from_jax``; inputs are made with numpy
from seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.core.config import HDRDecodeConfig as JHDRDecodeConfig
from hdrvae.core.config import Precision as JPrecision
from hdrvae.decode.pipeline import hdr_decode as jhdr_decode
from hdrvae.models import layers as jlayers
from hdrvae.models.decoder import decoder_apply as jdecoder_apply
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.sharding import mesh as jmesh
from hdrvae.tiling import tiled as jtiled
from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      Precision)
from hdrvae_torch.decode.pipeline import hdr_decode
from hdrvae_torch.models.decoder import decoder_apply, gn_call_count
from hdrvae_torch.models.layers import GNTape
from hdrvae_torch.models.params import (decoder_from_state_dict,
                                        state_dict_from_jax)
from hdrvae_torch.sharding import mesh as tmesh
from hdrvae_torch.sharding import multihost
from hdrvae_torch.tiling import tiled

torch.set_num_threads(2)

RANKS = 4
F32_FAST = Precision(compute_dtype=torch.float32,
                     storage_dtype=torch.float32, mode="fast",
                     upstack="pallas")
J_F32_FAST = JPrecision(compute_dtype=jnp.float32, storage_dtype=jnp.float32,
                        mode="fast", upstack="xla")
TIERS = {"parity": (Precision.parity(), JPrecision.parity()),
         "mixed": (Precision.mixed(), JPrecision.mixed()),
         "f32fast": (F32_FAST, J_F32_FAST)}


def _latent(seed, h, w, zc=4):
    return (np.random.default_rng(seed).standard_normal((1, h, w, zc))
            * 2).astype(np.float32)


def _decoders():
    """(JAX params, port state dict) of the with_small() decoder (key 0)
    and of one whose norm_out is squashed (key 11, scale x 0.05: no HDR
    pixels, so the decode takes the fallback tier)."""
    jcfg, cfg = JDecoderConfig().with_small(), DecoderConfig().with_small()
    out = {}
    for name, key in (("small", 0), ("squashed", 11)):
        params = jinit(jax.random.PRNGKey(key), jcfg)
        if name == "squashed":
            params = dict(params)
            params["norm_out"] = dict(params["norm_out"])
            params["norm_out"]["scale"] = params["norm_out"]["scale"] * 0.05
        sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 cfg)
        out[name] = (params, sd)
    return out


CONS = {"hdr_mode": "conservative"}
FIRST3 = {"hdr_mode": "conservative", "conservative_ev_multiplier": 2.0,
          "fallback_collapse": "first3"}
# name: (decoder, latent (seed, h, w), latent tile, overlap, norm_stats,
#        tier, HDR config, image bound).  Image bounds against JAX's 4-device
# tiled decode, max-abs on the conservative images: the slab decode's
# (tests/test_torch_sharding.py) -- parity 1e-4, mixed 1e-3, the float32
# fast chain 5e-4 (there JAX's mesh runs its XLA layers).  None: the
# default (logit) mode, compared by mean and p99.9 of |diff| instead.
CASES = {
    "g16": ("small", (1, 16, 16), 12, 8, "global", "parity", CONS, 1e-4),
    "t16": ("small", (1, 16, 16), 12, 8, "per_tile", "parity", CONS, 1e-4),
    "g13": ("small", (2, 13, 13), 8, 4, "global", "parity", CONS, 1e-4),
    "t13": ("small", (2, 13, 13), 8, 4, "per_tile", "parity", CONS, 1e-4),
    "g20x12": ("small", (3, 20, 12), 8, 4, "global", "parity", CONS, 1e-4),
    "t20x12": ("small", (3, 20, 12), 8, 4, "per_tile", "parity", CONS,
               1e-4),
    "seam_g": ("small", (4, 16, 16), 12, 8, "global", "parity", {}, None),
    "seam_t": ("small", (4, 16, 16), 12, 8, "per_tile", "parity", {}, None),
    "mixed_g": ("small", (5, 16, 16), 12, 8, "global", "mixed", CONS, 1e-3),
    "fast_t": ("small", (6, 16, 16), 12, 8, "per_tile", "f32fast", CONS,
               5e-4),
    "first3": ("squashed", (7, 16, 16), 12, 4, "global", "parity", FIRST3,
               1e-4),
    # one tile on four ranks: three ranks decode nothing
    "one_tile": ("small", (8, 8, 8), 12, 8, "per_tile", "parity", CONS,
                 1e-4),
}
# the default mode's bounds on mean and p99.9 of |port - JAX|: the logit
# amplifies float32 noise near saturation ~8000x (ROADMAP), so the max is
# no measure; a stitching fault moves the mean and the tail by far more
LOGIT_MEAN, LOGIT_P999 = 1e-4, 1e-2


def _run_jax(ranks, name):
    dname, (seed, h, w), t, o, ns, tier, hcfg, _ = CASES[name]
    return np.asarray(jmesh.sharded_tiled_decode(
        ranks.decoders[dname][0], jnp.asarray(_latent(seed, h, w)),
        JDecoderConfig().with_small(), JHDRDecodeConfig(**hcfg),
        mesh=jmesh.make_mesh(num_devices=RANKS), latent_tile=t,
        latent_overlap=o, norm_stats=ns, precision=TIERS[tier][1]))


class _Ranks:
    def __init__(self, group, decoders):
        self.group, self.decoders = group, decoders
        self._records = None

    def records(self, name):
        if self._records is None:
            ranks = self.group.wait(timeout=600)
            self._records = {rec["name"]: [r[i] for r in ranks]
                             for i, rec in enumerate(ranks[0])}
        return self._records[name]


@pytest.fixture(scope="module")
def ranks():
    decoders = _decoders()
    cfg = DecoderConfig().with_small()
    cases = [multihost.TiledCase(
        name, dname, torch.from_numpy(_latent(seed, h, w)),
        HDRDecodeConfig(**hcfg), TIERS[tier][0], latent_tile=t,
        latent_overlap=o, norm_stats=ns)
        for name, (dname, (seed, h, w), t, o, ns, tier, hcfg, _)
        in CASES.items()]
    group = multihost.RankGroup(
        RANKS, {n: (cfg, d[1]) for n, d in decoders.items()}, cases,
        device="cpu")
    with group:
        yield _Ranks(group, decoders)


def _port_decoder(ranks, name):
    return decoder_from_state_dict(ranks.decoders[name][1],
                                   DecoderConfig().with_small(),
                                   device="cpu")


# ---------------------------------------------------------------------------
# The ranks against JAX's mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_decode_matches_jax(ranks, name):
    """4 gloo ranks against JAX's 4-device tiled decode: every rank holds
    the same image, of the right shape, within the case's bound (the
    default mode by mean and p99.9)."""
    dname, (seed, h, w), t, o, ns, tier, hcfg, bound = CASES[name]
    ref = _run_jax(ranks, name)
    recs = ranks.records(name)
    assert [r["rank"] for r in recs] == list(range(RANKS))
    assert all(r["backend"] == "gloo" and r["world_size"] == RANKS
               for r in recs)
    assert len({r["digest"] for r in recs}) == 1
    got = recs[0]["image"].numpy()
    assert got.shape == ref.shape == (1, 2 * h, 2 * w, 3)
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    if bound is None:
        assert d.mean() <= LOGIT_MEAN and np.quantile(d, 0.999) <= \
            LOGIT_P999, (name, d.mean(), np.quantile(d, 0.999))
    else:
        assert d.max() <= bound, f"{name}: {d.max():.3e} > {bound}"


def test_seam_bounds_both_sides(ranks):
    """tests/test_sharding.py's seam bounds on both packages' tiled
    decodes against their whole-image decodes: global < 2e-2 of the
    signal, and global < per_tile."""
    dname, (seed, h, w) = CASES["seam_g"][:2]
    z = _latent(seed, h, w)
    jwhole = np.asarray(jhdr_decode(
        ranks.decoders[dname][0], jnp.asarray(z),
        JDecoderConfig().with_small(), JHDRDecodeConfig(),
        JPrecision.parity()).image)
    whole = hdr_decode(_port_decoder(ranks, dname), torch.from_numpy(z),
                       HDRDecodeConfig(), Precision.parity()).image.numpy()
    for side, ref, img in (
            ("jax", jwhole, {n: _run_jax(ranks, n)
                             for n in ("seam_g", "seam_t")}),
            ("port", whole, {n: ranks.records(n)[0]["image"].numpy()
                             for n in ("seam_g", "seam_t")})):
        signal = np.abs(ref).max()
        g, t = (np.abs(ref - img[n]).max() / signal
                for n in ("seam_g", "seam_t"))
        assert g < 2e-2 and g < t, (side, g, t)


def test_first3_fallback_on_the_tiled_path(ranks):
    """The first3 fallback is taken on the tiled path, as on the
    whole-image decode, within tests/test_sharding.py's 2 % of the
    signal."""
    dname, (seed, h, w), t, o, ns, tier, hcfg, _ = CASES["first3"]
    rec = ranks.records("first3")[0]
    assert rec["summary"]["used_fallback"] is True
    z = torch.from_numpy(_latent(seed, h, w))
    whole = hdr_decode(_port_decoder(ranks, dname), z,
                       HDRDecodeConfig(**hcfg), Precision.parity())
    assert bool(whole.used_fallback)
    signal = max(1.0, float(whole.image.abs().max()))
    err = float((rec["image"] - whole.image).abs().max())
    assert err <= 0.02 * signal, err


@pytest.mark.parametrize("name", ["g13", "t20x12", "mixed_g"])
def test_one_rank_equals_four(ranks, name):
    """Sharding is a placement decision: the one-rank tiled decode (no
    process group) equals the four-rank one within 1e-5."""
    dname, (seed, h, w), t, o, ns, tier, hcfg, _ = CASES[name]
    one = tmesh.sharded_tiled_decode(
        _port_decoder(ranks, dname), torch.from_numpy(_latent(seed, h, w)),
        HDRDecodeConfig(**hcfg), mesh=tmesh.Mesh("cpu"), latent_tile=t,
        latent_overlap=o, norm_stats=ns, precision=TIERS[tier][0])
    four = ranks.records(name)[0]["image"]
    torch.testing.assert_close(one, four, rtol=1e-5, atol=1e-5)


def test_tiled_decode_validation():
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(_decoders()["small"][1], cfg,
                                  device="cpu")
    z = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="norm_stats must be"):
        tmesh.sharded_tiled_decode(dec, z, mesh=tmesh.Mesh("cpu"),
                                   norm_stats="tiles")
    with pytest.raises(ValueError, match="must be 4D"):
        tmesh.sharded_tiled_decode(dec, z[0], mesh=tmesh.Mesh("cpu"))
    with pytest.raises(ValueError, match="channel axis"):
        tmesh.sharded_tiled_decode(dec, torch.zeros(1, 8, 8, 5),
                                   mesh=tmesh.Mesh("cpu"))
    # NCHW is taken as JAX takes it
    a = tmesh.sharded_tiled_decode(dec, z.permute(0, 3, 1, 2),
                                   mesh=tmesh.Mesh("cpu"), latent_tile=6,
                                   latent_overlap=2,
                                   precision=Precision.parity())
    assert a.shape == (1, 16, 16, 3)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


GRIDS = [(13, 13, 8, 4), (16, 16, 12, 8), (20, 12, 8, 4), (9, 17, 8, 2)]


@pytest.mark.parametrize("h,w,tile,ov", GRIDS)
def test_crop_boxes_match_jax_and_partition(h, w, tile, ov):
    """The owned boxes are JAX's and partition every pixel once."""
    scale = 2
    plan = tiled.plan_tiles(h, w, tile, ov)
    jplan = jtiled.plan_tiles(h, w, tile, ov)
    assert plan.positions == jplan.positions
    boxes = tmesh._crop_boxes(plan, scale)
    assert boxes == jmesh._crop_boxes(jplan, scale)
    cover = np.zeros((h * scale, w * scale), np.int32)
    for (y, x0), (top, bottom, left, right) in zip(plan.positions, boxes):
        cover[y * scale + top:y * scale + bottom,
              x0 * scale + left:x0 * scale + right] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("h,w,tile,ov", GRIDS[:2])
def test_extract_tiles_matches_jax(h, w, tile, ov):
    x = np.random.default_rng(3).standard_normal((2, h, w, 5)).astype(
        np.float32)
    plan = tiled.plan_tiles(h, w, tile, ov)
    got = tiled.extract_tiles(torch.from_numpy(x), plan)
    ref = np.asarray(jtiled.extract_tiles(jnp.asarray(x),
                                          jtiled.plan_tiles(h, w, tile, ov)))
    assert got.shape == (plan.num_tiles, 2, plan.tile_h, plan.tile_w, 5)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# The GroupNorm tape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["parity", "mixed"])
def test_gn_tape_matches_jax(tier):
    """A collected tape has gn_call_count entries of [B, G] (mean, var),
    each within 1e-5 of JAX's ``GNTape`` (two-pass in parity, one-pass in
    mixed); replaying it gives the decode without a tape."""
    params, sd = _decoders()["small"]
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(sd, cfg, device="cpu")
    z = _latent(9, 12, 10)
    prec, jprec = TIERS[tier]
    tape = GNTape("collect")
    out = decoder_apply(dec, torch.from_numpy(z), precision=prec,
                        apply_conv_out=False, tape=tape)
    assert out.rgb is None
    jtape = jlayers.GNTape("collect")
    jdecoder_apply(params, jnp.asarray(z), JDecoderConfig().with_small(),
                   precision=jprec, apply_conv_out=False, tape=jtape)
    assert len(tape.stats) == len(jtape.stats) == gn_call_count(cfg)
    for (m, v), (jm, jv) in zip(tape.stats, jtape.stats):
        assert m.shape == v.shape == (1, cfg.num_groups)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)
    plain = decoder_apply(dec, torch.from_numpy(z), precision=prec)
    replayed = decoder_apply(dec, torch.from_numpy(z), precision=prec,
                             tape=GNTape("inject", tape.stats))
    torch.testing.assert_close(replayed.rgb, plain.rgb, rtol=0, atol=1e-6)
    torch.testing.assert_close(replayed.pre_conv_out, plain.pre_conv_out,
                               rtol=0, atol=1e-6)


def test_gn_tape_routes():
    """A taped fast decode takes the layers (no chain), "pallas" with a
    tape raises, "off" records nothing, and a bad mode raises."""
    cfg = DecoderConfig().with_small()
    dec = decoder_from_state_dict(_decoders()["small"][1], cfg,
                                  device="cpu")
    z = torch.from_numpy(_latent(10, 8, 8))
    fast = Precision.fast()
    taped = decoder_apply(dec, z, precision=fast, tape=GNTape("collect"))
    xla = decoder_apply(dec, z, precision=dataclasses.replace(
        fast, upstack="xla"))
    torch.testing.assert_close(taped.rgb, xla.rgb, rtol=0, atol=0)
    with pytest.raises(ValueError, match="upstack='pallas'"):
        decoder_apply(dec, z, precision=dataclasses.replace(
            fast, upstack="pallas"), tape=GNTape("inject", []))
    off = GNTape()
    decoder_apply(dec, z, precision=Precision.parity(), tape=off)
    assert off.stats == []
    with pytest.raises(ValueError, match="GNTape mode"):
        GNTape("replay")
