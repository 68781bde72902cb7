"""The port's sharded two-pass upscale against its single-rank
``hdr_upscale`` and against the JAX package's ``sharded_hdr_upscale``.

Two groups of gloo ranks on the CPU (2 and 3 ranks), started together
once for the module through ``multihost.RankGroup``, run
``sharded_hdr_upscale`` of a seeded ESRGAN (nf 8, x2) on a 40 x 48 image in
the parity tier with the feather, crop and comfy seams: each within 1e-5
max-abs of ``hdr_upscale`` and of JAX's ``sharded_hdr_upscale`` on its
CPU mesh (tests/test_sharding.py's setup and bound).  A one-tile grid and
a tile count below the rank count, in one process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.config import Precision as JPrecision
from hdrvae.core.config import TilingConfig as JTilingConfig
from hdrvae.core.config import UpscaleConfig as JUpscaleConfig
from hdrvae.models.rrdbnet import RRDBNetConfig as JRRDBNetConfig
from hdrvae.models.rrdbnet import init_rrdbnet as jinit_rrdbnet
from hdrvae.sharding import mesh as jmesh
from hdrvae_torch.core.config import Precision, TilingConfig, UpscaleConfig
from hdrvae_torch.models.params import rrdbnet_state_dict_from_jax
from hdrvae_torch.models.rrdbnet import rrdbnet_from_state_dict
from hdrvae_torch.models.zoo import upscaler_state_dict
from hdrvae_torch.sharding import mesh as tmesh
from hdrvae_torch.sharding import multihost
from hdrvae_torch.upscale.pipeline import hdr_upscale

torch.set_num_threads(2)

BOUND = 1e-5
SEAMS = ("feather", "crop", "comfy")
GROUPS = (2, 3)


def _setup():
    """tests/test_sharding.py's: RRDBNet nf 8, gc 4, nb 1, x2 from key 0;
    a 40 x 48 image uniform in [-0.3, 2) from seed 3."""
    jcfg = JRRDBNetConfig(nf=8, gc=4, nb=1, scale=2)
    params = jinit_rrdbnet(jax.random.PRNGKey(0), jcfg)
    net, _ = rrdbnet_from_state_dict(rrdbnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    img = np.random.default_rng(3).uniform(-0.3, 2.0, (1, 40, 48, 3)) \
        .astype(np.float32)
    return params, jcfg, net, img


def _cfgs(seam, tile=16, overlap=4):
    return (UpscaleConfig(tiling=TilingConfig(tile=tile, overlap=overlap,
                                              seam_mode=seam)),
            JUpscaleConfig(tiling=JTilingConfig(tile=tile, overlap=overlap,
                                                seam_mode=seam)))


@pytest.fixture(scope="module")
def ranks():
    params, jcfg, net, img = _setup()
    cases = [multihost.UpscaleCase(seam, "esrgan", torch.from_numpy(img),
                                   _cfgs(seam)[0], Precision.parity())
             for seam in SEAMS]
    up = {"esrgan": ("ESRGAN", upscaler_state_dict(net))}
    groups = {n: multihost.RankGroup(n, {}, cases, upscalers=up,
                                     device="cpu") for n in GROUPS}
    try:
        yield {"setup": (params, jcfg, net, img), "groups": groups,
               "records": {}}
    finally:
        for g in groups.values():
            g.close()


def _records(ranks, n, seam):
    if n not in ranks["records"]:
        got = ranks["groups"][n].wait(timeout=600)
        ranks["records"][n] = {rec["name"]: [r[i] for r in got]
                               for i, rec in enumerate(got[0])}
    return ranks["records"][n][seam]


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("seam", SEAMS)
def test_sharded_upscale_matches_both(ranks, seam, n):
    """n gloo ranks: every rank the same image, within 1e-5 of the port's
    single-rank hdr_upscale and of JAX's sharded_hdr_upscale."""
    params, jcfg, net, img = ranks["setup"]
    cfg, jucfg = _cfgs(seam)
    ref = hdr_upscale(net, torch.from_numpy(img), cfg,
                      architecture="ESRGAN", precision=Precision.parity())
    jref = jmesh.sharded_hdr_upscale(
        params, jnp.asarray(img), jcfg, jucfg, architecture="ESRGAN",
        mesh=jmesh.make_mesh(num_devices=n), precision=JPrecision.parity())
    recs = _records(ranks, n, seam)
    assert [r["world_size"] for r in recs] == [n] * n
    assert len({r["digest"] for r in recs}) == 1
    got = recs[0]["image"]
    assert got.shape == (1, 80, 96, 3)
    assert float((got - ref.image).abs().max()) <= BOUND
    assert float(np.abs(got.numpy() - np.asarray(jref.image)).max()) <= BOUND


@pytest.mark.parametrize("seam,tile", [("feather", 64), ("comfy", 64),
                                       ("crop", 24)])
def test_one_rank_matches_hdr_upscale(seam, tile):
    """One rank (no process group): the one-tile grids (the model output
    as it is, as tiled_apply takes it) and a 2 x 2 crop grid equal
    hdr_upscale bit for bit."""
    _, _, net, img = _setup()
    cfg = _cfgs(seam, tile=tile)[0]
    x = torch.from_numpy(img)
    for prec in (Precision.parity(), Precision.fast()):
        ref = hdr_upscale(net, x, cfg, architecture="ESRGAN", precision=prec)
        got = tmesh.sharded_hdr_upscale(net, x, cfg, architecture="ESRGAN",
                                        mesh=tmesh.Mesh("cpu"),
                                        precision=prec)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sharded_upscale_validation():
    _, _, net, _ = _setup()
    with pytest.raises(ValueError, match=r"expected \[B, H, W, 3\]"):
        tmesh.sharded_hdr_upscale(net, torch.zeros(1, 8, 8, 4),
                                  mesh=tmesh.Mesh("cpu"))
    bad = dataclasses.replace(UpscaleConfig(), tiling=TilingConfig(
        tile=8, overlap=8, seam_mode="feather"))
    with pytest.raises(ValueError, match="overlap"):
        tmesh.sharded_hdr_upscale(net, torch.zeros(1, 20, 20, 3), bad,
                                  mesh=tmesh.Mesh("cpu"))
