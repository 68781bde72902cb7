"""The port's utilities and public helpers against the JAX package:

- ``utils/profiling.py``: the counterparts of ``tests/test_profiling.py``'s
  four tests (StageTimer, debug_nans, op_profile) and ``trace``'s file
  (``debug_nans`` seeing a NaN that a kernel writes is a card test, in
  ``tests/test_torch_cuda.py``);
- ``utils/introspect.py``: ``flatten_params`` and ``describe_params`` on
  the JAX package's own trees;
- the helpers ``linear_to_srgb``, ``to_nhwc_rgb`` / ``_channels_last``,
  ``analyze_conv_out`` and ``param_count`` on ``tests/test_decode_math.py``'s
  cases, against the JAX functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.core.color import linear_to_srgb as jlinear_to_srgb
from hdrvae.core.color import srgb_to_linear as jsrgb_to_linear
from hdrvae.core.config import DecoderConfig as JDecoderConfig
from hdrvae.decode.analysis import analyze_conv_out as janalyze
from hdrvae.decode.formatting import to_nhwc_rgb as jto_nhwc_rgb
from hdrvae.models.decoder import init_decoder as jinit
from hdrvae.models.decoder import param_count as jparam_count
from hdrvae.utils import introspect as jintrospect
from hdrvae_torch.core.color import linear_to_srgb, srgb_to_linear
from hdrvae_torch.core.config import DecoderConfig
from hdrvae_torch.decode.analysis import analyze_conv_out
from hdrvae_torch.decode.formatting import (_channels_last,
                                            collapse_channels_maxpool,
                                            to_nhwc_rgb)
from hdrvae_torch.models.decoder import Decoder, param_count
from hdrvae_torch.utils import introspect
from hdrvae_torch.utils.profiling import (StageTimer, debug_nans,
                                          op_profile, trace)


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


# ---------------------------------------------------------------------------
# profiling: tests/test_profiling.py's four, and more
# ---------------------------------------------------------------------------


def test_stage_timer_syncs_once_per_stage():
    t = StageTimer()
    with t.stage("a", block_on=None):
        x = torch.ones(8, 8) * 2.0
    with t.stage("b", block_on=x):
        x = x + 1.0
    assert set(t.stages) == {"a", "b"}
    assert all(dt >= 0.0 for dt in t.stages.values())
    assert "total" in t.report()


def test_stage_timer_disabled_records_nothing():
    t = StageTimer(enabled=False)
    with t.stage("a"):
        pass
    assert t.stages == {}


def test_debug_nans_scoped():
    """Inside the scope an op that writes a NaN raises; outside it (and
    after it) the same op returns its NaN; views and fresh allocations
    are not checks."""
    from hdrvae_torch.kernels import _build
    with debug_nans(True):
        assert _build.NAN_SCOPES == 1
        torch.empty(64).view(8, 8)
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
    assert _build.NAN_SCOPES == 0
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    with debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_op_profile_returns_sorted_rows(tmp_path):
    def f(x):
        return torch.tanh(x @ x) + 1.0

    x = torch.ones(64, 64)
    rows = op_profile(f, x, logdir=str(tmp_path), top=10)
    assert isinstance(rows, list) and rows
    for name, n, ms in rows:
        assert isinstance(name, str) and n >= 1 and ms >= 0.0
    times = [ms for _, _, ms in rows]
    assert times == sorted(times, reverse=True)
    assert any(name.startswith("aten::mm") for name, _, _ in rows)
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_profiled_tiled_case_records_its_rows():
    """A profiled ``multihost.TiledCase`` on the one-rank mesh: its record
    holds at most five sorted (name, count, ms) rows and the time of all
    rows, which is at least the five's sum."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.models.params import init_decoder
    from hdrvae_torch.sharding import mesh, multihost
    cfg = DecoderConfig().with_small()
    dec = init_decoder(cfg, seed=3, device="cpu")
    z = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 12, 12, cfg.z_channels)).astype(np.float32))
    case = multihost.TiledCase("p", "small", z, precision=Precision.parity(),
                               latent_tile=8, latent_overlap=4,
                               norm_stats="per_tile", profile=True)
    rec = multihost._run_case(case, {"small": dec}, mesh.Mesh("cpu"), 0,
                              False)
    top = rec["top"]
    assert 1 <= len(top) <= 5
    assert [ms for _, _, ms in top] == sorted((ms for _, _, ms in top),
                                              reverse=True)
    assert rec["kernel_ms"] >= sum(ms for _, _, ms in top) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# introspect
# ---------------------------------------------------------------------------


def test_flatten_params_matches_jax():
    """Nested dicts (int keys too) and lists flatten to JAX's dotted paths
    in JAX's order; a module flattens to its state dict's keys."""
    tree = {"b": {"1": [np.ones(2), np.zeros(3)], "0": np.ones(1)},
            "a": {10: np.ones(4), 2: np.ones(5)}}
    got = [p for p, _ in introspect.flatten_params(tree)]
    ref = [p for p, _ in jintrospect.flatten_params(tree)]
    assert got == ref
    with torch.device("meta"):
        dec = Decoder(DecoderConfig().with_small())
    assert [p for p, _ in introspect.flatten_params(dec)] == \
        list(dec.state_dict())


def test_describe_params_matches_jax():
    """The same tree described in the same lines (max_rows too)."""
    params = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(0), JDecoderConfig().with_small()))
    for rows in (0, 5):
        assert introspect.describe_params(params, "small", rows) == \
            jintrospect.describe_params(params, "small", rows)


# ---------------------------------------------------------------------------
# the helpers, on tests/test_decode_math.py's cases
# ---------------------------------------------------------------------------


def _np_srgb_to_linear(x):
    a = np.abs(x)
    out = np.where(a <= 0.04045, a / 12.92, ((a + 0.055) / 1.055) ** 2.4)
    return np.sign(x) * out


def test_linear_to_srgb_matches_jax(rng):
    x = rng.uniform(-2, 2, (16,)).astype(np.float32)
    back = linear_to_srgb(srgb_to_linear(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, atol=5e-4)
    y = rng.uniform(-1.5, 2.0, (3, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        linear_to_srgb(torch.from_numpy(y)).numpy(),
        np.asarray(jlinear_to_srgb(jnp.asarray(y))), rtol=1e-5, atol=1e-6)
    lin = _np_srgb_to_linear(y)
    np.testing.assert_allclose(
        srgb_to_linear(torch.from_numpy(y)).numpy(),
        np.asarray(jsrgb_to_linear(jnp.asarray(y))), rtol=1e-5, atol=1e-6)
    assert np.isfinite(lin).all()


def test_to_nhwc_rgb_layouts(rng):
    nchw = rng.standard_normal((1, 3, 4, 5)).astype(np.float32)
    out = to_nhwc_rgb(torch.from_numpy(nchw)).numpy()
    np.testing.assert_array_equal(out, nchw.transpose(0, 2, 3, 1))
    nchw128 = rng.standard_normal((1, 128, 4, 5)).astype(np.float32)
    assert to_nhwc_rgb(torch.from_numpy(nchw128)).shape == (1, 4, 5, 3)
    hwc = rng.standard_normal((4, 5, 3)).astype(np.float32)
    assert to_nhwc_rgb(torch.from_numpy(hwc)).shape == (1, 4, 5, 3)
    with pytest.raises(ValueError, match="3D/4D"):
        to_nhwc_rgb(torch.zeros(2, 3))


@pytest.mark.parametrize("shape", [
    (1, 128, 130, 140), (1, 130, 140, 128), (1, 64, 48, 48),
    (1, 48, 48, 64), (1, 6, 7, 1), (1, 30, 20, 25), (2, 5, 7, 2)])
def test_to_nhwc_rgb_matches_jax(rng, shape):
    """tests/test_decode_math.py's layouts (the 128-channel map whose
    spatial dims exceed its channels, in both layouts; the square
    tie-break; gray) and two more: the same image as JAX's to_nhwc_rgb,
    float32, and the same layout guess."""
    x = rng.standard_normal(shape).astype(np.float32)
    got = to_nhwc_rgb(torch.from_numpy(x))
    ref = np.asarray(jto_nhwc_rgb(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    from hdrvae.decode.formatting import _channels_last as jcl
    assert _channels_last(shape) == jcl(shape)


def test_to_nhwc_rgb_collapses_as_maxpool(rng):
    nchw = rng.standard_normal((1, 128, 130, 140)).astype(np.float32)
    out = to_nhwc_rgb(torch.from_numpy(nchw))
    ref = collapse_channels_maxpool(torch.from_numpy(
        nchw.transpose(0, 2, 3, 1)))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["sigmoid", "tanh", "custom"])
def test_analyze_conv_out_matches_jax(rng, kind):
    lo = {"sigmoid": 0.0, "tanh": -1.0, "custom": -3.0}[kind]
    rgb = rng.uniform(lo, 1.0, (1, 8, 8, 3)).astype(np.float32)
    rgb[0, 0, 0] = [lo, 1.0, 0.5]
    pre = rng.standard_normal((1, 8, 8, 128)).astype(np.float32)
    got = analyze_conv_out(torch.from_numpy(rgb), torch.from_numpy(pre))
    ref = janalyze(jnp.asarray(rgb), jnp.asarray(pre))
    assert int(got.norm_kind) == int(ref.norm_kind)
    for mine, theirs in ((got.pre_stats, ref.pre_stats),
                         (got.post_stats, ref.post_stats)):
        for k in ("min", "max", "mean", "std"):
            assert float(mine[k]) == pytest.approx(float(theirs[k]),
                                                   rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("small", [True, False], ids=["small", "flux"])
def test_param_count_matches_jax(small):
    jcfg, cfg = JDecoderConfig(), DecoderConfig()
    if small:
        jcfg, cfg = jcfg.with_small(), cfg.with_small()
    with torch.device("meta"):
        dec = Decoder(cfg)
    ref = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    assert param_count(dec) == jparam_count(ref)
    if not small:
        assert 49.4e6 < param_count(dec) < 49.6e6
