"""The port's dense conv (K6) and its RRDBNet chain against the JAX package.

On this CPU-only suite the ``dense_conv3x3`` wrapper runs its plain
version (the CUDA kernel is held to that same plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  The JAX side runs the
Pallas kernel under ``pltpu.force_tpu_interpret_mode``, as the JAX
package's own tests do, at small shapes.  Inputs are made with numpy from a
seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrvae.core.config import Precision as JPrecision
from hdrvae.kernels import conv3x3 as jconv
from hdrvae.models import rrdbnet as jrrdb
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import dense_conv
from hdrvae_torch.models.params import rrdbnet_state_dict_from_jax
from hdrvae_torch.models.rrdbnet import (rrdbnet_apply,
                                         rrdbnet_from_state_dict,
                                         rrdbnet_layers)
from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply

torch.set_num_threads(2)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# (input widths, act, residual scale or None): the JAX test's three inputs
# with lrelu and a 0.2 residual; conv_first's 3 channels; the five-input
# conv5 shape; conv_body's 1.0 residual
CASES = [((8, 8, 16), "lrelu", 0.2), ((3,), None, None),
         ((8, 4, 4, 4, 4), "lrelu", None), ((8,), None, 1.0)]


def _case(cins, cout, res_scale, h=8, w=16):
    xs = [_np(i, (1, h, w, c)) for i, c in enumerate(cins)]
    kern = _np(10, (3, 3, sum(cins), cout), 0.2)
    bias = _np(11, (cout,))
    r = _np(12, (1, h, w, cout)) if res_scale is not None else None
    return xs, kern, bias, r


@pytest.mark.parametrize("cins,act,res_scale", CASES)
def test_reference_matches_pallas_f32(cins, act, res_scale):
    """float32: the same function, summation order only (<= 1e-5)."""
    cout = 8
    xs, kern, bias, r = _case(cins, cout, res_scale)
    jkw, tkw = {}, {}
    if r is not None:
        jkw = dict(residual=jnp.asarray(r[0]), res_scale=res_scale)
        tkw = dict(residual=_t(r), res_scale=res_scale)
    with pltpu.force_tpu_interpret_mode():
        ref = jconv.dense_conv3x3([jnp.asarray(x[0]) for x in xs],
                                  jnp.asarray(kern), jnp.asarray(bias),
                                  act=act, block_rows=4, block_cols=8, **jkw)
    got = dense_conv.dense_conv3x3([_t(x) for x in xs], _t(kern), _t(bias),
                                   act=act, **tkw)
    assert got.dtype == torch.float32 and got.shape == (1, 8, 16, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[None], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_reference_matches_pallas_bf16(out_dtype):
    """bf16 inputs, kernel and residual, float32 accumulation, stored in
    bf16 or float32: both sides round the same float32 value once, so they
    differ only where summation order flips a bf16 rounding (one ulp,
    2^-8 relative), and by float32 noise (<= 1e-5) in float32."""
    cins, cout = (8, 8, 16), 8
    xs, kern, bias, r = _case(cins, cout, 0.2)
    bf, jdt = torch.bfloat16, (jnp.bfloat16 if out_dtype == torch.bfloat16
                               else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jconv.dense_conv3x3(
            [jnp.asarray(x[0], jnp.bfloat16) for x in xs],
            jnp.asarray(kern, jnp.bfloat16), jnp.asarray(bias), act="lrelu",
            residual=jnp.asarray(r[0], jnp.bfloat16), res_scale=0.2,
            out_dtype=jdt, block_rows=4, block_cols=8)
    got = dense_conv.dense_conv3x3([_t(x, bf) for x in xs], _t(kern, bf),
                                   _t(bias), act="lrelu", residual=_t(r, bf),
                                   res_scale=0.2, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    ref = np.asarray(ref.astype(jnp.float32))[None]
    if out_dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# (input widths, Cout): conv_first's 3 and 12 channels (K packed across the
# taps), its 48 (unshuffle 4), a dense block's five inputs, widths that end
# in a part chunk (8, 4, 24), conv_last's 3 outputs (N 8) and N 128
LAYOUT_CASES = [((3,), 64), ((12,), 64), ((48,), 64),
                ((16, 8, 8, 8, 8), 16), ((8, 4, 4), 8), ((24,), 100),
                ((64,), 3)]


@pytest.mark.parametrize("cins,cout", LAYOUT_CASES)
def test_prepared_weights_layout(cins, cout):
    """The kernel's weight layout (``prepare_weights``), read back as the
    kernel reads it (``dense_conv3x3_as_gemm``: per K chunk and tap the
    decoded [16, N] slice times that chunk's window), reproduces the plain
    version's conv of the same HWIO kernel: float32 sums in another order,
    <= 1e-5 of the largest value.  Its shape: [chunks, taps, N / 8, 2, 8,
    8], N the first of 8, 16, 32, 64, 128 >= Cout, zeros past Cout."""
    xs = [_t(_np(20 + i, (2, 5, 7, c))) for i, c in enumerate(cins)]
    kern = _t(_np(30, (3, 3, sum(cins), cout), 0.2))
    bias = _t(_np(31, (cout,)))
    pw = dense_conv.prepare_weights(kern, bias, cins)
    n = dense_conv.padded_cout(cout)
    packed = len(cins) == 1 and cins[0] < 16
    chunks = (-(-9 * cins[0] // 16) if packed
              else sum(-(-c // 16) for c in cins))
    assert pw.packed == packed
    assert pw.w.shape == (chunks, 1 if packed else 9, n // 8, 2, 8, 8)
    assert pw.bias.shape == (n,) and not pw.bias[cout:].any()
    assert not pw.w.permute(0, 1, 3, 5, 2, 4).reshape(
        chunks, -1, n)[..., cout:].any()
    got = dense_conv.dense_conv3x3_as_gemm(xs, pw) + bias
    ref = dense_conv.dense_conv3x3_reference(xs, kern, bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())


def test_prepared_weights_on_cpu():
    """A call with prepared weights runs the same plain version as one with
    the HWIO kernel; prepared weights carry their bias and refuse another,
    and refuse inputs of other widths."""
    cins, cout = (8, 4), 8
    xs = [_t(_np(i, (1, 4, 6, c))) for i, c in enumerate(cins)]
    kern, bias = _t(_np(5, (3, 3, 12, cout), 0.2)), _t(_np(6, (cout,)))
    pw = dense_conv.prepare_weights(kern, bias, cins)
    r = _t(_np(7, (1, 4, 6, cout)))
    kw = dict(act="lrelu", residual=r, res_scale=0.2)
    np.testing.assert_array_equal(
        dense_conv.dense_conv3x3(xs, pw, **kw).numpy(),
        dense_conv.dense_conv3x3(xs, kern, bias, **kw).numpy())
    with pytest.raises(ValueError, match="bias"):
        dense_conv.dense_conv3x3(xs, pw, bias)
    with pytest.raises(ValueError, match="Cout"):
        dense_conv.prepare_weights(_t(_np(8, (3, 3, 12, 130))),
                                   torch.zeros(130), cins)


def test_unknown_act_refused():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="unknown act"):
        dense_conv.dense_conv3x3([x], torch.zeros(3, 3, 8, 8),
                                 torch.zeros(8), act="relu")


def test_cpu_tensors_never_launch():
    """On CPU tensors the wrapper runs its plain version: the launch
    counter stays 0."""
    before = dense_conv.dense_conv3x3.launches
    x = torch.zeros(1, 4, 8, 8, dtype=torch.bfloat16)
    dense_conv.dense_conv3x3([x, x], torch.zeros(3, 3, 16, 3,
                                                 dtype=torch.bfloat16),
                             torch.zeros(3), out_dtype=torch.float32)
    assert dense_conv.dense_conv3x3.launches == before == 0


# ---------------------------------------------------------------------------
# The RRDBNet chain
# ---------------------------------------------------------------------------


def _pair(jcfg, seed=0):
    params = jrrdb.init_rrdbnet(jax.random.PRNGKey(seed), jcfg)
    net, cfg = rrdbnet_from_state_dict(rrdbnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    return params, net


@pytest.mark.parametrize("unshuffle,scale,hw", [(1, 2, (8, 12)),
                                                (2, 2, (7, 10))])
def test_chain_f32_matches_jax_layers(unshuffle, scale, hw):
    """The fused chain in a float32-storage fast tier against the JAX
    package's layers in the same tier: the same function (the chain
    leaves the RRDB adds and upsamples to torch ops, as the JAX chain
    does), so float32 noise only, <= 1e-5.  The unshuffle case pads an
    odd 7 x 10 input and feeds conv_first 12 channels."""
    jcfg = jrrdb.RRDBNetConfig(nf=8, nb=2, gc=4, scale=scale,
                               unshuffle=unshuffle)
    params, net = _pair(jcfg)
    x = _np(3, (1, *hw, 3), 0.5)
    jprec = JPrecision(compute_dtype=jnp.float32, storage_dtype=jnp.float32,
                       mode="fast")
    ref = np.asarray(jrrdb.rrdbnet_apply(params, jnp.asarray(x), jcfg,
                                         precision=jprec))
    prec = Precision(compute_dtype=torch.float32,
                     storage_dtype=torch.float32, mode="fast")
    got = rrdbnet_fused_apply(net, _t(x), precision=prec)
    assert got.shape == ref.shape == (1, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_chain_fast_tier_within_band():
    """The fast tier: the port's bf16 chain (K6's plain version) against
    the JAX package's bf16 layers, which round to bf16 between each conv
    and its activation where the chain rounds once after its epilogue.
    Held to the chain's band, 5e-2 * max(1, max |ref|), the budget of the
    JAX dense chain against its layers."""
    jcfg = jrrdb.RRDBNetConfig().with_small()
    params, net = _pair(jcfg, seed=1)
    x = _np(4, (1, 8, 12, 3), 0.5)
    ref = np.asarray(jrrdb.rrdbnet_apply(params, jnp.asarray(x), jcfg,
                                         precision=JPrecision.fast())
                     .astype(jnp.float32))
    got = rrdbnet_fused_apply(net, _t(x), precision=Precision.fast())
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max()
    assert err <= 5e-2 * max(1.0, np.abs(ref).max()), err
    # the port's own unfused fast layers sit in the same band
    layers = rrdbnet_layers(net, _t(x), precision=Precision.fast()).float()
    assert np.abs(layers.numpy() - ref).max() <= 5e-2


def test_chain_prepares_each_conv_once():
    """``rrdbnet_fused_apply`` prepares each conv's weights once per
    compute dtype and device and keeps them on the module: two calls
    prepare 15 a RRDB + conv_first, conv_body, the upsample convs, conv_hr
    and conv_last, once."""
    jcfg = jrrdb.RRDBNetConfig().with_small()
    _, net = _pair(jcfg, seed=2)
    x = _t(_np(6, (1, 6, 10, 3)))
    convs = 15 * jcfg.nb + 4 + jcfg.num_upsamples
    before = dense_conv.prepare_weights.preparations
    a = rrdbnet_fused_apply(net, x, precision=Precision.fast())
    assert dense_conv.prepare_weights.preparations == before + convs
    b = rrdbnet_fused_apply(net, x, precision=Precision.fast())
    assert dense_conv.prepare_weights.preparations == before + convs
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # another compute dtype is another preparation of each conv
    rrdbnet_fused_apply(net, x, precision=Precision(
        compute_dtype=torch.float32, storage_dtype=torch.float32,
        mode="fast"))
    assert dense_conv.prepare_weights.preparations == before + 2 * convs


def test_chain_prepares_again_after_weights_change():
    """The weights kept on a module follow its parameters: after
    ``load_state_dict`` puts another net's weights in place, the chain
    prepares each conv anew and gives that net's output, not the old
    one's."""
    jcfg = jrrdb.RRDBNetConfig().with_small()
    _, net = _pair(jcfg, seed=2)
    _, other = _pair(jcfg, seed=3)
    x = _t(_np(6, (1, 6, 10, 3)))
    convs = 15 * jcfg.nb + 4 + jcfg.num_upsamples
    a = rrdbnet_fused_apply(net, x, precision=Precision.fast())
    want = rrdbnet_fused_apply(other, x, precision=Precision.fast())
    before = dense_conv.prepare_weights.preparations
    net.load_state_dict(other.state_dict())
    b = rrdbnet_fused_apply(net, x, precision=Precision.fast())
    assert dense_conv.prepare_weights.preparations == before + convs
    np.testing.assert_array_equal(b.numpy(), want.numpy())
    assert not np.array_equal(a.numpy(), b.numpy())


def test_apply_runs_layers_on_cpu():
    """``rrdbnet_apply`` takes the chain only for CUDA inputs in the fast
    tier; a CPU input runs the layers, as the JAX package does off the
    TPU."""
    _, net = _pair(jrrdb.RRDBNetConfig().with_small())
    x = _t(_np(5, (1, 6, 8, 3)))
    for prec in (Precision.fast(), Precision.parity()):
        np.testing.assert_array_equal(
            rrdbnet_apply(net, x, precision=prec).float().numpy(),
            rrdbnet_layers(net, x, precision=prec).float().numpy())
