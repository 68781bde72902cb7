"""The port's SwinIR and HAT upscalers against the JAX package: the K7
(``swin_block_fused``) and K8 (``ocab_attention``) plain versions against
the JAX kernels run in interpret mode, the weight layout, the gate, both
forwards, their loaders and the zoo, and ``hdr_upscale`` end to end.

Weights move across with ``*_state_dict_from_jax`` (or are made with numpy
and loaded into both packages); inputs are made with numpy from a seed.
Everything runs at ``with_small()`` widths on CPU tensors.  Tolerances:
the parity tier <= 1e-5 (relative to max(1, max|ref|) for whole
networks); the fast tier (bf16) <= 5e-2 * max(1, max|ref|), the two
packages rounding the same float32 sums, taken in different orders, to
bf16.  Images after the atanh reversal are compared by mean and p99.9.
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
from hdrvae.kernels import ocab as jocab
from hdrvae.kernels import swin_attention as jska
from hdrvae.models import hat as jhat
from hdrvae.models import swinir as jswin
from hdrvae.models import zoo as jzoo
from hdrvae.upscale import pipeline as jpipe
from hdrvae_torch.core.config import Precision, TilingConfig, UpscaleConfig
from hdrvae_torch.kernels import ocab as tocab
from hdrvae_torch.kernels import swin_attention as tska
from hdrvae_torch.models import hat as thatm
from hdrvae_torch.models import swinir as tswin
from hdrvae_torch.models import zoo as tzoo
from hdrvae_torch.models.params import (hat_state_dict_from_jax,
                                        swinir_state_dict_from_jax)
from hdrvae_torch.upscale import pipeline as tpipe
from tests.torch_oracle import TorchHAT, TorchSwinIR

torch.set_num_threads(2)

JFAST = JPrecision(compute_dtype=jnp.bfloat16, storage_dtype=jnp.bfloat16,
                   mode="fast")
TIERS = {"parity": (JPrecision.parity(), Precision.parity()),
         "fast": (JFAST, Precision.fast())}
FUSED = {k: (dataclasses.replace(j, swin_attn="pallas"),
             dataclasses.replace(t, swin_attn="pallas"))
         for k, (j, t) in TIERS.items()}


def _np(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _interpret(fn):
    """Run a JAX call with the Swin/HAT kernels in interpret mode (the
    seam of ``tests/test_swin_kernel.py``; it covers OCAB's kernel too)."""
    jska._INTERPRET = True
    try:
        return fn()
    finally:
        jska._INTERPRET = False


def _err(got, ref):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(ref, np.float32)).max())


def _budget(ref, tier):
    big = max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))
    return (1e-5 if tier == "parity" else 5e-2) * big


def _to_jax(a, tier):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if tier == "fast" else x


def _to_torch(a, tier):
    x = torch.from_numpy(a)
    return x.bfloat16() if tier == "fast" else x


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K7: swin_block_fused
# ---------------------------------------------------------------------------


def _block_pair(seed, dim, heads, ws, hidden):
    """One Swin block's weights from numpy, as a JAX pytree and as the
    port's ``SwinBlock`` (LN affines and biases non-trivial)."""
    r = iter(range(seed, seed + 100))
    lin = lambda i, o: (_np(next(r), (o, i), i ** -0.5),   # noqa: E731
                        _np(next(r), (o,), 0.1))
    qkv, proj, fc1, fc2 = (lin(dim, 3 * dim), lin(dim, dim),
                           lin(dim, hidden), lin(hidden, dim))
    n1, n2 = ((_np(next(r), (dim,), 0.2, 1.0), _np(next(r), (dim,), 0.1))
              for _ in range(2))
    table = _np(next(r), ((2 * ws - 1) ** 2, heads), 0.5)
    jl = lambda wb: {"kernel": wb[0].T, "bias": wb[1]}     # noqa: E731
    jp = {"attn": {"qkv": jl(qkv), "proj": jl(proj),
                   "relative_position_bias_table": table},
          "norm1": {"scale": n1[0], "bias": n1[1]},
          "norm2": {"scale": n2[0], "bias": n2[1]},
          "mlp": {"fc1": jl(fc1), "fc2": jl(fc2)}}
    blk = tswin.SwinBlock(dim, heads, ws, hidden / dim)
    sd = {"attn.qkv.weight": qkv[0], "attn.qkv.bias": qkv[1],
          "attn.proj.weight": proj[0], "attn.proj.bias": proj[1],
          "attn.relative_position_bias_table": table,
          "norm1.weight": n1[0], "norm1.bias": n1[1],
          "norm2.weight": n2[0], "norm2.bias": n2[1],
          "mlp.fc1.weight": fc1[0], "mlp.fc1.bias": fc1[1],
          "mlp.fc2.weight": fc2[0], "mlp.fc2.bias": fc2[1]}
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jax.tree_util.tree_map(jnp.asarray, jp), blk.requires_grad_(False)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("ws,shift", [(4, 0), (4, 2), (16, 0), (16, 8)])
def test_swin_block_fused_plain_vs_jax(ws, shift, with_extra, tier):
    """K7's plain version against the JAX kernel (interpret mode) on a 2 x 2
    window grid, n = 16 and n = 256 tokens, unshifted and shifted (every
    window of a 2 x 2 grid is in the last row or column, one in both),
    with and without HAT's extra residual."""
    dim, heads = 16, 2
    jp, blk = _block_pair(3, dim, heads, ws, 2 * dim)
    hw = 2 * ws
    img = _np(4, (1, hw, hw, dim), 1.0, 0.3)
    extra = _np(5, (1, hw, hw, dim), 0.1) if with_extra else None
    jprec, tprec = TIERS[tier]
    nww = hw // ws
    ref = _interpret(lambda: jska.swin_block_fused(
        _to_jax(img, tier), jp["attn"], jp["norm1"], jp["norm2"], jp["mlp"],
        heads, ws=ws, shift=shift,
        bias_hnn=jswin._gather_bias(jp["attn"], ws),
        bwin=jska.pick_bwin(nww, ws * ws), precision=jprec,
        extra=None if extra is None else _to_jax(extra, tier)))
    w = tswin.block_weights(blk, heads, ws, tprec.compute_dtype)
    got = tska.swin_block_fused(
        _to_torch(img, tier), w, ws=ws, shift=shift,
        extra=None if extra is None else _to_torch(extra, tier),
        precision=tprec)
    assert got.dtype == tprec.storage_dtype and got.shape == img.shape
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


def test_weight_layout_matches_jax():
    """The padded head-major qkv and proj layouts, the folded scale and the
    band masks are the JAX package's, element for element."""
    dim, heads, ws = 16, 2, 4
    jp, blk = _block_pair(7, dim, heads, ws, 24)
    jw, jb = jska._prep_qkv_weights(jp["attn"]["qkv"], heads, dim // heads)
    tw, tb = tska.prep_qkv_weights(blk.attn.qkv.weight, blk.attn.qkv.bias,
                                   heads, torch.float32)
    assert tw.shape == (16, heads * 96)
    np.testing.assert_allclose(
        tw[:dim].reshape(dim, heads * 3, 32).permute(1, 0, 2).numpy(),
        np.asarray(jw), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tb.reshape(heads * 3, 1, 32).numpy(),
                               np.asarray(jb), rtol=0, atol=1e-7)
    jwp = jska._prep_proj_weights(jp["attn"]["proj"], heads, dim // heads)
    twp = tska.prep_proj_weights(blk.attn.proj.weight, heads, torch.float32)
    np.testing.assert_array_equal(twp[:, :dim].reshape(heads, 32, dim)
                                  .numpy(), np.asarray(jwp))
    for shift in (1, 2):
        for t, j in zip(tska.band_masks(ws, shift),
                        jska._band_masks(ws, shift)):
            np.testing.assert_array_equal(t.numpy(), j)
    # the qkv of a width that is no multiple of 16 is zero-padded to it
    w = tska.prepare_block(blk.attn, blk.norm1, blk.norm2, blk.mlp, heads,
                           torch.zeros(heads, 16, 16), torch.bfloat16)
    assert w.w1.shape == (16, 32) and w.b1.shape == (32,)
    assert w.w1[:, 24:].abs().max() == 0 and w.w2[24:].abs().max() == 0


@pytest.mark.parametrize("hw", [(12, 20), (8, 12)])
def test_fused_block_takes_odd_window_grids(hw):
    """A window grid of odd width (5 and 3 windows across): the JAX gate
    refuses it (``pick_bwin``), the port's takes it, and the fused block's
    plain version there computes the unfused layers' function (parity,
    <= 1e-5), here against the JAX package's own XLA block."""
    dim, heads, ws = 16, 2, 4
    assert jska.pick_bwin(hw[1] // ws, ws * ws) == 0
    assert tska.use_swin_kernel(FUSED["parity"][1], torch.zeros(1), *hw, ws,
                                dim // heads)
    jp, blk = _block_pair(9, dim, heads, ws, 32)
    x = _np(10, (1, *hw, dim))
    for shift in (0, 2):
        ref = jswin._swin_block(jnp.asarray(x), jp, heads, ws, shift,
                                JPrecision.parity())
        got = tswin.swin_block(torch.from_numpy(x), blk, heads, ws, shift,
                               FUSED["parity"][1])
        unfused = tswin.swin_block(torch.from_numpy(x), blk, heads, ws,
                                   shift, Precision(swin_attn="xla"))
        assert _err(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())
        assert _err(unfused, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


def test_swin_gate():
    """auto: fused only for a CUDA tensor in the fast tier; xla: never;
    pallas: always, or raises on a grid the kernel cannot take."""
    x = torch.zeros(1)
    fast, parity = Precision.fast(), Precision.parity()
    assert not tska.use_swin_kernel(fast, x, 64, 64, 8, 30)     # CPU tensor
    assert not tska.use_swin_kernel(parity, x, 64, 64, 8, 30)
    pallas = dataclasses.replace(parity, swin_attn="pallas")
    assert tska.use_swin_kernel(pallas, x, 64, 64, 8, 30)
    assert tska.use_swin_kernel(pallas, x, 128, 120, 8, 30)
    assert not tska.use_swin_kernel(
        dataclasses.replace(fast, swin_attn="xla"), x, 64, 64, 8, 30)
    for args in ((64, 60, 8, 30), (64, 64, 8, 40), (64, 64, 32, 30)):
        with pytest.raises(ValueError, match="unsupported"):
            tska.use_swin_kernel(pallas, x, *args)
    with pytest.raises(ValueError, match="swin_attn"):
        tska.use_swin_kernel(dataclasses.replace(fast, swin_attn="cuda"), x,
                             64, 64, 8, 30)
    assert tocab.use_ocab_kernel(pallas, x, 30, 576)
    assert not tocab.use_ocab_kernel(fast, x, 30, 576)
    with pytest.raises(ValueError, match="OCAB"):
        tocab.use_ocab_kernel(pallas, x, 40, 576)


@pytest.mark.parametrize("ws", [4, 7, 8, 10, 12, 16])
def test_qkv_scratch_shape(ws):
    """K7 takes no device-memory scratch for windows of one 64-row block
    (ws <= 8: q, k and v stay on chip); past that, one slot of 32 values
    for each head's q, k and v of every token, the tokens rounded up to
    whole 64-row blocks."""
    nwin, heads, n = 5, 6, ws * ws
    shape = tska.qkv_scratch_shape(nwin, ws, heads)
    if n <= 64:
        assert shape is None
        return
    assert shape[:3] == (nwin, heads, 3) and shape[4] == tska.HDP
    assert shape[3] % 64 == 0 and 0 <= shape[3] - n < 64


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: the wrappers take
    the plain version for CPU tensors only (a meta tensor stands in for a
    device without a card)."""
    dim, heads, ws = 16, 2, 4
    _, blk = _block_pair(11, dim, heads, ws, 32)
    w = tswin.block_weights(blk, heads, ws, torch.bfloat16)
    img = torch.empty(1, 8, 8, dim, device="meta", dtype=torch.bfloat16)
    before = tska.swin_block_fused.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tska.swin_block_fused(img, w, ws=ws, shift=0,
                              precision=Precision.fast())
    q = torch.empty(2, heads, 16, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tocab.ocab_attention(q, q, q, torch.empty(heads, 16, 16),
                             compute_dtype=torch.bfloat16,
                             storage_dtype=torch.bfloat16)
    assert tska.swin_block_fused.launches == before
    assert tocab.ocab_attention.launches == 0


# ---------------------------------------------------------------------------
# K8: ocab_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("nq,nk", [(16, 36), (64, 144), (256, 576)])
def test_ocab_attention_plain_vs_jax(nq, nk, tier):
    """K8's plain version against the JAX kernel (interpret mode): HAT's
    window 4 (small config), 8 and HAT-M's 16 (nq 256, nk 576)."""
    nwb, heads = 2, 2
    q, k, v = (_np(20 + i, (nwb, heads, n, 32), 0.5)
               for i, n in enumerate((nq, nk, nk)))
    bias = _np(23, (heads, nq, nk), 0.5)
    jprec, tprec = TIERS[tier]
    ref = _interpret(lambda: jocab.ocab_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        compute_dtype=jprec.compute_dtype,
        storage_dtype=jprec.storage_dtype))
    got = tocab.ocab_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), compute_dtype=tprec.compute_dtype,
        storage_dtype=tprec.storage_dtype)
    assert got.dtype == tprec.storage_dtype and got.shape == q.shape
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


# ---------------------------------------------------------------------------
# SwinIR and HAT forwards
# ---------------------------------------------------------------------------


def _swinir_pair(seed=0, **kw):
    """A seeded SwinIR of the port, loaded into the JAX package from its
    official state dict (the JAX init makes no '3conv' RSTB), and carried
    back with ``swinir_state_dict_from_jax``: the round trip is exact."""
    sd = tswin.init_swinir(dataclasses.replace(
        tswin.SwinIRConfig().with_small(), **kw), seed=seed,
        device="cpu").state_dict()
    params, jcfg = jswin.swinir_from_state_dict(sd)
    back = swinir_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params))
    assert back.keys() == sd.keys()
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    net, cfg = tswin.swinir_from_state_dict(back, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return params, jcfg, net


def _hat_pair(seed=0):
    jcfg = jhat.HATConfig().with_small()
    params = jhat.init_hat(jax.random.PRNGKey(seed), jcfg)
    net, cfg = thatm.hat_from_state_dict(hat_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return params, jcfg, net


@pytest.mark.parametrize("upsampler,scale,resi", [
    ("nearest+conv", 2, "1conv"), ("nearest+conv", 4, "1conv"),
    ("pixelshuffle", 2, "3conv"), ("pixelshuffle", 3, "1conv"),
    ("pixelshuffledirect", 2, "1conv"), ("", 1, "3conv")])
def test_swinir_apply_parity(upsampler, scale, resi):
    """Every SwinIR head (both scales of the real-world head, a x3 shuffle)
    and both RSTB convs, on a 10 x 13 input that is reflect-padded to
    window multiples and cropped back: <= 1e-5 * max(1, max|ref|)."""
    params, jcfg, net = _swinir_pair(1, upsampler=upsampler, scale=scale,
                                     resi_connection=resi)
    x = _np(2, (1, 10, 13, 3), 0.3, 0.5)
    ref = np.asarray(jswin.swinir_apply(params, jnp.asarray(x), jcfg,
                                        precision=JPrecision.parity()))
    got = tswin.swinir_apply(net, torch.from_numpy(x),
                             precision=Precision.parity())
    assert got.shape == ref.shape == (1, 10 * scale, 13 * scale, 3)
    assert _err(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("upsampler", ["nearest+conv", "pixelshuffle"])
def test_swinir_apply_fast_fused(upsampler):
    """The fast tier with every block forced through the fused block (K7's
    plain version here, the JAX kernel in interpret mode there): <= 5e-2 *
    max(1, max|ref|)."""
    params, jcfg, net = _swinir_pair(3, upsampler=upsampler)
    # 16 x 16: the JAX kernel needs an even window-grid width
    x = _np(4, (1, 16, 16, 3), 0.3, 0.5)
    ref = np.asarray(_interpret(lambda: jswin.swinir_apply(
        params, jnp.asarray(x), jcfg, precision=FUSED["fast"][0])))
    got = tswin.swinir_apply(net, torch.from_numpy(x),
                             precision=FUSED["fast"][1])
    assert _err(got, ref) <= _budget(ref, "fast")


def test_hat_apply_parity():
    """HAT (HABs with the CAB branch, OCAB over the unfolded overlapping
    windows, LeakyReLU head) on a reflect-padded 10 x 13 input."""
    params, jcfg, net = _hat_pair(1)
    x = _np(5, (1, 10, 13, 3), 0.3, 0.5)
    ref = np.asarray(jhat.hat_apply(params, jnp.asarray(x), jcfg,
                                    precision=JPrecision.parity()))
    got = thatm.hat_apply(net, torch.from_numpy(x),
                          precision=Precision.parity())
    assert got.shape == ref.shape == (1, 20, 26, 3)
    assert _err(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_hat_apply_fused(tier):
    """HAT with the fused HAB (K7 with the CAB as ``extra``) and OCAB's K8
    forced: plain versions here, the JAX kernels in interpret mode
    there."""
    params, jcfg, net = _hat_pair(2)
    x = _np(6, (1, 16, 16, 3), 0.3, 0.5)
    ref = np.asarray(_interpret(lambda: jhat.hat_apply(
        params, jnp.asarray(x), jcfg, precision=FUSED[tier][0])))
    got = thatm.hat_apply(net, torch.from_numpy(x), precision=FUSED[tier][1])
    assert _err(got, ref) <= _budget(ref, tier)


def test_unfold_overlap_matches_jax():
    x = _np(7, (2, 8, 12, 5))
    np.testing.assert_array_equal(
        thatm._unfold_overlap(torch.from_numpy(x), 4, 6).numpy(),
        np.asarray(jhat._unfold_overlap(jnp.asarray(x), 4, 6)))
    np.testing.assert_array_equal(thatm.rpi_oca(4, 6).numpy(),
                                  jhat._rpi_oca(4, 6))
    np.testing.assert_array_equal(tswin.relative_position_index(8).numpy(),
                                  jswin._relative_position_index(8))
    np.testing.assert_array_equal(tswin.shift_attn_mask(16, 24, 8, 4).numpy(),
                                  jswin._shift_attn_mask(16, 24, 8, 4))


# ---------------------------------------------------------------------------
# loaders and the zoo
# ---------------------------------------------------------------------------


def _oracle_sd(module):
    torch.manual_seed(0)
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return module.state_dict()


@pytest.mark.parametrize("kw", [
    {}, {"upsampler": "pixelshuffle"},
    {"upsampler": "pixelshuffledirect", "patch_norm": False}])
def test_swinir_oracle_checkpoint_loads_in_both(kw):
    """A state dict of the official-schema SwinIR (with its
    relative_position_index buffers) loads into both packages to the same
    config, holds the same tensors and runs to the oracle's output."""
    cfg = dataclasses.replace(tswin.SwinIRConfig().with_small(), **kw)
    oracle = TorchSwinIR(cfg)
    sd = _oracle_sd(oracle)
    if cfg.upsampler == "pixelshuffledirect":
        # the head has no num_feat; both loaders report the width
        cfg = dataclasses.replace(cfg, num_feat=cfg.embed_dim)
    net, tcfg = tswin.swinir_from_state_dict(sd, device="cpu")
    _, jcfg = jswin.swinir_from_state_dict(sd)
    assert tcfg == cfg
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = _np(8, (1, 9, 11, 3), 0.3, 0.5)
    ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = tswin.swinir_apply(net, torch.from_numpy(x),
                             precision=Precision.parity())
    assert _err(got, ref) <= 1e-4


def test_hat_oracle_checkpoint_loads_and_is_not_swinir(tmp_path):
    """The official-schema HAT loads into both packages to the same config
    and runs to the oracle's output; SwinIR's loader refuses it, and the
    zoo names it HAT (detected before SwinIR, whose spine it shares)."""
    cfg = thatm.HATConfig().with_small()
    oracle = TorchHAT(cfg)
    sd = _oracle_sd(oracle)
    net, tcfg = thatm.hat_from_state_dict(sd, device="cpu")
    _, jcfg = jhat.hat_from_state_dict(sd)
    assert tcfg == cfg
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    x = _np(9, (1, 8, 8, 3), 0.3, 0.5)
    ref = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = thatm.hat_apply(net, torch.from_numpy(x),
                          precision=Precision.parity())
    assert _err(got, ref) <= 1e-4
    assert tswin.is_swinir_state_dict(sd) and thatm.is_hat_state_dict(sd)
    with pytest.raises(ValueError, match="SwinIR"):
        tswin.swinir_from_state_dict(sd, device="cpu")
    path = tmp_path / "hat.pth"
    torch.save({"params_ema": sd}, path)
    model, zcfg, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert (arch, zcfg) == ("HAT", cfg) and isinstance(model, thatm.HAT)


def test_load_swinir_through_zoo(tmp_path):
    cfg = tswin.SwinIRConfig().with_small()
    sd = tswin.init_swinir(cfg, seed=4, device="cpu").state_dict()
    path = tmp_path / "swinir.pth"
    torch.save({"params": sd}, path)
    model, zcfg, arch = tzoo.load_upscale_model(str(path), device="cpu")
    assert (arch, zcfg) == ("SwinIR", cfg) and isinstance(model, tswin.SwinIR)
    _, jcfg, jarch = jzoo.load_upscale_model(str(path))
    assert jarch == "SwinIR"
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def test_init_is_seeded():
    cfg = thatm.HATConfig().with_small()
    a, b = (thatm.init_hat(cfg, seed=5, device="cpu") for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("which", ["swinir", "hat"])
def test_zoo_sizing_matches_jax(which):
    jcfg = jswin.SwinIRConfig() if which == "swinir" else jhat.HATConfig()
    cfg = (tswin.SwinIRConfig() if which == "swinir"
           else thatm.HATConfig())
    for jp, tp in ((JPrecision.fast(), Precision.fast()),
                   (JPrecision.parity(), Precision.parity())):
        assert tzoo.working_set_bytes_per_pixel(cfg, tp) == \
            jzoo.working_set_bytes_per_pixel(jcfg, jp)


# ---------------------------------------------------------------------------
# hdr_upscale end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["SwinIR", "HAT"])
def test_hdr_upscale_parity(arch):
    """The two-pass upscale of a 24 x 40 HDR image (values > 1 and < 0),
    tile 16, overlap 4, parity tier on both sides, the atanh reversal of
    both families: mean and p99.9 of |difference|."""
    params, jcfg, net = _swinir_pair(6) if arch == "SwinIR" else _hat_pair(6)
    img = _np(11, (1, 24, 40, 3), 1.5, 0.3)
    jucfg = JUpscaleConfig(tiling=JTilingConfig(tile=16, overlap=4))
    ucfg = UpscaleConfig(tiling=TilingConfig(tile=16, overlap=4))
    ref = jpipe.hdr_upscale(params, jnp.asarray(img), jcfg, jucfg,
                            architecture=arch, precision=JPrecision.parity())
    got = tpipe.hdr_upscale(net, torch.from_numpy(img), ucfg,
                            architecture=arch, precision=Precision.parity())
    assert got.image.shape == (1, 48, 80, 3)
    assert torch.isfinite(got.image).all()
    for name in ("unclamped", "clamped", "image"):
        d = np.abs(getattr(got, name).numpy()
                   - np.asarray(getattr(ref, name)))
        assert d.mean() <= 1e-5 and np.percentile(d, 99.9) <= 1e-4, \
            (name, d.mean(), np.percentile(d, 99.9))
