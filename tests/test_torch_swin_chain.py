"""The port's staged Swin chain against the JAX package: the plain versions
of K10 (``ln_qkv``), K9 (``window_attention_core``) and K11 (``proj_mlp``)
against the JAX kernels run in interpret mode, ``swin_window_attention``
against JAX's, and ``swin_block_chain`` against the three JAX calls
composed and against K7's plain version.

Windows 4 and 16 (16 and 256 tokens) on 2 x 2 and 2 x 4 window grids at
dim 16, 2 heads, in both tiers.  Tolerances: parity <= 1e-5 * max(1,
max|ref|); fast (bf16) <= 5e-2 * max(1, max|ref|), the two packages
rounding the same float32 sums, taken in different orders, to bf16.  The
port's chain against K7's plain version: <= 1e-6 * max(1, max|ref|) in
parity and one bf16 ulp of max|ref| in fast (they round at the same
points).  The port's layouts ([nwb, n16, heads * 96] and [nwb, n16, heads
* 32]) are converted to JAX's slot layouts to compare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrvae.kernels import swin_attention as jska
from hdrvae.models import swinir as jswin
from hdrvae_torch.kernels import swin_attention as tska
from hdrvae_torch.models import swinir as tswin
from tests.test_torch_swin import (TIERS, _block_pair, _budget, _err, _f32,
                                   _interpret, _np, _to_jax, _to_torch)

torch.set_num_threads(2)

DIM, HEADS = 16, 2
# (window, window grid): 16 and 256 tokens on 2 x 2 and 2 x 4 grids
GRIDS = [(4, (2, 2)), (4, (2, 4)), (16, (2, 2)), (16, (2, 4))]


def _slots_to_jax(qkv, n, heads):
    """[nwb, n16, heads * 96] -> JAX's [nwb, heads * 3, n, 32]."""
    return qkv[:, :n].reshape(qkv.shape[0], n, heads * 3, 32).permute(
        0, 2, 1, 3)


def _slots_from_jax(a, heads):
    """JAX's [nwb, heads * k, n, 32] -> [nwb, n16, heads * k * 32]."""
    t = a.permute(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)
    return torch.nn.functional.pad(t, (0, 0, 0, -a.shape[2] % 16))


def _outs_to_jax(o, n, heads):
    """[nwb, n16, heads * 32] -> JAX's [nwb, heads, n, 32]."""
    return o[:, :n].reshape(o.shape[0], n, heads, 32).permute(0, 2, 1, 3)


def _ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _pair(ws):
    return _block_pair(3, DIM, HEADS, ws, 2 * DIM)


def _weights(blk, ws, tier):
    return tswin.block_weights(blk, HEADS, ws, TIERS[tier][1].compute_dtype)


def _jax_core(qkv, bias_hnn, ws, shift, grid):
    """JAX's K9 on its slot layout, with its bias tables."""
    n = ws * ws
    tables, colmask = jska.build_bias_tables(bias_hnn, ws, shift, n)
    return _interpret(lambda: jska._attn_core(
        qkv, tables, colmask, heads=HEADS, n=n, nwh=grid[0], nww=grid[1],
        bwin=jska.pick_bwin(grid[1], n), shifted=bool(shift)))


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("ws,grid", GRIDS)
def test_ln_qkv_vs_jax(ws, grid, tier):
    """K10's plain version against JAX's ``ln_qkv``: LN1, the qkv
    projection in the head-major slot layout with the scale folded into q,
    the partition of the image into windows."""
    jp, blk = _pair(ws)
    img = _np(4, (1, grid[0] * ws, grid[1] * ws, DIM), 1.0, 0.3)
    jprec, tprec = TIERS[tier]
    ref = _interpret(lambda: jska.ln_qkv(
        _to_jax(img, tier), jp["attn"], jp["norm1"], HEADS, ws=ws,
        bwin=jska.pick_bwin(grid[1], ws * ws), precision=jprec))
    got = tska.ln_qkv(_to_torch(img, tier), _weights(blk, ws, tier), ws=ws,
                      precision=tprec)
    assert got.dtype == tprec.storage_dtype
    assert got.shape == (grid[0] * grid[1], ws * ws, HEADS * 96)
    got = _slots_to_jax(got, ws * ws, HEADS)
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("ws,grid", GRIDS)
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_core_vs_jax(shifted, ws, grid, batch, tier):
    """K9's plain version against JAX's ``_attn_core`` on the same random
    q / k / v (every lane of the 32, pads too) and bias, unshifted and
    shifted (the band masks in the last window row and column), batch 1
    and 2 (the grid's rows repeat per image)."""
    n, shift = ws * ws, (ws // 2 if shifted else 0)
    nwb = batch * grid[0] * grid[1]
    qkv = _np(20, (nwb, HEADS * 3, n, 32), 0.5)
    bias = _np(21, (HEADS, n, n), 0.5)
    ref = _jax_core(_to_jax(qkv, tier), jnp.asarray(bias), ws, shift, grid)
    got = tska.window_attention_core(
        _slots_from_jax(_to_torch(qkv, tier), HEADS),
        torch.from_numpy(bias), heads=HEADS, ws=ws, shift=shift, grid=grid)
    assert got.dtype == _to_torch(qkv, tier).dtype
    assert got.shape == (nwb, n, HEADS * 32)
    got = _outs_to_jax(got, n, HEADS)
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("ws,grid", GRIDS)
@pytest.mark.parametrize("with_extra", [False, True])
def test_proj_mlp_vs_jax(with_extra, ws, grid, tier):
    """K11's plain version against JAX's ``proj_mlp`` (its A&S erf
    polynomial against the exact erf: <= 1.5e-7), with and without HAT's
    extra residual, the windows merged back into the image."""
    jp, blk = _pair(ws)
    n, nwb = ws * ws, grid[0] * grid[1]
    hw = (grid[0] * ws, grid[1] * ws)
    img = _np(4, (1, *hw, DIM), 1.0, 0.3)
    attn = _np(6, (nwb, HEADS, n, 32), 0.5)
    attn[..., DIM // HEADS:] = 0.0       # the head dim's pad lanes
    extra = _np(5, (1, *hw, DIM), 0.1) if with_extra else None
    jprec, tprec = TIERS[tier]
    ref = _interpret(lambda: jska.proj_mlp(
        _to_jax(attn, tier), _to_jax(img, tier), jp["attn"], jp["norm2"],
        jp["mlp"], HEADS, ws=ws, bwin=jska.pick_bwin(grid[1], n),
        precision=jprec,
        extra=None if extra is None else _to_jax(extra, tier)))
    got = tska.proj_mlp(
        _slots_from_jax(_to_torch(attn, tier), HEADS), _to_torch(img, tier),
        _weights(blk, ws, tier), ws=ws,
        extra=None if extra is None else _to_torch(extra, tier),
        precision=tprec)
    assert got.dtype == tprec.storage_dtype and got.shape == img.shape
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("ws,grid", GRIDS)
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_window_attention_vs_jax(shifted, ws, grid, tier):
    """The drop-in window attention (plain qkv -> K9 -> plain proj) against
    JAX's ``swin_window_attention`` on post-LN windows."""
    jp, blk = _pair(ws)
    n, shift = ws * ws, (ws // 2 if shifted else 0)
    hw = (grid[0] * ws, grid[1] * ws)
    wins = _np(7, (grid[0] * grid[1], n, DIM), 1.0)
    jprec, tprec = TIERS[tier]
    ref = _interpret(lambda: jska.swin_window_attention(
        _to_jax(wins, tier), jp["attn"], HEADS, ws, hw, shift,
        jswin._gather_bias(jp["attn"], ws), precision=jprec))
    got = tska.swin_window_attention(
        _to_torch(wins, tier), _weights(blk, ws, tier), ws=ws, grid_hw=hw,
        shift=shift, precision=tprec)
    assert got.dtype == tprec.storage_dtype and got.shape == wins.shape
    assert _err(_f32(got), _f32(ref)) <= _budget(_f32(ref), tier)


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("ws,grid", GRIDS)
@pytest.mark.parametrize("shifted,with_extra", [(False, False), (True, True)])
def test_swin_block_chain_vs_jax_and_k7(shifted, with_extra, ws, grid, tier):
    """The chain K10 -> K9 -> K11 against JAX's three calls composed, and
    against K7's plain version on the same weights: the same function,
    rounded at the same points."""
    jp, blk = _pair(ws)
    n, shift = ws * ws, (ws // 2 if shifted else 0)
    hw = (grid[0] * ws, grid[1] * ws)
    img = _np(4, (1, *hw, DIM), 1.0, 0.3)
    extra = _np(5, (1, *hw, DIM), 0.1) if with_extra else None
    jprec, tprec = TIERS[tier]
    bwin = jska.pick_bwin(grid[1], n)
    jimg = _to_jax(img, tier)
    jextra = None if extra is None else _to_jax(extra, tier)

    def jax_chain():
        qkv = jska.ln_qkv(jimg, jp["attn"], jp["norm1"], HEADS, ws=ws,
                          bwin=bwin, precision=jprec)
        tables, colmask = jska.build_bias_tables(
            jswin._gather_bias(jp["attn"], ws), ws, shift, n)
        o = jska._attn_core(qkv, tables, colmask, heads=HEADS, n=n,
                            nwh=grid[0], nww=grid[1], bwin=bwin,
                            shifted=bool(shift))
        return jska.proj_mlp(o, jimg, jp["attn"], jp["norm2"], jp["mlp"],
                             HEADS, ws=ws, bwin=bwin, precision=jprec,
                             extra=jextra)
    ref = _f32(_interpret(jax_chain))
    w = _weights(blk, ws, tier)
    kw = dict(ws=ws, shift=shift, precision=tprec,
              extra=None if extra is None else _to_torch(extra, tier))
    got = tska.swin_block_chain(_to_torch(img, tier), w, **kw)
    assert got.dtype == tprec.storage_dtype and got.shape == img.shape
    assert _err(_f32(got), ref) <= _budget(ref, tier)
    k7 = _f32(tska.swin_block_fused_reference(_to_torch(img, tier), w, **kw))
    bound = (1e-6 * max(1.0, np.abs(k7).max()) if tier == "parity"
             else _ulp(k7))
    assert _err(_f32(got), k7) <= bound


@pytest.mark.parametrize("tier", ["parity", "fast"])
@pytest.mark.parametrize("hw", [(8, 12), (12, 20)])
@pytest.mark.parametrize("shift", [0, 2])
def test_chain_on_odd_window_grids(shift, hw, tier):
    """Window grids 3 and 5 windows across, which JAX's kernels cannot take
    (``pick_bwin`` is 0): the chain against K7's plain version only, and
    ``chain_block`` (which rolls) against ``fused_block``."""
    ws = 4
    assert jska.pick_bwin(hw[1] // ws, ws * ws) == 0
    _, blk = _pair(ws)
    w = _weights(blk, ws, tier)
    prec = TIERS[tier][1]
    x = _to_torch(_np(10, (1, *hw, DIM), 1.0, 0.3), tier)
    got = tska.swin_block_chain(x, w, ws=ws, shift=shift, precision=prec)
    ref = tska.swin_block_fused_reference(x, w, ws=ws, shift=shift,
                                          precision=prec)
    bound = (1e-6 * max(1.0, np.abs(_f32(ref)).max()) if tier == "parity"
             else _ulp(_f32(ref)))
    assert _err(_f32(got), _f32(ref)) <= bound
    chained = tswin.chain_block(x, w, ws, shift, prec)
    fused = tswin.fused_block(x, w, ws, shift, prec)
    assert _err(_f32(chained), _f32(fused)) <= bound


def test_chain_wrappers_never_fall_back():
    """A tensor off the CPU goes to a kernel or raises (a meta tensor
    stands in for a device without a card), and no launch is counted; the
    chain refuses the SwinV2 body on any device."""
    ws = 4
    _, blk = _pair(ws)
    w = tswin.block_weights(blk, HEADS, ws, torch.bfloat16)
    img = torch.empty(1, 8, 8, DIM, device="meta", dtype=torch.bfloat16)
    qkv = torch.empty(4, 16, HEADS * 96, device="meta", dtype=torch.bfloat16)
    o = torch.empty(4, 16, HEADS * 32, device="meta", dtype=torch.bfloat16)
    before = (tska.ln_qkv.launches, tska.window_attention_core.launches,
              tska.proj_mlp.launches)
    for call in (
            lambda: tska.ln_qkv(img, w, ws=ws),
            lambda: tska.window_attention_core(qkv, w.bias, heads=HEADS,
                                               ws=ws, shift=0, grid=(2, 2)),
            lambda: tska.proj_mlp(o, img, w, ws=ws),
            lambda: tska.swin_block_chain(img, w, ws=ws, shift=0)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (tska.ln_qkv.launches, tska.window_attention_core.launches,
            tska.proj_mlp.launches) == before == (0, 0, 0)
    v2 = w._replace(post_norm=True, qk_scale=torch.ones(HEADS))
    x = torch.zeros(1, 8, 8, DIM)
    with pytest.raises(ValueError, match="v1 body"):
        tska.swin_block_chain(x, v2, ws=ws, shift=0)
