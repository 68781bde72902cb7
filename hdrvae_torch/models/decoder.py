"""Flux.1 AutoencoderKL decoder on PyTorch, NHWC at the boundaries, as
``hdrvae/models/decoder.py``.

:class:`Decoder` is an ``nn.Module`` whose submodule names are the ldm
checkpoint keys (``conv_in``, ``mid.block_1``, ``mid.attn_1.q``,
``up.{i}.block.{j}``, ``up.{i}.upsample.conv``, ``norm_out``, ``conv_out``),
so ``load_state_dict`` takes an ldm state dict (``decoder.`` prefix
stripped) as it is.  The forward is written as functions over the modules,
so the fused chain (``models/fused_tail.py``) and the layer path share the
weights.

One forward returns both the image and the pre-``conv_out`` feature map.
``precision.upstack`` picks the route of :func:`decoder_apply`: the fused
kernel chain ("auto" in the fast tier, or "pallas") runs conv_in, the mid
and the up stack and hands the chain's GroupNorm moments to ``norm_out``;
the layers ("auto" in parity and mixed, or "xla") run them on PyTorch's
ops with the mid attention through the tier's flash kernel: exact float32
in parity, the 3-pass bf16x3 kernel in mixed, the bf16 one in the fast
tier and in a mixed head with ``fast_head_levels``.

A ``tape`` (``layers.PadMask``) makes a zero-padded latent decode as the
unpadded one would, where the JAX decoder masks: the latent after its
prescale, every GroupNorm's statistics and output, each ResNet block's
``x + h``, and the mid attention's keys.  A ``layers.GNTape`` records the
GroupNorm statistics of a decode or replays them into another (the tiled
decode's whole-image statistics).  A taped decode runs on the layers in
every tier, as the JAX package keeps it off its Pallas chain.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from hdrvae_torch.core.config import DecoderConfig, Precision
from hdrvae_torch.kernels.attention import spatial_attention
from hdrvae_torch.models.layers import (EPS, Moments, Tape, conv2d,
                                        group_norm, group_norm_silu,
                                        nearest_upsample_2x)


class DecodeOutput(NamedTuple):
    rgb: Optional[torch.Tensor]       # [B, H, W, 3] in [0, 1], or None
    pre_conv_out: torch.Tensor        # [B, H, W, 128] post norm_out + SiLU


def _norm(c: int, cfg: DecoderConfig) -> nn.GroupNorm:
    return nn.GroupNorm(cfg.num_groups, c, eps=EPS)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: DecoderConfig):
        super().__init__()
        self.norm1 = _norm(cin, cfg)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout, cfg)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)


class AttnBlock(nn.Module):
    def __init__(self, c: int, cfg: DecoderConfig):
        super().__init__()
        self.norm = _norm(c, cfg)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)


class Mid(nn.Module):
    def __init__(self, c: int, cfg: DecoderConfig):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, cfg)
        if cfg.attn_mid:
            self.attn_1 = AttnBlock(c, cfg)
        self.block_2 = ResnetBlock(c, c, cfg)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class UpLevel(nn.Module):
    def __init__(self, cin: int, cout: int, level: int, cfg: DecoderConfig):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, cfg)
            for j in range(cfg.num_res_blocks + 1))
        if level != 0:
            self.upsample = Upsample(cout)


class Decoder(nn.Module):
    """The decoder's weights under ldm names; :func:`decoder_apply` runs
    it."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.block_in
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = Mid(block_in, cfg)
        # up[level] is built highest level first, as the forward visits it
        levels = {}
        cin = block_in
        for level in reversed(range(cfg.num_levels)):
            cout = cfg.ch * cfg.ch_mult[level]
            levels[level] = UpLevel(cin, cout, level, cfg)
            cin = cout
        self.up = nn.ModuleList(levels[i] for i in range(cfg.num_levels))
        c_final = cfg.pre_conv_out_channels
        self.norm_out = _norm(c_final, cfg)
        self.conv_out = nn.Conv2d(c_final, cfg.out_channels, 3, padding=1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def resnet_block(x: torch.Tensor, blk: ResnetBlock, *, num_groups: int,
                 precision: Precision,
                 tape: Optional[Tape] = None) -> torch.Tensor:
    """One ResNet block on the layers' own ops, whole image: x [B, H, W,
    Cin] -> [B, H, W, Cout] (the staged decode runs the head's last level
    through it).  With a tape, x + h is zeroed on the pad region: the conv
    biases write there, and the next conv must see zeros."""
    h = group_norm_silu(x, blk.norm1, num_groups=num_groups,
                        precision=precision, tape=tape)
    h = conv2d(h, blk.conv1, precision=precision)
    h = group_norm_silu(h, blk.norm2, num_groups=num_groups,
                        precision=precision, tape=tape)
    h = conv2d(h, blk.conv2, precision=precision)
    if hasattr(blk, "nin_shortcut"):
        x = conv2d(x, blk.nin_shortcut, precision=precision)
    out = x + h
    if tape is not None:
        tape.zero_pad_(out)
    return out


def attn_block(x: torch.Tensor, attn: AttnBlock, *, num_groups: int,
               precision: Precision,
               tape: Optional[Tape] = None) -> torch.Tensor:
    """Single-head spatial self-attention with residual; plain GroupNorm
    (no SiLU) before the 1x1 q/k/v projections.  With a tape the pad
    tokens are no keys; x + h is not masked (the next GroupNorm is)."""
    h = group_norm(x, attn.norm, num_groups=num_groups, precision=precision,
                   tape=tape)
    q = conv2d(h, attn.q, precision=precision)
    k = conv2d(h, attn.k, precision=precision)
    v = conv2d(h, attn.v, precision=precision)
    key_valid = tape.key_valid(x) if tape is not None else None
    h = spatial_attention(q, k, v, precision=precision, key_valid=key_valid)
    h = conv2d(h, attn.proj_out, precision=precision)
    return x + h


# ---------------------------------------------------------------------------
# Decoder forward
# ---------------------------------------------------------------------------


def _up_level(dec: Decoder, x: torch.Tensor, level: int,
              precision: Precision,
              tape: Optional[Tape] = None) -> torch.Tensor:
    """Up level ``level``: its ResNet blocks, then (above level 0) the
    nearest 2x upsample and its conv (not masked: the next GroupNorm
    is)."""
    up = dec.up[level]
    for blk in up.block:
        x = resnet_block(x, blk, num_groups=dec.cfg.num_groups,
                         precision=precision, tape=tape)
    if level != 0:
        x = conv2d(nearest_upsample_2x(x), up.upsample.conv,
                   precision=precision)
    return x


def tail_receptive_radius(cfg: DecoderConfig, tail_levels: int) -> int:
    """Receptive-field radius of :func:`decoder_tail` in tail-entry pixels,
    as ``hdrvae/models/decoder.py``: each 3x3 conv at resolution f x entry
    adds 1/f, each upsample doubles f (its conv runs at the doubled one),
    conv_out adds the last 1/f.  A slab halo of this many rows makes the
    halo-crop of the tail's convs exact."""
    rf = 0.0
    f = 1
    for level in reversed(range(tail_levels)):
        rf += 2 * (cfg.num_res_blocks + 1) / f
        if level != 0:
            f *= 2
            rf += 1.0 / f
    rf += 1.0 / f
    return max(1, int(math.ceil(rf)))


@torch.no_grad()
def decoder_head(dec: Decoder, z: torch.Tensor, *,
                 precision: Precision = Precision(),
                 tail_levels: int = 0,
                 tape: Optional[Tape] = None) -> torch.Tensor:
    """Latent prescale, conv_in, the mid (with the global attention) and
    the up levels above ``tail_levels``, on the layers' own ops.  With the
    default 0 that is every level: the pre-norm_out map.  Output
    resolution: latent x 2^(num_levels - max(tail_levels, 1)).

    conv_in and the mid run at ``precision.head_precision()`` and each up
    level at ``precision.for_level(level)``: all at ``precision`` unless a
    mixed tier sets ``fast_head_levels``.  With a tape the prescaled
    latent's pad region is zeroed (the shift writes there) before
    conv_in."""
    cfg = dec.cfg
    hp = precision.head_precision()
    z = z / cfg.scale_factor + cfg.shift_factor
    if tape is not None:
        z = tape.mask_output(z)
    x = conv2d(z, dec.conv_in, precision=hp)
    x = resnet_block(x, dec.mid.block_1, num_groups=cfg.num_groups,
                     precision=hp, tape=tape)
    if cfg.attn_mid:
        x = attn_block(x, dec.mid.attn_1, num_groups=cfg.num_groups,
                       precision=hp, tape=tape)
    x = resnet_block(x, dec.mid.block_2, num_groups=cfg.num_groups,
                     precision=hp, tape=tape)
    for level in reversed(range(tail_levels, cfg.num_levels)):
        x = _up_level(dec, x, level, precision.for_level(level), tape)
    return x


@torch.no_grad()
def decoder_tail(dec: Decoder, x: torch.Tensor, *,
                 precision: Precision = Precision(),
                 tail_levels: int = 0,
                 apply_conv_out: bool = True,
                 moments: Optional[Moments] = None,
                 tape: Optional[Tape] = None) -> DecodeOutput:
    """Up levels ``tail_levels - 1 .. 0`` (none by default), each at
    ``precision.for_level(level)``, and norm_out + SiLU (+ conv_out and the
    output mapping) at ``precision``, on a :func:`decoder_head` output of
    the same ``tail_levels``.  ``moments`` are norm_out's input moments
    when the producer already reduced them (the fused chain); ``tape`` the
    decode's pad mask, if any."""
    cfg = dec.cfg
    for level in reversed(range(tail_levels)):
        x = _up_level(dec, x, level, precision.for_level(level), tape)
    x = group_norm_silu(x, dec.norm_out, num_groups=cfg.num_groups,
                        precision=precision, moments=moments, tape=tape)
    # Kept in the storage dtype (bf16 in the fast tier): the epilogue's
    # passes over this map are bound by memory traffic.
    pre_conv_out = x.to(precision.storage_dtype)
    rgb = None
    if apply_conv_out:
        rgb = conv2d(pre_conv_out, dec.conv_out, precision=precision)
        rgb = rgb * cfg.output_scale + cfg.output_shift
        if cfg.output_clamp:
            rgb = torch.clamp(rgb, 0.0, 1.0)
        rgb = rgb.float()
    return DecodeOutput(rgb=rgb, pre_conv_out=pre_conv_out)


@torch.no_grad()
def decoder_apply(dec: Decoder, z: torch.Tensor, *,
                  precision: Precision = Precision(),
                  apply_conv_out: bool = True,
                  tape: Optional[Tape] = None) -> DecodeOutput:
    """Decode a latent ``z`` [B, h, w, z_channels] (NHWC) to
    ``DecodeOutput(rgb, pre_conv_out)`` in one forward.

    ``precision.upstack`` "auto": the fast tier runs the fused kernel chain
    (``models/fused_tail.py``: conv_in, the mid and the up stack, its
    moments of the pre-norm map going to ``norm_out``), parity and mixed
    the layers, with the mid attention through the tier's flash kernel
    (exact float32 in parity; the 3-pass bf16x3 kernel in mixed, or the
    bf16 one in a head with ``fast_head_levels``).  "xla": the layers in
    every tier.  "pallas": the fused chain, which takes only the fast tier
    and no tape (on a CPU tensor its kernels' plain versions run).

    ``tape``: a ``layers.PadMask`` for a zero-padded latent, or a
    ``layers.GNTape`` collecting or replaying the GroupNorm statistics;
    the decode then runs on the layers whatever ``upstack`` says, except
    "pallas", which raises.
    """
    if precision.upstack == "pallas" and (precision.mode != "fast"
                                          or tape is not None):
        raise ValueError(
            "precision.upstack='pallas' runs the fused chain, which takes "
            f"only the fast tier and no tape (got mode={precision.mode!r}, "
            f"tape={tape!r})")
    if (precision.mode == "fast" and precision.upstack != "xla"
            and tape is None):
        from hdrvae_torch.models.fused_tail import forward
        pre, moments = forward(dec, z, precision=precision)
        return decoder_tail(dec, pre, precision=precision,
                            apply_conv_out=apply_conv_out, moments=moments)
    x = decoder_head(dec, z, precision=precision, tape=tape)
    return decoder_tail(dec, x, precision=precision,
                        apply_conv_out=apply_conv_out, tape=tape)


def gn_call_count(cfg: DecoderConfig) -> int:
    """GroupNorm calls of one :func:`decoder_apply`: the entries of a
    collected ``GNTape`` (two a ResNet block, the mid attention's, and
    norm_out)."""
    blocks = 2 + cfg.num_levels * (cfg.num_res_blocks + 1)
    return 2 * blocks + int(cfg.attn_mid) + 1


def param_count(dec: Decoder) -> int:
    """Parameters of a :class:`Decoder`, as the JAX package's
    ``param_count`` of its pytree."""
    return sum(p.numel() for p in dec.parameters())
