"""Configuration dataclasses of the PyTorch port.

Mirrors ``hdrvae/core/config.py``: the decoder topology, the HDR decode
parameters, the numerics policy, and the tiling and upscale settings, with
torch dtypes in place of jnp ones.
The configs are frozen dataclasses; nothing global is switched when this
module is imported.  :func:`fp32_contractions` is the one place that turns
TF32 off for the float32 tiers.  :class:`ExportConfig` holds the export
node's inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Flux.1 AutoencoderKL decoder topology: conv_in -> mid(block_1,
    attn_1, block_2) -> up levels -> GroupNorm + SiLU -> conv_out."""

    z_channels: int = 16           # Flux.1 latent channels
    ch: int = 128                  # base width
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2        # decoder uses num_res_blocks + 1 per level
    out_channels: int = 3
    attn_mid: bool = True          # mid-block spatial self-attention
    num_groups: int = 32           # GroupNorm groups

    # Latent pre-scaling before the decoder (diffusers semantics:
    # z / scale_factor + shift_factor).  Flux.1 constants.
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    # Output mapping from the decoder range [-1, 1] to [0, 1]:
    # clamp(x * 0.5 + 0.5, 0, 1).  The clamp is what makes the analysis see
    # the post range as exactly [0, 1] and classify it SIGMOID.
    output_scale: float = 0.5
    output_shift: float = 0.5
    output_clamp: bool = True

    @property
    def num_levels(self) -> int:
        return len(self.ch_mult)

    @property
    def block_in(self) -> int:
        """Channel width at the mid block (and the start of up stages)."""
        return self.ch * self.ch_mult[-1]

    @property
    def pre_conv_out_channels(self) -> int:
        """Width of the pre-conv_out feature map (128 for Flux.1)."""
        return self.ch * self.ch_mult[0]

    @property
    def spatial_scale(self) -> int:
        """Latent -> pixel spatial upsampling factor (8 for Flux.1)."""
        return 2 ** (self.num_levels - 1)

    def with_small(self) -> "DecoderConfig":
        """A tiny config for tests (fast on one CPU core)."""
        return dataclasses.replace(
            self, z_channels=4, ch=16, ch_mult=(1, 2), num_res_blocks=1,
            num_groups=4,
        )


HDR_MODES = ("conservative", "exposure", "adaptive_recovery",
             "mathematical_recovery")

# Aliases kept for old-graph compatibility.
HDR_MODE_ALIASES = {
    "moderate": "conservative",
    "aggressive": "mathematical_recovery",
}


@dataclasses.dataclass(frozen=True)
class HDRDecodeConfig:
    """Parameters of the HDR decode pipeline (the JAX package's fields and
    defaults)."""

    hdr_mode: str = "mathematical_recovery"
    conservative_ev_multiplier: float = 1.0
    # Inner expansion factor of the conservative mode; the user multiplier
    # only scales the final image.
    conservative_expansion_factor: float = 1.0
    # Channel collapse of the fallback (bypass) tier image: "maxpool" (the
    # 42/42/42 MAX collapse) or "first3" (the first 3 raw channels).
    fallback_collapse: str = "maxpool"
    # Acceptance threshold of the intelligent result (hdr pixels > 0 or
    # max > 1.1).
    accept_max_threshold: float = 1.1
    # Also report conv_out re-applied alone and the conv_out weight/bias
    # statistics.
    full_analysis: bool = False
    hdr_tol: float = 1e-3          # HDR-data gate on the collapsed pre map
    sigmoid_eps: float = 1e-7      # inverse-activation epsilons
    tanh_eps: float = 1e-6
    ev_floor: float = 0.001        # clamp floor of the EV multipliers
    # Run the MAX-pool collapse and the pre-map statistics as one fused
    # kernel pass (K4, ``kernels/epilogue.py``) instead of the plain
    # reductions.
    use_fused_epilogue: bool = False
    # Return the plain (standard) decode next to the HDR image.
    keep_standard: bool = True

    def canonical_mode(self) -> str:
        mode = HDR_MODE_ALIASES.get(self.hdr_mode, self.hdr_mode)
        if mode not in HDR_MODES:
            raise ValueError(
                f"unknown hdr_mode {self.hdr_mode!r}; expected one of "
                f"{HDR_MODES} (or aliases {tuple(HDR_MODE_ALIASES)})")
        return mode


UPSTACK_EXECUTORS = ("auto", "xla", "pallas")


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numerics policy: the three tiers of the JAX package.

    - ``parity``: float32 everywhere, exact float32 contractions (TF32 off),
      two-pass GroupNorm variance.
    - ``mixed``: float32 activations, one-pass GroupNorm variance.  The mid
      attention runs the JAX package's 3-pass bf16x3 arithmetic (each
      float32 operand split into bf16 hi + lo, hi.hi + hi.lo + lo.hi summed
      in float32) in its own flash kernel.  The convs and matmuls, which
      the JAX package leaves to XLA at HIGH, run in exact float32 with TF32
      off, which is at least as accurate.
    - ``fast``: bf16 operands and storage with float32 accumulation; the
      mid and up stack run through the fused CUDA kernel chain.

    ``fast_head_levels`` (mixed only; 0 = off): conv_in, the mid and the up
    levels at or above it run in the fast tier's bf16 on the layers, the
    levels below it, norm_out and conv_out in mixed
    (:meth:`head_precision`, :meth:`for_level`).

    ``upstack`` picks the decoder's (and ESRGAN's) executor, with the JAX
    package's names: "auto" runs the fused CUDA chain in the fast tier and
    the layers otherwise; "xla" always runs the layers; "pallas" always
    runs the fused chain and refuses any other tier.

    ``swin_attn`` picks the executor of the SwinIR / HAT blocks the same
    way: "auto" runs the fused block (K7, and K8 for HAT's OCAB) for CUDA
    tensors in the fast tier and the unfused layers otherwise; "xla" always
    runs the unfused layers; "pallas" always runs the fused block, which on
    a CPU tensor is the kernels' plain versions.
    """

    compute_dtype: torch.dtype = torch.float32
    storage_dtype: torch.dtype = torch.float32
    mode: str = "parity"
    fast_head_levels: int = 0
    upstack: str = "auto"
    swin_attn: str = "auto"

    def __post_init__(self):
        if self.upstack not in UPSTACK_EXECUTORS:
            raise ValueError(f"unknown upstack {self.upstack!r}; expected "
                             f"one of {UPSTACK_EXECUTORS}")

    @classmethod
    def fast(cls) -> "Precision":
        return cls(compute_dtype=torch.bfloat16,
                   storage_dtype=torch.bfloat16, mode="fast")

    @classmethod
    def parity(cls) -> "Precision":
        return cls(mode="parity")

    @classmethod
    def mixed(cls, fast_head_levels: int = 0) -> "Precision":
        return cls(mode="mixed", fast_head_levels=fast_head_levels)

    def head_precision(self) -> "Precision":
        """The precision of conv_in, the mid and the up levels at or above
        ``fast_head_levels``: the fast tier's bf16 compute and storage in a
        mixed tier with ``fast_head_levels > 0``, else this one."""
        if self.mode != "mixed" or self.fast_head_levels <= 0:
            return self
        return dataclasses.replace(
            self, compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16,
            mode="fast", fast_head_levels=0)

    def for_level(self, level: int) -> "Precision":
        """The precision of up level ``level``: :meth:`head_precision` at or
        above ``fast_head_levels`` (when it is set), else this one."""
        if (self.mode == "mixed" and self.fast_head_levels > 0
                and level >= self.fast_head_levels):
            return self.head_precision()
        return self


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Overlap-tile plan of the upscaler.  ``tile`` and ``overlap`` are in
    input pixels (ComfyUI ``tiled_scale`` semantics); the blend feather is
    ``overlap * scale`` output pixels."""

    tile: int = 512
    overlap: int = 64
    min_tile: int = 128            # floor of the budgeted tile size
    # Device-memory budget (bytes) from which a tile size is picked; None
    # keeps ``tile`` as it is.
    hbm_budget_bytes: Optional[int] = None
    # "comfy" (ComfyUI tiled_scale's grid and blend), "feather" (uniform
    # grid) or "crop" (halo crop).
    seam_mode: str = "comfy"


UPSCALE_METHODS = ("nearest-exact", "bilinear", "area", "bicubic", "bislerp")


@dataclasses.dataclass(frozen=True)
class UpscaleConfig:
    """The HDR upscale node's inputs (``HDRUpscaleWithModel``)."""

    small_blur: bool = False
    local_fix: bool = False
    upscale_method: str = "bislerp"
    # Clamp range of the colour-stable second pass.
    color_stable_min: float = -1.0
    color_stable_max: float = 1.0
    luma_max: float = 8.0              # ceiling of the stabilized luma
    local_fix_threshold: float = 0.1   # dark-area threshold of local_fix
    tiling: TilingConfig = dataclasses.field(default_factory=TilingConfig)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Layout of a sharded decode, read by ``sharding.mesh.Mesh``.  The JAX
    package's mesh is a 1-D device axis; the port's is a
    ``torch.distributed`` process group, one device a rank.
    ``num_devices`` is the group's size, checked against it (None: every
    rank of the default group).  JAX's ``axis_name`` has no counterpart: a
    process group has no named axes."""

    num_devices: Optional[int] = None


# Blocks of fp32_contractions open in any thread, and the TF32 flags they
# found when the first of them opened.  The flags are process-wide, so a
# block that restored them on its own exit could turn TF32 back on under
# another thread's block that is still open.
_FP32_LOCK = threading.Lock()
_fp32_open = 0
_fp32_saved = None


@contextlib.contextmanager
def fp32_contractions(precision: Precision) -> Iterator[None]:
    """Run float32 convs and matmuls exactly in the parity and mixed tiers.

    cuDNN's ``allow_tf32`` defaults to True, which would quietly run every
    float32 conv with a 10-bit mantissa and take both tiers out of their
    error budget.  Sets ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False while any such block
    is open in any thread, and restores what the first one found when the
    last one closes.  A bf16 compute dtype (the fast tier) is left as it
    is: bf16 operands are exact in TF32.
    """
    global _fp32_open, _fp32_saved
    if precision.compute_dtype == torch.bfloat16:
        yield
        return
    with _FP32_LOCK:
        if _fp32_open == 0:
            _fp32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _fp32_open += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_open -= 1
            if _fp32_open == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _fp32_saved


EXR_COMPRESSIONS = ("none", "rle", "zip", "piz", "pxr24")
EXPORT_FORMATS = ("exr", "hdr")
BIT_DEPTHS = ("16bit", "32bit")


@dataclasses.dataclass(frozen=True)
class ExportConfig:
    """The export node's inputs, with the JAX package's fields and
    defaults.  ``compression`` is validated against
    :data:`EXR_COMPRESSIONS`; "piz" needs the native EXR codec
    (``io/export.py`` reports an ERROR without it)."""

    filename_prefix: str = "comfyUI"
    versioning: bool = False
    frame_sequence: bool = False
    start_frame: int = 1001
    frame_pad: int = 4
    output_path: str = "/HDR"
    format: str = "exr"
    bit_depth: str = "16bit"
    compression: str = "zip"
    save_workflow: bool = False
