"""Build and load the port's CUDA kernels.

Every ``hdrvae_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process,
all of them started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
the first kernel launch (never at import: the CPU tests import every
module), goes into ``hdrvae_torch/build/`` and is reused while a hash of
the sources and flags is unchanged.  Nothing but ``nvcc`` is needed: no
PyTorch headers, so a build takes seconds.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error,
because a refused launch never runs and no later synchronize reports it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    # conv3x3.cu
    "hdrvae_fused_conv3x3": [_P] * 9 + [_I] * 9 + [_P],
    "hdrvae_upsample_conv3x3": [_P] * 5 + [_I] * 8 + [_P],
    "hdrvae_group_stats": [_P, _P, _I, _I, _I, _I, _P],
    # upconv.cu
    "hdrvae_upconv_gn_conv3x3": [_P] * 9 + [_I] * 6 + [_P],
    # attention.cu
    "hdrvae_flash_attention_bf16": [_P] * 5 + [_I, _I, _I, _F, _P],
    "hdrvae_flash_attention_f32": [_P] * 5 + [_I, _I, _I, _F, _P],
    "hdrvae_flash_attention_3pass": [_P] * 3 + [_I, _I, _I, _P],
    "hdrvae_split_qkv": [_P] * 4 + [_L, _F, _P],
    # dense_conv.cu
    "hdrvae_dense_conv3x3": [_P] * 5 + [_I] * 5 + [_I, _P, _P, _P, _P,
                                                   _I, _I, _I, _I, _I, _I,
                                                   _I, _F, _I, _P],
    # epilogue.cu
    "hdrvae_collapse_and_stats": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                  _I, _P],
    # swin_block.cu
    "hdrvae_swin_block": [_P] * 18 + [_I] * 9 + [_P],
    # ocab.cu
    "hdrvae_ocab_attention": [_P] * 5 + [_I] * 4 + [_P],
    # swin_chain.cu
    "hdrvae_swin_ln_qkv": [_P] * 6 + [_I] * 6 + [_P],
    "hdrvae_swin_attn_core": [_P] * 3 + [_I] * 6 + [_P],
    "hdrvae_swin_proj_mlp": [_P] * 12 + [_I] * 7 + [_P],
    # f32_dot.cu
    "hdrvae_f32_dot": [_P] * 3 + [_I] * 4 + [_P],
    "hdrvae_f32_dot_split_w": [_P, _P, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin",
                                                    "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _run(procs) -> str:
    """Wait for every (name, Popen), then raise on the first failure."""
    done = [(name, *proc.communicate(), proc) for name, proc in procs]
    for name, out, err, proc in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):"
                               f"\n{out}\n{err}")
    return "".join(out + err for _, out, err, _ in done)


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for the current sources is
    missing; returns (library path, compiler log; empty when reused).
    One ``nvcc -c`` per source runs in parallel, then one link."""
    lib = BUILD_DIR / f"libhdrvae_kernels_{source_hash()}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log = _run(procs)
        tmp = os.path.join(tmpdir, "lib.so")
        log += _run([("link", subprocess.Popen(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp, *objs], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, lib)   # atomic: concurrent builders agree
    return lib, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


# Open scopes of ``utils.profiling.debug_nans``.  While one is open, every
# wrapper checks what its kernel wrote: a launch through ctypes is no
# PyTorch op, so the scope's dispatch hook never sees its outputs.
NAN_SCOPES = 0


def nan_check(name: str, *outputs) -> None:
    """Raise ``FloatingPointError`` if a debug_nans scope is open and an
    output of kernel ``name`` holds a NaN (synchronizes; nothing when no
    scope is open)."""
    if not NAN_SCOPES:
        return
    for t in outputs:
        if t is not None and t.is_floating_point() and \
                bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{name}: the kernel wrote a NaN")
