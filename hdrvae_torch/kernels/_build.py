"""Build and load the port's CUDA kernels.

Every ``hdrvae_torch/csrc/*.cu`` is compiled by ``nvcc`` into one shared
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    # conv3x3.cu
    "hdrvae_fused_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P],
    "hdrvae_upsample_conv3x3": [_P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _P],
    "hdrvae_group_stats": [_P, _P, _I, _I, _I, _I, _P],
    # attention.cu
    "hdrvae_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "hdrvae_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
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


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for the current sources is
    missing; returns (library path, compiler log; empty when reused)."""
    lib = BUILD_DIR / f"libhdrvae_kernels_{source_hash()}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


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
