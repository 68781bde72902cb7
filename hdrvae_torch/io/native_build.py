"""Build and load the native C++ EXR codec, as ``hdrvae/io/native_build.py``.

``hdrvae_torch/csrc/exr_codec.cpp`` is compiled by ``g++`` with zlib at the
first use (never at import) into ``hdrvae_torch/build/``, under a name that
carries a hash of the source and flags, and loaded with ``ctypes``.  When
no compiler or zlib is found, :func:`load_native` returns None: the callers
then write with the numpy codec (the same bytes), except PIZ, which only the
native codec writes (``io/exr.py`` refuses it).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "exr_codec.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
_FP = ctypes.POINTER(ctypes.c_float)
_HP = ctypes.POINTER(ctypes.c_uint16)
_IP = ctypes.POINTER(ctypes.c_int)

# entry point -> (argtypes, restype), as hdrvae/io/native_build.py binds them
SIGNATURES = {
    "exr_write": ([_S, _FP, _I, _I, _I, _I, _I, _I], _I),
    "exr_write_half": ([_S, _HP, _I, _I, _I, _I, _I, _I], _I),
    "exr_read_header": ([_S, _IP, _IP, _IP], _I),
    "exr_read": ([_S, _FP], _I),
    # the streaming (banded) writer
    "exr_lines_per_chunk": ([_I], _I),
    "exr_begin": ([_S, _I, _I, _I, _I, _I, _I, _I], _P),
    "exr_write_rows": ([_P, _FP, _I], _I),
    "exr_write_rows_half": ([_P, _HP, _I], _I),
    "exr_end": ([_P], _I),
    "exr_abort": ([_P], None),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libexr_codec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless the library of the current source exists;
    returns its path.  Raises ``RuntimeError`` (or ``OSError`` without
    ``g++``) when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp,
                               "-lz"], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)   # atomic: concurrent builders agree
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded codec, built on first use; None (with one warning) when
    it cannot be built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native EXR codec unavailable (%s): the numpy "
                           "codec writes none/rle/zips/zip/pxr24, and piz "
                           "is refused", e)
            _build_failed = True
            return None
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib
