"""ctypes bindings for the SDPA parser (``parse_sdpa.cpp`` beside this
file); a copy of ``proxsdp_tpu/utils/native.py`` with its own build.

The JAX package compiles its parser in place, inside its package, with
the output written directly under its final name, so a reader in a second
process can load a half-written library.  Here the library goes into the
checkout's ``build/proxsdp_tpu_torch/`` (gitignored), named by a hash of
the source and flags so a stale library is never loaded, and is written
under a temporary name in that directory and then moved into place with
``os.replace``, as ``kernels/build.py`` builds the CUDA kernels.  Every
failure raises; ``models/sdplib.py`` catches it and falls back to its
Python parser, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "parse_sdpa.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "proxsdp_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libparse_sdpa_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the parser to ``path``: g++ writes a temporary file in the
    same directory, which ``os.replace`` then moves into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp",
                               dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.sdpa_parse.restype = ctypes.c_void_p
        lib.sdpa_parse.argtypes = [ctypes.c_char_p]
        for name in ("sdpa_n", "sdpa_m", "sdpa_nnz"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("sdpa_c", "sdpa_entries"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_double)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.sdpa_free.restype = None
        lib.sdpa_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def parse_sdpa(path: str):
    """Parse a .dat-s file -> (n, m, entries(nnz, 4), c(m,)), the Python
    parser's convention (models/sdplib.py).  Raises on any failure."""
    lib = _load()
    h = lib.sdpa_parse(str(path).encode())
    if not h:
        raise IOError(f"native parse failed: {path}")
    try:
        n = int(lib.sdpa_n(h))
        m = int(lib.sdpa_m(h))
        nnz = int(lib.sdpa_nnz(h))
        c = np.ctypeslib.as_array(lib.sdpa_c(h), shape=(m,)).copy()
        entries = np.ctypeslib.as_array(
            lib.sdpa_entries(h), shape=(nnz, 4)
        ).copy()
    finally:
        lib.sdpa_free(h)
    return n, m, entries, c
