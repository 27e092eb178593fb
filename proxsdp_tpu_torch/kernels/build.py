"""Build the port's CUDA kernels with nvcc into one shared library.

The sources under ``csrc/`` have a plain C interface and are loaded with
ctypes (no PyTorch headers, so a build takes seconds).  The library is
built at first use into ``build/proxsdp_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags so a stale library is
never loaded, and written under a temporary name then moved into place
with ``os.replace`` so concurrent builders never see a half-written file.
Each source compiles in its own nvcc process, all started together, and
one more links the objects.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "proxsdp_tpu_torch"

# -fmad=false: no fused multiply-add contraction, so each kernel rounds
# every product and sum exactly where its plain PyTorch version does
# (the kernels are bandwidth-bound; FMA buys them nothing).
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)
LINK_FLAGS = (*ARCH, "-shared")


class KernelError(RuntimeError):
    """A kernel that cannot be built, loaded or launched on the card."""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libproxsdp_kernels_{h.hexdigest()[:16]}.so"


class BuildInfo:
    """What the last ``load`` did: library path, build seconds (0.0 when
    the library was already there) and the compiler's output."""

    path: Path | None = None
    seconds: float = 0.0
    log: str = ""


def load() -> ctypes.CDLL:
    """Build the library if it is missing, then load it."""
    path = library_path()
    BuildInfo.path = path
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            srcs = sorted(CSRC.glob("*.cu"))
            objs = [Path(tmpdir) / f"{src.stem}.o" for src in srcs]
            procs = [
                subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                  str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(srcs, objs)
            ]
            logs, failed = [], []
            for src, proc in zip(srcs, procs):
                out, _ = proc.communicate()
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
            tmp = Path(tmpdir) / path.name
            if not failed:
                link = subprocess.run(
                    [_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                if link.returncode != 0:
                    failed.append("link")
            BuildInfo.seconds = time.perf_counter() - t0
            BuildInfo.log = "\n".join(logs)
            if failed:
                raise KernelError(
                    f"nvcc failed ({', '.join(failed)}):\n{BuildInfo.log}")
            os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
