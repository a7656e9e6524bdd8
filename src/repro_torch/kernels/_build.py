"""Build-on-first-use for the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  It is compiled
by ``nvcc`` into a shared library under ``build/repro_torch_kernels/`` at
the root of the checkout and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The library name carries a hash of the source and
flags, so an edited source is rebuilt and an unchanged one is reused.  A
failed build raises with nvcc's output.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["BUILD_INFO", "load_library"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Per source name: {"seconds": build wall time (0.0 when reused),
#: "log": nvcc's output including the -Xptxas -v report, "path": library}.
BUILD_INFO: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(out)}
        _LIBS[name] = lib
        return lib
