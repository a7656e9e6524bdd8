"""Build-on-first-use for the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  It is compiled
by ``nvcc`` into a shared library under ``build/repro_torch_kernels/`` at
the root of the checkout and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The library name carries a hash of the source, the
headers it includes and its flags, so an edited source is rebuilt and an
unchanged one is reused.  A failed build raises `KernelError` with
nvcc's output.
`build_all` starts one nvcc process per source, all at once.

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

from ..device import KernelError

__all__ = ["BUILD_INFO", "SOURCES", "build_all", "load_library"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: The attention (both directions), SSD, RG-LRU and grouped GEMM kernels
#: need no bit-identity with their plain versions, so they let the compiler
#: fuse multiply-adds.
FMAD_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")

#: Per source name: its nvcc flags and the headers under ``csrc/`` it includes.
SOURCES: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    "knapsack": (NVCC_FLAGS, ()),
    "flash_attention": (FMAD_FLAGS, ("attention_common.cuh", "hopper_common.cuh")),
    "flash_attention_bwd": (FMAD_FLAGS, ("attention_common.cuh",)),
    "decode_attention": (FMAD_FLAGS, ("attention_common.cuh", "mma_common.cuh")),
    "ssd": (FMAD_FLAGS, ("attention_common.cuh", "mma_common.cuh")),
    "rglru": (FMAD_FLAGS, ("hopper_common.cuh",)),
    "grouped_gemm": (FMAD_FLAGS, ("hopper_common.cuh",)),
    "pack": (NVCC_FLAGS, ()),
    "placement": (NVCC_FLAGS, ()),
}

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
    raise KernelError("nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _library_path(name: str) -> pathlib.Path:
    flags, headers = SOURCES[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in headers)
        + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it; cached per process."""
    return build_all((name,))[name]


def build_all(names=tuple(SOURCES)) -> dict[str, ctypes.CDLL]:
    """Build and load several sources, one nvcc process each, all started
    at once; waits for every process before it raises on a failed one."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        paths = {n: _library_path(n) for n in todo}
        missing = [n for n in todo if not paths[n].exists()]
        nvcc = _nvcc() if missing else None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = {}
        for name in missing:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *SOURCES[name][0], "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            started[name] = (cmd, tmp, time.perf_counter(), proc)
        built = {}
        for name, (cmd, tmp, t0, proc) in started.items():
            log = proc.communicate()[0]
            built[name] = (time.perf_counter() - t0, log)
        for name, (cmd, tmp, t0, proc) in started.items():
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                                   f"{' '.join(cmd)}\n{built[name][1]}")
            os.replace(tmp, paths[name])
        for name in todo:
            try:
                _LIBS[name] = ctypes.CDLL(str(paths[name]))
            except OSError as e:  # a library that does not load (no CUDA runtime, ...)
                raise KernelError(f"cannot load {paths[name]}: {e}") from e
            seconds, log = built.get(name, (0.0, ""))
            BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(paths[name])}
        return {n: _LIBS[n] for n in names}
