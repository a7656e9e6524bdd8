"""What the flash forward's optional logsumexp output costs, against a parent.

A one-off comparison: it applies only to a parent checkout from before the
``lse`` output was added, whose ``flash_attention_bf16`` has exactly the
signature `_parent_fn` declares (no ``lse`` argument); against any other
parent the call is undefined.  Its reading is kept in ``PERF.md``.

The forward kernel (``csrc/flash_attention.cu``) takes an ``lse`` pointer:
training passes one and the kernel writes each row's logsumexp; serving
passes null.  This script builds the same source of another checkout (the
parent, whose C functions take no ``lse``) with the port's nvcc flags and
times, at the served prefill shapes of ``chip_smoke.py`` phase 8 and at
internlm2-1.8b's training shape, in bf16 (``wgmma``): the parent's kernel,
this checkout's with a null ``lse``, the same again, the parent again, and
this checkout's writing ``lse`` — each cold, as ``chip_smoke.py`` times
kernels (`time_cold_ms`).  The outputs must equal the parent's bit for bit.
Needs one card and nvcc.  Run from the repository root, the parent's
``src/repro_torch/kernels/csrc`` unpacked somewhere (``git archive``):

    PYTHONPATH=src python scripts/torch_flash_lse_cost.py --parent-csrc DIR [--json FILE]

It prints one JSON object on its last line; ``--json`` also writes it to
a file.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import attention as flash

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (label, B, S, H, KV, D, window, softcap)
SHAPES = [
    ("gemma2-2b prefill", 4, 2048, 8, 4, 256, None, 50.0),
    ("recurrentgemma-9b prefill", 4, 1024, 16, 1, 256, 2048, None),
    ("qwen3-moe-30b-a3b prefill", 4, 1024, 32, 4, 128, None, None),
    ("internlm2-1.8b training", 2, 4096, 16, 8, 128, None, None),
]
REPS = 20


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parent_fn(csrc: pathlib.Path):
    """The parent's ``flash_attention_bf16`` (q, k, v, o, B, S, H, KV, D,
    scale, softcap, window, stream), built into ``build/``."""
    out = ROOT / "build" / "flash_lse_cost" / "libflash_attention_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.SOURCES["flash_attention"][0], "-o", str(out),
           str(csrc / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's source:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _parent_call(fn, q, k, v, window, cap):
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2], d,
            d ** -0.5, 0.0 if cap is None else cap, 0 if window is None else window,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent kernel launch failed: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", required=True,
                    help="the parent checkout's src/repro_torch/kernels/csrc")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_lse_cost: torch sees no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    parent = _parent_fn(pathlib.Path(args.parent_csrc))
    rows = []
    for i, (label, b, s, h, kv, d, window, cap) in enumerate(SHAPES):
        rng = np.random.RandomState(2000 + i)
        q, k, v = (cs._normal(rng, (b, s, n, d), torch.bfloat16) for n in (h, kv, kv))
        want = _parent_call(parent, q, k, v, window, cap)
        null = flash._dispatch(q, k, v, window, cap)
        with_lse, _ = flash._dispatch(q, k, v, window, cap, with_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(null, want) and torch.equal(with_lse, want)):
            raise AssertionError(f"{label}: output differs from the parent's")
        runs = {"parent": [], "null": [], "lse": []}
        for name in ("parent", "null", "null", "parent", "lse"):
            call = {"parent": lambda: _parent_call(parent, q, k, v, window, cap),
                    "null": lambda: flash._dispatch(q, k, v, window, cap),
                    "lse": lambda: flash._dispatch(q, k, v, window, cap, with_lse=True)}[name]
            runs[name].append(cs.time_cold_ms(call, reps=REPS))
        row = {"shape": label, "B": b, "S": s, "H": h, "KV": kv, "D": d, "window": window,
               "softcap": cap, "runs_ms": runs,
               **{f"{n}_ms": float(np.mean(t)) for n, t in runs.items()}}
        row["null_vs_parent"] = row["null_ms"] / row["parent_ms"] - 1.0
        row["lse_vs_null"] = row["lse_ms"] / row["null_ms"] - 1.0
        rows.append(row)
        print(f"{label}: parent {runs['parent']} ms, null lse {runs['null']} ms, "
              f"with lse {runs['lse']} ms: null {row['null_vs_parent']:+.2%} vs parent, "
              f"lse {row['lse_vs_null']:+.2%} vs null", flush=True)
    line = json.dumps({"nvidia_smi": cs.nvidia_smi_line(), "reps": REPS, "rows": rows})
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
