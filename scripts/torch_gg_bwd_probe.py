"""What the store costs the grouped GEMM backward's bf16 ``dw`` kernel.

Builds a copy of ``src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu`` with
nvcc into ``build/gg_bwd_probe/`` in which the ``wgmma`` ``dw`` kernel
stages each tile in shared memory but never stores it (one text edit; the
script stops if the line it edits is no longer there), and times its
``dw`` (`grouped_gemm_dw_bf16`) beside the repo's build (through
`grouped_gemm._dispatch_bwd`) on the segments of ``chip_smoke.py`` phase 9
(a)'s routing (qwen3-moe-30b-a3b's 4,096 training tokens, 32,768 pairs,
capacity 20) at the gate/up (K 2048, F 768) and down (K 768, F 2048)
shapes, as that phase times it (`time_cold_ms`: L2 flushed, each call
queued while the card spins), beside the bound.  Needs one card.  Run
from the repository root:

    PYTHONPATH=src python scripts/torch_gg_bwd_probe.py [--json FILE]

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object on its last line; ``--json`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import grouped_gemm as gg

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "gg_bwd_probe"
#: The TMA store of the ``dw`` tile, and what the copy has in its place.
STORE = ("        if (f0 + 64 * b < F) tma_store_3d(&dwmap, out + b * kBox, f0 + 64 * b, "
         "k0 + 64 * g, e);")
NO_STORE = "        ;"
SHAPES = (("gate/up", 2048, 768), ("down", 768, 2048))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_no_store() -> ctypes.CDLL:
    """The copy of the source with `STORE` edited out, built."""
    src = (_build.CSRC / "grouped_gemm_bwd.cu").read_text()
    if src.count(STORE) != 1:
        raise SystemExit(f"the source no longer has the store this probe edits:\n{STORE}")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "grouped_gemm_bwd_no_store.cu"
    path.write_text(src.replace(STORE, NO_STORE))
    cmd = [_build._nvcc(), *_build.SOURCES["grouped_gemm_bwd"][0], "-I", str(_build.CSRC),
           "-o", str(path.with_suffix(".so")), str(path)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the probe:\n{proc.stdout[-4000:]}")
    lib = ctypes.CDLL(str(path.with_suffix(".so")))
    lib.grouped_gemm_dw_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.grouped_gemm_dw_bf16.restype = ctypes.c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the result to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(("grouped_gemm_bwd",))
    lib = build_no_store()
    offsets, pairs, kept = cs.gg_training_routing()
    counts = np.diff(offsets.cpu().numpy())
    mean_rows = float(counts[counts > 0].mean())
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"card": card, "pairs": pairs, "kept": kept, "shapes": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for label, k, f in SHAPES:
        e_n = len(counts)
        x = torch.randn((pairs, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((e_n, k, f), generator=gen, device="cuda") / np.sqrt(k)).bfloat16()
        dy = (torch.randn((pairs, f), generator=gen, device="cuda") / np.sqrt(mean_rows)).bfloat16()
        dw = torch.empty_like(w)

        def no_store():
            rc = lib.grouped_gemm_dw_bf16(x.data_ptr(), dy.data_ptr(), offsets.data_ptr(),
                                          dw.data_ptr(), pairs, k, f, e_n, 1, stream)
            if rc != 0:
                raise SystemExit(f"the probe's launch failed, CUDA error {rc}")

        row = {**cs.gg_bwd_bound("dw", x, w, offsets),
               "repo_ms": cs.time_cold_ms(lambda: gg._dispatch_bwd(x, w, offsets, dy,
                                                                   need_dx=False), reps=20),
               "no_store_ms": cs.time_cold_ms(no_store, reps=20)}
        out["shapes"][label] = row
        print(f"dw {label} (K {k}, F {f}): repo {row['repo_ms']:.4f} ms, no store "
              f"{row['no_store_ms']:.4f}; bound {row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
        del x, w, dy, dw
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
