"""How the RG-LRU kernel's ring shape and CTA width move its time.

Builds ``src/repro_torch/kernels/csrc/rglru.cu`` once for each ring shape
in `RINGS` (time steps a box, boxes in the ring: its ``kSteps`` and
``kStages`` replaced in a copy under ``build/rglru_ring/``), one nvcc a
shape, all at once, and times each build's two variants (``tma``,
``cp_async``) at 64 and 128 lanes a CTA (`rglru._variant` and
`rglru._lanes` replaced) at recurrentgemma-9b's served prefill (B 4, S
1024, W 4096, with h0; inputs from a seed), as ``chip_smoke.py`` times its
kernels (`time_cold_ms`: L2 flushed, events around each call queued while
the card spins), each checked against the plain version.  Needs one card.
Run from the repository root:

    PYTHONPATH=src python scripts/torch_rglru_ring.py [--json FILE]

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
object on its last line; ``--json`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels import _build, rglru

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "rglru_ring"
#: (time steps a box, boxes in the ring); (32, 4) is the source's own.
RINGS = ((32, 4), (16, 4), (16, 8), (32, 2), (32, 6), (64, 3))
SHAPE = (4, 1024, 4096)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all() -> dict[tuple[int, int], ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rglru.cu").read_text()
    for header in _build.SOURCES["rglru"][1]:
        shutil.copy(_build.CSRC / header, OUT / header)
    procs = {}
    for steps, stages in RINGS:
        text = src.replace("constexpr int kSteps = 32;", f"constexpr int kSteps = {steps};")
        text = text.replace("constexpr int kStages = 4;", f"constexpr int kStages = {stages};")
        name = f"s{steps}x{stages}"
        (OUT / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.SOURCES["rglru"][0], "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[(steps, stages)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    libs = {}
    for ring, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building ring {ring}:\n{log}")
        libs[ring] = ctypes.CDLL(str(OUT / f"libs{ring[0]}x{ring[1]}.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rglru_ring: torch sees no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    print(cs.nvidia_smi_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.sigmoid(torch.randn(SHAPE, device="cuda", generator=g))
    b = 0.3 * torch.randn(SHAPE, device="cuda", generator=g)
    h0 = 0.1 * torch.randn(SHAPE[0], SHAPE[2], device="cuda", generator=g)
    want = rglru.rglru_scan_plain(a, b, h0)
    libs = build_all()
    saved = rglru._kernel_fn, rglru._variant, rglru._lanes
    rows = []
    try:
        for (steps, stages), lib in libs.items():
            fn = lib.rglru_scan_f32
            fn.argtypes, fn.restype = rglru._ARGTYPES, ctypes.c_int
            rglru._kernel_fn = lambda variant, fn=fn: fn
            for variant in ("tma", "cp_async"):
                for lanes in (64, 128):
                    rglru._variant = lambda w, aligned=True, v=variant: v
                    rglru._lanes = lambda bsz, w, n_sms, n=lanes: n
                    err = float((rglru._dispatch(a, b, h0) - want).abs().max())
                    if err > 2e-5:
                        raise AssertionError(f"ring {steps}x{stages} {variant} {lanes}: {err}")
                    ms = cs.time_cold_ms(lambda: rglru._dispatch(a, b, h0), reps=30)
                    rows.append({"steps": steps, "stages": stages, "variant": variant,
                                 "lanes": lanes, "ms": ms, "max_abs_err": err})
                    print(f"ring {steps} steps x {stages} stages, {variant}, {lanes} lanes: "
                          f"{ms:.4f} ms", flush=True)
    finally:
        rglru._kernel_fn, rglru._variant, rglru._lanes = saved
    bound = cs.rglru_bound(a, h0)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
              "shape": list(SHAPE), "bound_ms": bound["bound_ms"], "rows": rows}
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
