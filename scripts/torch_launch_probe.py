"""The launch-and-sharding slice's card work alone, on one card.

    python scripts/torch_launch_probe.py [--out build/launch_probe.json]

Builds the kernels, then runs `chip_smoke.py`'s parts that go through
`repro_torch.launch`: phase 4's quickstart (`examples/torch_quickstart.py`),
phase 7 (c) (gemma2-2b through the prefill and decode builders, bit-equal
to the direct calls), phase 9 (c) for internlm2-1.8b (the step built by
`steps.make_train_setup` on the (1, 1) mesh) and (e) (2 micro-batches
against 1), and phase 10 (the dry-run, CPU arithmetic).  Each raises as
in `chip_smoke.py`; the seconds of each part are printed and written to
``--out`` with its record.  Some 2 minutes with the build.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "launch_probe.json"))
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(cs.nvidia_smi_line(), flush=True)

    out, seconds = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out[name] = fn(*a)
        seconds[name] = time.perf_counter() - t0

    timed("build", cs._build.build_all)
    timed("quickstart", cs.phase_quickstart)
    params = cs.tfm.init_params(cs.get_config(cs.BUILDER_ARCH), seed=0)
    timed("serve_builders", cs.serve_through_builders, cs.BUILDER_ARCH, params)
    del params
    torch.cuda.empty_cache()
    with cs.local_mesh() as mesh:
        timed("full_width", cs.train_full_width, cs.TRAIN_ARCH, mesh)
        timed("accumulation", cs.train_accumulation, mesh)
    timed("dryrun", cs.phase_dryrun)
    out["full_width"] = {k: out["full_width"][k]
                         for k in ("steps", "launches", "peak_memory_bytes")}
    out["seconds"] = seconds
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps(seconds), flush=True)
    return out


if __name__ == "__main__":
    main()
