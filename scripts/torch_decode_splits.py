"""How flash-decode's split count moves its time at the served decode shapes.

The wrapper splits each (batch row, KV head) of the cache over
``mma_splits(b, kv, L, target_ctas)`` CTAs (one cluster; ``splits`` for
the float32 ``simt`` kernel), with ``target_ctas`` from `_target_ctas`:
one CTA per SM for ``mma``.  This script times the bf16 call (the ``mma``
kernel, which merges its splits in the same launch) at the four served
steps of ``chip_smoke.py`` (gemma2-2b, recurrentgemma-9b, internlm2-1.8b's
shapes and qwen3-moe-30b-a3b) for several targets, each set by replacing
`_target_ctas` for the sweep, with a cold L2 as ``chip_smoke.py`` times
its kernels, beside the bytes bound.  Each row
names the splits, the slots a split and the slot tiles a CTA walks.
Inputs are random, from a seed.  Needs one card.  Run from the
repository root:

    PYTHONPATH=src python scripts/torch_decode_splits.py [--json FILE]

It prints one JSON object on its last line; ``--json`` also writes it to
a file.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch.kernels import decode_attention as decode

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (label, B, KV, R, D, L, cur, window, softcap): the served steps.
SHAPES = [
    ("gemma2-2b", 4, 4, 2, 256, 2064, 2055, 4096, 50.0),
    ("recurrentgemma-9b", 4, 1, 16, 256, 1040, 1031, 2048, None),
    ("internlm2-1.8b", 4, 8, 2, 128, 528, 527, None, None),
    ("qwen3-moe-30b-a3b", 4, 4, 8, 128, 1040, 1031, None, None),
]
#: CTAs the split choice aims at, per SM of the card.
CTAS_PER_SM = (0.25, 0.5, 1, 2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(cs, sms: int) -> list[dict]:
    """One row per (served step, target); replaces `_target_ctas`."""
    rows = []
    for i, (label, b, kv, r, d, cache_len, cur, window, cap) in enumerate(SHAPES):
        rng = np.random.RandomState(1000 + i)
        q = cs._normal(rng, (b, kv, r, d), torch.bfloat16)
        k = cs._normal(rng, (b, cache_len, kv, d), torch.bfloat16)
        v = cs._normal(rng, (b, cache_len, kv, d), torch.bfloat16)
        pos = torch.arange(cache_len, dtype=torch.int32, device="cuda")
        pos = torch.where(pos <= cur, pos, -1).to(torch.int32)
        want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                             logit_softcap=cap)
        bound = cs.decode_bound(q, k, pos, cur, window)
        tile = 32 * max(1, 256 // d)  # the mma split pass's slot tile at R <= 16
        max_splits = decode._max_mma_splits(d, r)
        call = (q, k, v, pos, cur, window, cap)
        for per_sm in CTAS_PER_SM:
            target = int(per_sm * sms)
            decode._target_ctas = lambda device_index, variant, target=target: target
            n_split, chunk = decode.mma_splits(b, kv, cache_len, target, max_splits)
            got = decode._dispatch(*call)
            err = float((got.float() - want.float()).abs().max())
            ms = cs.time_cold_ms(lambda: decode._dispatch(*call), reps=50)
            rows.append({"shape": label, "ctas_per_sm": per_sm, "ctas": b * kv * n_split,
                         "n_split": n_split, "slots_per_split": chunk,
                         "tiles_per_cta": -(-chunk // tile), "ms": ms,
                         "bound_ms": bound["bound_ms"], "max_abs_err": err})
            print(f"{label}: {per_sm} CTAs/SM -> {b * kv * n_split} CTAs, {chunk} slots a "
                  f"split: {ms:.4f} ms, bound {bound['bound_ms']:.4f}, max abs err {err:.3g}",
                  flush=True)
    return rows



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_splits: torch sees no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    target_ctas = decode._target_ctas
    try:
        rows = _sweep(cs, sms)
    finally:
        decode._target_ctas = target_ctas
    smi = cs.nvidia_smi_line()
    line = json.dumps({"nvidia_smi": smi, "sms": sms, "rows": rows})
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(line)
    print(line)
    return 0

if __name__ == "__main__":
    sys.exit(main())
