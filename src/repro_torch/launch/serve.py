"""Serving launcher: manager-planned fleet + serving engines.

Mirrors `repro/launch/serve.py`: plans the fleet with the MC-VBP solver
(TPU-cloud catalog), then boots one `ServingEngine` per planned instance
and serves synthetic batched requests — the end-to-end inference entry
point of this paper's system.

Two differences from the reference: ``--device`` picks where the manager
and the engines run (default: the card), and ``--smoke-weights`` is a
boolean flag that ``--no-smoke-weights`` turns off, serving the full
configuration (the reference's flag is ``store_true`` with default True, so
it cannot be turned off).

It serves every architecture: attention-only configs, mamba2-1.3b (the
SSD scan kernel in prefill), recurrentgemma-9b (the RG-LRU scan and both
attention kernels) and the MoE configs qwen3-moe-30b-a3b and grok-1-314b
(both attention kernels and the grouped GEMM).

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --streams 3 --rate 20 --requests 4 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import ARCH_IDS, get_config, smoke_variant
from ..core.catalog import tpu_cloud_catalog
from ..core.manager import ResourceManager
from ..core.profiler import TPU_V5E, ProfileTable, ResourceProfile
from ..core.simulator import simulate_plan
from ..core.streams import AnalysisProgram, FrameSize, StreamSpec
from ..device import resolve_device
from ..models import transformer as tfm
from ..roofline.analysis import model_flops
from ..serving import Request, ServingEngine


def build_profile(arch: str) -> ProfileTable:
    table = ProfileTable()
    cfg = get_config(arch)
    flops_tok = model_flops(cfg, 1) * 1.15
    mem_gb = cfg.param_count() * 2 / 1e9 + 2.0
    cores = flops_tok / 75e9
    table.add(ResourceProfile(arch, "0x0", "cpu", 1.0,
                              (cores, mem_gb, 0, 0), max_fps=16.0 / cores))
    occ = TPU_V5E.occupancy_per_frame(flops_tok, cfg.param_count() * 2)
    table.add(ResourceProfile(arch, "0x0", "accel", 1.0,
                              (cores * 0.05, mem_gb * 0.25, occ * 197.0,
                               mem_gb), max_fps=1.0 / occ))
    return table


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="desired tokens/s per stream")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--smoke-weights", action=argparse.BooleanOptionalAction,
                    default=True, help="serve the reduced smoke variant "
                    "(--no-smoke-weights: the full configuration)")
    ap.add_argument("--device", default=None,
                    help="torch device for the manager and the engines "
                    "(default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Plan, serve, print; returns ``{"plan", "results" (per instance),
    "tokens"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    table = build_profile(args.arch)
    mgr = ResourceManager(tpu_cloud_catalog(), table, device=device)
    streams = [
        StreamSpec(f"stream{i}", AnalysisProgram("p", args.arch), args.rate,
                   FrameSize(0, 0))
        for i in range(args.streams)
    ]
    plan = mgr.allocate(streams)
    print(plan.summary())
    sim = simulate_plan(plan, table, target=mgr.utilization_cap)
    print(f"simulated performance: {sim['overall_performance']:.0%}\n")

    cfg = get_config(args.arch)
    if args.smoke_weights:
        cfg = smoke_variant(cfg)
    params = tfm.init_params(cfg, seed=0, device=device)
    rid = 0
    results: dict[int, list] = {}
    for inst_i, inst_type in enumerate(plan.instances):
        engine = ServingEngine(cfg, params, batch_slots=4, max_seq=96, device=device)
        members = [p for p in plan.placements if p.instance_index == inst_i]
        for _ in range(args.requests * len(members)):
            engine.submit(Request(
                rid=rid, prompt=np.arange(6 + rid % 5) % cfg.vocab_size,
                max_new_tokens=args.new_tokens))
            rid += 1
        results[inst_i] = engine.run()
        toks = sum(len(r.tokens) for r in results[inst_i])
        print(f"[{inst_i}] {inst_type}: {len(results[inst_i])} requests, "
              f"{toks} tokens")
    print(f"\nhourly cost: ${plan.hourly_cost:.2f} (optimal={plan.optimal})")
    return {
        "plan": plan,
        "results": results,
        "tokens": sum(len(r.tokens) for rs in results.values() for r in rs),
    }


if __name__ == "__main__":
    main()
