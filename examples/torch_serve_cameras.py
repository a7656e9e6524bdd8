"""End to end: a manager-planned fleet actually SERVING requests.

The PyTorch port of `examples/serve_cameras.py`, the full loop of the
paper, data plane included:

  1. A fleet of "camera" streams wants analysis by transformer models
     (the 2026 analysis programs) at given request rates.
  2. The ResourceManager profiles, formulates MC-VBP, and solves for the
     cheapest instance fleet (TPU-cloud catalog).
  3. Each planned instance boots a ServingEngine (smoke-scale weights)
     and serves its assigned streams' batched requests, on the card
     unless ``--device cpu`` is given; we report generated tokens, hourly
     cost, and simulated utilization.

Run:  PYTHONPATH=src python examples/torch_serve_cameras.py [--requests 3] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.catalog import tpu_cloud_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import ProfileTable, ResourceProfile, TPU_V5E
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.streams import AnalysisProgram, FrameSize, StreamSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.roofline.analysis import model_flops
from repro_torch.serving import Request, ServingEngine

ARCHS = ("internlm2-1.8b", "gemma2-2b")


def build_profiles() -> ProfileTable:
    table = ProfileTable()
    for arch in ARCHS:
        cfg = get_config(arch)
        flops_tok = model_flops(cfg, 1) * 1.15
        mem_gb = cfg.param_count() * 2 / 1e9 + 2.0
        cores_per_tok = flops_tok / 75e9
        table.add(ResourceProfile(arch, "0x0", "cpu", 1.0,
                                  (cores_per_tok, mem_gb, 0, 0),
                                  max_fps=16.0 / cores_per_tok))
        occ = TPU_V5E.occupancy_per_frame(flops_tok, cfg.param_count() * 2)
        table.add(ResourceProfile(arch, "0x0", "accel", 1.0,
                                  (cores_per_tok * 0.05, mem_gb * 0.25,
                                   occ * 197.0, mem_gb),
                                  max_fps=1.0 / occ))
    return table


def camera_streams() -> list:
    return [
        StreamSpec("traffic-cam", AnalysisProgram("a", "internlm2-1.8b"), 25.0,
                   FrameSize(0, 0)),
        StreamSpec("mall-cam", AnalysisProgram("b", "internlm2-1.8b"), 10.0,
                   FrameSize(0, 0)),
        StreamSpec("river-cam", AnalysisProgram("c", "gemma2-2b"), 6.0,
                   FrameSize(0, 0)),
    ]


def main(argv=None) -> dict:
    """Returns ``{"plan": AllocationPlan, "served": {(instance, arch):
    (requests, tokens)}}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    streams = camera_streams()
    table = build_profiles()
    manager = ResourceManager(tpu_cloud_catalog(), table, device=dev)
    plan = manager.allocate(streams)
    print("=== allocation plan (exact MC-VBP solve)")
    print(plan.summary())
    sim = simulate_plan(plan, table, target=manager.utilization_cap)
    print(f"simulated fleet performance: {sim['overall_performance']:.0%}\n")

    # Boot one engine per planned instance and serve its streams' requests.
    rid = 0
    served = {}
    for inst_i, inst_type in enumerate(plan.instances):
        members = [p for p in plan.placements if p.instance_index == inst_i]
        archs = {p.stream.program.program_id for p in members}
        print(f"--- instance [{inst_i}] {inst_type} hosts "
              f"{[p.stream.name for p in members]}")
        for arch in sorted(archs):
            cfg = smoke_variant(get_config(arch))  # smoke weights
            params = tfm.init_params(cfg, seed=0, device=dev)
            engine = ServingEngine(cfg, params, batch_slots=2, max_seq=64, device=dev)
            n_streams = sum(
                1 for p in members if p.stream.program.program_id == arch)
            for _ in range(args.requests * n_streams):
                prompt = np.arange(6 + rid % 4) % cfg.vocab_size
                engine.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=args.new_tokens))
                rid += 1
            results = engine.run()
            toks = sum(len(r.tokens) for r in results)
            served[(inst_i, arch)] = (len(results), toks)
            print(f"    {arch}: served {len(results)} requests, "
                  f"{toks} tokens generated")
    print(f"\nhourly cost: ${plan.hourly_cost:.2f} "
          f"(optimal={plan.optimal})")
    return {"plan": plan, "served": served}


if __name__ == "__main__":
    main()
