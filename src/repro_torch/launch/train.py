"""Training launcher: the train step of `launch/steps.py` over a mesh.

Mirrors `repro/launch/train.py` with the reference's flags (``--arch``,
``--smoke``, ``--steps``, ``--batch``, ``--seq-len``, ``--lr``,
``--production-mesh``, ``--multi-pod``, ``--ckpt``) plus ``--device``: it
runs on the card unless ``--device cpu`` is given.  The step is
`steps.make_train_setup`'s (activation checkpointing of each layer group
on, as the reference's production step trains) over the local mesh, the
reference's non-production branch: (world size, 1) over ``("data",
"model")``: (1, 1) in one process, where the launcher creates a
one-rank process group and destroys it at the end, and (N, 1) under an
initialized group of N ranks (one the caller made, or ``torchrun
--nproc-per-node N``, whose environment the launcher reads): each rank
then holds its shards of the state (`repro_torch.sharding.execute`),
on its own card (``LOCAL_RANK``'s) where the host has one a rank, else
all on the one card, and only rank 0 prints and writes the checkpoint.
``--production-mesh`` builds the (16, 16) mesh (``--multi-pod``: (2, 16,
16)) over the initialized process group and fails at once, naming both
numbers, when that group is not 256 (512) ranks.  Every config trains:
attention, SSD (mamba2-1.3b), recurrent (recurrentgemma-9b) and MoE
(qwen3-moe-30b-a3b, grok-1-314b, whose experts' gradients come from the
grouped GEMM's backward kernels).
The checkpoint is written in the reference's format
(`repro_torch.train.checkpoint`).

Example (CPU smoke; the last over four ranks):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --smoke --steps 10 --batch 4 --seq-len 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
      --smoke --steps 3 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch internlm2-1.8b --smoke --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, smoke_variant
from ..data import BatchSpec, make_batch
from ..device import resolve_device
from ..train.checkpoint import save
from ..train.optimizer import AdamWConfig
from ..sharding import execute
from ..train.train_loop import batch_to_device, init_state
from . import steps as steps_lib
from .mesh import destroy_process_group, make_local_mesh, make_production_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device_type = resolve_device(args.device).type  # raises first without a card
    owned = not dist.is_initialized()
    try:
        if args.production_mesh:
            mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=device_type)
        else:
            mesh = make_local_mesh(device_type)
        dev = resolve_device(args.device)  # this rank's card, once the group is known
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return _train(args, cfg, dev, mesh)
    finally:
        if owned:
            destroy_process_group()


def _train(args, cfg, dev, mesh) -> dict:
    sharded = mesh.size() > 1
    log = print if not sharded or dist.get_rank() == 0 else (lambda *a, **k: None)
    log(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={dev} "
        f"mesh={steps_lib.mesh_axes(mesh)}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn, _, (state_specs, batch_specs) = steps_lib.make_train_setup(
        cfg, mesh, multi_pod=args.multi_pod and args.production_mesh,
        batch=args.batch, seq_len=args.seq_len, opt_cfg=opt_cfg)
    state = init_state(0, cfg, device=dev)
    model = state["params"]
    if sharded:
        state = execute.place_train_state(cfg, model, state_specs, mesh)
        if not args.ckpt:
            del model
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = batch_to_device(
            make_batch(cfg, BatchSpec(args.batch, args.seq_len), seed=step), dev)
        if sharded:
            batch = execute.place_tree(batch, batch_specs, mesh)
        state, metrics = step_fn(state, batch)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            losses.append(float(metrics["loss"]))
            log(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.perf_counter() - t0:.1f}s)")
    if args.ckpt:
        if sharded:
            execute.copy_into(cfg, model, state["params"])
            state = {"params": model}
        if not sharded or dist.get_rank() == 0:
            save(args.ckpt, state["params"], metadata={"arch": cfg.name}, cfg=cfg)
            log(f"checkpoint -> {args.ckpt}.npz")
    return {"arch": cfg.name, "losses": losses, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
