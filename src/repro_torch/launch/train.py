"""Training launcher: the train step on one device.

Mirrors `repro/launch/train.py` with the reference's flags (``--arch``,
``--smoke``, ``--steps``, ``--batch``, ``--seq-len``, ``--lr``, ``--ckpt``)
plus ``--remat`` (activation checkpointing of each layer group, as the
reference's production step trains) and ``--device``: it runs on the card
unless ``--device cpu`` is given.  The reference's ``--production-mesh``
and ``--multi-pod`` build TPU meshes; the port trains on one card and has
no mesh yet (ROADMAP queue A).  Every config trains: attention, SSD
(mamba2-1.3b), recurrent (recurrentgemma-9b) and MoE (qwen3-moe-30b-a3b,
grok-1-314b, whose experts' gradients come from the grouped GEMM's
backward kernels).
The checkpoint is written in the reference's format
(`repro_torch.train.checkpoint`).

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --smoke --steps 10 --batch 4 --seq-len 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --smoke --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
      --smoke --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import time

from ..configs import ARCH_IDS, get_config, smoke_variant
from ..data import BatchSpec, make_batch
from ..device import resolve_device
from ..train.checkpoint import save
from ..train.optimizer import AdamWConfig
from ..train.train_loop import batch_to_device, init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer group in the backward (activation checkpointing)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={dev} "
          f"remat={args.remat}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat)
    state = init_state(0, cfg, device=dev)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = batch_to_device(
            make_batch(cfg, BatchSpec(args.batch, args.seq_len), seed=step), dev)
        state, metrics = step_fn(state, batch)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            losses.append(float(metrics["loss"]))
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    if args.ckpt:
        save(args.ckpt, state["params"], metadata={"arch": cfg.name}, cfg=cfg)
        print(f"checkpoint -> {args.ckpt}.npz")
    return {"arch": cfg.name, "losses": losses, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
