"""Train a small model end-to-end with the port's full substrate.

The PyTorch port of `examples/train_small.py`: the port's data pipeline ->
loss (flash attention and its backward kernel on the card) -> AdamW ->
checkpoint, on a scaled-down internlm2-family config.  The same presets
and flags, plus ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions).  The checkpoint is written in the reference's format, so
`repro.train.checkpoint.restore` reads it too.

Run:  PYTHONPATH=src python examples/torch_train_small.py [--steps 60] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import BatchSpec, token_batches
from repro_torch.train import AdamWConfig, train
from repro_torch.train.checkpoint import save

PRESETS = {
    # ~15M params: fits a laptop/CI CPU.
    "15m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192),
    # ~100M params: the paper-scale example for real hardware.
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32000),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="15m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_small"))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()

    base = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(base, name=f"internlm2-{args.preset}-example",
                              **PRESETS[args.preset])
    print(f"config: {cfg.name}  params~{cfg.param_count()/1e6:.1f}M")

    batches = token_batches(cfg, BatchSpec(args.batch, args.seq_len), seed=0)
    state, history = train(
        cfg, batches, steps=args.steps,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
        log_every=max(args.steps // 10, 1), device=args.device,
    )
    first, last = history[0], history[-1]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} "
          f"({args.steps} steps, {last['elapsed_s']:.1f}s)")
    save(args.ckpt, state["params"], metadata={"config": cfg.name, "steps": args.steps},
         cfg=cfg)
    print(f"checkpoint written to {args.ckpt}.npz")


if __name__ == "__main__":
    main()
