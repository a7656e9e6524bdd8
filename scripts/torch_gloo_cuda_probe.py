#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, for ranks sharing one card.

`chip_smoke.py` phase 11 runs four ranks on one card over gloo (NCCL
refuses two ranks on one card), and `repro_torch.sharding.parallel` picks
its collectives by what gloo takes there (`ALL_REDUCE_GATHER`).  This
script tries each collective the port could issue, the functional ops
(``torch.ops._c10d_functional``, what the port calls) and the classic
``torch.distributed`` ones, each in a 4-rank group of its own, so that one
that kills its process (a segfault) leaves the others to run, and prints
one line a collective: ``ok`` with the result's shape and first values,
``FAIL`` with the error it raised, or ``CRASH`` when a rank died.  Needs
one CUDA card:

    python scripts/torch_gloo_cuda_probe.py
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
NAMES = ("f_all_reduce", "f_all_gather_into_tensor", "f_reduce_scatter_tensor", "f_broadcast",
         "c_all_reduce", "c_all_gather_into_tensor", "c_all_gather", "c_reduce_scatter_tensor",
         "c_broadcast")


def _call(name: str, x: torch.Tensor, pg) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    if name == "f_all_reduce":
        return ops.wait_tensor(ops.all_reduce(x, "sum", pg.group_name))
    if name == "f_all_gather_into_tensor":
        return ops.wait_tensor(ops.all_gather_into_tensor(x, WORLD, pg.group_name))
    if name == "f_reduce_scatter_tensor":
        return ops.wait_tensor(ops.reduce_scatter_tensor(x, "sum", WORLD, pg.group_name))
    if name == "f_broadcast":
        return ops.wait_tensor(ops.broadcast(x, 0, pg.group_name))
    y = x.clone()
    if name == "c_all_reduce":
        dist.all_reduce(y)
    elif name == "c_all_gather_into_tensor":
        y = x.new_empty((x.shape[0] * WORLD,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(y, x)
    elif name == "c_all_gather":
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        y = torch.cat(parts)
    elif name == "c_reduce_scatter_tensor":
        y = x.new_empty((x.shape[0] // WORLD,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(y, x)
    elif name == "c_broadcast":
        dist.broadcast(y, 0)
    else:
        raise KeyError(name)
    return y


def _rank(rank: int, world: int, store_path: str, name: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    x = torch.full((WORLD, 3), float(rank + 1), device="cuda")
    try:
        y = _call(name, x, dist.group.WORLD)
        torch.cuda.synchronize()
        msg = f"ok {tuple(y.shape)} {y.flatten()[:4].tolist()} on {y.device}"
    except Exception as e:  # noqa: BLE001 - the probe reports what each op raises
        msg = f"FAIL {type(e).__name__}: {str(e)[:200]}"
    if rank == 0:
        print(f"{name}: {msg}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(NAMES):
            try:
                mp.spawn(_rank, args=(WORLD, os.path.join(tmp, f"store{i}"), name),
                         nprocs=WORLD)
            except mp.ProcessExitedException as e:
                print(f"{name}: CRASH {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
