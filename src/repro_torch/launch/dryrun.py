"""Multi-pod dry-run: place every (arch x shape x mesh) combination on meta.

Mirrors `repro/launch/dryrun.py`, which lowers and compiles each step on
512 placeholder devices so that GSPMD proves the sharding plan coherent,
and reads XLA's memory and cost analyses.  PyTorch has no such compiler,
so the port proves what it can without one.  Per combination, `run_one`:

  1. initializes a fake process group of the mesh's size (256 or 512
     ranks, torch's ``"fake"`` backend: no devices, no communication) and
     builds the production `DeviceMesh` on it;
  2. builds the step's abstract arguments with `launch/steps.py` on the
     meta device: parameters, AdamW moments, the batch and the caches,
     each block leaf and each slot's caches stacked over layer groups as
     the reference's plan is defined;
  3. places every leaf with `distribute_tensor` at its spec's placements,
     and checks that every shard is even (`_check_divisible` strips
     "model" where a dim does not divide; any other uneven shard is an
     error);
  4. runs the step itself on those meta shards under the fake group
     (`count_collectives`): the sharded step of
     `repro_torch.sharding.execute`, its kernels on their shape-only
     path, with a dispatch mode that counts every functional collective
     rank 0 issues and its result bytes.  As the reference compiles 1-
     and 2-group variants and extrapolates, so does this: total = F(1) +
     (G - 1) (F(2) - F(1));
  5. records rank 0's bytes per device by kind (params, optimizer state,
     batch, caches), whether their sum fits the card's 80 GB, the model
     FLOPs, the collectives, and the roofline's compute, memory and
     collective terms on the H100 record, in
     ``build/dryrun/<arch>__<shape>__<mesh>.json``;
  6. destroys the group.

One of the reference's numbers has no counterpart: the compiled
program's temp memory.  The record holds ``null`` for it, with the
reason.  Nothing runs on a device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..interop import param_leaves
from ..roofline.analysis import H100, H100_MEMORY_BYTES, model_flops, roofline_terms
from ..sharding import execute, parallel
from ..sharding.specs import placements
from . import steps as steps_lib
from .mesh import MESH_SHAPES, destroy_process_group, make_production_mesh

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: long_500k policy: archs that run it natively.
NATIVE_LONG = {"mamba2-1.3b", "recurrentgemma-9b", "gemma2-2b"}

NO_TEMP = ("not counted: no compiler analyses the port's program; eager PyTorch's temp "
           "memory shows only when a step runs")


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, MESH_SHAPES[multi_pod][0]))


def stacked_params(cfg, model) -> dict:
    """``{path: meta tensor}``: each block leaf's per-layer tensors stacked
    over layer groups (`torch.stack` on meta: no memory)."""
    return {path: leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))
            for path, leaf in param_leaves(cfg, model).items()}


def stacked_caches(cfg, caches: list) -> tuple:
    """Per-slot caches stacked over groups, as the reference holds them:
    slot ``s`` stacks the caches of layers ``s, s + n, ...``."""
    n = len(cfg.layer_pattern)
    return tuple({key: torch.stack([c[key] for c in caches[slot::n]]) for key in caches[slot]}
                 for slot in range(n))


def _pairs(tree, specs, prefix=""):
    """(name, tensor, spec) of every leaf of ``tree`` (dicts, tuples and
    lists of tensors) against the same-shaped ``specs``."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree, specs
    elif isinstance(tree, dict):
        for key in tree:
            yield from _pairs(tree[key], specs[key], f"{prefix}/{key}" if prefix else key)
    else:
        for i, (leaf, spec) in enumerate(zip(tree, specs, strict=True)):
            yield from _pairs(leaf, spec, f"{prefix}/[{i}]")


def _shards(entry, axes: dict) -> int:
    if entry is None:
        return 1
    return math.prod(axes[a] for a in ((entry,) if isinstance(entry, str) else entry))


def place(tree, specs, mesh) -> int:
    """Bytes of rank 0's shards of ``tree`` placed on ``mesh`` at
    ``specs``; raises on an uneven shard."""
    from torch.distributed.tensor import distribute_tensor

    axes = steps_lib.mesh_axes(mesh)
    total = 0
    for name, leaf, spec in _pairs(tree, specs):
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        uneven = [(d, size, entry) for d, (size, entry) in enumerate(zip(leaf.shape, spec))
                  if size % _shards(entry, axes)]
        if uneven:
            raise ValueError(f"{name} {tuple(leaf.shape)} at {spec}: uneven shards {uneven}")
        local = distribute_tensor(leaf, mesh, placements(spec, mesh)).to_local()
        total += local.numel() * local.element_size()
    return total


def _abstract_run(cfg, kind: str, mesh, *, multi_pod: bool, batch: int, seq_len: int,
                  microbatches: int, long_context: bool) -> None:
    """Build the step for ``mesh`` and run it once on meta shards of its
    abstract arguments."""
    kw = dict(multi_pod=multi_pod, batch=batch)
    if kind == "train":
        step, (state, inputs), (state_specs, in_specs) = steps_lib.make_train_setup(
            cfg, mesh, seq_len=seq_len, microbatches=microbatches, **kw)
        placed = execute.place_train_state(cfg, state["params"], state_specs, mesh,
                                           opt=state["opt"])
        step(placed, execute.place_tree(inputs, in_specs, mesh))
    elif kind == "prefill":
        step, (params, inputs, caches), (pspecs, in_specs, cspecs) = (
            steps_lib.make_prefill_setup(cfg, mesh, seq_len=seq_len, **kw))
        step(execute.place_params(cfg, params, pspecs, mesh),
             execute.place_tree(inputs, in_specs, mesh),
             execute.place_caches(caches, cspecs, cfg, mesh))
    else:
        step, (params, toks, _, caches), (pspecs, in_specs, cspecs) = (
            steps_lib.make_decode_setup(cfg, mesh, cache_len=seq_len,
                                        long_context=long_context, **kw))
        step(execute.place_params(cfg, params, pspecs, mesh),
             execute.place(toks, in_specs["tokens"], mesh), seq_len - 1,
             execute.place_caches(caches, cspecs, cfg, mesh))


def count_collectives(cfg, kind: str, mesh, *, multi_pod: bool, batch: int, seq_len: int,
                      microbatches: int = 1, long_context: bool = False) -> dict:
    """``{op: {"count", "bytes"}, "total": ...}``: the functional
    collectives one rank of ``mesh`` issues in one step of ``kind`` and
    their result bytes, counted on meta tensors (under a fake process group
    nothing is sent).  Depth is extrapolated from 1- and 2-group variants
    of ``cfg``, as the reference's dry-run does; a config of at most 2
    groups runs whole."""
    def one(groups: int) -> dict:
        small = dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern) * groups)
        with parallel.CollectiveCounter() as counter:
            _abstract_run(small, kind, mesh, multi_pod=multi_pod, batch=batch,
                          seq_len=seq_len, microbatches=microbatches,
                          long_context=long_context)
        return counter.counts

    g = cfg.num_groups
    if g <= 2:
        coll = one(g)
    else:
        f1, f2 = one(1), one(2)
        coll = {op: {"count": int(f1[op]["count"]
                                  + (g - 1) * max(f2[op]["count"] - f1[op]["count"], 0)),
                     "bytes": f1[op]["bytes"]
                     + (g - 1) * max(f2[op]["bytes"] - f1[op]["bytes"], 0.0)}
                for op in f1}
    coll["total"] = {"count": sum(v["count"] for v in coll.values()),
                     "bytes": sum(v["bytes"] for v in coll.values())}
    return coll


def run_one(arch: str, shape: str, multi_pod: bool, *, save: bool = True) -> dict:
    cfg = get_config(arch)
    seq_len, batch, kind = steps_lib.SHAPES[shape]
    long_context = shape == "long_500k"
    variant = ""
    if long_context and arch not in NATIVE_LONG:
        assert cfg.long_context_window, f"{arch}: no long-context variant"
        variant = f"-sw{cfg.long_context_window}"
    # Gradient-accumulation factor of the production train program.
    microbatches = 32 if cfg.param_count() > 1e11 else 8

    if dist.is_initialized():
        raise RuntimeError("run_one makes its own fake process group; one is initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n_chips = math.prod(MESH_SHAPES[multi_pod][0])
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
        kw = dict(multi_pod=multi_pod, batch=batch)
        opt = ospecs = caches = cspecs = None
        if kind == "train":
            _, (state, inputs), (state_specs, in_specs) = steps_lib.make_train_setup(
                cfg, mesh, seq_len=seq_len, microbatches=microbatches, **kw)
            params, opt = state["params"], state["opt"]
            pspecs, ospecs = state_specs["params"], state_specs["opt"]
        elif kind == "prefill":
            _, (params, inputs, caches), (pspecs, in_specs, cspecs) = (
                steps_lib.make_prefill_setup(cfg, mesh, seq_len=seq_len, **kw))
        else:
            _, (params, toks, pos, caches), (pspecs, in_specs, cspecs) = (
                steps_lib.make_decode_setup(cfg, mesh, cache_len=seq_len,
                                            long_context=long_context, **kw))
            inputs = {"tokens": toks, "cur_pos": pos}
        t_build = time.perf_counter() - t0
        by_kind = {"params": place(stacked_params(cfg, params), pspecs, mesh),
                   "opt": place(opt, ospecs, mesh) if opt is not None else 0,
                   "batch": place(inputs, in_specs, mesh),
                   "caches": (place(stacked_caches(cfg, caches), cspecs, mesh)
                              if caches is not None else 0)}
        t_place = time.perf_counter() - t0 - t_build
        coll, coll_reason = None, None
        if kind == "train":
            # The sharded step cuts the micro-batches from each batch rank's
            # rows, or runs them side by side on sub-groups of the ranks.
            shards = n_chips // steps_lib.mesh_axes(mesh)["model"]
            try:
                execute.microbatch_groups(batch, shards, microbatches)
            except ValueError as e:
                coll_reason = f"not counted: {e}"
        if coll_reason is None:
            coll = count_collectives(cfg, kind, mesh, multi_pod=multi_pod, batch=batch,
                                     seq_len=seq_len, microbatches=microbatches,
                                     long_context=long_context)
        t_coll = time.perf_counter() - t0 - t_build - t_place
    finally:
        destroy_process_group()
    by_kind["total"] = sum(by_kind.values())

    tokens = batch * (1 if kind == "decode" else seq_len)
    mf = model_flops(cfg, tokens) * (3 if kind == "train" else 1)
    # Compute from the model FLOPs spread evenly; memory from each resident
    # byte touched once a step (a floor on the traffic); the collectives'
    # result bytes over NVLink.
    terms = roofline_terms(hlo_flops_per_device=mf / n_chips,
                           hlo_bytes_per_device=by_kind["total"],
                           collective_bytes_per_device=coll["total"]["bytes"] if coll else 0.0,
                           hw=H100,
                           links_per_chip=1)
    record = {
        "arch": arch + variant,
        "shape": shape,
        "mesh": mesh_name(multi_pod),
        "kind": kind,
        "n_chips": n_chips,
        "seq_len": seq_len,
        "batch": batch,
        "microbatches": microbatches if kind == "train" else None,
        "build_s": t_build,
        "place_s": t_place,
        "collectives_s": t_coll,
        "bytes_per_device": by_kind,
        "device_memory_bytes": H100_MEMORY_BYTES,
        "fits_device": by_kind["total"] <= H100_MEMORY_BYTES,
        "hardware": H100.name,
        "model_flops": mf,
        "model_flops_per_device": mf / n_chips,
        "roofline": terms,
        "collectives": coll,
        "collectives_reason": coll_reason,
        "temp": None,
        "temp_reason": NO_TEMP,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if save:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        path = ARTIFACT_DIR / f"{arch}__{shape}__{record['mesh']}.json"
        path.write_text(json.dumps(record, indent=1))
    return record


def _fmt(record: dict) -> str:
    b, r = record["bytes_per_device"], record["roofline"]
    gb = {k: v / 1e9 for k, v in b.items()}
    return (
        f"{record['arch']:28s} {record['shape']:12s} {record['mesh']:8s} "
        f"GB/device params {gb['params']:7.3f} opt {gb['opt']:7.3f} batch {gb['batch']:7.4f} "
        f"caches {gb['caches']:7.3f} total {gb['total']:7.3f} "
        f"{'fits' if record['fits_device'] else 'OVER'} 80 GB | "
        f"t_comp {r['compute_s'] * 1e3:9.2f}ms t_mem {r['memory_s'] * 1e3:8.2f}ms "
        f"t_coll {r['collective_s'] * 1e3:8.2f}ms -> {r['dominant']} | "
        + (f"coll/dev {record['collectives']['total']['bytes'] / 1e9:.3f} GB | "
           if record["collectives"] else f"{record['collectives_reason']} | ") +
        f"place {record['place_s']:.2f}s count {record['collectives_s']:.2f}s"
    )


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(steps_lib.SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"), default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(steps_lib.SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = {"pod": (False,), "multipod": (True,), "both": (False, True)}[args.mesh]

    failures, records = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                path = ARTIFACT_DIR / f"{arch}__{shape}__{mesh_name(mp)}.json"
                if args.skip_existing and path.exists():
                    continue
                try:
                    rec = run_one(arch, shape, mp)
                    records.append(rec)
                    print(_fmt(rec), flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAIL {arch} {shape} multipod={mp}: {e}", flush=True)
                    if not args.continue_on_error:
                        traceback.print_exc()
                        raise SystemExit(1)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll dry-runs passed.")
    return records


if __name__ == "__main__":
    main()
