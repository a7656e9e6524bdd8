"""The ranks of `tests/test_torch_sharded.py`: a 4-rank gloo group on the CPU.

Each rank runs, for every architecture of `ARCHS`, the sharded steps of
`repro_torch` on a (2, 2) ``("data", "model")`` mesh from the reference's
parameters (handed over as numpy arrays), then the training launcher on
the group's (4, 1) mesh, then the train steps of `GROUPED` (micro-batches
of fewer rows than there are data ranks, also from the reference's
parameters, and smoke grok-1-314b's forward with tensor-parallel experts);
off the group, rank ``i`` runs ``ARCHS[i]``'s work and the
``i``-th of `GROUPED_ONE` on one device, and the launcher in one process,
for comparison.  It imports `torch` and `repro_torch` only: the JAX
package stays in the parent.  Results are written to ``rank<r>.pt`` in
the run's directory.
"""
from __future__ import annotations

import dataclasses
import io
import pathlib
import pickle
import sys
import time
from contextlib import redirect_stdout

import torch
import torch.distributed as dist

ARCHS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b")
B, S, CACHE = 4, 32, 40
#: The launcher's sequence length.
LAUNCH_S = 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=5)
#: The architecture also run in bf16.
BF16 = "internlm2-1.8b"
#: The architecture also trained with its group axis sharded over data.
GROUP_FSDP = "mamba2-1.3b"
#: The architectures also decoded at batch 1, the caches' slots split.
CONTEXT_PARALLEL = ("internlm2-1.8b", "recurrentgemma-9b")


#: Depth cuts of the smoke configs: recurrentgemma-9b's 19-slot group cut
#: to one (recurrent, recurrent, attention) group, as tests/test_torch_train.py
#: cuts it.
CUTS = {"recurrentgemma-9b": dict(layer_pattern=("recurrent", "recurrent", "attention"),
                                  window_pattern=(None, None, 16), num_layers=3)}


#: Train steps whose micro-batches have fewer rows than there are data
#: ranks: case -> (architecture, mesh, batch, micro-batch counts, config
#: changes).  ``tp_experts``: smoke grok-1-314b with 3 experts, which do
#: not divide the model axis of 2 (as 8 do not divide 16 at full size), so
#: they are tensor-parallel; at M 4 two micro-batches of one row run side
#: by side, one data rank each.  ``dispatch``: smoke qwen3-moe-30b-a3b on
#: the (4, 1) mesh, one dispatch group and a capacity of 12 pairs an expert
#: for a micro-batch's 64 (so some are dropped); at M 4 two sub-groups of
#: two data ranks, the keep's gather, the capacity and the aux reaching
#: across a sub-group.
GROUPED = {
    "tp_experts": ("grok-1-314b", (2, 2), 4, (1, 4), dict(num_experts=3)),
    "dispatch": ("qwen3-moe-30b-a3b", (4, 1), 8, (4,),
                 dict(moe_dispatch_groups=1, moe_capacity_factor=0.75)),
}
GROUPED_S = 16
#: The one-device steps to hold them against, rank ``i`` the ``i``-th.
GROUPED_ONE = (("tp_experts", 1), ("dispatch", 4), ("tp_experts", 4))
#: The batch seed of the `GROUPED` cases.
GROUPED_SEED = 2


def grouped_params(case: str) -> str:
    """The name of the reference's parameters ``case`` trains from: its
    architecture's where `ARCHS` has it (the config changes leave the
    shapes), else its own."""
    arch = GROUPED[case][0]
    return arch if arch in ARCHS else case


def grouped_config(case: str, configs=None):
    """`GROUPED`'s config of ``case`` from ``configs`` (either package's
    `configs` module; the port's by default), in float32."""
    if configs is None:
        from repro_torch import configs
    arch, _, _, _, changes = GROUPED[case]
    return dataclasses.replace(configs.smoke_variant(configs.get_config(arch)),
                               dtype="float32", **changes)


def cut(cfg, arch: str, dtype: str):
    """``cfg`` (either package's smoke config) at `CUTS`' depth in ``dtype``."""
    return dataclasses.replace(cfg, dtype=dtype, **CUTS.get(arch, {}))


def config(arch: str, dtype: str = "float32"):
    from repro_torch.configs import get_config, smoke_variant

    return cut(smoke_variant(get_config(arch)), arch, dtype)


def _counts(comm) -> dict:
    return {op._qualified_op_name.split("::")[-1]: n for op, n in comm.get_comm_counts().items()
            if n}


def _trained(step, state, batch: dict) -> dict:
    """One sharded step's collectives (`CommDebugMode`), metrics, and whole
    parameters and moments after it."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.sharding import execute as ex

    with CommDebugMode() as comm:
        state, metrics = step(state, batch)
    return {"comm": _counts(comm), "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {p: ex.full(dt) for p, dt in state["params"].items()},
            "mu": {p: ex.full(dt) for p, dt in state["opt"]["mu"].items()},
            "nu": {p: ex.full(dt) for p, dt in state["opt"]["nu"].items()}}


class DropCounter:
    """Counts the (token, choice) pairs `moe._keep` drops while entered."""

    def __enter__(self):
        from repro_torch.models import moe

        self.dropped, self._keep = 0, moe._keep

        def keep(*args, **kwargs):
            out = self._keep(*args, **kwargs)
            self.dropped += int((~out).sum())
            return out

        moe._keep = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._keep = self._keep


def _grouped_run(case: str, tree, mesh) -> dict:
    """`GROUPED`'s train steps of ``case`` on ``mesh`` from the reference's
    parameters ``tree``: each M's result (as `_trained`'s) and the pairs
    this rank's MoE layers dropped; on the (2, 2) mesh also
    ``forward_train``'s logits at the reference test's plan (no FSDP)."""
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import params_from_plain
    from repro_torch.launch import steps
    from repro_torch.sharding import execute as ex
    from repro_torch.sharding import specs as sh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import batch_to_device

    cfg = grouped_config(case)
    _, shape, b, mbs, _ = GROUPED[case]
    batch = batch_to_device(make_batch(cfg, BatchSpec(b, GROUPED_S), seed=GROUPED_SEED), "cpu")
    out = {}
    if shape[1] > 1:
        m = params_from_plain(cfg, tree, device="cpu")
        pspecs = sh.param_specs(m, cfg, model_axis=shape[1])
        bspecs = {k: v for k, v in sh.train_batch_specs(cfg, multi_pod=False).items()
                  if k in batch}
        logits, _ = ex.sharded_forward_train(cfg, mesh, pspecs, bspecs)(
            ex.place_params(cfg, m, pspecs, mesh), ex.place_tree(batch, bspecs, mesh))
        out["logits"] = ex.full(logits)
    for mb in mbs:
        step, _, (state_specs, bspecs) = steps.make_train_setup(
            cfg, mesh, multi_pod=False, batch=b, seq_len=GROUPED_S,
            opt_cfg=AdamWConfig(**OPT), microbatches=mb)
        state = ex.place_train_state(cfg, params_from_plain(cfg, tree, device="cpu"),
                                     state_specs, mesh)
        with DropCounter() as drops:
            out[mb] = _trained(step, state, ex.place_tree(batch, bspecs, mesh))
        out[mb]["dropped"] = drops.dropped
    return out


def _one_step(cfg, model, batch: dict, microbatches: int) -> dict:
    """The port's one-device train step (remat, as the builders') from
    ``model``: its metrics, parameters and moments after it."""
    from repro_torch.interop import param_leaves
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    model.requires_grad_(True)
    st = {"params": model, "opt": init_opt_state(param_leaves(cfg, model))}
    st, met = make_train_step(cfg, AdamWConfig(**OPT), remat=True, microbatches=microbatches)(
        st, batch)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": {p: (t if isinstance(t, torch.Tensor) else torch.stack(list(t))).detach()
                       for p, t in param_leaves(cfg, model).items()},
            "mu": dict(st["opt"]["mu"]), "nu": dict(st["opt"]["nu"])}


def _grouped_one(case: str, microbatches: int, tree) -> dict:
    """`_grouped_run`'s step on one device on the rows in the sharded
    step's order (`execute.microbatch_rows`), and the pairs it dropped."""
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import params_from_plain
    from repro_torch.sharding import execute as ex
    from repro_torch.train.train_loop import batch_to_device

    cfg = grouped_config(case)
    _, shape, b, _, _ = GROUPED[case]
    batch = batch_to_device(make_batch(cfg, BatchSpec(b, GROUPED_S), seed=GROUPED_SEED), "cpu")
    order = torch.tensor(ex.microbatch_rows(b, shape[0], microbatches))
    with DropCounter() as drops:
        out = _one_step(cfg, params_from_plain(cfg, tree, device="cpu"),
                        {k: v[order] for k, v in batch.items()}, microbatches)
    return {"case": case, "microbatches": microbatches, "dropped": drops.dropped,
            "groups": ex.microbatch_groups(b, shape[0], microbatches), **out}


def _arch_run(arch: str, tree, mesh) -> dict:
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import params_from_plain
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import execute as ex
    from repro_torch.sharding import specs as sh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import batch_to_device

    cfg = config(arch)
    opt_cfg = AdamWConfig(**OPT)
    out: dict = {}
    batch = batch_to_device(make_batch(cfg, BatchSpec(B, S), seed=1), "cpu")

    def model():
        return params_from_plain(cfg, tree, device="cpu")

    # forward_train, at the reference test's plan (no FSDP).
    m = model()
    pspecs = sh.param_specs(m, cfg, model_axis=2)
    bspecs = {k: v for k, v in sh.train_batch_specs(cfg, multi_pod=False).items() if k in batch}
    fwd = ex.sharded_forward_train(cfg, mesh, pspecs, bspecs)
    logits, _ = fwd(ex.place_params(cfg, m, pspecs, mesh), ex.place_tree(batch, bspecs, mesh))
    out["logits"] = ex.full(logits)

    # One train step with M = 1 and 2 (FSDP over data, as the builder plans it).
    for mb in (1, 2):
        step, _, (state_specs, bspecs) = steps.make_train_setup(
            cfg, mesh, multi_pod=False, batch=B, seq_len=S, opt_cfg=opt_cfg, microbatches=mb)
        state = ex.place_train_state(cfg, model(), state_specs, mesh)
        out[f"train{mb}"] = {"params_bytes": ex.resident_bytes(state["params"]),
                             "opt_bytes": ex.resident_bytes(state["opt"]),
                             **_trained(step, state, ex.place_tree(batch, bspecs, mesh))}
    if arch == GROUP_FSDP:
        # FSDP at min_elements 1 << 10 shards the 2-group leaves' group axis
        # over data: each data rank holds one group, the other reaches it
        # from its owner.
        from repro_torch.interop import plain_shapes

        pspecs = sh.apply_fsdp(sh.param_specs(m, cfg, model_axis=2), plain_shapes(cfg, m),
                               axis_size=2, min_elements=1 << 10)
        state_specs = {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}
        bspecs = {k: v for k, v in sh.train_batch_specs(cfg, multi_pod=False).items()
                  if k in batch}
        step = ex.make_sharded_train_step(cfg, opt_cfg, mesh, state_specs, bspecs)
        state = ex.place_train_state(cfg, model(), state_specs, mesh)
        state, metrics = step(state, ex.place_tree(batch, bspecs, mesh))
        out["train_group_fsdp"] = {
            "group_sharded": sorted(p for p, spec in pspecs.items()
                                    if "blocks/" in p and spec[0] == "data"),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {p: ex.full(dt) for p, dt in state["params"].items()},
            "mu": {p: ex.full(dt) for p, dt in state["opt"]["mu"].items()},
            "nu": {p: ex.full(dt) for p, dt in state["opt"]["nu"].items()}}

    # A prefill and two decode steps through the builders.
    m = model()
    pre, _, (pspecs, bsp, cspecs) = steps.make_prefill_setup(cfg, mesh, multi_pod=False,
                                                             batch=B, seq_len=CACHE)
    dec, _, (_, insp, _) = steps.make_decode_setup(cfg, mesh, multi_pod=False, batch=B,
                                                   cache_len=CACHE, long_context=False)
    params = ex.place_params(cfg, m, pspecs, mesh)
    caches = ex.place_caches(tfm.init_serve_cache(cfg, B, CACHE, device="cpu"), cspecs, cfg,
                             mesh)
    toks = {"tokens": batch["tokens"]}
    lg, caches = pre(params, ex.place_tree(toks, bsp, mesh), caches)
    serve = [ex.full(lg)]
    tok = serve[0][:, -1:].argmax(-1).to(torch.int32)
    for pos in (S, S + 1):
        lg, caches = dec(params, ex.place(tok, insp["tokens"], mesh), pos, caches)
        serve.append(ex.full(lg))
        tok = serve[-1].argmax(-1).to(torch.int32)
    out["serve"] = serve
    if arch in CONTEXT_PARALLEL:
        # Batch 1 does not split over data, so decode splits the caches'
        # slots over it (and over model where the KV heads do not split):
        # each rank attends over its run of slots, merged by lse.
        dec, _, (pspecs, insp, cspecs) = steps.make_decode_setup(
            cfg, mesh, multi_pod=False, batch=1, cache_len=CACHE, long_context=False)
        caches = tfm.init_serve_cache(cfg, 1, CACHE, device="cpu")
        _, caches = tfm.forward_prefill(m, cfg, {"tokens": batch["tokens"][:1]}, caches)
        placed = ex.place_caches(caches, cspecs, cfg, mesh)
        params = ex.place_params(cfg, m, pspecs, mesh)
        tok = batch["tokens"][:1, -1:]
        out["context_parallel"] = {"seq_axes": [c["pos"][1] for c in cspecs if "pos" in c][0],
                                   "sharded": [], "one": []}
        for pos in (S, S + 1):
            lg, placed = dec(params, ex.place(tok, insp["tokens"], mesh), pos, placed)
            lg1, caches = tfm.forward_decode(m, cfg, tok, pos, caches)
            out["context_parallel"]["sharded"].append(ex.full(lg))
            out["context_parallel"]["one"].append(lg1)
            tok = lg1.argmax(-1).to(torch.int32)
    return out


def _one_device(arch: str, tree, serve: list) -> dict:
    """The same work on one device: the train steps on the rows in the
    order the shards cut them, and the prefill and decode steps on the
    sharded run's tokens."""
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import params_from_plain
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import execute as ex
    from repro_torch.train.train_loop import batch_to_device

    cfg = config(arch)
    batch = batch_to_device(make_batch(cfg, BatchSpec(B, S), seed=1), "cpu")
    out: dict = {}
    for mb in (1, 2):
        order = torch.tensor(ex.microbatch_rows(B, 2, mb))
        out[f"train{mb}"] = _one_step(cfg, params_from_plain(cfg, tree, device="cpu"),
                                      {k: v[order] for k, v in batch.items()}, mb)
    m = params_from_plain(cfg, tree, device="cpu")
    caches = tfm.init_serve_cache(cfg, B, CACHE, device="cpu")
    lg, caches = tfm.forward_prefill(m, cfg, {"tokens": batch["tokens"]}, caches)
    logits = [lg]
    for i, pos in enumerate((S, S + 1)):
        tok = serve[i][:, -1:].argmax(-1).to(torch.int32)
        lg, caches = tfm.forward_decode(m, cfg, tok, pos, caches)
        logits.append(lg)
    out["serve"] = logits
    return out


def _launch(arch: str) -> list:
    from repro_torch.launch import train as launcher

    with redirect_stdout(io.StringIO()):
        rec = launcher.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", str(B),
                             "--seq-len", str(LAUNCH_S), "--device", "cpu"])
    return rec["losses"]


def _params(run_dir: str, name: str) -> dict:
    """The reference's parameters of ``name`` (an architecture of `ARCHS`
    or a case of `GROUPED`), which the parent writes (one file each,
    renamed into place) while the ranks work."""
    path = pathlib.Path(run_dir) / f"params-{name}.pkl"
    while not path.exists():
        time.sleep(0.02)
    with open(path, "rb") as f:
        return pickle.load(f)


def main(rank: int, world: int, run_dir: str) -> None:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(f"{run_dir}/store", world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.interop import params_from_plain
    from repro_torch.sharding import execute as ex
    from repro_torch.sharding import specs as sh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    results: dict = {"seconds": {}}
    trees = {}
    for arch in ARCHS:
        t = time.perf_counter()
        trees[arch] = _params(run_dir, arch)
        results[arch] = _arch_run(arch, trees[arch], mesh)
        results["seconds"][arch] = time.perf_counter() - t
    # The bf16 case: forward_train's logits.
    cfg = config(BF16, "bfloat16")
    m = params_from_plain(cfg, trees[BF16], device="cpu")
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.train.train_loop import batch_to_device

    batch = batch_to_device(make_batch(cfg, BatchSpec(B, S), seed=1), "cpu")
    pspecs = sh.param_specs(m, cfg, model_axis=2)
    bspecs = {k: v for k, v in sh.train_batch_specs(cfg, multi_pod=False).items() if k in batch}
    logits, _ = ex.sharded_forward_train(cfg, mesh, pspecs, bspecs)(
        ex.place_params(cfg, m, pspecs, mesh), ex.place_tree(batch, bspecs, mesh))
    results["bf16_logits"] = ex.full(logits)
    # The launcher on the group's (4, 1) mesh.
    t = time.perf_counter()
    results["launcher"] = {arch: _launch(arch) for arch in ARCHS}
    results["seconds"]["launcher"] = time.perf_counter() - t
    # Micro-batches of fewer rows than there are data ranks.
    t = time.perf_counter()
    meshes = {(2, 2): mesh,
              (4, 1): init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))}
    for case in GROUPED:
        name = grouped_params(case)
        trees[case] = trees[name] if name in trees else _params(run_dir, name)
    results["grouped"] = {case: _grouped_run(case, trees[case], meshes[GROUPED[case][1]])
                          for case in GROUPED}
    results["seconds"]["grouped"] = time.perf_counter() - t
    dist.barrier()
    dist.destroy_process_group()
    # Off the group: this rank's architecture on one device, and the
    # launcher in one process.
    arch = ARCHS[rank]
    t = time.perf_counter()
    results["one"] = {"arch": arch, **_one_device(arch, trees[arch], results[arch]["serve"])}
    results["one_launcher"] = {"arch": arch, "losses": _launch(arch)}
    results["seconds"]["one"] = time.perf_counter() - t
    t = time.perf_counter()
    results["one_grouped"] = [_grouped_one(case, mb, trees[case])
                              for case, mb in GROUPED_ONE[rank::world]]
    results["seconds"]["one_grouped"] = time.perf_counter() - t
    results["seconds"]["total"] = time.perf_counter() - t0
    torch.save(results, f"{run_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
