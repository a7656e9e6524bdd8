"""The ranks of `tests/test_torch_sharded.py`: a 4-rank gloo group on the CPU.

Each rank runs, for every architecture of `ARCHS`, the sharded steps of
`repro_torch` on a (2, 2) ``("data", "model")`` mesh from the reference's
parameters (handed over as numpy arrays), and one of them (rank ``i``
then the training launcher on the group's (4, 1) mesh; off the group,
rank ``i`` runs ``ARCHS[i]``'s work on one device, and the launcher in one
process, for comparison.  It imports
`torch` and `repro_torch` only: the JAX package stays in the parent.
Results are written to ``rank<r>.pt`` in the run's directory.
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


def cut(cfg, arch: str, dtype: str):
    """``cfg`` (either package's smoke config) at `CUTS`' depth in ``dtype``."""
    return dataclasses.replace(cfg, dtype=dtype, **CUTS.get(arch, {}))


def config(arch: str, dtype: str = "float32"):
    from repro_torch.configs import get_config, smoke_variant

    return cut(smoke_variant(get_config(arch)), arch, dtype)


def _counts(comm) -> dict:
    return {op._qualified_op_name.split("::")[-1]: n for op, n in comm.get_comm_counts().items()
            if n}


def _arch_run(arch: str, tree, mesh) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import param_leaves, params_from_plain
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import execute as ex
    from repro_torch.sharding import specs as sh
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import batch_to_device, make_train_step

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
        res = {"params_bytes": ex.resident_bytes(state["params"]),
               "opt_bytes": ex.resident_bytes(state["opt"])}
        with CommDebugMode() as comm:
            state, metrics = step(state, ex.place_tree(batch, bspecs, mesh))
        res["comm"] = _counts(comm)
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["params"] = {p: ex.full(dt) for p, dt in state["params"].items()}
        res["mu"] = {p: ex.full(dt) for p, dt in state["opt"]["mu"].items()}
        res["nu"] = {p: ex.full(dt) for p, dt in state["opt"]["nu"].items()}
        out[f"train{mb}"] = res
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
    from repro_torch.interop import param_leaves, params_from_plain
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import execute as ex
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import batch_to_device, make_train_step

    cfg = config(arch)
    batch = batch_to_device(make_batch(cfg, BatchSpec(B, S), seed=1), "cpu")
    out: dict = {}
    for mb in (1, 2):
        order = torch.tensor(ex.microbatch_rows(B, 2, mb))
        m1 = params_from_plain(cfg, tree, device="cpu")
        m1.requires_grad_(True)
        st = {"params": m1, "opt": init_opt_state(param_leaves(cfg, m1))}
        st, met = make_train_step(cfg, AdamWConfig(**OPT), remat=True, microbatches=mb)(
            st, {k: v[order] for k, v in batch.items()})
        out[f"train{mb}"] = {
            "metrics": {k: float(v) for k, v in met.items()},
            "params": {p: (t if isinstance(t, torch.Tensor) else torch.stack(list(t))).detach()
                       for p, t in param_leaves(cfg, m1).items()},
            "mu": dict(st["opt"]["mu"]), "nu": dict(st["opt"]["nu"])}
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


def _params(run_dir: str, arch: str) -> dict:
    """The reference's parameters of ``arch``, which the parent writes (one
    file an architecture, renamed into place) while the ranks work."""
    path = pathlib.Path(run_dir) / f"params-{arch}.pkl"
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
    dist.barrier()
    dist.destroy_process_group()
    # Off the group: this rank's architecture on one device, and the
    # launcher in one process.
    arch = ARCHS[rank]
    t = time.perf_counter()
    results["one"] = {"arch": arch, **_one_device(arch, trees[arch], results[arch]["serve"])}
    results["one_launcher"] = {"arch": arch, "losses": _launch(arch)}
    results["seconds"]["one"] = time.perf_counter() - t
    results["seconds"]["total"] = time.perf_counter() - t0
    torch.save(results, f"{run_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
