"""Sharded execution on a 4-rank gloo group on the CPU, against one device.

One module-scoped run spawns four processes (`tests/torch_sharded_ranks.py`,
a `FileStore` in a temporary directory for the rendezvous, one torch
thread each) that build a (2, 2) ``("data", "model")`` mesh and run the
reference test's four architectures (`tests/test_sharding.py:160-161`) at
smoke size in float32 (recurrentgemma-9b cut to one (recurrent, recurrent,
attention) group, `ranks.CUTS`), from the reference's parameters made here with
numpy and the JAX package while the ranks start.  While they run, this
process computes the reference's single-device logits and the dry-run's
counts on a fake 4-rank group.  The tests then hold:

* the sharded ``forward_train`` logits against the reference's within
  1e-4 of its largest |logit| (for the MoE also the reference test's own
  ``mean_err < 0.02`` and ``frac_large < 0.02``); one bf16 case within the
  reference test's 0.15;
* one train step (M = 1 and M = 2 micro-batches, FSDP over ``data`` as
  `make_train_setup` plans it) against the port's one-device step on the
  same rows in the order the shards cut them (`execute.microbatch_rows`):
  loss, its parts and the grad norm within 1e-5 relative, every moment
  within 1e-5 relative in norm (an element of a sum that nearly cancels,
  as a few of recurrentgemma-9b's ``lam`` gradients, moves by more of its
  leaf's largest), every parameter within 1e-5 of the
  larger of its leaf's largest and lr wherever the gradient stands clear
  of float32 noise and of Adam's eps (|g| above 1e-4 of the leaf's largest
  and above 1e3 eps: the first step moves an element by lr · g / (|g| +
  eps), so a gradient at the noise of two sum orders moves its weight by
  anything up to lr) and within 2 lr elsewhere;
* the same step with smoke mamba2-1.3b's group axis sharded over
  ``data`` (FSDP at ``min_elements=1 << 10``: a group's layer reaches the
  other data rank from its owner) within the same limits;
* a prefill and two decode steps through the builders (smoke
  recurrentgemma-9b's kv 1 splits the decode caches' slots over
  ``model``, merged by log-sum-exp) within 1e-5 of the one-device logits;
* two decode steps at batch 1 (internlm2-1.8b, recurrentgemma-9b), whose
  caches' slots split over data (and model) and merge by log-sum-exp,
  within 1e-5 of one device's;
* the launcher's ``main`` for 2 steps on the group's (4, 1) mesh: its
  first loss within 1e-5 relative of the one-rank launcher's, its second,
  after one AdamW update (see the train step above), within 1e-3;
* each rank's resident parameter and moment bytes equal to the dry-run's
  count of the plan's bytes for that rank (fake 4-rank group);
* the collectives `CommDebugMode` counted on the real group in the M = 1
  step equal to the dry-run's count for the same step on a fake group.
"""
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.data import BatchSpec as JBatchSpec
from repro.data import make_batch as jmake_batch
from repro.models import transformer as jtfm
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks  # noqa: E402

ARCHS = ranks.ARCHS
RTOL = 1e-5
WORLD = 4
BETA1, EPS = 0.9, 1e-8  # AdamWConfig's defaults, which ranks.OPT keeps


def _jcfg(arch, dtype="float32"):
    return ranks.cut(jconfigs.smoke_variant(jconfigs.get_config(arch)), arch, dtype)


def _fake_mesh(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=WORLD)
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _plan_bytes(arch) -> dict:
    """``{rank: (param bytes, moment bytes)}`` by the dry-run's count."""
    cfg = ranks.config(arch)
    out = {}
    for rank in range(WORLD):
        mesh = _fake_mesh(rank)
        try:
            _, (state, _), (state_specs, _) = tsteps.make_train_setup(
                cfg, mesh, multi_pod=False, batch=ranks.B, seq_len=ranks.S)
            params = dryrun.stacked_params(cfg, state["params"])
            out[rank] = (dryrun.place(params, state_specs["params"], mesh),
                         dryrun.place(state["opt"], state_specs["opt"], mesh))
        finally:
            dist.destroy_process_group()
    return out


def _dry_counts(arch) -> dict:
    mesh = _fake_mesh(0)
    try:
        coll = dryrun.count_collectives(ranks.config(arch), "train", mesh, multi_pod=False,
                                        batch=ranks.B, seq_len=ranks.S)
    finally:
        dist.destroy_process_group()
    return {op: v["count"] for op, v in coll.items() if op != "total" and v["count"]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    assert not dist.is_initialized()
    run_dir = tmp_path_factory.mktemp("sharded")
    t0 = time.perf_counter()
    jparams = {}
    here = {"ref": {}, "plan_bytes": {}, "dry_counts": {}}
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = mp.start_processes(ranks.main, args=(WORLD, str(run_dir)), nprocs=WORLD,
                               join=False, start_method="spawn")
    try:
        # While the ranks start: the reference's parameters (its init_params
        # under jit), handed over an architecture at a time.
        for arch in ARCHS:
            cfg = _jcfg(arch)
            p = jax.jit(lambda key, c=cfg: jtfm.init_params(key, c))(jax.random.PRNGKey(0))
            jparams[arch, "float32"] = p
            with open(run_dir / "params.part", "wb") as f:
                pickle.dump(jax.tree.map(lambda a: np.asarray(a, np.float32), p), f)
            os.replace(run_dir / "params.part", run_dir / f"params-{arch}.pkl")
        # The bf16 model: the same weights rounded once, as its init rounds them.
        jparams[ranks.BF16, "bfloat16"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                                       jparams[ranks.BF16, "float32"])
        # While they run: the reference's logits, the dry-run's counts.
        for (arch, dtype), p in jparams.items():
            batch = {k: jnp.asarray(v) for k, v in
                     jmake_batch(_jcfg(arch, dtype), JBatchSpec(ranks.B, ranks.S), seed=1).items()}
            logits, _ = jax.jit(lambda p_, b_, c=_jcfg(arch, dtype): jtfm.forward_train(
                p_, c, b_))(p, batch)
            here["ref"][arch, dtype] = np.asarray(logits.astype(jnp.float32))
        for arch in ARCHS:
            here["plan_bytes"][arch] = _plan_bytes(arch)
            here["dry_counts"][arch] = _dry_counts(arch)
        t_parent = time.perf_counter() - t0
        while not procs.join(timeout=1):
            if time.perf_counter() - t0 > 600:
                raise TimeoutError("the ranks did not finish in 600 s")
    finally:
        torch.set_num_threads(torch_threads)
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    assert not dist.is_initialized()
    here["ranks"] = [torch.load(run_dir / f"rank{r}.pt") for r in range(WORLD)]
    here["one"] = {r["one"]["arch"]: r["one"] for r in here["ranks"]}
    here["one_launcher"] = {r["one_launcher"]["arch"]: r["one_launcher"]["losses"]
                            for r in here["ranks"]}
    here["seconds"] = time.perf_counter() - t0
    print("sharded run", here["seconds"], [r["seconds"] for r in here["ranks"]], t_parent)
    return here


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_reference(run, arch):
    got = run["ranks"][0][arch]["logits"].numpy()
    want = run["ref"][arch, "float32"]
    diff = np.abs(got - want)
    assert float(diff.max()) <= 1e-4 * float(np.abs(want).max()), float(diff.max())
    if "moe" in arch:  # the reference test's own bounds for a routed model
        assert float(diff.mean()) < 0.02 and float((diff > 0.2).mean()) < 0.02


def test_sharded_bf16_forward_matches_reference(run):
    got = run["ranks"][0]["bf16_logits"].float().numpy()
    want = run["ref"][ranks.BF16, "bfloat16"]
    assert float(np.abs(got - want).max()) < 0.15


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_device(run, arch, microbatches):
    key = f"train{microbatches}"
    _check_train(run["ranks"][0][arch][key], run["one"][arch][key])


def _check_train(got, want):
    for name, value in want["metrics"].items():
        assert abs(got["metrics"][name] - value) <= RTOL * max(abs(value), 1e-30), name
    lr = ranks.OPT["lr"]
    for path in want["params"]:
        for moment in ("mu", "nu"):
            assert _norm_rel(got[moment][path], want[moment][path]) <= RTOL, (moment, path)
        mu = np.abs(want["mu"][path].numpy())
        clear = (mu > 1e-4 * mu.max()) & (mu / (1 - BETA1) > 1e3 * EPS)
        diff = np.abs(got["params"][path].float().numpy() - want["params"][path].float().numpy())
        scale = max(float(np.abs(want["params"][path].numpy()).max()), lr)
        assert float(diff[clear].max(initial=0.0)) <= RTOL * scale, path
        assert float(diff.max()) <= 2 * lr, path


def test_sharded_train_step_with_the_group_axis_over_data(run):
    """FSDP at ``min_elements=1 << 10`` puts smoke mamba2-1.3b's group axis
    over ``data`` (each data rank holds one of its 2 groups): the step
    equals the one-device step as the builder's plan does."""
    got = run["ranks"][0][ranks.GROUP_FSDP]["train_group_fsdp"]
    assert "blocks/[0]/mamba/conv_x_b" in got["group_sharded"]
    _check_train(got, run["one"][ranks.GROUP_FSDP]["train1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_one_device(run, arch):
    got = run["ranks"][0][arch]["serve"]
    want = run["one"][arch]["serve"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("arch,axes", [("internlm2-1.8b", "data"),
                                       ("recurrentgemma-9b", ("data", "model"))])
def test_context_parallel_decode_matches_one_device(run, arch, axes):
    """Batch 1: the decode caches' slots split over data (and over model
    where the one KV head does not split), merged by lse, never gathered."""
    got = run["ranks"][0][arch]["context_parallel"]
    assert got["seq_axes"] == axes
    assert len(got["sharded"]) == len(got["one"]) == 2
    for g, w in zip(got["sharded"], got["one"]):
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_on_the_groups_mesh_matches_one_rank(run, arch):
    want = run["one_launcher"][arch]
    for r in range(WORLD):
        got = run["ranks"][r]["launcher"][arch]
        assert len(got) == len(want) == 2
        # The first step's loss is the same function; the second follows one
        # AdamW update, which moves a weight whose gradient sits at float32
        # noise by up to lr either way (see the train step's test).
        assert abs(got[0] - want[0]) <= RTOL * abs(want[0])
        assert abs(got[1] - want[1]) <= 1e-3 * abs(want[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_bytes_are_the_plans(run, arch):
    for r in range(WORLD):
        res = run["ranks"][r][arch]["train1"]
        assert (res["params_bytes"], res["opt_bytes"]) == run["plan_bytes"][arch][r]
    # and the plan does shard: a rank holds less than the whole.
    cfg = ranks.config(arch)
    model = ttfm.init_params(cfg, device="meta")
    whole = sum(t.numel() * t.element_size() for t in dryrun.stacked_params(cfg, model).values())
    assert run["ranks"][0][arch]["train1"]["params_bytes"] < whole


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_counted_on_the_group_equal_the_dry_runs(run, arch):
    want = run["dry_counts"][arch]
    assert want
    for r in range(WORLD):
        assert run["ranks"][r][arch]["train1"]["comm"] == want, r
