"""The port's step builders against the reference's, on the CPU.

`repro_torch.launch.steps` against `repro.launch.steps`: the shapes table,
the FSDP rule and the abstract batches for every configuration; one train
step with gradient accumulation (M = 2) of smoke internlm2-1.8b and
mamba2-1.3b in float32 against the reference's `make_train_setup` step on
a (1, 1) mesh (loss, parts and grad norm within 1e-4 relative; every
updated parameter within 1e-4 absolute, as `tests/test_torch_train.py`
holds its weights: Adam's first step moves each element by lr times
g / (|g| + eps), so where |g| is near the float32 noise of the two
packages' different sum orders a weight may move by a few percent of
lr = 1e-3 more or less); M = 2 against M = 1 in the port; the
gradients' type AdamW gets; the prefill and decode builders against
direct calls; and that a step over more than one rank runs (on meta
shards under a fake group).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.data import BatchSpec as JBatchSpec
from repro.data import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke_variant as tsmoke_variant
from repro_torch.data import BatchSpec, make_batch
from repro_torch.interop import flatten_plain, param_leaves, params_from_plain, params_to_plain
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop
from repro_torch.train.train_loop import batch_to_device

RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def local_mesh():
    """The launcher's (1, 1) mesh on the CPU, its group destroyed after."""
    assert not dist.is_initialized()
    yield tmesh.make_local_mesh("cpu")
    tmesh.destroy_process_group()


def _close(got, want, what, absolute=False):
    """Within `RTOL` of ``want``'s largest magnitude (``absolute``: of 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = 1.0 if absolute else max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


def test_shapes_fsdp_and_abstract_batches_equal_reference():
    assert tsteps.SHAPES == jsteps.SHAPES
    for arch in ARCH_IDS:
        jcfg, tcfg = jconfigs.get_config(arch), tget_config(arch)
        for axis in (2, 16):
            assert tsteps.needs_fsdp(tcfg, model_axis=axis) == jsteps.needs_fsdp(
                jcfg, model_axis=axis), (arch, axis)
        for seq_len, batch, _ in jsteps.SHAPES.values():
            for labels in (False, True):
                want = jsteps.abstract_batch(jcfg, seq_len, batch, with_labels=labels)
                got = tsteps.abstract_batch(tcfg, seq_len, batch, with_labels=labels)
                assert list(got) == list(want), arch
                for k in want:
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == want[k].shape, (arch, k)
                    assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (arch, k)


def _smoke(arch):
    return dataclasses.replace(jconfigs.smoke_variant(jconfigs.get_config(arch)),
                               dtype="float32")


def _ref_step(cfg, params, batch, microbatches):
    # The reference launcher's local mesh (`repro/launch/train.py:52-56`).
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jitted, _, _ = jsteps.make_train_setup(
        cfg, mesh, multi_pod=False, batch=batch["tokens"].shape[0],
        seq_len=batch["tokens"].shape[1], opt_cfg=jopt.AdamWConfig(**OPT),
        microbatches=microbatches)
    state = {"params": params, "opt": jopt.init_opt_state(params)}
    with mesh:
        new, metrics = jitted(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return new["params"], {k: float(v) for k, v in metrics.items()}


def _port_step(cfg, plain, batch, mesh, microbatches):
    model = params_from_plain(cfg, plain, device="cpu")
    state = {"params": model, "opt": topt.init_opt_state(param_leaves(cfg, model))}
    step, _, _ = tsteps.make_train_setup(
        cfg, mesh, multi_pod=False, batch=batch["tokens"].shape[0],
        seq_len=batch["tokens"].shape[1], opt_cfg=topt.AdamWConfig(**OPT),
        microbatches=microbatches)
    state, metrics = step(state, batch_to_device(batch, "cpu"))
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b"])
def test_accumulated_train_step_matches_reference(arch, local_mesh):
    """M = 2 micro-batches of B 4 x S 32, float32: the loss, its parts, the
    grad norm and every parameter leaf after the AdamW update, against the
    reference's step."""
    cfg = _smoke(arch)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    plain = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    batch = jmake_batch(cfg, JBatchSpec(4, 32), seed=1)
    want_params, want = _ref_step(cfg, params, batch, microbatches=2)
    state, got = _port_step(cfg, plain, batch, local_mesh, microbatches=2)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    want_flat = flatten_plain(jax.tree.map(np.asarray, want_params))
    got_flat = flatten_plain(params_to_plain(cfg, state["params"]))
    assert list(got_flat) == list(want_flat)
    for path in want_flat:
        _close(got_flat[path], want_flat[path], path, absolute=True)


def test_two_micro_batches_equal_one_batch(local_mesh):
    """In float32, M = 2 gives M = 1's loss and grad norm (a dense model's
    mean cross entropy over two equal halves is the whole batch's)."""
    cfg = _smoke("internlm2-1.8b")
    plain = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         jtfm.init_params(jax.random.PRNGKey(0), cfg))
    batch = jmake_batch(cfg, JBatchSpec(4, 32), seed=2)
    one_state, one = _port_step(cfg, plain, batch, local_mesh, microbatches=1)
    two_state, two = _port_step(cfg, plain, batch, local_mesh, microbatches=2)
    for k in ("loss", "ce", "grad_norm", "lr"):
        _close(two[k], one[k], k)
    for a, b in zip(two_state["params"].parameters(), one_state["params"].parameters()):
        _close(a.detach(), b.detach(), "updated weight", absolute=True)


@pytest.mark.parametrize("microbatches,want", [(1, torch.bfloat16), (2, torch.float32)])
def test_adamw_gets_float32_sums_only_when_accumulating(microbatches, want, local_mesh,
                                                       monkeypatch):
    """bf16 weights: with M = 1 AdamW gets the gradients in bf16, with
    M = 2 their float32 sums over M, as the reference's step hands them."""
    seen = []
    real = train_loop.adamw_update

    def spy(opt_cfg, params, grads, state):
        seen.extend(g.dtype for leaf in grads.values()
                    for g in ([leaf] if isinstance(leaf, torch.Tensor) else leaf))
        return real(opt_cfg, params, grads, state)

    monkeypatch.setattr(train_loop, "adamw_update", spy)
    cfg = tsmoke_variant(tget_config("internlm2-1.8b"))
    assert cfg.dtype == "bfloat16"
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    state = {"params": model, "opt": topt.init_opt_state(param_leaves(cfg, model))}
    step, _, _ = tsteps.make_train_setup(cfg, local_mesh, multi_pod=False, batch=4,
                                         seq_len=16, microbatches=microbatches)
    step(state, batch_to_device(make_batch(cfg, BatchSpec(4, 16), seed=0), "cpu"))
    float32_leaves = {p.dtype for p in model.parameters()} - {torch.bfloat16}
    assert seen and set(seen) <= {want} | float32_leaves
    assert want in seen


def test_prefill_and_decode_builders_equal_direct_calls(local_mesh):
    cfg = tsmoke_variant(tget_config("gemma2-2b"))
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    batch, seq = 2, 16
    prefill, (pshape, abstract, cshape), (pspecs, bspecs, cspecs) = tsteps.make_prefill_setup(
        cfg, local_mesh, multi_pod=False, batch=batch, seq_len=seq)
    assert set(pspecs) == set(param_leaves(cfg, pshape)) and set(bspecs) == set(abstract)
    assert len(cshape) == cfg.num_layers and len(cspecs) == len(cfg.layer_pattern)
    decode, _, _ = tsteps.make_decode_setup(cfg, local_mesh, multi_pod=False, batch=batch,
                                            cache_len=seq + 4, long_context=False)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                               (batch, seq)))
    got_caches = ttfm.init_serve_cache(cfg, batch, seq + 4, device="cpu")
    want_caches = ttfm.init_serve_cache(cfg, batch, seq + 4, device="cpu")
    got, got_caches = prefill(model, {"tokens": tokens}, got_caches)
    want, want_caches = ttfm.forward_prefill(model, cfg, {"tokens": tokens}, want_caches)
    assert torch.equal(got, want)
    tok = got[:, -1:].argmax(-1)
    for pos in range(seq, seq + 2):
        got, got_caches = decode(model, tok, pos, got_caches)
        want, want_caches = ttfm.forward_decode(model, cfg, tok, pos, want_caches)
        assert torch.equal(got, want)
        tok = got.argmax(-1)


def test_steps_refuse_a_mesh_of_more_than_one_rank():
    """On a fake group of 2 ranks the builders give specs and abstract
    arguments, and their steps no longer refuse the mesh: each runs on its
    arguments placed at those specs (meta shards: under the fake group
    nothing is sent), the train step summing its gradients over ``data``.  The sharded steps' values
    are held against one device in `tests/test_torch_sharded.py`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.sharding import execute
    from repro_torch.sharding.parallel import CollectiveCounter

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = tmesh.make_local_mesh("cpu")
        assert tsteps.mesh_axes(mesh) == {"data": 2, "model": 1}
        cfg = tsmoke_variant(tget_config("internlm2-1.8b"))
        train, (state, batch), (state_specs, bspecs) = tsteps.make_train_setup(
            cfg, mesh, multi_pod=False, batch=4, seq_len=16)
        assert state["params"].embed.device.type == "meta"
        prefill, (params, pbatch, caches), (pspecs, pbspecs, cspecs) = (
            tsteps.make_prefill_setup(cfg, mesh, multi_pod=False, batch=2, seq_len=16))
        decode, (_, toks, _, dcaches), (_, dspecs, dcspecs) = tsteps.make_decode_setup(
            cfg, mesh, multi_pod=False, batch=2, cache_len=16, long_context=False)
        placed = execute.place_params(cfg, params, pspecs, mesh)
        calls = (
            lambda: train(execute.place_train_state(cfg, state["params"], state_specs, mesh,
                                                    opt=state["opt"]),
                          execute.place_tree(batch, bspecs, mesh)),
            lambda: prefill(placed, execute.place_tree(pbatch, pbspecs, mesh),
                            execute.place_caches(caches, cspecs, cfg, mesh)),
            lambda: decode(placed, execute.place(toks, dspecs["tokens"], mesh), 15,
                           execute.place_caches(dcaches, dcspecs, cfg, mesh)))
        with CollectiveCounter() as counter:
            _, metrics = calls[0]()
        # The gradients of the data-parallel ranks are summed.
        assert counter.counts["all_reduce"]["count"] > 0
        assert metrics["loss"].device.type == "meta"
        logits, _ = calls[1]()
        assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
        logits, _ = calls[2]()
        assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    finally:
        tmesh.destroy_process_group()
    assert not dist.is_initialized()


def test_step_refuses_tensors_off_the_mesh_device(local_mesh, monkeypatch):
    """A step's tensors must lie on the mesh's device: a CPU model on a
    ``"cuda"`` mesh is refused, not run on the CPU."""
    cfg = tsmoke_variant(tget_config("internlm2-1.8b"))
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    prefill, _, _ = tsteps.make_prefill_setup(cfg, local_mesh, multi_pod=False, batch=1,
                                              seq_len=8)
    monkeypatch.setattr(tsteps, "mesh_device", lambda mesh: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="the mesh on cuda:0"):
        prefill(model, {}, [])
