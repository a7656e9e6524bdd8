"""Sharded execution's pieces that need no process of their own, on the CPU.

* The plan's stacked specs turned into each layer's: `execute.place_params`
  holds every leaf at its stacked spec, a block leaf built from the port's
  per-layer tensors, and equals the stacked reference leaf's shard at that
  spec on each rank of a fake (2, 2) group; with FSDP at
  ``min_elements=1 << 10`` (as `tests/test_sharding.py` applies it) smoke
  mamba2-1.3b's 2-group leaves shard their group axis over ``data``, each
  data rank holds its own run of groups, and a rank's bytes are the
  dry-run's count of the plan's bytes for that rank.
* The merge by log-sum-exp of context-parallel decode: a cache cut into 2
  and 4 runs of slots (a wrapped ring, a window, a softcap), each run
  through the plain `decode_attention` with ``return_lse``, merged by
  `attention.merge_by_lse`, against the reference's `decode_attention_ref`
  over the whole cache within 2e-5; the plain lse against a direct
  logsumexp of the masked scores.
* `execute.microbatch_rows`: for B/M >= D the order it always gave; for
  grok-1-314b's B 256, M 32 over 16 and 32 data ranks a permutation whose
  every micro-batch takes one row from each rank of one contiguous
  sub-group; a B/M that neither is a multiple of D nor divides it raises
  naming B, M and D.  `execute.microbatch_mesh` on a fake 2x16x16 group:
  sub-group ``g`` is batch ranks ``8g`` to ``8g + 7``, pod-major.
* The ``tp`` flag `_Layers` gives a sub-module: set for grok-style
  tensor-parallel experts (3 experts over a model axis of 2) as for
  expert-parallel ones.
* `device.resolve_device` in a process group on a host with several
  cards: ``LOCAL_RANK``'s card; with one card ``cuda:0``; without a card
  it raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.kernels import ref
from repro_torch import device as tdevice
from repro_torch.configs import get_config, smoke_variant
from repro_torch.interop import param_leaves, plain_shapes
from repro_torch.kernels import decode_attention as decode
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import merge_by_lse
from repro_torch.sharding import execute
from repro_torch.sharding import specs as sh


@pytest.fixture
def fake_mesh():
    """A (2, 2) ("data", "model") mesh on torch's fake backend, as rank
    ``rank`` (set by the test through the returned function)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    made = []

    def make(rank: int):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        made.append(rank)
        return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _stacked(cfg, model) -> dict:
    return {p: leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))
            for p, leaf in param_leaves(cfg, model).items()}


@pytest.mark.parametrize("arch,min_elements", [("mamba2-1.3b", 1 << 10),
                                               ("qwen3-moe-30b-a3b", 1 << 16),
                                               ("recurrentgemma-9b", 1 << 10)])
@pytest.mark.parametrize("rank", [0, 3])
def test_layers_take_their_stacked_leaf_shards(arch, min_elements, rank, fake_mesh):
    cfg = smoke_variant(get_config(arch))
    model = tfm.init_params(cfg, seed=0, device="cpu")
    specs = sh.apply_fsdp(sh.param_specs(model, cfg, model_axis=2), plain_shapes(cfg, model),
                          axis_size=2, min_elements=min_elements)
    mesh = fake_mesh(rank)
    placed = execute.place_params(cfg, model, specs, mesh)
    stacked = _stacked(cfg, model)
    group_sharded = [p for p, spec in specs.items() if "blocks/" in p and spec[0] == "data"]
    if arch == "mamba2-1.3b":
        assert "blocks/[0]/mamba/conv_x_b" in group_sharded, specs
    for path, dt in placed.items():
        spec = execute._pad(specs[path], stacked[path].dim())
        assert dt.shape == stacked[path].shape
        assert torch.equal(dt.to_local(), execute.local_slice(stacked[path], spec, mesh)), path
        if path in group_sharded:
            # This data rank's run of groups, and layer i is row i // n of it.
            groups = execute.owned_groups(cfg.num_groups, spec, mesh)
            assert len(groups) == cfg.num_groups // 2
            assert groups.start == mesh.get_local_rank("data") * len(groups)
            n = len(cfg.layer_pattern)
            slot = int(path.split("/")[1][1:-1])
            name = path.split("/", 2)[2].replace("/", ".")
            for g in groups:
                layer = model.blocks[g * n + slot].get_parameter(name)
                assert torch.equal(dt.to_local()[g - groups.start],
                                   execute.local_slice(layer, spec[1:], mesh))
    # The rank's bytes are the dry-run's count of the plan's bytes.
    assert execute.resident_bytes(placed) == dryrun.place(
        dryrun.stacked_params(cfg, tfm.init_params(cfg, device="meta")), specs, mesh)


def test_layer_spec_drops_the_group_entry_and_caches_follow_their_slot(fake_mesh):
    cfg = smoke_variant(get_config("recurrentgemma-9b"))
    mesh = fake_mesh(1)
    assert execute.layer_spec((None, "data", "model")) == ("data", "model")
    cspecs = sh.cache_specs(cfg, 4, multi_pod=False, n_data=2, model_axis=2,
                            context_parallel=False, decode=True)
    caches = tfm.init_serve_cache(cfg, 4, 32, device="cpu")
    placed = execute.place_caches(caches, cspecs, cfg, mesh)
    n = len(cfg.layer_pattern)
    for i, c in enumerate(placed):
        for key, dt in c.items():
            assert execute._spec_of(dt) == execute._pad(execute.layer_spec(cspecs[i % n][key]),
                                                        dt.dim())
    # kv 1 does not split over model 2: decode splits the attention slots.
    attn = next(c for c in placed if "pos" in c)
    slots = attn["k"].shape[1]
    assert attn["k"].to_local().shape[1] == slots // 2
    assert attn["pos"].to_local().shape == (slots // 2,)


def _rows_before(batch, shards, microbatches):
    """`microbatch_rows` as it was before micro-batches could be smaller
    than the data axis."""
    per = batch // shards
    n = per // microbatches
    return [s * per + i * n + j for i in range(microbatches)
            for s in range(shards) for j in range(n)]


@pytest.mark.parametrize("batch,shards,microbatches", [(4, 2, 1), (4, 2, 2), (8, 4, 2),
                                                       (256, 16, 8), (256, 32, 8),
                                                       (256, 16, 16)])
def test_microbatch_rows_unchanged_where_a_microbatch_spans_every_shard(batch, shards,
                                                                        microbatches):
    assert execute.microbatch_groups(batch, shards, microbatches) == 1
    assert execute.microbatch_rows(batch, shards, microbatches) == _rows_before(
        batch, shards, microbatches)


@pytest.mark.parametrize("batch,shards,microbatches", [(256, 16, 32), (256, 32, 32),
                                                       (8, 4, 4), (4, 2, 4)])
def test_microbatch_rows_spread_a_microbatch_over_a_sub_group(batch, shards, microbatches):
    rows = execute.microbatch_rows(batch, shards, microbatches)
    assert sorted(rows) == list(range(batch))
    n, per = batch // microbatches, batch // shards
    groups = execute.microbatch_groups(batch, shards, microbatches)
    assert groups == shards // n > 1
    for i in range(microbatches):
        mine = rows[i * n:(i + 1) * n]
        owners = [r // per for r in mine]
        # one row from each of n consecutive shards, starting on a sub-group
        assert owners == list(range(owners[0], owners[0] + n)) and owners[0] % n == 0
        # local step j = i // G takes row j of each rank
        assert {r % per for r in mine} == {i // groups}


@pytest.mark.parametrize("batch,shards,microbatches", [(12, 8, 4), (256, 24, 32), (12, 4, 2),
                                                       (8, 4, 3)])
def test_microbatch_groups_refuse_rows_that_cut_neither_way(batch, shards, microbatches):
    with pytest.raises(ValueError, match=rf"B {batch} .* M {microbatches} .* D {shards} "):
        execute.microbatch_groups(batch, shards, microbatches)


@pytest.mark.parametrize("rank", [0, 307, 511])
def test_microbatch_mesh_cuts_the_batch_ranks_pod_major(rank):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=512)
    try:
        mesh = init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
        sub = execute.microbatch_mesh(mesh, ("pod", "data"), 4)
        assert sub.mesh_dim_names == (execute.SIDE_BY_SIDE, execute.WITHIN, "model")
        assert tuple(sub.mesh.shape) == (4, 8, 16)
        batch_rank = mesh.get_local_rank("pod") * 16 + mesh.get_local_rank("data")
        assert sub.get_local_rank(execute.SIDE_BY_SIDE) == batch_rank // 8
        assert sub.get_local_rank(execute.WITHIN) == batch_rank % 8
        assert sub.get_local_rank("model") == mesh.get_local_rank("model")
        # a sub-group lies inside one pod
        within = sub.mesh[batch_rank // 8, :, mesh.get_local_rank("model")]
        assert len({int(r) // 256 for r in within}) == 1
        with pytest.raises(ValueError, match="do not lead"):
            execute.microbatch_mesh(mesh, ("data",), 2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("num_experts", [3, 4])
def test_layers_flag_tensor_and_expert_parallel_experts(num_experts, fake_mesh):
    """3 experts do not divide the model axis of 2: each rank holds its
    columns of every expert (grok-1-314b's plan), 4 do: each holds 2
    experts.  Either way the experts' partial outputs are summed over
    ``model`` (``tp``)."""
    import dataclasses

    from repro_torch.sharding import parallel

    cfg = dataclasses.replace(smoke_variant(get_config("grok-1-314b")),
                              num_experts=num_experts)
    model = tfm.init_params(cfg, seed=0, device="cpu")
    specs = sh.param_specs(model, cfg, model_axis=2)
    mesh = fake_mesh(1)
    placed = execute.place_params(cfg, model, specs, mesh)
    layers = execute._Layers(cfg, {p: dt.to_local() for p, dt in placed.items()}, specs,
                             parallel.Parallel(mesh, batch_dims=("data",)))
    moe = layers.group(0)[0].moe
    assert moe.tp
    tensor_parallel = num_experts % 2 != 0
    assert moe.up.shape[0] == (num_experts if tensor_parallel else num_experts // 2)
    assert moe.down.shape[1] == (cfg.d_ff // 2 if tensor_parallel else cfg.d_ff)


def _ring_positions(cache_len, cur):
    slots = np.arange(cache_len)
    last = cur - (cur - slots) % cache_len
    return np.where(last >= 0, last, -1).astype(np.int32)


MERGE_CASES = [  # (b, kv, r, d, L, cur, window, softcap)
    (2, 2, 4, 64, 64, 150, 48, 50.0),
    (1, 1, 16, 64, 128, 100, None, None),
    (3, 2, 2, 128, 96, 95, 40, None),
]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_runs_of_slots_merged_by_lse_equal_the_whole_cache(case, shards):
    b, kv, r, d, L, cur, window, softcap = case
    rng = np.random.RandomState(L + shards)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, kv, r, d), (b, L, kv, d), (b, L, kv, d)))
    pos = _ring_positions(L, cur)
    outs, lses = [], []
    per = L // shards
    for i in range(shards):
        sl = slice(i * per, (i + 1) * per)
        o, lse = decode.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()), torch.from_numpy(v[:, sl].copy()),
            torch.from_numpy(pos[sl].copy()), cur, window=window, logit_softcap=softcap,
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    got, lse = merge_by_lse(torch.stack(outs), torch.stack(lses))
    want = ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), jnp.asarray(cur, jnp.int32),
                                    window=window, logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    whole = decode.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos), cur,
                                    window=window, logit_softcap=softcap, return_lse=True)[1]
    np.testing.assert_allclose(lse.numpy(), whole.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", MERGE_CASES)
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(case):
    b, kv, r, d, L, cur, window, softcap = case
    rng = np.random.RandomState(L)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, kv, r, d), (b, L, kv, d), (b, L, kv, d)))
    pos = torch.from_numpy(_ring_positions(L, cur))
    out, lse = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap,
                                       return_lse=True)
    assert torch.equal(out, decode.decode_attention(q, k, v, pos, cur, window=window,
                                                    logit_softcap=softcap))
    s = torch.einsum("bgrd,blgd->bgrl", q.double(), k.double()) * d ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = (pos >= 0) & (pos <= cur)
    if window is not None:
        valid &= pos > cur - window
    want = torch.logsumexp(s[..., valid], dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, kv, r)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_default_card_is_the_local_rank_on_a_host_with_several(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.resolve_device() == torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.resolve_device() == torch.device("cuda", 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.resolve_device() == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tdevice.KernelError, match="no CUDA device"):
        tdevice.resolve_device()
