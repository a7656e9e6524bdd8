"""The port's dry-run on the CPU: placement on meta under a fake group.

`repro_torch.launch.dryrun.run_one` on one combination of each step kind
(qwen3-moe-30b-a3b train_4k on 16x16, gemma2-2b long_500k on 2x16x16,
yi-34b decode_32k on 16x16), without saving: the record's fields, the
parameter bytes per device equal to the sum over the reference's leaves
of JAX's shard shape on an ``AbstractMesh`` times the item size (under the
reference's own plan: FSDP for train, `needs_fsdp` otherwise), and no
process group left initialized; the collectives the step issues on meta
shards under the fake group, counted and fed into the roofline's
collective term.
"""
import math

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import NamedSharding

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.mesh import MESH_SHAPES
from repro.models import transformer as jtfm
from repro.sharding import specs as jsh
from repro_torch.launch import dryrun

COMBOS = [("qwen3-moe-30b-a3b", "train_4k", False), ("gemma2-2b", "long_500k", True),
          ("yi-34b", "decode_32k", False)]


def _reference_param_bytes(arch, kind, multi_pod) -> int:
    cfg = jconfigs.get_config(arch)
    shape, axes = MESH_SHAPES[multi_pod]
    sizes = dict(zip(axes, shape))
    params = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.PRNGKey(0))
    specs = jsh.param_specs(params, cfg, model_axis=sizes["model"])
    if kind == "train" or jsteps.needs_fsdp(cfg, model_axis=sizes["model"]):
        specs = jsh.apply_fsdp(specs, params, fsdp_axes=("data",), axis_size=sizes["data"])
    mesh = jax.sharding.AbstractMesh(shape, axes)
    leaves = jax.tree.leaves(params)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, spec_leaves, strict=True))


@pytest.mark.parametrize("arch,shape,multi_pod", COMBOS)
def test_run_one_records_per_device_bytes(arch, shape, multi_pod):
    assert not dist.is_initialized()
    rec = dryrun.run_one(arch, shape, multi_pod, save=False)
    assert not dist.is_initialized()
    seq_len, batch, kind = jsteps.SHAPES[shape]
    cfg = jconfigs.get_config(arch)
    n_chips = 512 if multi_pod else 256
    assert rec["shape"] == shape and rec["kind"] == kind and rec["n_chips"] == n_chips
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert (rec["seq_len"], rec["batch"]) == (seq_len, batch)
    assert rec["params"] == cfg.param_count() and rec["active_params"] == cfg.active_param_count()
    assert rec["arch"] == arch  # gemma2-2b runs long_500k natively: no -sw variant
    b = rec["bytes_per_device"]
    assert b["params"] == _reference_param_bytes(arch, kind, multi_pod)
    assert b["total"] == b["params"] + b["opt"] + b["batch"] + b["caches"]
    if kind == "train":
        assert b["opt"] > 2 * b["params"] and b["caches"] == 0 and rec["microbatches"] == 8
    else:
        assert b["opt"] == 0 and b["caches"] > 0 and rec["microbatches"] is None
    assert rec["fits_device"] == (b["total"] <= 80e9)
    tokens = batch * (1 if kind == "decode" else seq_len)
    assert rec["model_flops"] == 6.0 * cfg.active_param_count() * tokens * (
        3 if kind == "train" else 1)
    terms = rec["roofline"]
    assert terms["compute_s"] == pytest.approx(rec["model_flops"] / n_chips / 989e12)
    assert terms["memory_s"] == pytest.approx(b["total"] / 3.35e12)
    coll = rec["collectives"]
    assert coll["total"]["count"] == sum(v["count"] for k, v in coll.items() if k != "total")
    assert coll["total"]["count"] > 0 and coll["total"]["bytes"] > 0
    assert terms["collective_s"] == pytest.approx(coll["total"]["bytes"] / 450e9)
    assert rec["temp"] is None and rec["temp_reason"]


def test_run_one_refuses_an_initialized_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="one is initialized"):
            dryrun.run_one("gemma2-2b", "decode_32k", False, save=False)
    finally:
        dist.destroy_process_group()
