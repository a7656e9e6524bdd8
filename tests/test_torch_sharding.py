"""The port's sharding plan against the reference's, leaf by leaf, on the CPU.

`repro_torch.sharding.specs` against `repro.sharding.specs` for all ten
configurations at full size: the reference's parameter shapes from
``jax.eval_shape`` of its ``init_params``, the port's from its meta init.
A port spec is a plain tuple, so it compares equal to ``tuple(P)`` of the
reference's, the stacked leaves' group entry included.  Under a fake
2x16x16 process group (torch's ``"fake"`` backend: no devices), every
placed leaf's local shape equals JAX's shard shape of the same spec on an
``AbstractMesh`` of the same axes.
"""
import functools

import jax
import pytest
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.sharding import specs as jsh
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke_variant as tsmoke_variant
from repro_torch.interop import plain_shapes
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import specs as tsh

MODEL_AXIS = 16


def _is_spec(s):
    return isinstance(s, P)


def flat_specs(tree, leaf=tuple) -> dict:
    """``{path: tuple(P)}`` of a reference spec tree (``leaf`` of each leaf
    of another tree), paths as `repro_torch.interop.flatten_plain` writes
    them."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]:
        key = "/".join(str(e.key) if hasattr(e, "key") else f"[{e.idx}]" for e in path)
        out[key] = leaf(spec)
    return out


@functools.cache
def _ref_shapes(arch, smoke=False):
    cfg = jconfigs.get_config(arch)
    cfg = jconfigs.smoke_variant(cfg) if smoke else cfg
    return cfg, jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.PRNGKey(0))


@functools.cache
def _port_model(arch, smoke=False):
    cfg = tget_config(arch)
    cfg = tsmoke_variant(cfg) if smoke else cfg
    return cfg, ttfm.init_params(cfg, device="meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_fsdp_equal_reference(arch):
    """Every leaf's spec at model axis 16, then FSDP at axis 16: equal to
    the reference's ``tuple(P)``, the group entry included (mamba2-1.3b's
    group-axis shards, and block leaves sharded although one layer's
    tensor is under ``min_elements``)."""
    jcfg, jparams = _ref_shapes(arch)
    tcfg, model = _port_model(arch)
    shapes = plain_shapes(tcfg, model)
    assert shapes == flat_specs(jparams, leaf=lambda a: tuple(a.shape))
    want = jsh.param_specs(jparams, jcfg, model_axis=MODEL_AXIS)
    got = tsh.param_specs(model, tcfg, model_axis=MODEL_AXIS)
    assert got == flat_specs(want)
    want_fsdp = jsh.apply_fsdp(want, jparams, axis_size=MODEL_AXIS)
    got_fsdp = tsh.apply_fsdp(got, shapes, axis_size=MODEL_AXIS)
    assert got_fsdp == flat_specs(want_fsdp)
    if arch == "mamba2-1.3b":
        group_sharded = [p for p, s in got_fsdp.items() if p.startswith("blocks") and s[0]]
        assert len(group_sharded) == 3, group_sharded


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_equal_reference(arch):
    """`train_batch_specs`, `decode_input_specs` and `cache_specs` for
    both meshes, batch sizes that shard and that do not, with
    context_parallel and decode on and off."""
    jcfg, tcfg = jconfigs.get_config(arch), tget_config(arch)
    for multi_pod in (False, True):
        assert tsh.data_axes(multi_pod) == jsh.data_axes(multi_pod)
        got = tsh.train_batch_specs(tcfg, multi_pod=multi_pod)
        assert got == {k: tuple(v) for k, v in
                       jsh.train_batch_specs(jcfg, multi_pod=multi_pod).items()}
        for batch in (1, 32, 128):
            got = tsh.decode_input_specs(tcfg, batch, multi_pod=multi_pod, n_data=16)
            want = jsh.decode_input_specs(jcfg, batch, multi_pod=multi_pod, n_data=16)
            assert got == {k: tuple(v) for k, v in want.items()}
            for cp in (False, True):
                for decode in (False, True):
                    kw = dict(multi_pod=multi_pod, n_data=16, model_axis=MODEL_AXIS,
                              context_parallel=cp, decode=decode)
                    want = jsh.cache_specs(jcfg, batch, **kw)
                    got = tsh.cache_specs(tcfg, batch, **kw)
                    assert got == tuple({k: tuple(v) for k, v in slot.items()}
                                        for slot in want)


# ---- the cases of tests/test_sharding.py ------------------------------------


def _smoke_specs(arch, model_axis):
    jcfg, jparams = _ref_shapes(arch, smoke=True)
    tcfg, model = _port_model(arch, smoke=True)
    return (flat_specs(jsh.param_specs(jparams, jcfg, model_axis=model_axis)),
            tsh.param_specs(model, tcfg, model_axis=model_axis))


def test_attention_tensor_parallel():
    want, got = _smoke_specs("internlm2-1.8b", 2)
    assert got == want
    assert got["blocks/[0]/attn/wq"] == (None, None, "model")
    assert got["blocks/[0]/attn/wo"] == (None, "model", None)
    assert got["blocks/[0]/mlp/up"] == (None, None, "model")
    assert got["blocks/[0]/mlp/down"] == (None, "model", None)
    assert got["blocks/[0]/ln1"] == (None, None)


def test_moe_expert_parallel_when_divisible():
    want, got = _smoke_specs("qwen3-moe-30b-a3b", 2)  # 4 experts % 2 == 0
    assert got == want and got["blocks/[0]/moe/up"] == (None, "model", None, None)
    want3, got3 = _smoke_specs("qwen3-moe-30b-a3b", 3)  # 4 % 3 != 0, 512 % 3 != 0
    assert got3 == want3 and got3["blocks/[0]/moe/up"] == (None, None, None, None)


def test_divisibility_guard():
    want, got = _smoke_specs("mamba2-1.3b", 7)  # nothing divides 7
    assert got == want and got["embed"] == (None, None, None)


def test_fsdp_adds_data_axis_to_large_leaves():
    jcfg, jparams = _ref_shapes("yi-34b", smoke=True)
    tcfg, model = _port_model("yi-34b", smoke=True)
    want = jsh.apply_fsdp(jsh.param_specs(jparams, jcfg, model_axis=2), jparams,
                          fsdp_axes=("data",), axis_size=2, min_elements=1 << 10)
    specs = tsh.param_specs(model, tcfg, model_axis=2)
    got = tsh.apply_fsdp(specs, plain_shapes(tcfg, model), fsdp_axes=("data",), axis_size=2,
                         min_elements=1 << 10)
    assert got == flat_specs(want)
    assert "data" in got["embed"]
    assert got["final_norm"] == specs["final_norm"]


def test_cache_specs_context_parallel():
    cfg = tsmoke_variant(tget_config("gemma2-2b"))
    specs = tsh.cache_specs(cfg, batch=1, multi_pod=False, n_data=4, model_axis=2,
                            context_parallel=True)
    assert specs[0]["k"][2] == "data"  # sequence sharded
    specs_b = tsh.cache_specs(cfg, batch=8, multi_pod=False, n_data=4, model_axis=2,
                              context_parallel=False)
    assert specs_b[0]["k"][1] == "data"  # batch sharded


# ---- placements ----------------------------------------------------------------


@pytest.fixture
def fake_group():
    """A fake process group of 512 ranks, destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    yield
    tmesh.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "yi-34b"])
def test_local_shapes_equal_jax_shard_shapes(arch, fake_group):
    """The train plan (FSDP on) placed on the 2x16x16 mesh of a fake
    group: rank 0's local shape of every stacked leaf equals
    ``NamedSharding(AbstractMesh, P).shard_shape``."""
    from torch.distributed.tensor import distribute_tensor

    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    (shape, axes) = tmesh.MESH_SHAPES[True]
    abstract = jax.sharding.AbstractMesh(shape, axes)
    tcfg, model = _port_model(arch)
    specs = tsh.apply_fsdp(tsh.param_specs(model, tcfg, model_axis=16),
                           plain_shapes(tcfg, model), axis_size=16)
    for path, leaf in dryrun.stacked_params(tcfg, model).items():
        local = distribute_tensor(leaf, mesh, tsh.placements(specs[path], mesh)).to_local()
        want = NamedSharding(abstract, P(*specs[path])).shard_shape(tuple(leaf.shape))
        assert tuple(local.shape) == tuple(want), path


def test_placements_of_composite_and_bad_specs(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tsh.placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        tsh.placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="not all on mesh"):
        tsh.placements(("expert",), mesh)
