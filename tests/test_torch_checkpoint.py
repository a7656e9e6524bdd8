"""The port's checkpoints in the reference's file format, on the CPU.

`repro_torch.train.checkpoint` writes the reference's ``.npz`` (arrays
keyed by the parameter pytree's ``/``-joined paths, bf16 as float32) and
``.manifest.json``.  A model saved by the port restores through the
reference's ``restore`` and the other way round, with equal arrays (exact:
bf16 widens to float32 without rounding); shapes and missing leaves raise
as in the reference.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro.train import checkpoint as jckpt
from repro_torch import configs as tconfigs
from repro_torch.interop import flatten_plain, params_to_plain
from repro_torch.models import transformer as ttfm
from repro_torch.train import checkpoint as tckpt

ARCHS = ["gemma2-2b", "internlm2-1.8b", "llava-next-mistral-7b", "mamba2-1.3b",
         "recurrentgemma-9b", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small models' ops are a few ms each, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(arch, seed):
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    return cfg, ttfm.init_params(cfg, seed=seed, device="cpu")


def _flat(cfg, model):
    return flatten_plain(params_to_plain(cfg, model))


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip(tmp_path, arch):
    cfg, model = _port_model(arch, 1)
    path = str(tmp_path / "ckpt")
    tckpt.save(path, model, metadata={"arch": cfg.name}, cfg=cfg)
    manifest = json.loads((tmp_path / "ckpt.manifest.json").read_text())
    assert manifest["metadata"] == {"arch": cfg.name}
    assert set(manifest["dtypes"]) == set(_flat(cfg, model))
    _, like = _port_model(arch, 2)
    restored = tckpt.restore(path, like, cfg=cfg)
    for (name, a), (_, b) in zip(model.named_parameters(), restored.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    path = str(tmp_path / "ckpt")
    tckpt.save(path, {"w": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError):
        tckpt.restore(path, {"w": np.zeros((4, 5), np.float32)})
    with pytest.raises(KeyError):
        tckpt.restore(path, {"w": np.zeros((4, 4), np.float32), "b": np.zeros(4, np.float32)})
    cfg, model = _port_model("internlm2-1.8b", 0)
    tckpt.save(path, model, cfg=cfg)
    wider = tconfigs.smoke_variant(tconfigs.get_config("gemma2-2b"))
    with pytest.raises((KeyError, ValueError)):
        tckpt.restore(path, ttfm.init_params(wider, seed=0, device="cpu"), cfg=wider)


def test_plain_tree_round_trip_keeps_types(tmp_path):
    path = str(tmp_path / "tree.npz")
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "blocks": ({"w": np.ones((2, 2), np.float32)},)}
    tckpt.save(path, tree)
    back = tckpt.restore(path, tree)
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], tree["a"])
    assert isinstance(back["blocks"], tuple)
    np.testing.assert_array_equal(back["blocks"][0]["w"], tree["blocks"][0]["w"])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_restores_through_the_reference(tmp_path, arch):
    cfg, model = _port_model(arch, 3)
    path = str(tmp_path / "ckpt")
    tckpt.save(path, model, metadata={"arch": cfg.name}, cfg=cfg)
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    # The reference's tree of zeros (its structure and types, no init run).
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg)))
    restored = jckpt.restore(path, like)
    want = _flat(cfg, model)
    got = flatten_plain(jax.tree.map(lambda a: np.asarray(a, np.float32), restored))
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert all(a.dtype == b.dtype for a, b in zip(jax.tree.leaves(restored),
                                                   jax.tree.leaves(like)))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_save_restores_through_the_port(tmp_path, arch):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    params = jtfm.init_params(jax.random.PRNGKey(4), jcfg)
    path = str(tmp_path / "ckpt")
    jckpt.save(path, params, metadata={"arch": jcfg.name})
    cfg, like = _port_model(arch, 0)
    restored = tckpt.restore(path, like, cfg=cfg)
    want = flatten_plain(jax.tree.map(lambda a: np.asarray(a, np.float32), params))
    got = _flat(cfg, restored)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for (name, a), (_, b) in zip(like.named_parameters(), restored.named_parameters()):
        assert a.dtype == b.dtype, name
