"""The port's training path against the JAX reference, on the CPU.

`repro_torch.train` (AdamW, the cosine schedule, the train step and loop)
and `repro_torch.models.transformer.loss_fn` against `repro.train` and
`repro.models.transformer.loss_fn`.  Weights come from the reference's
``init_params`` and cross with `params_from_plain`; gradients come back
with `param_leaves`, stacked as the reference stacks them.

Tolerances, all float32: the loss, ``ce`` and every gradient within 1e-4
relative to the largest magnitude of the compared quantity (a leaf's
largest |grad|); 5 train steps' losses within 1e-4 relative and final
weights within 1e-4 absolute (Adam's step moves by up to lr where a
gradient is near zero, whatever its relative error).
The two packages differ in the order of float32 sums only (the reference's
blocked online softmax against the port's plain attention, its XLA
reductions against torch's).  The optimizer on bf16 leaves may round a
weight to the neighbouring bf16 value, so bf16 weights are held to one
bf16 ulp (2^-7 relative) beside the float32 moments' 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import train as jtrain
from repro.data import BatchSpec as JBatchSpec
from repro.data import make_batch as jmake_batch
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro_torch import train as ttrain
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import smoke_variant as tsmoke_variant
from repro_torch.data import BatchSpec, make_batch
from repro_torch.interop import (flatten_plain, opt_state_from_plain, opt_state_to_plain,
                                 param_leaves, params_from_plain, params_to_plain)
from repro_torch.models import transformer as ttfm
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import batch_to_device

RTOL = 1e-4  # relative to the largest magnitude of each compared leaf


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small models' ops are a few ms each, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, **updates):
    cfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    return dataclasses.replace(cfg, dtype="float32", **updates)


@functools.cache
def _ref_params(cfg, seed=0):
    return jtfm.init_params(jax.random.PRNGKey(seed), cfg)


def _port_params(cfg, seed=0):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), _ref_params(cfg, seed))
    model = params_from_plain(cfg, tree, device="cpu")
    model.requires_grad_(True)
    return model


def _assert_leafwise_close(got: dict, want: dict, rtol=RTOL, what=""):
    assert list(got) == list(want)
    for path in want:
        w = np.asarray(want[path], np.float32)
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {path}: max err {err:.3g} vs scale {scale:.3g}"


def _port_grads_plain(cfg, model) -> dict:
    return {path: (leaf.grad.numpy() if isinstance(leaf, torch.Tensor)
                   else np.stack([p.grad.numpy() for p in leaf]))
            for path, leaf in param_leaves(cfg, model).items()}


def _loss_and_grads(cfg, batch):
    """(reference (total, ce, grads), port (total, ce, grads)), grads as
    ``{path: array}`` in the reference's leaf order."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jparts), jgrads = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, jb), has_aux=True)(_ref_params(cfg))
    model = _port_params(cfg)
    ttotal, tparts = ttfm.loss_fn(model, cfg, batch_to_device(batch, "cpu"))
    ttotal.backward()
    return ((float(jtotal), float(jparts["ce"]), flatten_plain(jgrads)),
            (ttotal.item(), tparts["ce"].item(), _port_grads_plain(cfg, model)))


# ---- optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 110), (0, 50), (3, 3)])
def test_cosine_lr_matches_reference(warmup, total):
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    tcfg = topt.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    for step in range(0, total + 12, 3):
        want = float(jopt.cosine_lr(cfg, jnp.asarray(step, jnp.int32)))
        got = float(topt.cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _opt_tree(rng, dtype):
    """A small tree with a top-level leaf and a stacked block leaf."""
    return {"embed": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": ({"w": rng.standard_normal((3, 4, 4)).astype(np.float32),
                        "ln": rng.standard_normal((3, 4)).astype(np.float32)},)}


@pytest.mark.parametrize("clip", [1.0, 1e9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clip):
    """Three updates of a tree of float32 or bf16 leaves, with gradients of
    norm near 10 (clipped to 1, or not): weights, moments, step, grad norm
    and lr."""
    rng = np.random.RandomState(3)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=clip)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                         torch.float32)
    tree = _opt_tree(rng, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    flat = flatten_plain(tree)

    def port_leaf(path, a):  # a stacked block leaf is one tensor per group
        if path.startswith("blocks/"):
            return [torch.from_numpy(r.copy()).to(tdt) for r in a]
        return torch.from_numpy(a.copy()).to(tdt)

    tparams = {path: port_leaf(path, a) for path, a in flat.items()}
    jstate, tstate = jopt.init_opt_state(jparams), topt.init_opt_state(tparams)
    for it in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 2.0,
                             tree)
        jgrads = jax.tree.map(lambda a: jnp.asarray(a, jdt), grads)
        tgrads = {path: port_leaf(path, a) for path, a in flatten_plain(grads).items()}
        jparams, jstate, jm = jopt.adamw_update(jcfg, jparams, jgrads, jstate)
        tparams, tstate, tm = topt.adamw_update(tcfg, tparams, tgrads, tstate)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == it + 1
        plain = opt_state_to_plain(tstate)
        _assert_leafwise_close(flatten_plain(plain["mu"]), flatten_plain(jstate["mu"]), 1e-5,
                               "mu")
        _assert_leafwise_close(flatten_plain(plain["nu"]), flatten_plain(jstate["nu"]), 1e-5,
                               "nu")
        got = {path: (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                      else np.stack([t.float().numpy() for t in leaf]))
               for path, leaf in tparams.items()}
        want = {path: np.asarray(a, np.float32) for path, a in flatten_plain(jparams).items()}
        tol = dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "bfloat16" else dict(rtol=0, atol=1e-5)
        for path in want:  # bf16: at most one ulp of the weight apart
            np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


def test_opt_state_round_trips_through_the_reference_form():
    cfg = _smoke("internlm2-1.8b", num_kv_heads=2)
    state = jopt.init_opt_state(_ref_params(cfg))
    state = {"mu": jax.tree.map(lambda a: a + 0.5, state["mu"]),
             "nu": jax.tree.map(lambda a: a + 0.25, state["nu"]),
             "step": jnp.asarray(7, jnp.int32)}
    port = opt_state_from_plain(jax.tree.map(np.asarray, state), device="cpu")
    assert list(port["mu"]) == list(flatten_plain(jax.tree.map(np.asarray, state["mu"])))
    back = opt_state_to_plain(port)
    assert int(back["step"]) == 7
    for key in ("mu", "nu"):
        for path, a in flatten_plain(state[key]).items():
            np.testing.assert_array_equal(flatten_plain(back[key])[path], np.asarray(a))


# ---- loss and gradients ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-2b"])
def test_loss_and_every_gradient_match_reference(arch):
    """Smoke internlm2-1.8b with 2 KV heads (GQA), and smoke gemma2-2b with
    2 KV heads (GQA, a 16-token window binding at S = 40, attention softcap
    50, final softcap 30, embeddings scaled by sqrt(d))."""
    cfg = _smoke(arch, num_kv_heads=2)
    batch = make_batch(cfg, BatchSpec(2, 40), seed=1)
    (jt, jce, jg), (tt, tce, tg) = _loss_and_grads(cfg, batch)
    assert tt == pytest.approx(jt, rel=RTOL)
    assert tce == pytest.approx(jce, rel=RTOL)
    _assert_leafwise_close(tg, jg, what=arch)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-large", "nemotron-4-15b",
                                  "yi-34b"])
def test_loss_matches_reference(arch):
    """The vision prefix (llava: the loss scores text positions only), the
    codebook lattice (musicgen: (B, S, K) labels), squared ReLU (nemotron)
    and a plain GQA stack (yi)."""
    cfg = _smoke(arch)
    batch = make_batch(cfg, BatchSpec(2, 40), seed=2)
    want, wparts = jtfm.loss_fn(_ref_params(cfg), cfg,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, gparts = ttfm.loss_fn(_port_params(cfg), cfg, batch_to_device(batch, "cpu"))
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    assert float(gparts["ce"]) == pytest.approx(float(wparts["ce"]), rel=RTOL)
    assert float(gparts["router_aux"]) == float(wparts["router_aux"]) == 0.0


def test_remat_equals_no_remat():
    cfg = _smoke("gemma2-2b", num_kv_heads=2)
    batch = batch_to_device(make_batch(cfg, BatchSpec(2, 24), seed=3), "cpu")
    out = []
    for remat in (False, True):
        model = _port_params(cfg)
        total, _ = ttfm.loss_fn(model, cfg, batch, remat=remat)
        total.backward()
        out.append((total.item(), _port_grads_plain(cfg, model)))
    assert out[0][0] == out[1][0]
    for path, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][path], g, err_msg=path)


def test_five_train_steps_match_reference():
    """The reference's `train` from its seed-0 init, and the port's `train`
    from the same weights (`params_from_plain`), on the same 5 batches:
    every step's loss, ce, grad norm and lr, and the final weights."""
    cfg = _smoke("internlm2-1.8b", num_kv_heads=2)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)  # the reference tests' lr
    spec = BatchSpec(2, 32)
    jstate, jhist = jtrain.train(cfg, iter([jmake_batch(cfg, JBatchSpec(2, 32), seed=s)
                                            for s in range(5)]),
                                 steps=5, opt_cfg=jopt.AdamWConfig(**opt), seed=0, log_every=1,
                                 log_fn=lambda s: None)
    jstate = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate)
    model = _port_params(cfg)
    tstate = {"params": model, "opt": topt.init_opt_state(param_leaves(cfg, model))}
    logs = []
    tstate, thist = ttrain.train(cfg, iter([make_batch(cfg, spec, seed=s) for s in range(5)]),
                                 steps=5, opt_cfg=topt.AdamWConfig(**opt), log_every=1,
                                 log_fn=logs.append, device="cpu", state=tstate)
    assert len(thist) == len(jhist) == 5 and len(logs) == 5
    assert logs[0].startswith("step     0 loss ")
    for j, t in zip(jhist, thist):
        assert set(t) == set(j) == {"loss", "ce", "router_aux", "grad_norm", "lr", "step",
                                    "elapsed_s"}
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert t[key] == pytest.approx(j[key], rel=RTOL), (t["step"], key)
        assert t["step"] == j["step"]
    # Adam divides by sqrt(nu): where a gradient is near zero its small
    # float32 differences move the step by up to lr, so the weights are held
    # to 1e-4 absolute (they are O(0.1-1)), the moments relative as above.
    got = flatten_plain(params_to_plain(cfg, tstate["params"]))
    for path, want in flatten_plain(jstate["params"]).items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-4, err_msg=path)
    _assert_leafwise_close(flatten_plain(opt_state_to_plain(tstate["opt"])["mu"]),
                           flatten_plain(jstate["opt"]["mu"]), what="mu")


def test_loss_decreases_on_fixed_batch():
    """The reference's `tests/test_train.py::test_loss_decreases_on_fixed_batch`,
    on the port (smoke internlm2-1.8b in its bf16, 15 steps on one batch)."""
    cfg = tsmoke_variant(tget_config("internlm2-1.8b"))

    def batches():
        while True:
            yield make_batch(cfg, BatchSpec(2, 32), seed=0)

    _, hist = ttrain.train(cfg, batches(), steps=15,
                           opt_cfg=topt.AdamWConfig(lr=1e-3, total_steps=15, warmup_steps=2),
                           log_every=100, log_fn=lambda s: None, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "grok-1-314b"])
def test_layers_without_a_backward_kernel_raise(arch):
    """``"ssd"``, ``"recurrent"`` and ``"moe"`` layers wait for backward
    kernels: the loss, the forward and `train` raise before any work."""
    cfg = tsmoke_variant(tget_config(arch))
    model = ttfm.init_params(cfg, seed=0, device="cpu")
    batch = batch_to_device(make_batch(cfg, BatchSpec(1, 16)), "cpu")
    for call in (lambda: ttfm.forward_train(model, cfg, batch),
                 lambda: ttfm.loss_fn(model, cfg, batch, remat=True),
                 lambda: ttrain.train(cfg, iter([make_batch(cfg, BatchSpec(1, 16))]), steps=1,
                                      device="cpu", state={"params": model, "opt": None})):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A item 3"):
            call()
