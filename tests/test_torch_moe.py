"""The port's MoE block against the JAX reference, on the CPU.

`repro_torch.models.moe.moe_ffn` must compute `repro.models.moe.moe_ffn`
exactly: the float32 routing, the dispatch groups, the capacity and its
drops, the renormalised combine.  The reference runs the experts on a
``(G, E, C, D)`` capacity buffer, the port on the kept pairs sorted by
expert through the grouped GEMM (its plain version on the CPU); row for
row the products are the same, so in float32 the outputs differ only in
the order of float32 sums: 1e-5.  In bfloat16 the reference's einsums
round where the port's grouped GEMM accumulates in float32, so the
reference's serving tolerance applies, ``TOL = 0.08``
(`tests/test_serving_consistency.py`).  Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.08, rtol=0.08)


def _params(seed, d, ff, e, gated):
    """The reference's float32 init, as jax arrays and as the port's `MoE`."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e, gated, dtype=jnp.float32)
    tp = tmoe.MoE(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


def _slots_oracle(top_i, g, e):
    """Each pair's rank among its expert's pairs, token-major then choice,
    per dispatch group: the definition, as a running count."""
    flat = top_i.reshape(g, -1)
    slots = np.zeros_like(flat)
    for grp in range(g):
        seen = np.zeros(e, np.int64)
        for p, ex in enumerate(flat[grp]):
            slots[grp, p] = seen[ex]
            seen[ex] += 1
    return slots.reshape(-1)


@pytest.mark.parametrize("gated,activation", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("b,s,groups,dropless", [
    (2, 16, 4, False),   # 4 groups of 8 tokens, capacity 2: drops
    (2, 16, 1, False),   # one group, capacity 8
    (3, 5, 4, False),    # 15 tokens: 4 groups do not divide them, one group
    (2, 16, 4, True),    # dropless: one group, capacity T
    (4, 1, 16, True),    # a decode step
])
def test_moe_ffn_matches_reference_float32(b, s, groups, dropless, gated, activation):
    d, ff, e, k, cf = 32, 48, 8, 2, 1.0
    jp, tp = _params(b * s + groups, d, ff, e, gated)
    x = np.random.RandomState(b * s).standard_normal((b, s, d)).astype(np.float32)
    kw = dict(num_experts=e, experts_per_token=k, capacity_factor=cf, activation=activation,
              dropless=dropless, dispatch_groups=groups)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), **kw)
    got, got_aux = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **F32_TOL)
    if (b, s, groups, dropless) == (2, 16, 4, False):
        # The capacity really binds here: some pairs are dropped.
        _, _, top_i = tmoe._route(torch.from_numpy(x.reshape(-1, d)) @ tp.router, k)
        slots = _slots_oracle(top_i.numpy(), 4, e)
        capacity = int(max(1, cf * k * b * s / (e * 4)))
        assert capacity == 2 and (slots >= capacity).sum() > 0


def test_moe_ffn_matches_reference_bfloat16():
    d, ff, e, k = 64, 96, 4, 2
    jp32, _ = _params(5, d, ff, e, True)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp32)
    jp["router"] = jp32["router"]  # float32 in a bf16 model
    tp = tmoe.MoE(**{kk: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if kk in tmoe.FLOAT32_PARAMS else torch.bfloat16) for kk, v in jp.items()})
    x = np.random.RandomState(5).standard_normal((2, 24, d)).astype(np.float32)
    kw = dict(num_experts=e, experts_per_token=k, capacity_factor=1.25, activation="silu",
              dispatch_groups=4)
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), **kw)
    got, _ = tmoe.moe_ffn(tp, torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_slots_are_token_major_running_counts():
    rng = np.random.RandomState(3)
    g, tg, k, e = 3, 10, 4, 6
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(g * tg)])
    got = tmoe._slots(torch.from_numpy(top_i.reshape(g, tg * k)), e).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), _slots_oracle(top_i, g, e))


def test_route_matches_reference():
    logits = np.random.RandomState(4).standard_normal((50, 16)).astype(np.float32) * 3
    jprobs, jp, ji = jmoe._route(jnp.asarray(logits), 4)
    tprobs, tp, ti = tmoe._route(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))  # descending, as lax.top_k
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=1e-6)


def test_router_aux_loss_matches_reference():
    rng = np.random.RandomState(6)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top_i = np.stack([rng.permutation(8)[:2] for _ in range(40)]).astype(np.int32)
    want = jmoe.router_aux_loss(jnp.asarray(probs), jnp.asarray(top_i), 8)
    got = tmoe.router_aux_loss(torch.from_numpy(probs), torch.from_numpy(top_i).long(), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_moe_has_the_reference_shapes_and_types():
    gen = torch.Generator().manual_seed(0)
    tp = tmoe.init_moe(gen, 32, 48, 8, True, torch.bfloat16)
    jp = jax.eval_shape(lambda kk: jmoe.init_moe(kk, 32, 48, 8, True, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    got = {kk: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for kk, v in tp.state_dict().items()}
    assert got == {kk: (tuple(v.shape), str(v.dtype)) for kk, v in jp.items()}
    # N(0, 1/d_in) scales, as the reference draws them.
    assert abs(float(tp.up.float().std()) - 32 ** -0.5) < 0.02
    assert abs(float(tp.down.float().std()) - 48 ** -0.5) < 0.02
    assert tmoe.init_moe(gen, 32, 48, 8, False).gate is None
