"""The MoE block's training path against autograd and the JAX reference, on the CPU.

`repro_torch.kernels.grouped_gemm.GroupedGemmFn` takes the grouped GEMM's
gradient with `grouped_gemm_backward` (its plain version on the CPU; the
``dx`` and ``dw`` kernels on the card, tested in `test_torch_gpu.py`):
held here against `torch.autograd` through `grouped_gemm_plain`, with
empty experts and rows outside every segment, in float32 within 1e-6 of
each gradient's largest magnitude (the same float32 products, summed in
another order).

`repro_torch.models.moe.moe_ffn`'s output, aux loss and the gradients of
x, the router and the expert stacks against ``jax.grad`` of
`repro.models.moe.moe_ffn`, in float32, within 1e-4 of each compared
quantity's largest magnitude: the reference scatters the pairs into a
capacity buffer and runs einsums where the port sorts the kept pairs and
runs the grouped GEMM, so the two differ in the order of float32 sums
only.  The loss whose gradient is taken weighs the output by a fixed
random cotangent and adds the aux loss, so the router's gradient holds
both its paths.  Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.models import moe as tmoe

RTOL = 1e-4  # relative to the largest magnitude of each compared quantity
AUX_WEIGHT = 0.37


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these ops are small, and several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g} vs scale {scale:.3g}"


# ---- GroupedGemmFn ---------------------------------------------------------------


def _ragged(seed, counts, k, f, head=0, tail=0, dtype=torch.float32):
    """x with ``head`` rows before the first segment and ``tail`` after the
    last (rows outside every segment), w N(0, 1/K), offsets from ``head``."""
    rng = np.random.RandomState(seed)
    n = head + sum(counts) + tail
    x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((len(counts), k, f)) / np.sqrt(k))
                         .astype(np.float32)).to(dtype)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]) + head, dtype=torch.int32)
    dy = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dtype)
    return x, w, offsets, dy


#: (rows of each expert's segment, K, F, rows before the first segment,
#: rows past the last).
BWD_CASES = [
    ([5, 0, 3, 9], 12, 7, 0, 3),      # an empty expert, dropped rows after
    ([0, 4, 0, 0, 6], 16, 24, 2, 5),  # empty experts first and last, rows before
    ([0, 0, 0], 8, 8, 0, 4),          # every expert empty: dx and dw all zero
    ([1, 1, 1, 1], 33, 5, 0, 0),      # one row an expert, no row outside
]


@pytest.mark.parametrize("counts,k,f,head,tail", BWD_CASES)
def test_grouped_gemm_fn_matches_autograd_through_the_plain_version(counts, k, f, head, tail):
    x, w, offsets, dy = _ragged(len(counts) + k, counts, k, f, head, tail)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    plain = gg.grouped_gemm_plain(xa, wa, offsets)
    if plain.requires_grad:
        plain.backward(dy)
    else:  # no segment has a row: the output is a constant zero
        xa.grad, wa.grad = torch.zeros_like(x), torch.zeros_like(w)
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (gg.BWD_LAUNCHES, gg.LAUNCHES)
    out = gg.grouped_gemm_ragged(xf, wf, offsets)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "GroupedGemmFnBackward"
    out.backward(dy)
    assert (gg.BWD_LAUNCHES, gg.LAUNCHES) == before  # the CPU launches nothing
    for name, got, want in (("dx", xf.grad, xa.grad), ("dw", wf.grad, wa.grad)):
        _close(got.numpy(), want.numpy(), 1e-6, name)
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not xf.grad[:lo].any() and not xf.grad[hi:].any()  # rows outside the segments
    for e, (a, b) in enumerate(zip(offsets.tolist(), offsets.tolist()[1:])):
        if a == b:
            assert not wf.grad[e].any(), e  # an empty expert's dw is zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_is_one_float32_product_a_segment(dtype):
    """dx and dw in x's type from float32 products cast once, against the
    same products in float64; each half alone when the other is not
    needed; and the wrapper, which takes the plain version on the CPU."""
    counts, k, f = [6, 0, 11], 40, 24
    x, w, offsets, dy = _ragged(7, counts, k, f, tail=2, dtype=dtype)
    dx, dw = gg.grouped_gemm_backward_plain(x, w, offsets, dy)
    assert dx.dtype == dw.dtype == dtype
    bounds = [0, *np.cumsum(counts)]
    x64, w64, dy64 = (t.double() for t in (x, w, dy))
    for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        want_dx = (dy64[lo:hi] @ w64[e].T).to(dtype).double()
        want_dw = (x64[lo:hi].T @ dy64[lo:hi]).to(dtype).double()
        # float32 sums against float64 ones, each rounded once to x's type:
        # one rounding step of that type apart at most.
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
        torch.testing.assert_close(dx[lo:hi].double(), want_dx, rtol=ulp, atol=1e-6)
        torch.testing.assert_close(dw[e].double(), want_dw, rtol=ulp, atol=1e-6)
    assert not dx[bounds[-1]:].any()
    only_dx, none_dw = gg.grouped_gemm_backward_plain(x, w, offsets, dy, need_dw=False)
    none_dx, only_dw = gg.grouped_gemm_backward_plain(x, w, offsets, dy, need_dx=False)
    assert none_dw is None and none_dx is None
    assert torch.equal(only_dx, dx) and torch.equal(only_dw, dw)
    got = gg.grouped_gemm_backward(x, w, offsets, dy)
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)


def test_grouped_gemm_fn_only_where_grad_is_wanted():
    """No graph without grad or without an input that requires it; a
    frozen w gets no dw (and none is computed), x still its dx."""
    x, w, offsets, dy = _ragged(3, [3, 2], 8, 6, tail=1)
    assert gg.grouped_gemm_ragged(x, w, offsets).grad_fn is None
    with torch.no_grad():
        assert gg.grouped_gemm_ragged(x.requires_grad_(), w, offsets).grad_fn is None
    out = gg.grouped_gemm_ragged(x, w, offsets)
    out.backward(dy)
    assert w.grad is None
    torch.testing.assert_close(x.grad, gg.grouped_gemm_backward_plain(
        x.detach(), w, offsets, dy)[0], rtol=0, atol=0)


def test_backward_checks_dy():
    x, w, offsets, dy = _ragged(4, [2, 2], 8, 6)
    with pytest.raises(ValueError):
        gg.grouped_gemm_backward(x, w, offsets, dy[:, :5])
    with pytest.raises(TypeError):
        gg.grouped_gemm_backward(x, w, offsets, dy.double())


@pytest.mark.parametrize("k,f,dtype,aligned,want", [
    (2048, 768, torch.bfloat16, True, "wgmma"),   # qwen3-moe-30b-a3b's gate and up
    (768, 2048, torch.bfloat16, True, "wgmma"),   # ... and down
    (72, 64, torch.bfloat16, True, "wgmma"),      # K = 72: a K tail of 8
    (8, 8, torch.bfloat16, True, "wgmma"),
    (2048, 768, torch.bfloat16, False, "simt"),   # x, w or dy off a 16-byte boundary
    (2048, 768, torch.float32, True, "simt"),     # float32: TF32 would break 2e-5
    (768, 2048, torch.float32, True, "simt"),
    (100, 77, torch.bfloat16, True, "simt"),      # no TMA row stride for K or F
    (100, 64, torch.bfloat16, True, "simt"),
    (2048, 764, torch.bfloat16, True, "simt"),
    (100, 77, torch.float32, True, "simt"),
])
def test_bwd_variant_follows_dtype_shape_and_alignment(k, f, dtype, aligned, want):
    """The backward's design, picked before the launch from dtype, K, F and
    alignment alone (never the rows or the offsets)."""
    assert gg._bwd_variant(k, f, dtype, aligned=aligned) == want


# ---- moe_ffn against jax.grad -------------------------------------------------------


def _params(seed, d, ff, e, gated):
    """The reference's float32 init, as jax arrays and as the port's `MoE`."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e, gated, dtype=jnp.float32)
    tp = tmoe.MoE(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


@pytest.mark.parametrize("gated,activation", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("b,s,groups,dropless", [
    (2, 16, 4, False),   # 4 groups of 8 tokens, capacity 2: drops
    (2, 16, 1, False),   # one group, capacity 8
    (2, 16, 4, True),    # dropless: one group, capacity T
])
def test_moe_ffn_gradients_match_jax_grad(b, s, groups, dropless, gated, activation):
    d, ff, e, k, cf = 32, 48, 8, 2, 1.0
    jp, tp = _params(b * s + groups + 11, d, ff, e, gated)
    rng = np.random.RandomState(b * s + groups)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(num_experts=e, experts_per_token=k, capacity_factor=cf, activation=activation,
              dropless=dropless, dispatch_groups=groups)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, **kw)
        return jnp.sum(out * cot) + AUX_WEIGHT * aux, (out, aux)

    (jl, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))

    tp.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tp, xt, **kw)
    loss = torch.sum(out * torch.from_numpy(cot)) + AUX_WEIGHT * aux
    loss.backward()

    _close(out.detach().numpy(), jout, RTOL, "out")
    _close(aux.item(), float(jaux), RTOL, "aux")
    _close(loss.item(), float(jl), RTOL, "loss")
    _close(xt.grad.numpy(), jgx, RTOL, "dx")
    names = ("router", "gate", "up", "down") if gated else ("router", "up", "down")
    assert set(jgp) == set(names)
    for name in names:
        grad = getattr(tp, name).grad
        assert grad is not None, name
        _close(grad.numpy(), jgp[name], RTOL, f"d{name}")
    if (groups, dropless) == (4, False):
        # The capacity really binds here, and so the dropped pairs' zero
        # gradient is held too.
        logits = torch.from_numpy(x.reshape(-1, d)) @ tp.router.detach()
        keep, _, _ = tmoe._sort_pairs(tmoe._route(logits, k)[2], e, 2, groups)
        assert not bool(keep.all())
