"""The gradient of the port's RG-LRU scan and Griffin block, on the CPU.

`repro_torch.kernels.rglru.rglru_scan_backward_plain` (the reverse loop the
CUDA backward in ``csrc/rglru_bwd.cu`` computes) against autograd through
`rglru_scan_plain` (1e-5 of each gradient's largest magnitude: float32
rounding only) and against ``jax.grad`` of the reference's
``associative_scan`` (`repro.models.rglru.rglru_scan`) and of its
sequential oracle `repro.kernels.ref.rglru_ref` (1e-4: the associative
scan sums in another order); the port's differentiable `rglru_train`
against ``jax.grad`` of the reference's, its weights carried across (1e-4
of each leaf's largest |grad|).  All float32, inputs from numpy seeds.  The
kernel itself is held to the plain version on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py` phase 9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import rglru as jrglru
from repro_torch.kernels import rglru
from repro_torch.models import rglru as trglru

AUTOGRAD_RTOL = 1e-5
REFERENCE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, w, seed=0):
    """(a, b, dh) float32: a in (0, 1) as the gates make it."""
    rng = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w)) - 2.0))).astype(np.float32)
    bb = (rng.standard_normal((b, s, w)) * 0.3).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, bb, dh


def _assert_close(got, want, rtol, what=""):
    for name, g, w in zip(("da", "db"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {name}: max err {err:.3g} vs scale {scale:.3g}"


def _plain(a, bb, dh):
    ta = torch.from_numpy(a)
    h = rglru.rglru_scan_plain(ta, torch.from_numpy(bb))
    return [g.numpy() for g in rglru.rglru_scan_backward_plain(ta, h, torch.from_numpy(dh))]


@pytest.mark.parametrize("b,s,w", [(2, 33, 7), (1, 1, 5), (3, 100, 64)])
def test_plain_backward_matches_autograd(b, s, w):
    a, bb, dh = _inputs(b, s, w, seed=s)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, bb)]
    want = torch.autograd.grad(rglru.rglru_scan_plain(*leaves), leaves, torch.from_numpy(dh))
    _assert_close(_plain(a, bb, dh), [g.numpy() for g in want], AUTOGRAD_RTOL)


@pytest.mark.parametrize("b,s,w", [(2, 64, 32), (1, 37, 48)])
def test_plain_backward_matches_jax_grad_of_the_reference(b, s, w):
    """``jax.grad`` of the model's ``associative_scan`` and of the
    sequential oracle, from a zero state."""
    a, bb, dh = _inputs(b, s, w, seed=s)
    got = _plain(a, bb, dh)
    for fn in (lambda a, b: jrglru.rglru_scan(a, b, None), ref.rglru_ref):
        want = jax.jit(jax.grad(lambda a, b: jnp.sum(fn(a, b) * dh), argnums=(0, 1)))(
            jnp.asarray(a), jnp.asarray(bb))
        _assert_close(got, want, REFERENCE_RTOL)


def test_rglru_scan_fn_is_the_plain_backward_on_the_cpu():
    a, bb, dh = _inputs(2, 29, 12, seed=3)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, bb)]
    h = rglru.rglru_scan_train(*leaves)
    assert torch.equal(h.detach(), rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb)))
    assert "RglruScanFn" in type(h.grad_fn).__name__
    h.backward(torch.from_numpy(dh))
    for g, w in zip((t.grad for t in leaves), _plain(a, bb, dh)):
        np.testing.assert_array_equal(g.numpy(), w)
    # Without grad the call keeps the forward's route.
    with torch.no_grad():
        assert rglru.rglru_scan_train(*leaves).grad_fn is None


def test_backward_raises_on_what_it_does_not_take():
    a, bb, dh = (torch.from_numpy(t) for t in _inputs(1, 8, 4))
    h = rglru.rglru_scan_plain(a, bb)
    with pytest.raises(ValueError, match="dh must be like a"):
        rglru.rglru_scan_backward(a, h, dh[:, :4])
    with pytest.raises(ValueError, match="dh must be like a"):
        rglru.rglru_scan_backward(a, h, dh.double())
    with pytest.raises(TypeError):
        rglru.rglru_scan_backward(a.double(), h, dh)
    assert rglru.BWD_LAUNCHES == 0  # the CPU never launches


# ---- the Griffin block -----------------------------------------------------------

D_MODEL, WIDTH, CONV = 64, 64, 4


def test_block_train_gradients_match_jax_grad():
    """``jax.grad`` of the reference's `rglru_train` against autograd of the
    port's, with respect to the input and every parameter (``lam``, ``b_r``
    and ``b_i`` included)."""
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(4), D_MODEL, WIDTH, CONV, dtype=jnp.float32)
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 24, D_MODEL)).astype(np.float32)
    dout = rng.standard_normal((2, 24, D_MODEL)).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jrglru.rglru_train(p, x) * dout),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    block = trglru.RGLRU(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    block.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    trglru.rglru_train(block, tx).backward(torch.from_numpy(dout))
    got = {"x": tx.grad.numpy(), **{k: getattr(block, k).grad.numpy() for k in jp}}
    want = {"x": np.asarray(jgx), **{k: np.asarray(v) for k, v in jgp.items()}}
    for key, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[key] - w).max())
        assert err <= REFERENCE_RTOL * scale, f"{key}: {err:.3g} vs scale {scale:.3g}"
