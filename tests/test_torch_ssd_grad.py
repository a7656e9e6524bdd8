"""The gradient of the port's SSD scan and Mamba-2 block, on the CPU.

`repro_torch.kernels.ssd.ssd_scan_backward_plain` (the explicit formulas
the CUDA backward in ``csrc/ssd_bwd.cu`` computes) against autograd through
`ssd_scan_plain` (within 1e-5 of each gradient's largest magnitude: the two
differ in float32 rounding only) at S a multiple of the chunk and not, and
against ``jax.grad`` of the reference's `repro.models.ssm.ssd_chunked` at S
a multiple of the chunk (1e-4; where S is not, the reference takes one
chunk of S and the port its chunks with the last partial, the queue C
caveat, so those cases hold to the port's own autograd only).  The port's
differentiable `mamba2_train` against ``jax.grad`` of the reference's, its
weights carried across (1e-4 of each leaf's largest |grad|).  All float32,
inputs from numpy seeds.  The kernel itself is held to the plain version
on the card (`tests/test_torch_gpu.py`, `chip_smoke.py` phase 9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ssd
from repro_torch.models import ssm as tssm

AUTOGRAD_RTOL = 1e-5  # of each gradient's largest magnitude
REFERENCE_RTOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these ops are small, and several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, p, n, seed=0):
    """(x, dt, A, Bm, Cm, dy) as float32 numpy arrays: dt in mamba2's
    softplus range, A = -exp(A_log) over its init's span."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.2, (b, s, h)).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, h)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return x, dt, A, Bm, Cm, dy


def _assert_close(got, want, rtol, what=""):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {name}: max err {err:.3g} vs scale {scale:.3g}"


def _autograd(arrays, chunk):
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ssd.ssd_scan_plain(*leaves, chunk=chunk)
    return [g.numpy() for g in torch.autograd.grad(y, leaves, dy)]


def _plain(arrays, chunk):
    return [g.numpy() for g in ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in arrays), chunk=chunk)]


SHAPES = [
    (2, 64, 3, 8, 16, 16),   # 4 full chunks
    (1, 96, 2, 32, 32, 32),  # the kernel's smallest (P, N, chunk)
    (2, 37, 3, 8, 16, 16),   # ragged: chunks 16, 16, 5
    (1, 5, 2, 4, 8, 16),     # one short chunk
    (1, 130, 2, 8, 32, 64),  # ragged: chunks 64, 64, 2
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_backward_matches_autograd(b, s, h, p, n, chunk):
    arrays = _inputs(b, s, h, p, n, seed=s)
    _assert_close(_plain(arrays, chunk), _autograd(arrays, chunk), AUTOGRAD_RTOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 3, 8, 16, 16), (1, 96, 2, 32, 32, 32)])
def test_plain_backward_matches_jax_grad_of_the_reference(b, s, h, p, n, chunk):
    """S a multiple of the chunk, where both take the same chunks."""
    x, dt, A, Bm, Cm, dy = _inputs(b, s, h, p, n, seed=s)

    def loss(x, dt, A, Bm, Cm):
        y, _ = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    _assert_close(_plain((x, dt, A, Bm, Cm, dy), chunk), want, REFERENCE_RTOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 37, 3, 8, 16, 16), (1, 64, 2, 8, 16, 16)])
def test_ssd_scan_fn_is_the_plain_backward_on_the_cpu(b, s, h, p, n, chunk):
    """`ssd_scan_train` with grad goes through `SsdScanFn`, whose forward is
    `ssd_scan`'s and whose backward on CPU tensors is the plain formulas;
    B and C arrive as column views of one tensor, as `_ssd_io` makes them."""
    x, dt, A, Bm, Cm, dy = _inputs(b, s, h, p, n, seed=1)
    bc = torch.from_numpy(np.concatenate([Bm, Cm], axis=-1)).requires_grad_()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A)]
    y = ssd.ssd_scan_train(*leaves, bc[..., :n], bc[..., n:], chunk=chunk)
    want_y, _ = ssd.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    assert torch.equal(y.detach(), want_y)
    assert y.grad_fn is not None and "SsdScanFn" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(dy))
    got = [t.grad.numpy() for t in leaves] + [bc.grad[..., :n].numpy(), bc.grad[..., n:].numpy()]
    want = _plain((x, dt, A, Bm, Cm, dy), chunk)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _sequential_walk(x, dt, A, Bm, Cm, dy, chunk):
    """float64, position by position: the state entering each chunk and the
    gradient of the state leaving it (from the positions after it), (B, H,
    chunks, P, N) each."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    decay = np.exp(dt * A)  # (B, S, H)
    state, h_in = np.zeros((b, h, p, n)), np.zeros((b, h, nc, p, n))
    for t in range(s):
        if t % q == 0:
            h_in[:, :, t // q] = state
        state = (decay[:, t, :, None, None] * state
                 + (dt[:, t, :, None, None] * x[:, t, :, :, None]) * Bm[:, t, None, None, :])
    grad, g = np.zeros((b, h, p, n)), np.zeros((b, h, nc, p, n))
    for t in reversed(range(s)):
        if t % q == q - 1 or t == s - 1:
            g[:, :, t // q] = grad
        grad = decay[:, t, :, None, None] * (grad + dy[:, t, :, :, None] * Cm[:, t, None, None, :])
    return h_in, g


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 75, 2, 32, 32, 32),     # chunks 32, 32, 11
    (1, 261, 2, 64, 128, 128),  # mamba2-1.3b's (P, N, chunk): 128, 128, 5
    (1, 150, 3, 32, 128, 64),   # 64, 64, 22
])
def test_chunk_parallel_states_equal_the_sequential_walk(b, s, h, p, n, chunk):
    """The backward's phases 1 and 2 (each chunk's own state and state
    gradient in parallel, then the elementwise walk over the chunks) give
    the states entering the chunks and the gradients leaving them that the
    recurrence gives position by position, in float64."""
    arrays = [a.astype(np.float64) for a in _inputs(b, s, h, p, n, seed=s)]
    want_h, want_g = _sequential_walk(*arrays, chunk)
    S, T, edecay = ssd.bwd_chunk_states_plain(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    h_in, g = ssd.bwd_state_pass_plain(S, T, edecay)
    assert h_in.dtype == g.dtype == torch.float64
    for got, want in ((h_in, want_h), (g, want_g)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-12 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_backward_phases_match_the_plain_backward(b, s, h, p, n, chunk):
    """The four phases chained (`ssd_scan_backward_phases`) against the
    explicit formulas, float32: the same gradients in other sum orders."""
    arrays = _inputs(b, s, h, p, n, seed=s)
    got = [g.numpy() for g in ssd.ssd_scan_backward_phases(
        *(torch.from_numpy(a) for a in arrays), chunk=chunk)]
    _assert_close(got, _plain(arrays, chunk), AUTOGRAD_RTOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 3, 8, 16, 16), (1, 96, 2, 32, 32, 32)])
def test_backward_phases_match_jax_grad_of_the_reference(b, s, h, p, n, chunk):
    x, dt, A, Bm, Cm, dy = _inputs(b, s, h, p, n, seed=s)

    def loss(x, dt, A, Bm, Cm):
        y, _ = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    got = ssd.ssd_scan_backward_phases(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)), chunk=chunk)
    _assert_close([g.numpy() for g in got], want, REFERENCE_RTOL)


def test_ssd_scan_train_without_grad_keeps_the_forward_route():
    x, dt, A, Bm, Cm, _ = _inputs(1, 20, 2, 8, 16)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y = ssd.ssd_scan_train(*args, chunk=16)
    assert y.grad_fn is None
    assert torch.equal(y, ssd.ssd_scan(*args, chunk=16)[0])
    with torch.no_grad():
        y = ssd.ssd_scan_train(*(a.requires_grad_() for a in args), chunk=16)
    assert y.grad_fn is None


def test_backward_raises_on_what_it_does_not_take():
    x, dt, A, Bm, Cm, dy = (torch.from_numpy(a) for a in _inputs(1, 20, 2, 8, 16))
    with pytest.raises(ValueError, match="dy must be like x"):
        ssd.ssd_scan_backward(x, dt, A, Bm, Cm, dy[:, :10])
    with pytest.raises(ValueError, match="dy must be like x"):
        ssd.ssd_scan_backward(x, dt, A, Bm, Cm, dy.double())
    with pytest.raises(TypeError):
        ssd.ssd_scan_backward(x, dt.double(), A, Bm, Cm, dy)
    assert ssd.BWD_LAUNCHES == 0  # the CPU never launches


def test_bwd_tolerance_covers_both_types():
    assert set(ssd.BWD_TOLERANCE) == {torch.float32, torch.bfloat16}
    assert all(0 < share <= 1e-3 and 0 < rtol <= 2.0 ** -7
               for share, rtol in ssd.BWD_TOLERANCE.values())


# ---- the Mamba-2 block ---------------------------------------------------------

D_MODEL, D_INNER, D_STATE, HEAD_DIM, CONV = 64, 128, 32, 32, 4


@pytest.fixture(scope="module")
def block_params():
    jp = jssm.init_mamba2(jax.random.PRNGKey(3), D_MODEL, D_INNER, D_STATE, HEAD_DIM, CONV,
                          dtype=jnp.float32)
    return jp, {k: np.array(v) for k, v in jp.items()}


@pytest.mark.parametrize("s,chunk", [(40, 8)])
def test_block_train_gradients_match_jax_grad(block_params, s, chunk):
    """``jax.grad`` of the reference's `mamba2_train` against autograd of
    the port's, with respect to the input and every parameter, over five
    chunks."""
    jp, arrays = block_params
    kw = dict(d_inner=D_INNER, d_state=D_STATE, head_dim=HEAD_DIM, chunk=chunk, norm_eps=1e-6)
    rng = np.random.RandomState(s)
    x = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)
    dout = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jssm.mamba2_train(p, x, **kw) * dout)

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    block = tssm.Mamba2(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    block.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    out = tssm.mamba2_train(block, tx, **kw)
    out.backward(torch.from_numpy(dout))
    got = {"x": tx.grad.numpy(), **{k: getattr(block, k).grad.numpy() for k in arrays}}
    want = {"x": np.asarray(jgx), **{k: np.asarray(v) for k, v in jgp.items()}}
    for key, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[key] - w).max())
        assert err <= REFERENCE_RTOL * scale, f"{key}: {err:.3g} vs scale {scale:.3g}"
