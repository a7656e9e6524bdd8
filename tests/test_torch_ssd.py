"""The port's SSD scan and Mamba-2 block against the JAX reference, on the CPU.

`repro_torch.kernels.ssd.ssd_scan` on CPU tensors runs its plain torch
version, the function the CUDA kernel computes.  The same numpy-seeded
inputs go through it and through the Pallas kernel (`repro.kernels.ops`,
in interpret mode as `tests/test_kernels.py` runs it), the sequential
oracle `repro.kernels.ref.ssd_ref` and the model's XLA path
`repro.models.ssm.ssd_chunked`, at the reference's kernel limits (atol
2e-4, rtol 1e-3, `tests/test_kernels.py:83-84`).  The Mamba-2 block's
prefill and decode are held against the reference's with its parameters
carried across, at 1e-4 in float32.  The CUDA kernel itself is checked
against the same plain version on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).  The card's ``mma`` variant splits each float32 operand
of its tensor-core products into bf16 hi + lo; `ssd_mma_emulated` repeats
that arithmetic here and shows why (`test_one_bf16_rounding_...`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import ssm as jssm
from repro_torch.kernels import ssd
from repro_torch.models import ssm as tssm

KERNEL_TOL = dict(atol=2e-4, rtol=1e-3)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(b, s, h, p, n, seed=0, scale=0.5, h0_scale=0.1):
    """(x, dt, A, Bm, Cm, h0) as float32 numpy arrays, the distributions of
    `tests/test_kernels.py:test_ssd_scan`."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) * scale).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) * scale).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * h0_scale).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


KERNEL_SHAPES = [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 128, 128), (1, 256, 2, 64, 64, 32)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", KERNEL_SHAPES)
def test_plain_matches_pallas_kernel_and_ref(b, s, h, p, n, chunk):
    """`tests/test_kernels.py:68-70`'s shapes, with h0."""
    arrays = _inputs(b, s, h, p, n)
    y, hf = ssd.ssd_scan(*_t(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(hf.shape) == (b, h, p, n)
    for want_y, want_h in (ops.ssd_scan(*_j(arrays), chunk=chunk), ref.ssd_ref(*_j(arrays))):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **KERNEL_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **KERNEL_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (2, 128, 4, 32, 64, 32, False),  # test_ssd_kernel_matches_xla_chunked_path's case
    (2, 200, 3, 32, 32, 64, True),   # ragged: chunks 64, 64, 64, 8
    (1, 7, 2, 64, 128, 128, True),   # one short chunk
])
def test_plain_matches_ref_and_xla_chunked_path(b, s, h, p, n, chunk, with_h0):
    arrays = _inputs(b, s, h, p, n, seed=s)
    x, dt, A, Bm, Cm, h0 = arrays
    h0 = h0 if with_h0 else None
    y, hf = ssd.ssd_scan(*_t((x, dt, A, Bm, Cm)), None if h0 is None else torch.from_numpy(h0),
                         chunk=chunk)
    jh0 = None if h0 is None else jnp.asarray(h0)
    for want_y, want_h in (ref.ssd_ref(*_j((x, dt, A, Bm, Cm)), jh0),
                           jssm.ssd_chunked(*_j((x, dt, A, Bm, Cm)), chunk, h0=jh0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **KERNEL_TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **KERNEL_TOL)


@pytest.mark.parametrize("s,chunk", [(40, 16), (32, 16), (14, 16)])
def test_model_ssd_chunked_is_the_reference_rule(s, chunk):
    """The port's `ssd_chunked` keeps the reference's chunk rule, including
    one chunk of S when S is not a multiple (40 against 16), and agrees with
    the reference's to float32 rounding."""
    arrays = _inputs(2, s, 4, 32, 32, seed=1)
    x, dt, A, Bm, Cm, h0 = arrays
    y, hf = tssm.ssd_chunked(*_t((x, dt, A, Bm, Cm)), chunk, h0=torch.from_numpy(h0))
    want_y, want_h = jssm.ssd_chunked(*_j((x, dt, A, Bm, Cm)), chunk, h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)


def _recurrence_f64(x, dt, A, Bm, Cm, h0):
    """The SSD recurrence step by step in float64 (numpy)."""
    x, dt, A, Bm, Cm, h0 = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm, h0))
    state, ys = h0.copy(), np.zeros_like(x)
    for t in range(x.shape[1]):
        state = (state * np.exp(dt[:, t] * A)[:, :, None, None]
                 + np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t]))
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, Cm[:, t])
    return ys, state


def test_ragged_chunks_beat_one_long_chunk_in_float32():
    """Why the plain version (and the kernel) cut a ragged S into chunks
    with a partial last one instead of the reference's one chunk of S:
    e^{cum_i - cum_j} comes from two long float32 sums, so the error grows
    with the chunk's length.  At S = 1000, chunks of 128 land within the
    kernel tolerance of the float64 recurrence, one chunk of 1000 does not."""
    arrays = _inputs(1, 1000, 2, 32, 128, seed=0, scale=1.0, h0_scale=1.0)
    want_y, _ = _recurrence_f64(*arrays)
    ragged, _ = ssd.ssd_scan(*_t(arrays), chunk=128)
    long_chunk, _ = tssm.ssd_chunked(*_t(arrays[:5]), 128, h0=torch.from_numpy(arrays[5]))
    tol = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(want_y)
    err_ragged = np.max(np.abs(ragged.numpy() - want_y) / tol)
    err_long = np.max(np.abs(long_chunk.numpy() - want_y) / tol)
    assert err_ragged < 1.0 < err_long
    assert err_long > 2 * err_ragged


def test_bfloat16_inputs_round_once():
    """In bf16 the plain version reads bf16 x, B, C, computes in float32 and
    rounds y once: it equals the float32 result on the same values rounded
    to bf16."""
    arrays = _inputs(2, 64, 2, 32, 32)
    x, dt, A, Bm, Cm, h0 = _t(arrays)
    bf = [t.bfloat16() for t in (x, Bm, Cm)]
    y, hf = ssd.ssd_scan(bf[0], dt, A, bf[1], bf[2], h0, chunk=32)
    y32, h32 = ssd.ssd_scan(bf[0].float(), dt, A, bf[1].float(), bf[2].float(), h0, chunk=32)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    torch.testing.assert_close(y, y32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(hf, h32, atol=0, rtol=0)


def test_strided_b_and_c_views_give_the_contiguous_result():
    """The model passes Bm and Cm as column slices of one (B, S, 2N) tensor."""
    x, dt, A, Bm, Cm, h0 = _t(_inputs(2, 50, 3, 32, 64))
    bc = torch.cat([Bm, Cm], dim=-1)
    got = ssd.ssd_scan(x, dt, A, bc[..., :64], bc[..., 64:], h0, chunk=32)
    want = ssd.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# ---- the tensor-core variant's arithmetic, emulated ----------------------------


def _bf16(t):
    return t.bfloat16().float()


def _operand(a, rounding):
    """The bf16 parts a float32 operand enters a tensor-core product as:
    ``"split"`` hi = bf16(a) and lo = bf16(a - hi), each multiplied in;
    ``"once"`` bf16(a) alone."""
    hi = _bf16(a)
    return [hi, _bf16(a - hi)] if rounding == "split" else [hi]


def ssd_mma_emulated(x, dt, A, Bm, Cm, h0, chunk, w="split", h_in="split", sx="split"):
    """The ``mma`` variant's arithmetic in float32 on the CPU, chunk by
    chunk: C·Bᵀ from bf16 inputs; the float32 operand of each product (the
    weights w, the entering state h_in, the scaled x) fed as `_operand`
    says, each part's product summed in float32; the state carried in
    float32.  x, Bm and Cm hold bf16 values.  Returns float32 (y, state)."""
    b, s, h, p = x.shape
    state = h0.clone()
    ys = []
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    for s0 in range(0, s, chunk):
        xc, dtc, bc, cc = (t[:, s0:s0 + chunk] for t in (x, dt, Bm, Cm))
        cum = torch.cumsum(dtc * A, dim=1)  # (B, Q, H)
        total = cum[:, -1]  # (B, H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        seg = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # (B, Qi, Qj, H)
        weights = torch.where(causal[None, :, :, None], cb[..., None] * seg * dtc[:, None],
                              0.0)
        y = sum(torch.einsum("bijh,bjhp->bihp", part, xc) for part in _operand(weights, w))
        inter = sum(torch.einsum("bin,bhpn->bihp", cc, part) for part in _operand(state, h_in))
        ys.append(y + inter * torch.exp(cum)[..., None])
        scaled = xc * (dtc * torch.exp(total[:, None] - cum))[..., None]  # (B, Q, H, P)
        state = state * torch.exp(total)[..., None, None] + sum(
            torch.einsum("bjhp,bjn->bhpn", part, bc) for part in _operand(scaled, sx))
    return torch.cat(ys, dim=1), state


def _emulation_inputs():
    """mamba2-1.3b's P, N and chunk over four chunks, x, B and C in bf16."""
    x, dt, A, Bm, Cm, h0 = _t(_inputs(1, 512, 4, 64, 128, seed=3))
    return _bf16(x), dt, A, _bf16(Bm), _bf16(Cm), h0


def test_mma_emulation_with_split_operands_stays_within_the_card_tolerance():
    """The ``mma`` variant's design: every float32 operand split into bf16
    hi + lo keeps y and the state within the card's limits (atol 2e-4,
    rtol 1e-3) of `ssd_scan_plain`, at chunk 128, P 64, N 128 over four
    chunks."""
    args = _emulation_inputs()
    y, state = ssd_mma_emulated(*args, 128)
    y_p, h_p = ssd.ssd_scan_plain(*args, chunk=128)
    torch.testing.assert_close(y, y_p, **KERNEL_TOL)
    torch.testing.assert_close(state, h_p, **KERNEL_TOL)


@pytest.mark.parametrize("operand", ["w", "h_in", "sx"])
def test_one_bf16_rounding_of_an_operand_leaves_the_card_tolerance(operand):
    """Why the ``mma`` variant splits: the weights w, the entering state
    h_in or the scaled x rounded once to bf16 put y outside the card's
    limits (at these inputs 73,591, 927 and 753 of 131,072 outputs)."""
    args = _emulation_inputs()
    y, _ = ssd_mma_emulated(*args, 128, **{operand: "once"})
    y_p, _ = ssd.ssd_scan_plain(*args, chunk=128)
    tol = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * y_p.abs()
    outside = int(((y - y_p).abs() > tol).sum())
    assert outside > 0


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_variant_follows_dtype_alone(dtype, want):
    """Every bf16 call takes the tensor-core kernels, every float32 call
    ``simt``, whatever the shape."""
    assert ssd._variant(dtype) == want
    assert set(ssd.LAUNCHES_BY_VARIANT) == {"mma", "simt"}


def test_cpu_tensors_run_the_plain_version_and_never_build(monkeypatch):
    """On the CPU the wrapper neither builds nor loads a kernel, launches
    nothing, and returns `ssd_scan_plain`'s result."""
    from repro_torch.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(ssd, "_kernel_fn", refuse)
    x, dt, A, Bm, Cm, h0 = _t(_inputs(1, 40, 2, 32, 32))
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), h0)
        before = ssd.LAUNCHES, dict(ssd.LAUNCHES_BY_VARIANT)
        got = ssd.ssd_scan(*args, chunk=32)
        assert (ssd.LAUNCHES, ssd.LAUNCHES_BY_VARIANT) == before
        for g, w in zip(got, ssd.ssd_scan_plain(*args, chunk=32)):
            assert torch.equal(g, w)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm, h0 = _t(_inputs(1, 8, 2, 32, 32))
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.double(), dt, A, Bm.double(), Cm.double(), h0)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, h0)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, h0)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt[:, :4], A, Bm, Cm, h0)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bm, Cm, h0[..., :16])
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=0)
    assert ssd.LAUNCHES == 0  # the CPU never launches


# ---- the Mamba-2 block ---------------------------------------------------------

D_MODEL, D_INNER, D_STATE, HEAD_DIM, CONV = 64, 128, 32, 32, 4


@pytest.fixture(scope="module")
def block_params():
    jp = jssm.init_mamba2(jax.random.PRNGKey(3), D_MODEL, D_INNER, D_STATE, HEAD_DIM, CONV,
                          dtype=jnp.float32)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tssm.Mamba2(**tensors)


def test_block_prefill_then_decode_matches_reference(block_params):
    """A ragged 21-token prefill (chunks 8, 8, 5 in the port; one chunk of
    21 in the reference) from a non-zero cache, then 3 decode steps."""
    jp, tp = block_params
    kw = dict(d_inner=D_INNER, d_state=D_STATE, head_dim=HEAD_DIM, norm_eps=1e-6)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 24, D_MODEL)).astype(np.float32)
    ssm0 = (rng.standard_normal((2, D_INNER // HEAD_DIM, HEAD_DIM, D_STATE)) * 0.1).astype(
        np.float32)
    conv0 = (rng.standard_normal((2, CONV - 1, D_INNER + 2 * D_STATE)) * 0.5).astype(np.float32)
    jc = {"ssm": jnp.asarray(ssm0), "conv": jnp.asarray(conv0)}
    tc = {"ssm": torch.from_numpy(ssm0), "conv": torch.from_numpy(conv0)}
    want, jc = jssm.mamba2_prefill(jp, jnp.asarray(x[:, :21]), jc, chunk=8, **kw)
    got, tc = tssm.mamba2_prefill(tp, torch.from_numpy(x[:, :21]), tc, chunk=8, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for t in range(21, 24):
        want, jc = jssm.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, **kw)
        got, tc = tssm.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32_TOL)


def test_decode_step_matches_reference():
    x, dt, A, Bm, Cm, h0 = _inputs(3, 1, 4, 32, 64, seed=9)
    got = tssm.ssd_decode_step(torch.from_numpy(h0), *_t((x[:, 0], dt[:, 0], A, Bm[:, 0],
                                                          Cm[:, 0])))
    want = jssm.ssd_decode_step(jnp.asarray(h0), *_j((x[:, 0], dt[:, 0], A, Bm[:, 0],
                                                      Cm[:, 0])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_init_has_the_reference_shapes_and_types():
    jp = jax.eval_shape(lambda k: jssm.init_mamba2(k, D_MODEL, D_INNER, D_STATE, HEAD_DIM,
                                                   CONV), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = tssm.init_mamba2(gen, D_MODEL, D_INNER, D_STATE, HEAD_DIM, CONV)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tp.state_dict().items()}
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    np.testing.assert_array_equal(tp.dt_bias.numpy(), np.asarray(
        jssm.init_mamba2(jax.random.PRNGKey(0), D_MODEL, D_INNER, D_STATE, HEAD_DIM,
                         CONV)["dt_bias"]))
