"""The port's RG-LRU scan and Griffin block against the JAX reference, on the CPU.

`repro_torch.kernels.rglru.rglru_scan` on CPU tensors runs its plain
torch loop, the function the CUDA kernel computes.  The same numpy-seeded
inputs go through it and through the Pallas kernel (`repro.kernels.ops`,
in interpret mode), the sequential oracle `repro.kernels.ref.rglru_ref`
and the model's ``associative_scan`` (`repro.models.rglru.rglru_scan`),
at the reference's 1e-5 (`tests/test_kernels.py:100`).  The block's
prefill and decode are held against the reference's with its parameters
carried across, at 1e-4 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import rglru as jrglru
from repro_torch.kernels import rglru
from repro_torch.models import rglru as trglru

TOL = dict(atol=1e-5, rtol=1e-5)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(b, s, w, seed=0):
    """(a, b, h0) float32, the distributions of `tests/test_kernels.py:test_rglru_scan`."""
    rng = np.random.RandomState(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))).astype(np.float32)
    bb = (rng.standard_normal((b, s, w)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((b, w)) * 0.1).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,w,bt,bw", [(2, 256, 512, 64, 128), (1, 64, 128, 64, 128)])
def test_plain_matches_pallas_kernel_and_ref(b, s, w, bt, bw):
    arrays = _inputs(b, s, w)
    got = rglru.rglru_scan(*(torch.from_numpy(x) for x in arrays))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    jargs = [jnp.asarray(x) for x in arrays]
    for want in (ops.rglru_scan(*jargs, block_t=bt, block_w=bw), ref.rglru_ref(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,w,with_h0", [(2, 128, 256, True), (3, 37, 100, True),
                                           (2, 1, 64, False)])
def test_plain_matches_ref_and_associative_scan(b, s, w, with_h0):
    """Ragged S and W (37 x 100) and a single step, which the Pallas kernel's
    blocks do not take."""
    a, bb, h0 = _inputs(b, s, w, seed=s)
    th0 = torch.from_numpy(h0) if with_h0 else None
    jh0 = jnp.asarray(h0) if with_h0 else None
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb), th0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.rglru_ref(jnp.asarray(a), jnp.asarray(bb), jh0)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(bb), jh0)),
        atol=1e-5, rtol=1e-4)  # test_rglru_kernel_matches_associative_scan's limits


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    a, bb, h0 = (torch.from_numpy(x) for x in _inputs(1, 8, 16))
    with pytest.raises(TypeError):
        rglru.rglru_scan(a.bfloat16(), bb.bfloat16())
    with pytest.raises(TypeError):
        rglru.rglru_scan(a, bb, h0.double())
    with pytest.raises(ValueError):
        rglru.rglru_scan(a, bb[:, :4])
    with pytest.raises(ValueError):
        rglru.rglru_scan(a, bb, h0[:, :8])
    with pytest.raises(ValueError):
        rglru.rglru_scan(a[:, :0], bb[:, :0])
    assert rglru.LAUNCHES == 0  # the CPU never launches


# ---- the Griffin recurrent block --------------------------------------------------

D_MODEL, WIDTH, CONV = 64, 128, 4


def _carry(jp):
    return trglru.RGLRU(**{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})


@pytest.fixture(scope="module")
def block_params():
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(4), D_MODEL, WIDTH, CONV,
                                 dtype=jnp.float32)
    return jp, _carry(jp)


def test_block_prefill_then_decode_matches_reference(block_params):
    """A 13-token prefill from a non-zero state and conv tail, then 3 decode steps."""
    jp, tp = block_params
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 16, D_MODEL)).astype(np.float32)
    h0 = (rng.standard_normal((2, WIDTH)) * 0.1).astype(np.float32)
    conv0 = (rng.standard_normal((2, CONV - 1, WIDTH)) * 0.5).astype(np.float32)
    jc = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    tc = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0)}
    want, jc = jrglru.rglru_prefill(jp, jnp.asarray(x[:, :13]), jc)
    got, tc = trglru.rglru_prefill(tp, torch.from_numpy(x[:, :13]), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for t in range(13, 16):
        want, jc = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = trglru.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **F32_TOL)


def test_gates_keep_lambda_in_float32_in_a_bf16_block():
    """In a bf16 block ``lam`` stays float32: rounded to bf16, 0.999 would be
    1.0, ``-log(1)`` would clip to 1e-6 and the decay a would be about 1."""
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(5), D_MODEL, WIDTH, CONV)
    assert jp["lam"].dtype == jnp.float32 and jp["in_x"].dtype == jnp.bfloat16
    tp = _carry(jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    for name in ("in_x", "in_gate", "conv_w", "conv_b", "w_r", "w_i", "out"):
        setattr(tp, name, torch.nn.Parameter(getattr(tp, name).bfloat16(), requires_grad=False))
    assert {k for k, v in tp.state_dict().items() if v.dtype == torch.float32} == set(
        trglru.FLOAT32_PARAMS)
    xb = np.random.RandomState(7).standard_normal((1, 5, WIDTH)).astype(np.float32)
    want_a, want_b = jrglru._gates(jp, jnp.asarray(xb, jnp.bfloat16))
    got_a, got_b = trglru._gates(tp, torch.from_numpy(xb).bfloat16())
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-6, rtol=1e-5)
    assert float(got_a.max()) < 0.9999  # not the decay of a bf16 lam


def test_init_has_the_reference_shapes_and_types():
    jp = jax.eval_shape(lambda k: jrglru.init_rglru_block(k, D_MODEL, WIDTH, CONV),
                        jax.random.PRNGKey(0))
    tp = trglru.init_rglru_block(torch.Generator().manual_seed(0), D_MODEL, WIDTH, CONV)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tp.state_dict().items()}
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}


@pytest.mark.parametrize("s", [1, 7, 64, 65, 77, 1000, 1024, 4096, 100_000])
def test_kernel_chunks_cover_the_sequence(s):
    """The CUDA kernel's ring walks S in boxes of `BOX_STEPS` steps, the last
    one partial and none empty."""
    n, last = rglru.boxes(s)
    assert n >= 1 and 1 <= last <= rglru.BOX_STEPS
    assert (n - 1) * rglru.BOX_STEPS + last == s


STAGES = 4  # kStages in csrc/rglru.cu


def _ring_emulated(a, b, h0, lanes, variant):
    """The kernel's walk in numpy, CTA by CTA: a ring of `STAGES` stages of
    (BOX_STEPS x lanes) boxes of a and b, loaded as the kernel loads them
    (the first `STAGES` boxes, then box i + STAGES into box i's stage once
    box i is walked), float32 multiply-adds, h stored only for lanes inside
    W.  ``"tma"`` zero-fills a box past S or W; ``"cp_async"`` copies only
    a lane's steps inside them and leaves the rest of the stage as it was
    (NaN here, so a read of it would show)."""
    bsz, s, w = a.shape
    h = np.full_like(a, np.nan)
    n_boxes, _ = rglru.boxes(s)
    for row in range(bsz):
        for w0 in range(0, w, lanes):
            ring = np.full((STAGES, 2, rglru.BOX_STEPS, lanes), np.nan, dtype=np.float32)

            def load(i):
                box = ring[i % STAGES]
                t0 = i * rglru.BOX_STEPS
                t1, w1 = min(s, t0 + rglru.BOX_STEPS), min(w, w0 + lanes)
                if variant == "tma":
                    box[:] = 0.0
                box[0, :t1 - t0, :w1 - w0] = a[row, t0:t1, w0:w1]
                box[1, :t1 - t0, :w1 - w0] = b[row, t0:t1, w0:w1]

            for i in range(min(STAGES, n_boxes)):
                load(i)
            state = np.zeros(lanes, dtype=np.float32)
            if h0 is not None:
                state[:min(w, w0 + lanes) - w0] = h0[row, w0:w0 + lanes]
            for i in range(n_boxes):
                box = ring[i % STAGES]
                t0 = i * rglru.BOX_STEPS
                for k in range(min(rglru.BOX_STEPS, s - t0)):
                    state = (box[0, k] * state + box[1, k]).astype(np.float32)
                    on = min(w, w0 + lanes) - w0
                    h[row, t0 + k, w0:w0 + on] = state[:on]
                if i + STAGES < n_boxes:
                    load(i + STAGES)
    return h


@pytest.mark.parametrize("variant", ["tma", "cp_async"])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("b,s,w,with_h0", [(2, 1, 100, True), (1, 7, 77, False),
                                           (2, 65, 130, True), (1, 1000, 64, True),
                                           (1, 130, 77, True)])
def test_ring_emulation_matches_plain(b, s, w, with_h0, lanes, variant):
    """Ragged S (one step, a partial first box, a box and one step, the
    ring wrapping many times) and ragged W (a partial lane block), with and
    without h0: every h is written, within the card tolerance of the plain
    recurrence."""
    a, bb, h0 = _inputs(b, s, w, seed=s + w)
    h0 = h0 if with_h0 else None
    got = _ring_emulated(a, bb, h0, lanes, variant)
    assert not np.isnan(got).any()
    want = rglru.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(bb),
                                  None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bsz,w,aligned,want", [
    (4, 4096, True, ("tma", 128)),    # recurrentgemma-9b's served prefill: 128 CTAs
    (2, 4096, True, ("tma", 64)),     # 64 CTAs of 128 lanes would idle half the SMs
    (3, 100, True, ("tma", 64)),      # 400-byte rows are 16-byte aligned
    (3, 77, True, ("cp_async", 64)),  # 308-byte rows are not
    (2, 64, False, ("cp_async", 64)),  # a base address off 16 bytes
])
def test_variant_and_lanes(bsz, w, aligned, want):
    assert (rglru._variant(w, aligned), rglru._lanes(bsz, w, 132)) == want
