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
import re

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


# ---- the kernel's split of the time axis ------------------------------------------


def _fma(x, y, z):
    """float32 ``fmaf``: the product and sum in float64, rounded once."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _segmented_emulated(a, h, dh, seg, lanes):
    """The ``split`` variant's arithmetic in numpy, cluster by cluster: each
    of ``seg`` segments of `rglru.segment_steps` steps loads its dh_t,
    a_{t+1} and h_{t-1} planes in TMA boxes of `rglru.BOX_STEPS` steps
    (zero past S, past W and before step 0; NaN where no box was loaded,
    so a read of it would show), walks them from a zero carry to (G, A),
    folds the later segments' pairs last to first into its carry and walks
    again, storing da and db for the lanes inside W."""
    bsz, s, w = a.shape
    steps, box = rglru.segment_steps(s, seg), rglru.BOX_STEPS
    da, db = np.full_like(a, np.nan), np.full_like(a, np.nan)

    def rows(x, row, t0, n, w0):
        """x[row, t0:t0 + n, w0:w0 + lanes], zero outside the tensor."""
        out = np.zeros((n, lanes), dtype=np.float32)
        for j in range(n):
            if 0 <= t0 + j < s:
                v = x[row, t0 + j, w0:w0 + lanes]
                out[j, :len(v)] = v
        return out

    for row in range(bsz):
        for w0 in range(0, w, lanes):
            segs = []
            for k in range(seg):
                t0 = k * steps
                n = max(0, min(steps, s - t0))
                planes = np.full((3, steps, lanes), np.nan, dtype=np.float32)
                for i in range(-(-n // box)):
                    t = t0 + i * box
                    planes[:, i * box:(i + 1) * box] = [rows(dh, row, t, box, w0),
                                                        rows(a, row, t + 1, box, w0),
                                                        rows(h, row, t - 1, box, w0)]
                g, prod = np.zeros(lanes, np.float32), np.ones(lanes, np.float32)
                for j in reversed(range(n)):
                    g = _fma(planes[1, j], g, planes[0, j])
                    prod = (prod * planes[1, j]).astype(np.float32)
                segs.append((t0, n, planes, g, prod))
            on = min(w, w0 + lanes) - w0
            for k, (t0, n, planes, _, _) in enumerate(segs):
                g = np.zeros(lanes, np.float32)
                for big_g, big_a in (x[3:] for x in reversed(segs[k + 1:])):
                    g = _fma(big_a, g, big_g)
                for j in reversed(range(n)):
                    g = _fma(planes[1, j], g, planes[0, j])
                    db[row, t0 + j, w0:w0 + on] = g[:on]
                    da[row, t0 + j, w0:w0 + on] = (g * planes[2, j]).astype(np.float32)[:on]
    return da, db


@pytest.mark.parametrize("seg", [1, 2, 8])
@pytest.mark.parametrize("b,s,w", [(2, 77, 40), (2, 200, 100), (1, 33, 36)])
def test_segmented_emulation_matches_plain(b, s, w, seg):
    """S not a multiple of SEG (at SEG 8 and S 77 or 33 some segments hold
    no step), W not a multiple of the lanes, B 2: the split's fold and
    rewalk against the plain reverse loop within the kernel's limit
    `rglru.BWD_TOLERANCE`, every output written."""
    a, bb, dh = _inputs(b, s, w, seed=s + seg)
    ta = torch.from_numpy(a)
    h = rglru.rglru_scan_plain(ta, torch.from_numpy(bb))
    want = rglru.rglru_scan_backward_plain(ta, h, torch.from_numpy(dh))
    got = _segmented_emulated(a, h.numpy(), dh, seg, rglru.SPLIT_LANES)
    share, rtol = rglru.BWD_TOLERANCE
    for name, g, w_ in zip(("da", "db"), got, want):
        assert np.isfinite(g).all(), name
        torch.testing.assert_close(torch.from_numpy(g), w_, rtol=rtol,
                                   atol=share * float(w_.abs().max()), msg=name)


def test_split_at_recurrentgemma_training_and_at_short_s():
    """recurrentgemma-9b's training call (B 1, S 4096, W 4096) on 132 SMs
    takes 8 segments of 512 steps, 32 lanes a CTA: 1,024 CTAs in clusters
    of 8, each segment's planes in 196 KB; its (1, 256) card-vs-CPU call
    4 segments of 64; an S too short for two segments of `SPLIT_MIN_STEPS`
    or too long for 8 segments in shared memory takes the walk (SEG 1)."""
    assert rglru._split(1, 4096, 4096, 132) == (8, 32)
    assert rglru.segment_steps(4096, 8) == 512
    assert 3 * 512 * 32 * 4 == 196_608
    assert rglru._bwd_variant(4096, 8) == "split"
    assert rglru._split(1, 256, 4096, 132) == (4, 32)
    for s in (1, 33, 127):
        assert rglru._split(1, s, 4096, 132)[0] == (2 if s == 127 else 1)
    assert rglru._split(1, 8192, 4096, 132)[0] == 1
    assert rglru._bwd_variant(4096, 1) == "walk"
    assert rglru._bwd_variant(4098, 8) == "walk"  # rows not on 16 bytes
    assert rglru._bwd_variant(4096, 8, aligned=False) == "walk"


@pytest.mark.parametrize("b,s,w", [(1, 4096, 4096), (1, 256, 4096), (4, 4096, 4096),
                                   (2, 1001, 40), (1, 4800, 4096), (3, 70, 12)])
def test_split_segments_cover_s_and_fit(b, s, w):
    """Every SEG the helper picks is 1 or a power of two up to
    `SPLIT_MAX_SEG` whose segments cover S in whole boxes, fit the
    kernel's planes, and hold at least one step each but the last ones."""
    seg, lanes = rglru._split(b, s, w, 132)
    assert lanes == rglru.SPLIT_LANES and seg in (1, 2, 4, 8)
    if seg > 1:
        steps = rglru.segment_steps(s, seg)
        assert steps % rglru.BOX_STEPS == 0 and steps <= rglru.SPLIT_MAX_STEPS
        assert seg * steps >= s > 0 and steps >= min(rglru.SPLIT_MIN_STEPS, s)


def test_split_constants_match_the_source():
    """`SPLIT_LANES`, `SPLIT_MAX_STEPS` and `BOX_STEPS` are the CUDA
    source's kSplitLanes, kPlaneFloats / kSplitLanes and kBoxSteps."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "rglru_bwd.cu").read_text()
    lanes = int(re.search(r"constexpr int kSplitLanes = (\d+);", src)[1])
    plane = re.search(r"constexpr int kPlaneFloats = (\d+) \* kSplitLanes;", src)
    box = int(re.search(r"constexpr int kBoxSteps = (\d+);", src)[1])
    assert (lanes, int(plane[1]), box) == (rglru.SPLIT_LANES, rglru.SPLIT_MAX_STEPS,
                                           rglru.BOX_STEPS)


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
