"""The port's grouped GEMM (plain version) against the JAX reference, on the CPU.

`repro_torch.kernels.grouped_gemm` computes, on CPU tensors, the function
of the Pallas kernel `repro.kernels.ops.grouped_gemm` (run in interpret
mode) and of its oracle `repro.kernels.ref.grouped_gemm_ref`, and its
`pad_and_sort_tokens` gives the reference's outputs exactly.  Inputs come
from numpy seeds and go through both packages, at the sizes
`tests/test_kernels.py` sweeps.  Tolerances are the reference's own kernel
tolerances: 2e-5 in float32 and 2e-2 in bfloat16, where both round a
float32 product to bfloat16 once but may sum in another order.  The CUDA
kernel is checked against the same plain version on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import grouped_gemm as gg

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SIZES = [(512, 64, 4, 128, 128), (256, 128, 8, 256, 64)]  # tests/test_kernels.py:126


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, name, scale=1.0):
    """The same values as a jax array and a torch tensor of one dtype."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _offsets(counts):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,e,f,bt", SIZES)
def test_pad_and_sort_then_gemm_match_reference(t, d, e, f, bt, name):
    """The reference's sweep: sort and pad, multiply, restore; the port's
    sorted rows, block map and inverse equal the reference's exactly, its
    product matches the Pallas kernel (interpret mode) and `ref.py`."""
    rng = np.random.RandomState(t + e)
    jx, tx = _pair(rng, (t, d), name)
    jw, tw = _pair(rng, (e, d, f), name, scale=0.1)
    eids = rng.randint(0, e, size=t)
    jxs, jmap, jinv = ops.pad_and_sort_tokens(jx, jnp.asarray(eids), e, block_t=bt)
    txs, tmap, tinv = gg.pad_and_sort_tokens(tx, torch.from_numpy(eids), e, block_t=bt)
    np.testing.assert_array_equal(_np(txs), _np(jxs))
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert tmap.dtype == tinv.dtype == torch.int32 and txs.dtype == tx.dtype

    before = gg.LAUNCHES
    got = gg.grouped_gemm(txs, tw, tmap, block_t=bt, block_f=min(128, f))
    assert gg.LAUNCHES == before and got.dtype == tx.dtype  # the CPU runs the plain version
    pallas = ops.grouped_gemm(jxs, jw, jmap, block_t=bt, block_f=min(128, f))
    oracle = ref.grouped_gemm_ref(jxs, jw, jmap, bt)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(name))
    direct = np.einsum("td,tdf->tf", _np(tx), _np(tw)[eids])
    np.testing.assert_allclose(_np(got[tinv.long()]), direct, **_tol(name))


def test_empty_experts_do_not_corrupt_neighbours():
    """`tests/test_kernels.py:142`: experts 1 and 2 get no tokens."""
    t, d, e, f, bt = 128, 32, 4, 64, 64
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng, (t, d), "float32")
    jw, tw = _pair(rng, (e, d, f), "float32", scale=0.1)
    eids = np.zeros(t, np.int64)
    eids[64:] = 3
    jxs, jmap, jinv = ops.pad_and_sort_tokens(jx, jnp.asarray(eids), e, block_t=bt)
    txs, tmap, tinv = gg.pad_and_sort_tokens(tx, torch.from_numpy(eids), e, block_t=bt)
    got = gg.grouped_gemm(txs, tw, tmap, block_t=bt, block_f=64)[tinv.long()]
    want = ops.grouped_gemm(jxs, jw, jmap, block_t=bt, block_f=64)[jinv]
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got), np.einsum("td,tdf->tf", _np(tx), _np(tw)[eids]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [
    [3, 0, 0, 5, 1],            # empty experts between full ones
    [0, 0, 7, 0, 0],            # one expert
    [1, 1, 1, 1, 1, 0, 2, 0],   # decode-like: a row or two an expert
    [40, 0, 33, 61],            # segments longer than a tile, ragged
])
def test_ragged_segments_match_a_row_by_row_product(counts, name):
    """The ragged entry the MoE block calls: each row times its expert's
    weights; rows past the last segment (dropped pairs) come out zero."""
    rng = np.random.RandomState(sum(counts))
    e, k, f, tail = len(counts), 48, 37, 5  # ragged K and F
    n = sum(counts) + tail
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((e, k, f))).astype(np.float32)
    _, tdt = DTYPES[name]
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = gg.grouped_gemm_ragged(tx, tw, _offsets(counts))
    assert got.shape == (n, f) and got.dtype == tdt
    eids = np.repeat(np.arange(e), counts)
    want = np.einsum("tk,tkf->tf", _np(tx)[: n - tail], _np(tw)[eids])
    np.testing.assert_allclose(_np(got[: n - tail]), want, **_tol(name))
    assert not got[n - tail:].any()


def test_ragged_entry_raises_on_what_it_does_not_take():
    x = torch.zeros(6, 8)
    w = torch.zeros(3, 8, 4)
    good = _offsets([2, 2, 2])
    with pytest.raises(TypeError):
        gg.grouped_gemm_ragged(x.double(), w.double(), good)
    with pytest.raises(TypeError):
        gg.grouped_gemm_ragged(x, w.bfloat16(), good)
    with pytest.raises(TypeError):
        gg.grouped_gemm_ragged(x, w, good.long())
    with pytest.raises(ValueError):
        gg.grouped_gemm_ragged(x, torch.zeros(3, 7, 4), good)
    with pytest.raises(ValueError):
        gg.grouped_gemm_ragged(x, w, good[:3])
    for bad in ([0, 4, 2, 6], [0, 2, 4, 7], [-1, 2, 4, 6]):
        with pytest.raises(ValueError):
            gg.grouped_gemm_ragged(x, w, torch.tensor(bad, dtype=torch.int32))


def test_reference_contract_checks_blocks():
    x = torch.zeros(128, 16)
    w = torch.zeros(4, 16, 64)
    with pytest.raises(ValueError):
        gg.grouped_gemm(x[:100], w, torch.zeros(2, dtype=torch.int32), block_t=64)
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w, torch.zeros(3, dtype=torch.int32), block_t=64)
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w, torch.tensor([0, 4], dtype=torch.int32), block_t=64)
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w, torch.tensor([-1, 0], dtype=torch.int32), block_t=64)
    with pytest.raises(ValueError):
        gg.grouped_gemm(x, w, torch.zeros(2, dtype=torch.int32), block_t=64, block_f=48)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("bmap", [[2, 0, 2, 1], [3, 3, 0, 1, 0, 2]])
def test_reference_contract_takes_blocks_in_any_order(bmap, name):
    """The reference streams ``w[block_expert[i]]`` for block ``i`` in any
    order; so does the adapter, against the Pallas kernel (interpret mode)
    and `ref.py`."""
    bt, d, e, f = 64, 32, 4, 128
    rng = np.random.RandomState(len(bmap))
    jx, tx = _pair(rng, (bt * len(bmap), d), name)
    jw, tw = _pair(rng, (e, d, f), name, scale=0.1)
    jmap = jnp.asarray(bmap, jnp.int32)
    got = gg.grouped_gemm(tx, tw, torch.tensor(bmap, dtype=torch.int32), block_t=bt,
                          block_f=64)
    assert got.shape == (bt * len(bmap), f) and got.dtype == tx.dtype
    pallas = ops.grouped_gemm(jx, jw, jmap, block_t=bt, block_f=64)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(ref.grouped_gemm_ref(jx, jw, jmap, bt)),
                               **_tol(name))


def test_sorted_block_map_is_neither_gathered_nor_scattered(monkeypatch):
    """A nondecreasing map goes to the ragged product as it is (x itself, its
    output returned); an unsorted one is gathered into expert order and
    scattered back."""
    seen = []

    def ragged(x, w, offsets):
        seen.append(x)
        return gg.grouped_gemm_plain(x, w, offsets)

    monkeypatch.setattr(gg, "grouped_gemm_ragged", ragged)
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(32, 3)
    w = torch.eye(3).expand(3, 3, 3).contiguous()  # every expert the identity
    got = gg.grouped_gemm(x, w, torch.tensor([0, 1, 1, 2], dtype=torch.int32), block_t=8)
    assert seen[-1] is x and torch.equal(got, x)
    got = gg.grouped_gemm(x, w, torch.tensor([2, 0, 1, 0], dtype=torch.int32), block_t=8)
    blocks = x.view(4, 8, 3)
    assert torch.equal(seen[-1], blocks[[1, 3, 2, 0]].reshape(32, 3))
    assert torch.equal(got, x)


# ---- the kernel variant, chosen from dtype and alignment alone ---------------
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n,k,f,e,dtype,want", [
    (32_768, 2048, 768, 128, _BF16, "wgmma"),   # qwen3-moe-30b-a3b's served prefill gate
    (32_768, 2048, 768, 128, _BF16, "wgmma"),   # ... and up
    (32_768, 768, 2048, 128, _BF16, "wgmma"),   # ... and down
    (32, 2048, 768, 128, _BF16, "wgmma"),       # a decode step's gate and up
    (32, 768, 2048, 128, _BF16, "wgmma"),       # ... and down
    (32_768, 2048, 768, 128, _F32, "simt"),     # float32 prefill
    (32, 2048, 768, 128, _F32, "simt"),         # float32 decode
    (40, 100, 77, 16, _BF16, "simt"),           # F = 77: no TMA row stride
    (4096, 100, 77, 16, _BF16, "simt"),         # K = 100: no TMA row stride
    (4096, 100, 64, 16, _BF16, "simt"),
    (4096, 72, 64, 4, _BF16, "wgmma"),          # K = 72: a K tail of 8
    (40, 100, 77, 16, _F32, "simt"),
    (8, 4096, 6, 8, _F32, "simt"),              # F = 6 float32
    (8, 4096, 12, 8, _F32, "simt"),             # F = 12 float32
])
def test_variant_follows_shape_and_dtype(n, k, f, e, dtype, want):
    """N and E (so the rows an expert) do not enter the choice."""
    del n, e
    assert gg._variant(k, f, dtype) == want


def test_variant_threshold_and_alignment():
    """No threshold on the rows: bf16 goes to `wgmma` at every K and F that
    are multiples of 8, and only for 16-byte-aligned x and w."""
    for k, f in ((2048, 768), (768, 2048), (72, 64), (8, 8)):
        assert gg._variant(k, f, _BF16) == "wgmma"
        assert gg._variant(k, f, _BF16, aligned=False) == "simt"
        assert gg._variant(k, f, _F32) == "simt"
    for k, f in ((2048, 764), (2044, 768), (100, 77)):
        assert gg._variant(k, f, _BF16) == "simt"


def test_cpu_tensors_run_the_plain_version_and_never_build(monkeypatch):
    """On the CPU the wrapper neither builds nor loads a kernel, launches
    nothing, and returns `grouped_gemm_plain`'s result."""
    from repro_torch.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(gg, "_kernel_fn", refuse)
    rng = np.random.RandomState(3)
    for dtype in (_F32, _BF16):
        x = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32)).to(dtype)
        w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32)).to(dtype)
        offsets = _offsets([5, 0, 12])
        before = gg.LAUNCHES, dict(gg.LAUNCHES_BY_VARIANT)
        got = gg.grouped_gemm_ragged(x, w, offsets)
        assert (gg.LAUNCHES, gg.LAUNCHES_BY_VARIANT) == before
        assert torch.equal(got, gg.grouped_gemm_plain(x, w, offsets))
        assert not got[17:].any()
