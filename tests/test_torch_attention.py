"""The port's attention kernels' plain versions against the JAX reference.

`repro_torch.kernels.attention` and `.decode_attention` compute, on CPU
tensors, the functions of `repro.kernels.ref.attention_ref` and
`decode_attention_ref` (the Pallas kernels' oracles).  Inputs come from
numpy seeds and go through both packages.  Tolerances are the reference's
own kernel tolerances (`tests/test_kernels.py`): 2e-5 in float32 and 2e-2
in bfloat16, where the reference rounds its score matrix and ``p`` to
bfloat16 and the port, like the Pallas kernels, keeps them in float32.
The CUDA kernels themselves are checked against the same plain versions
on the card (`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import attention as flash
from repro_torch.kernels import decode_attention as decode

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, name):
    """The same values as a jax array and a torch tensor of one dtype."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def ring_positions(cache_len, cur):
    """Slot s holds the latest position p <= cur with p % cache_len == s."""
    slots = np.arange(cache_len)
    last = cur - (cur - slots) % cache_len
    return np.where(last >= 0, last, -1).astype(np.int32)


FLASH_SHAPES = [  # tests/test_kernels.py's sweep, then ragged lengths
    (2, 256, 4, 2, 64, None, None),
    (1, 128, 8, 1, 128, None, 50.0),
    (2, 256, 4, 4, 64, 64, None),
    (1, 512, 2, 2, 64, 128, 30.0),
    (2, 77, 4, 2, 64, None, 50.0),
    (1, 45, 4, 1, 256, 16, None),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kv,d,window,softcap", FLASH_SHAPES)
def test_flash_plain_matches_reference(b, s, h, kv, d, window, softcap, dtype):
    rng = np.random.RandomState(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, s, n, d), dtype) for n in (h, kv, kv))
    got = flash.flash_attention(tq, tk, tv, window=window, logit_softcap=softcap)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, s, h, d)
    want = ref.attention_ref(jq, jk, jv, window=window, logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


DECODE_SHAPES = [  # tests/test_kernels.py's sweep, a ragged cache, a wrapped ring
    (2, 2, 4, 64, 1024, 700, None, None, False),
    (1, 1, 8, 128, 2048, 2047, 512, None, False),
    (3, 4, 1, 64, 512, 100, None, None, False),
    (1, 2, 2, 64, 512, 511, 128, None, False),
    (3, 2, 4, 64, 77, 70, 32, 50.0, False),
    (2, 2, 2, 256, 64, 150, 64, 50.0, True),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,kvh,rep,d,L,cur,window,softcap,ring", DECODE_SHAPES)
def test_decode_plain_matches_reference(b, kvh, rep, d, L, cur, window, softcap, ring, dtype):
    rng = np.random.RandomState(L + d)
    jq, tq = _pair(rng, (b, kvh, rep, d), dtype)
    jk, tk = _pair(rng, (b, L, kvh, d), dtype)
    jv, tv = _pair(rng, (b, L, kvh, d), dtype)
    if ring:
        pos = ring_positions(L, cur)
    else:
        pos = np.where(np.arange(L) <= cur, np.arange(L), -1).astype(np.int32)
    got = decode.decode_attention(tq, tk, tv, torch.from_numpy(pos), cur, window=window,
                                  logit_softcap=softcap)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, kvh, rep, d)
    want = ref.decode_attention_ref(jq, jk, jv, jnp.asarray(pos), jnp.asarray(cur, jnp.int32),
                                    window=window, logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas_kernel(dtype):
    """One small case through the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (1, 64, n, 64), dtype) for n in (4, 2, 2))
    got = flash.flash_attention(tq, tk, tv, window=32, logit_softcap=30.0)
    want = ops.flash_attention(jq, jk, jv, window=32, logit_softcap=30.0, block_q=32,
                               block_k=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_pallas_kernel(dtype):
    """One small case through the Pallas kernel in interpret mode: a
    wrapped ring with a window."""
    rng = np.random.RandomState(4)
    jq, tq = _pair(rng, (2, 2, 2, 64), dtype)
    jk, tk = _pair(rng, (2, 64, 2, 64), dtype)
    jv, tv = _pair(rng, (2, 64, 2, 64), dtype)
    pos = ring_positions(64, 100)
    got = decode.decode_attention(tq, tk, tv, torch.from_numpy(pos), 100, window=48,
                                  logit_softcap=50.0)
    want = ops.decode_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(100, jnp.int32),
                                window=48, logit_softcap=50.0, block_l=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_fully_masked_decode_is_finite():
    """-2e38, not -inf: a cache with no valid slot gives finite numbers (the
    mean of v), as the TPU kernel does, where -inf would give NaN."""
    q = torch.randn(1, 1, 2, 64)
    k, v = torch.randn(1, 8, 1, 64), torch.randn(1, 8, 1, 64)
    pos = torch.full((8,), -1, dtype=torch.int32)
    out = decode.decode_attention(q, k, v, pos, 5)
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand(1, 1, 2, 64)
                               .reshape(1, 1, 2, 64), rtol=1e-5, atol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k = torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64)
    with pytest.raises(TypeError):
        flash.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        flash.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        flash.flash_attention(q, k[:, :4], k[:, :4])
    with pytest.raises(ValueError):
        flash.flash_attention(torch.zeros(1, 8, 3, 64), k, k)  # 3 heads over 2 KV heads
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, k, window=0)
    dq, cache = torch.zeros(1, 2, 2, 64), torch.zeros(1, 16, 2, 64)
    pos = torch.arange(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        decode.decode_attention(dq, cache, cache, pos, torch.tensor(5))  # a device scalar
    with pytest.raises(TypeError):
        decode.decode_attention(dq, cache, cache, pos.long(), 5)
    with pytest.raises(ValueError):
        decode.decode_attention(dq, cache, cache, pos[:8], 5)
    with pytest.raises(ValueError):
        decode.decode_attention(dq, cache, cache[:, :8], pos, 5)
    assert flash.LAUNCHES == 0 and decode.LAUNCHES == 0  # the CPU never launches


@pytest.mark.parametrize("b,kv,L", [(4, 4, 2064), (4, 8, 528), (1, 1, 1), (3, 2, 77),
                                    (64, 8, 100_000), (1, 1, 8192), (4, 1, 1040),
                                    (4, 4, 1040), (2, 2, 31)])
def test_decode_splits_cover_the_cache(b, kv, L):
    target = 264  # two CTAs per SM of an H100
    n, chunk = decode.splits(b, kv, L, target)
    assert chunk % 32 == 0 and n >= 1  # the simt kernel's slot tile
    assert (n - 1) * chunk < L <= n * chunk  # every split holds at least one slot
    assert n == 1 or b * kv * n <= 2 * target
    # The mma kernel's splits form one cluster a (b, g): a power of two up
    # to 16, none empty, each of 32 slots or more unless there is one.
    for max_splits in (16, 8):
        n, chunk = decode.mma_splits(b, kv, L, target, max_splits)
        assert n & (n - 1) == 0 and 1 <= n <= max_splits
        assert (n - 1) * chunk < L <= n * chunk
        assert n == 1 or (b * kv * n <= target and chunk >= 32)


def test_mma_splits_at_the_served_steps():
    """One CTA an SM of an H100 (132): gemma2-2b's and qwen3-moe-30b-a3b's
    caches (16 KV heads in all) get clusters of 8, recurrentgemma-9b's (4)
    of 16 and internlm2-1.8b's (32) of 4, each CTA several slot tiles."""
    assert decode.mma_splits(4, 4, 2064, 132) == (8, 258)
    assert decode.mma_splits(4, 4, 1040, 132) == (8, 130)
    assert decode.mma_splits(4, 1, 1040, 132) == (16, 65)
    assert decode.mma_splits(4, 8, 528, 132) == (4, 132)


# ---- the kernel variants, chosen from dtype alone ------------------------------


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_decode_variant_follows_dtype_alone(dtype, want):
    """Every bf16 call takes the tensor-core split pass, every float32 call
    ``simt``, whatever the shape."""
    assert decode._variant(dtype) == want
    assert set(decode.LAUNCHES_BY_VARIANT) == {"mma", "simt"}


def test_decode_cpu_tensors_run_the_plain_version_and_never_build(monkeypatch):
    """On the CPU the decode wrapper neither builds nor loads a kernel,
    launches nothing, and returns `decode_attention_plain`'s result."""
    from repro_torch.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(decode, "_kernel_fn", refuse)
    rng = np.random.RandomState(6)
    pos = torch.arange(40, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.standard_normal((2, 2, 20, 64)).astype(np.float32)).to(dtype)
        k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 64)).astype(np.float32))
                .to(dtype) for _ in range(2))
        before = decode.LAUNCHES, dict(decode.LAUNCHES_BY_VARIANT)
        got = decode.decode_attention(q, k, v, pos, 30, window=16, logit_softcap=30.0)
        assert (decode.LAUNCHES, decode.LAUNCHES_BY_VARIANT) == before
        assert torch.equal(got, decode.decode_attention_plain(q, k, v, pos, 30, window=16,
                                                              logit_softcap=30.0))


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_flash_variant_follows_dtype_alone(dtype, want):
    """Every bf16 call takes ``wgmma`` and every float32 call ``simt``."""
    assert flash._variant(dtype) == want


def test_flash_cpu_tensors_run_the_plain_version_and_never_build(monkeypatch):
    """On the CPU the wrapper neither builds nor loads a kernel, launches
    nothing, and returns `flash_attention_plain`'s result."""
    from repro_torch.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(flash, "_kernel_fn", refuse)
    rng = np.random.RandomState(5)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, n, 64)).astype(np.float32))
                   .to(dtype) for n in (4, 2, 2))
        before = flash.LAUNCHES, dict(flash.LAUNCHES_BY_VARIANT)
        got = flash.flash_attention(q, k, v, window=16, logit_softcap=30.0)
        assert (flash.LAUNCHES, flash.LAUNCHES_BY_VARIANT) == before
        assert torch.equal(got, flash.flash_attention_plain(q, k, v, window=16,
                                                            logit_softcap=30.0))
