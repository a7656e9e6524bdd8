"""The gradient of the port's flash attention, on the CPU.

`repro_torch.kernels.attention.flash_attention_backward_plain` (the
explicit formulas the CUDA backward computes) against autograd through
`flash_attention_plain` (within 1e-5 of the largest |grad|) and against
``jax.grad`` of the reference's oracle `repro.kernels.ref.attention_ref`
(1e-4); the port's differentiable `attention_train` against ``jax.grad``
of the reference's `repro.models.attention.attention_train`, projections
and rope included (1e-4).  All float32, D = 64, GQA with 1, 2 and 4 query
heads a KV head, no window or one shorter than S, no softcap or 50.

The CUDA kernel cannot run here (`tests/test_torch_gpu.py` holds it to the
plain version on the card), so what it is given is checked: the block
ranges `_bwd_ranges` writes for it against the mask by brute force, the
tile sizes those ranges are written for against the source, and a numpy
walk of the kernel's two passes over those ranges against the plain
backward.  `FlashAttentionFn` on CPU tensors equals the plain versions,
and calls without grad keep the old route.
"""
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import attention as flash
from repro_torch.models import attention as tattn

CASES = list(itertools.product([1, 2, 4], [None, 7], [None, 50.0]))  # rep, window, softcap
H, D, B, S = 4, 64, 2, 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: these small models' ops are a few ms each, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, rep, s=S):
    rng = np.random.RandomState(seed)
    kv = H // rep
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    k = rng.standard_normal((B, s, kv, D)).astype(np.float32)
    v = rng.standard_normal((B, s, kv, D)).astype(np.float32)
    do = rng.standard_normal((B, s, H, D)).astype(np.float32)
    return q, k, v, do


def _assert_grads_close(got, want, rtol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rtol * scale, f"{name}: {err:.3g} vs {rtol} x {scale:.3g}"


def _plain_backward(q, k, v, do, window, cap):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    with torch.no_grad():
        o, lse = flash.flash_attention_plain(*t[:3], window=window, logit_softcap=cap,
                                             return_lse=True)
        return flash.flash_attention_backward_plain(*t[:3], o, lse, t[3], window=window,
                                                    logit_softcap=cap)


@pytest.mark.parametrize("rep,window,softcap", CASES)
def test_plain_backward_matches_autograd(rep, window, softcap):
    q, k, v, do = _inputs(rep, rep)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash.flash_attention_plain(tq, tk, tv, window=window, logit_softcap=softcap).backward(
        torch.from_numpy(do))
    got = _plain_backward(q, k, v, do, window, softcap)
    _assert_grads_close(got, (tq.grad, tk.grad, tv.grad), 1e-5)


@pytest.mark.parametrize("rep,window,softcap", CASES)
def test_plain_backward_matches_jax_grad_of_the_oracle(rep, window, softcap):
    q, k, v, do = _inputs(10 + rep, rep)
    _, vjp = jax.vjp(lambda a, b, c: ref.attention_ref(a, b, c, window=window,
                                                      logit_softcap=softcap),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    _assert_grads_close(_plain_backward(q, k, v, do, window, softcap), want, 1e-4)


@pytest.mark.parametrize("rep,window,softcap", CASES)
def test_attention_train_gradient_matches_reference(rep, window, softcap):
    """d/d(x, wq, wk, wv, wo) of a sum of the layer's output times a fixed
    cotangent, through the port's `attention_train` (flash under
    `FlashAttentionFn`) and ``jax.grad`` of the reference's."""
    rng = np.random.RandomState(20 + rep)
    d_model, kv = 32, H // rep
    x = rng.standard_normal((B, S, d_model)).astype(np.float32)
    w = {"wq": (d_model, H * D), "wk": (d_model, kv * D), "wv": (d_model, kv * D),
         "wo": (H * D, d_model)}
    w = {name: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for name, shape in w.items()}
    cot = rng.standard_normal((B, S, d_model)).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=kv, head_dim=D, rope_theta=10_000.0, window=window,
              logit_softcap=softcap, norm_eps=1e-6)
    pos = np.arange(S, dtype=np.int32)

    def jloss(params, xx):
        return jnp.sum(jattn.attention_train(params, xx, jnp.asarray(pos), **kw) * cot)

    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x))
    tparams = tattn.Attention(*(torch.from_numpy(w[n]) for n in ("wq", "wk", "wv", "wo")))
    tparams.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    out = tattn.attention_train(tparams, tx, torch.from_numpy(pos), **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    for name in w:
        got, want = getattr(tparams, name).grad.numpy(), np.asarray(jg_params[name])
        assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max()), name
    assert float(np.abs(tx.grad.numpy() - np.asarray(jg_x)).max()) <= 1e-4 * float(
        np.abs(np.asarray(jg_x)).max())


@pytest.mark.parametrize("rep,window,softcap", CASES[::3])
def test_flash_attention_fn_on_cpu_is_the_plain_versions(rep, window, softcap):
    q, k, v, do = _inputs(30 + rep, rep)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, window=window, logit_softcap=softcap)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    with torch.no_grad():
        want_o = flash.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                             window=window, logit_softcap=softcap)
    assert torch.equal(out.detach(), want_o)
    for got, want in zip((tq.grad, tk.grad, tv.grad), _plain_backward(q, k, v, do, window,
                                                                      softcap)):
        assert torch.equal(got, want)


def test_calls_without_grad_take_the_old_route(monkeypatch):
    """Under `torch.no_grad` (every serving call), or with inputs that need
    no grad, `flash_attention` never builds the autograd node and asks for
    no logsumexp; with grad it does."""
    q, k, v, _ = _inputs(40, 2)
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("with_lse", args[5] if len(args) > 5 else False))
        return real(*args, **kw)

    real = flash._dispatch
    monkeypatch.setattr(flash, "_dispatch", spy)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        assert flash.flash_attention(tq, tk, tv).grad_fn is None
    assert flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).grad_fn is None
    assert calls == [False, False]
    assert flash.flash_attention(tq, tk, tv).grad_fn is not None
    assert calls == [False, False, True]


@pytest.mark.parametrize("bq,bk", sorted({t for tiles in flash.BWD_TILES.values()
                                           for passes in tiles.values()
                                           for t in passes.values()}) + [(32, 64), (64, 32)])
@pytest.mark.parametrize("s", [1, 31, 64, 65, 200])
@pytest.mark.parametrize("window", [None, 1, 16, 40, 300])
def test_visible_block_ranges_match_the_mask(s, window, bq, bk):
    """The ranges handed to the kernel: each key block's query-block range
    is exactly the set of query blocks holding a (query, key) pair the
    causal mask and the window let through, and each query block's
    key-block range likewise."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    mask = j <= i
    if window is not None:
        mask &= j > i - window
    n_q, n_k = -(-s // bq), -(-s // bk)
    seen = np.zeros((n_q, n_k), bool)
    for qb in range(n_q):
        for kb in range(n_k):
            seen[qb, kb] = mask[qb * bq:(qb + 1) * bq, kb * bk:(kb + 1) * bk].any()
    q_ranges, k_ranges = flash._bwd_ranges(s, bq, bk, window)
    assert q_ranges.dtype == k_ranges.dtype == np.int32
    assert q_ranges.shape == (n_k, 2) and k_ranges.shape == (n_q, 2)
    for kb, (first, end) in enumerate(q_ranges):
        assert list(range(first, end)) == list(np.flatnonzero(seen[:, kb])), kb
    for qb, (first, end) in enumerate(k_ranges):
        assert list(range(first, end)) == list(np.flatnonzero(seen[qb])), qb


#: The namespace of each backward variant's ``Tiles<D>`` in the source.
_TILE_NAMESPACES = {"simt": "simt", "wgmma": "wg"}


def _source_tiles(src, namespace, d):
    """``{pass: (query rows, key rows)}`` of ``Tiles<d>`` in ``namespace`` of
    the kernel source: dkdv's ``BQ``, ``BK``, and dq's ``DQ_BQ``, ``DQ_BK``
    where the struct has them (else dkdv's), each a constant or ``D == x ?
    y : z``."""
    body = src[src.index(f"namespace {namespace} {{"):]
    body = body[body.index("struct Tiles {"):]
    body = body[:body.index("};")]

    def const(name):
        m = re.search(rf"static constexpr int {name} = (?:D == (\d+) \? (\d+) : (\d+)|(\d+));",
                      body)
        if m is None:
            return None
        when, yes, no, value = m.groups()
        return int(value) if value else int(yes) if d == int(when) else int(no)

    dkdv = (const("BQ"), const("BK"))
    assert None not in dkdv, namespace
    dq = (const("DQ_BQ"), const("DQ_BK"))
    return {"dkdv": dkdv, "dq": dkdv if dq == (None, None) else dq}


def test_tile_sizes_match_the_kernel_source():
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert set(flash.BWD_TILES) == set(_TILE_NAMESPACES) == set(flash.LAUNCHES_BY_VARIANT)
    for variant, tiles in flash.BWD_TILES.items():
        assert set(tiles) == set(flash.HEAD_DIMS), variant
        for d, passes in tiles.items():
            assert _source_tiles(src, _TILE_NAMESPACES[variant], d) == passes, (variant, d)
    assert "flash_attention_bwd" in _build.SOURCES
    assert "hopper_common.cuh" in _build.SOURCES["flash_attention_bwd"][1]


def _kernel_walk(q, k, v, o, lse, do, window, cap, bq, bk):
    """The CUDA backward's two passes as numpy loops over its tiles and the
    ranges `_bwd_ranges` hands it: dk, dv per (key block, KV head) over
    the visible query blocks of each query head of the group; dq per
    (query block, head) over the visible key blocks.  Tiles past S are
    zero rows, masked as the kernel masks them."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep, scale = h // kv, d ** -0.5
    delta = np.einsum("bshd,bshd->bhs", do, o)
    n_q, n_k = -(-s // bq), -(-s // bk)
    pad = n_q * bq + n_k * bk

    def padded(a):
        out = np.zeros((a.shape[0], pad) + a.shape[2:], np.float64)
        out[:, :s] = a
        return out

    qp, kp, vp, dop = (padded(a) for a in (q, k, v, do))
    lsep = np.zeros((b, h, pad))
    lsep[:, :, :s] = lse
    deltap = np.zeros((b, h, pad))
    deltap[:, :, :s] = delta

    def tile(bi, hh, i0, k0):
        g = hh // rep
        qi, doi = qp[bi, i0:i0 + bq, hh], dop[bi, i0:i0 + bq, hh]
        kj, vj = kp[bi, k0:k0 + bk, g], vp[bi, k0:k0 + bk, g]
        x = qi @ kj.T * scale
        th = np.tanh(x / cap) if cap else None
        sc = cap * th if cap else x
        ii, jj = np.arange(i0, i0 + bq)[:, None], np.arange(k0, k0 + bk)[None, :]
        ok = (ii < s) & (jj < s) & (jj <= ii)
        if window is not None:
            ok &= jj > ii - window
        p = np.exp(np.where(ok, sc, -2e38) - lsep[bi, hh, i0:i0 + bq, None])
        ds = p * (doi @ vj.T - deltap[bi, hh, i0:i0 + bq, None])
        if cap:
            ds *= 1 - th * th
        return p, ds, qi, doi, kj

    q_ranges, k_ranges = flash._bwd_ranges(s, bq, bk, window)
    dq, dk, dv = np.zeros_like(qp), np.zeros_like(kp), np.zeros_like(vp)
    for bi, g, kb in itertools.product(range(b), range(kv), range(n_k)):
        first, end = q_ranges[kb]
        for hh in range(g * rep, (g + 1) * rep):
            for qb in range(first, end):
                p, ds, qi, doi, _ = tile(bi, hh, qb * bq, kb * bk)
                dv[bi, kb * bk:(kb + 1) * bk, g] += p.T @ doi
                dk[bi, kb * bk:(kb + 1) * bk, g] += ds.T @ qi * scale
    for bi, hh, qb in itertools.product(range(b), range(h), range(n_q)):
        first, end = k_ranges[qb]
        for kb in range(first, end):
            _, ds, _, _, kj = tile(bi, hh, qb * bq, kb * bk)
            dq[bi, qb * bq:(qb + 1) * bq, hh] += ds @ kj * scale
    return dq[:, :s], dk[:, :s], dv[:, :s]


@pytest.mark.parametrize("rep,window,softcap", [(2, None, None), (4, 16, 50.0), (1, 70, None)])
@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 32), (64, 128), (128, 64)])
def test_kernel_tile_walk_matches_plain_backward(rep, window, softcap, bq, bk):
    """A ragged S = 100 (two, four, or one partial tiles), tiles of every
    size the two variants' passes use: the walk over the visible ranges
    misses no pair and counts none twice."""
    q, k, v, do = _inputs(50 + rep, rep, s=100)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    with torch.no_grad():
        o, lse = flash.flash_attention_plain(*t[:3], window=window, logit_softcap=softcap,
                                             return_lse=True)
        want = flash.flash_attention_backward_plain(*t[:3], o, lse, t[3], window=window,
                                                    logit_softcap=softcap)
    got = _kernel_walk(q, k, v, o.numpy(), lse.numpy(), do, window, softcap, bq, bk)
    _assert_grads_close(got, want, 1e-5)


# ---- the wgmma variant's arithmetic ---------------------------------------------

def _hi_lo(x):
    """x as the kernel multiplies it: bf16 hi, and bf16 of what hi left out."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()]


def _rounded(x):
    return [x.to(torch.bfloat16).float()]


def _backward_emulated(q, k, v, o, lse, do, window, cap, operand):
    """`flash_attention_backward_plain`'s function with the arithmetic of the
    ``wgmma`` variant: bf16 operands, float32 sums, p and dS handed to the
    products by them as the bf16 parts ``operand`` gives (one product a
    part), each gradient rounded once to bf16."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep, scale = h // kv, d ** -0.5
    scores, th = flash._scores(q, k, window, cap)
    p = torch.exp(scores - lse.float().reshape(b, kv, rep, s)[..., None])
    dor = do.float().reshape(b, s, kv, rep, d)
    dp = torch.einsum("bsgrd,btgd->bgrst", dor, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(b, s, kv, rep).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)

    def product(eq, x, y):
        return sum(torch.einsum(eq, part, y) for part in operand(x))

    dv = product("bgrst,bsgrd->btgd", p, dor)
    dk = product("bgrst,bsgrd->btgd", ds, q.float().reshape(b, s, kv, rep, d)) * scale
    dq = product("bgrst,btgd->bsgrd", ds, k.float()).reshape(b, s, h, d) * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _outside(got, want):
    """Per gradient, the elements outside the card's bf16 limits
    (`BWD_TOLERANCE`)."""
    share, rtol = flash.BWD_TOLERANCE[torch.bfloat16]
    scale = max(float(w.float().abs().max()) for w in want)
    return [int(((g.float() - w.float()).abs() > share * scale + rtol * w.float().abs()).sum())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("d,window,softcap", [(64, None, None), (128, None, None),
                                              (256, None, None), (256, 100, 50.0)])
def test_wgmma_split_of_p_and_ds_holds_the_card_limit(d, window, softcap):
    """Why the ``wgmma`` backward splits p and dS into bf16 hi + lo (two
    products each): at S = 256 with bf16 inputs, one bf16 rounding of p
    and dS puts elements of every gradient outside the card's limit
    against the plain backward, and the split puts none there."""
    rng = np.random.RandomState(60 + d + (window or 0))
    b, s, h, kv = 1, 256, 4, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, n, d)).astype(np.float32))
                   .to(torch.bfloat16) for n in (h, kv, kv, h))
    with torch.no_grad():
        o, lse = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=softcap,
                                             return_lse=True)
        want = flash.flash_attention_backward_plain(q, k, v, o, lse, do, window=window,
                                                    logit_softcap=softcap)
        rounded = _outside(_backward_emulated(q, k, v, o, lse, do, window, softcap, _rounded),
                           want)
        split = _outside(_backward_emulated(q, k, v, o, lse, do, window, softcap, _hi_lo), want)
    assert all(n > 0 for n in rounded), rounded
    assert split == [0, 0, 0], split
