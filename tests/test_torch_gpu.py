"""The port's CUDA kernels on the card (``gpu`` marker; skips without one).

Imports only `repro_torch`, so it runs on a machine that has the card but
not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The knapsack kernel does adds and compares only, so it must equal its
plain torch version exactly: ``best``, the take bits, and the counts and
plans built from them.  The attention kernels sum in another order than
their plain versions, both in float32: float32 is held to the
reference's kernel tolerance, 2e-5; in bfloat16 the two round to outputs
at most one bf16 ulp apart (rtol 2^-7), with atol 1e-4 for the float32
difference.  The SSD and RG-LRU scans' and the grouped GEMM's limits are
stated beside their tests.  The live loop's pack scan and placement scores
equal their plain versions bit for bit, and a short replay on the card
equals the same replay on the CPU.  Calibration on the card equals the numpy path
bit for bit; VGG-16 and ZF on the card (cuDNN convs, TF32 off) are within
1e-3 of the largest logit of the same weights on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import calibration as cal
from repro_torch.core.binpack import colgen, heuristics
from repro_torch.core.binpack.arcflow import group_items
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.streams import AnalysisProgram, StreamSpec
from repro_torch.device import KernelError
from repro_torch.interop import plan_to_plain
from repro_torch.kernels import attention as flash
from repro_torch.kernels import decode_attention as decode
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import knapsack, pack, placement, rglru, ssd
from repro_torch.models import analysis_programs as ap
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # The plain versions' products compare in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _random_pricing(rng, b_n, e_n, dim, dtype):
    values = rng.uniform(0.0, 1.0, size=(b_n, e_n)).astype(dtype)
    weights = rng.randint(0, 4, size=(b_n, e_n, dim)).astype(np.int64)
    weights[..., 0] = np.maximum(weights[..., 0], 1)
    bounds = rng.randint(0, 5, size=(b_n, e_n)).astype(np.int64)
    cap_levels = rng.randint(1, 7, size=(b_n, dim)).astype(np.int64)
    return values, weights, bounds, cap_levels


def _camera_fleet(n):
    vgg, zf = AnalysisProgram("VGG-16", "vgg16"), AnalysisProgram("ZF", "zf")
    kinds = [(vgg, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
        (zf, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
    ]
    return [StreamSpec(f"cam{i}", *kinds[i % 10]) for i in range(n)]


def _assert_kernel_equals_plain(steps, device, variant=None):
    """Kernel vs plain, bit for bit: best, the packed take bits, the
    kernel's mask of steps taken against the plain backtrack over the same
    bits, and the counts from it against `_backtrack`'s."""
    before = knapsack.LAUNCHES
    by_variant = dict(knapsack.LAUNCHES_BY_VARIANT)
    args = steps.to(device)
    best_k, take_k, taken_k = knapsack._dispatch(*args)
    torch.cuda.synchronize()
    assert knapsack.LAUNCHES == before + 1
    if variant is not None:
        assert knapsack.LAUNCHES_BY_VARIANT[variant] == by_variant[variant] + 1
    best_p, take_p = knapsack.knapsack_dp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(take_k, take_p)
    assert torch.equal(best_k, best_p)
    taken_p = knapsack.taken_steps_plain(take_p, steps.shifts, steps.final_idx)
    np.testing.assert_array_equal(taken_k.cpu().numpy(), taken_p)
    e_n = int(steps.step_entry.max()) + 1
    want = steps.counts(knapsack.unpack_take(take_p, steps.states).cpu().numpy(), e_n)
    np.testing.assert_array_equal(steps.counts_from_taken(taken_k.cpu().numpy(), e_n), want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_equals_plain_seeded(cuda, seed, dtype):
    rng = np.random.RandomState(seed)
    args = _random_pricing(rng, int(rng.randint(1, 5)), int(rng.randint(1, 6)),
                           int(rng.randint(1, 4)), dtype)
    steps = knapsack.pricing_steps(*args)
    if steps.step_values.shape[1]:
        _assert_kernel_equals_plain(steps, cuda)
    got = knapsack.price_knapsacks(*args, device=cuda)
    ref = knapsack.price_knapsacks(*args, device="cpu")
    np.testing.assert_array_equal(got.best, ref.best)
    np.testing.assert_array_equal(got.counts, ref.counts)


def _fleet_steps(grid_states, n_nodes=1, dtype=np.float64):
    """colgen's pricing batch on the 500-camera fleet's grid: 3 bin kinds a
    node, seeded duals."""
    problem = ResourceManager(
        paper_ec2_catalog(), paper_profile_table(), device="cpu"
    ).formulate(_camera_fleet(500))
    class_reqs, _demands, _members = group_items(problem)
    grid = colgen._discretize(problem, class_reqs, grid_states)
    n_kinds = grid.weights.shape[0]
    values = np.random.RandomState(1).uniform(
        0.0, 0.5, size=(n_nodes * n_kinds, len(grid.entries))).astype(dtype)
    return knapsack.pricing_steps(values, np.tile(grid.weights, (n_nodes, 1, 1)),
                                  np.tile(grid.fit, (n_nodes, 1)),
                                  np.tile(grid.cap_levels, (n_nodes, 1)))


@pytest.mark.parametrize("variant", ["cluster", "global"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("grid_states,n_nodes", [(32_768, 5), (131_072, 2)])
def test_kernel_equals_plain_on_fleet_grid(cuda, monkeypatch, grid_states, n_nodes, dtype,
                                           variant):
    """The 500-camera fleet's grid (30,940 states, B = 15 as the main path's
    largest call) and the large grid (120,384 states, 16 slices), each on
    both variants."""
    steps = _fleet_steps(grid_states, n_nodes, dtype)
    assert steps.states in (30_940, 120_384)
    assert knapsack._variant(steps.states) == "cluster"
    monkeypatch.setattr(knapsack, "_variant", lambda s_n: variant)
    _assert_kernel_equals_plain(steps, cuda, variant)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [2, 3, 4, 6, 8, 12, 16])
def test_cluster_sizes_equal_plain(cuda, monkeypatch, c, dtype):
    """The cluster variant at sizes from 2 to 16 on the fleet's 13,552-state
    grid (two slices of 8,192 states hold it), through `_layout`'s slices."""
    steps = _fleet_steps(16_384, 1, dtype)
    assert steps.states == 13_552
    monkeypatch.setattr(knapsack, "_cluster_size", lambda b_n, s_n, n_sms: c)
    _assert_kernel_equals_plain(steps, cuda, "cluster")


def test_cluster_waves_past_the_sms_equal_plain(cuda, monkeypatch):
    """B x C > 132: 18 knapsacks on clusters of 16 run in two waves."""
    steps = _fleet_steps(32_768, 6)
    assert steps.step_values.shape[0] == 18
    monkeypatch.setattr(knapsack, "_cluster_size", lambda b_n, s_n, n_sms: 16)
    _assert_kernel_equals_plain(steps, cuda, "cluster")


def test_global_variant_on_a_grid_past_the_clusters(cuda):
    """A row larger than 16 slices (217,800 states) takes the global variant
    by shape."""
    steps = _fleet_steps(262_144, 1)
    assert knapsack._variant(steps.states) == "global"
    _assert_kernel_equals_plain(steps, cuda, "global")


def test_wrapper_raises_instead_of_falling_back(cuda):
    steps = knapsack.pricing_steps(
        *_random_pricing(np.random.RandomState(0), 3, 4, 2, np.float64))
    sv, sw, fi, levels = steps.to(cuda)
    assert min(sv.shape) > 1  # so that a transposed copy is not contiguous
    before = knapsack.LAUNCHES
    with pytest.raises(KernelError):  # only the kernel refuses it
        knapsack.knapsack_dp(sv.t().contiguous().t(), sw, fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, sw.cpu(), fi, levels)
    with pytest.raises(ValueError):
        knapsack.knapsack_dp(sv, -sw, fi, levels)
    assert knapsack.LAUNCHES == before


def test_colgen_fleet_plan_on_card_equals_cpu_plan(cuda):
    streams = _camera_fleet(30)
    before = knapsack.LAUNCHES
    card = ResourceManager(paper_ec2_catalog(), paper_profile_table()).allocate(
        streams)
    launched = knapsack.LAUNCHES - before
    cpu = ResourceManager(
        paper_ec2_catalog(), paper_profile_table(), device="cpu"
    ).allocate(streams)
    assert launched > 0 and knapsack.LAUNCHES == before + launched
    a, b = plan_to_plain(card), plan_to_plain(cpu)
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


# ---- attention kernels ----------------------------------------------------

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-4, rtol=2.0 ** -7)}


def _normal(seed, shape, dtype, device):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


def _ring_positions(cache_len, cur):
    slots = np.arange(cache_len)
    last = cur - (cur - slots) % cache_len
    return torch.from_numpy(np.where(last >= 0, last, -1).astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,window,softcap", [
    (1, 512, 8, 4, 256, None, 50.0),
    (1, 700, 8, 4, 256, 256, 50.0),
    (2, 300, 16, 8, 128, None, None),
    (2, 77, 4, 2, 64, 16, 30.0),
    (1, 1, 2, 1, 64, None, None),
])
def test_flash_kernel_matches_plain(cuda, b, s, h, kv, d, window, softcap, dtype):
    """The kernel of the dtype's variant, its launch counted under that
    variant, against the plain version."""
    q, k, v = (_normal(i, (b, s, n, d), dtype, cuda) for i, n in enumerate((h, kv, kv)))
    before, by_variant = flash.LAUNCHES, dict(flash.LAUNCHES_BY_VARIANT)
    got = flash.flash_attention(q, k, v, window=window, logit_softcap=softcap)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    variant = flash._variant(dtype)
    assert {n: c - by_variant[n] for n, c in flash.LAUNCHES_BY_VARIANT.items()} == {
        n: int(n == variant) for n in by_variant}
    want = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def flash_exact_inputs(b, s, h, kv, d, device):
    """q_i = 2048 e_i, k_j = e_j (S <= D), random bf16 v: query i's score is
    2048 / sqrt(D) on key i and 0 on every other key, whose weight
    exp(-2048 / sqrt(D)) is 0 in float32, so the output must equal v."""
    pos = torch.arange(s, device=device)
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device=device)
    k = torch.zeros((b, s, kv, d), dtype=torch.bfloat16, device=device)
    q[:, pos, :, pos] = 2048.0
    k[:, pos, :, pos] = 1.0
    v = _normal(5, (b, s, kv, d), torch.bfloat16, device)
    want = v.repeat_interleave(h // kv, dim=2)
    return q, k, v, want


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_wgmma_exact_case_returns_v(cuda, d):
    """The attention counterpart of identity weights: a fragment, swizzle or
    repack fault in the wgmma kernel cannot reproduce v bit for bit."""
    q, k, v, want = flash_exact_inputs(2, d, 4, 2, d, cuda)
    before = flash.LAUNCHES_BY_VARIANT["wgmma"]
    got = flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES_BY_VARIANT["wgmma"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,r,d,L,cur,window,softcap,ring", [
    (4, 4, 2, 256, 2064, 2060, None, 50.0, False),
    (2, 4, 2, 256, 512, 1500, 512, 50.0, True),
    (4, 8, 2, 128, 528, 300, None, None, False),
    (3, 2, 4, 64, 77, 70, 32, None, False),
    (1, 1, 16, 256, 5, 2, None, None, False),
])
def test_decode_kernel_matches_plain(cuda, b, kv, r, d, L, cur, window, softcap, ring, dtype):
    q = _normal(0, (b, kv, r, d), dtype, cuda)
    k, v = (_normal(i, (b, L, kv, d), dtype, cuda) for i in (1, 2))
    if ring:
        pos = _ring_positions(L, cur).to(cuda)
    else:
        pos = torch.where(torch.arange(L) <= cur, torch.arange(L), -1).to(cuda, torch.int32)
    before = decode.LAUNCHES
    got = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap)
    torch.cuda.synchronize()
    assert decode.LAUNCHES == before + 1
    want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                         logit_softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _decode_inputs(b, kv, r, d, cache_len, cur, ring, dtype, device, seed=0):
    q = _normal(seed, (b, kv, r, d), dtype, device)
    k, v = (_normal(seed + i, (b, cache_len, kv, d), dtype, device) for i in (1, 2))
    if ring:
        pos = _ring_positions(cache_len, cur).to(device)
    else:
        pos = torch.where(torch.arange(cache_len) <= cur, torch.arange(cache_len), -1).to(
            device, torch.int32)
    return q, k, v, pos


#: (cache_len, cur, window, softcap, ring): a wrapped ring with a window, a
#: softcapped cache that is not full, a window that binds.
DECODE_KINDS = {"ring": (600, 1500, 512, None, True),
                "softcap": (333, 300, None, 50.0, False),
                "window": (1040, 1030, 200, None, False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(DECODE_KINDS))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("r", [1, 2, 8, 16, 20])
def test_decode_each_variant_matches_plain(cuda, r, d, kind, dtype):
    """The split pass of the dtype's variant, its launch counted under that
    variant, against the plain version: R pads to one row group of 16 (or
    two at R = 20) on ``mma``."""
    cache_len, cur, window, softcap, ring = DECODE_KINDS[kind]
    q, k, v, pos = _decode_inputs(2, 2, r, d, cache_len, cur, ring, dtype, cuda, seed=r + d)
    before = dict(decode.LAUNCHES_BY_VARIANT)
    got = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap)
    torch.cuda.synchronize()
    variant = decode._variant(dtype)
    assert {n: c - before[n] for n, c in decode.LAUNCHES_BY_VARIANT.items()} == {
        n: int(n == variant) for n in before}
    want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                         logit_softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("r,d", [(1, 64), (8, 128), (20, 256)])
def test_decode_mma_matches_plain_over_seeds(cuda, r, d):
    """The wrapped ring with a window over 32 input seeds, on ``mma``: a
    result within tolerance at one seed and outside it at another points at
    a fault that depends on the data, not on the shape."""
    cache_len, cur, window, softcap, ring = DECODE_KINDS["ring"]
    for seed in range(32):
        q, k, v, pos = _decode_inputs(2, 2, r, d, cache_len, cur, ring, torch.bfloat16, cuda,
                                      seed=1000 + seed)
        got = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap)
        want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                             logit_softcap=softcap)
        torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16],
                                   msg=lambda m, seed=seed: f"seed {seed}: {m}")


@pytest.mark.parametrize("kind", sorted(DECODE_KINDS))
@pytest.mark.parametrize("r,d", [(1, 64), (20, 256)])
def test_decode_mma_repeats_bit_for_bit(cuda, r, d, kind):
    """The cluster merges its splits in a fixed rank order, so the same
    inputs give the same bits on every call: a race in the ring or in the
    merge shows as a call that differs from the first."""
    cache_len, cur, window, softcap, ring = DECODE_KINDS[kind]
    q, k, v, pos = _decode_inputs(2, 2, r, d, cache_len, cur, ring, torch.bfloat16, cuda,
                                  seed=r + d)
    first = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap)
    for _ in range(100):
        got = decode.decode_attention(q, k, v, pos, cur, window=window, logit_softcap=softcap)
        assert torch.equal(got, first)


def test_decode_mma_max_splits_follow_the_layout(cuda):
    """The cluster limit comes from the kernel's layout: 16, and the
    portable 8 where two row groups at D = 256 take more than half an SM."""
    assert decode._max_mma_splits(256, 20) == 8
    assert {decode._max_mma_splits(d, r) for d, r in [(64, 1), (64, 128), (128, 2), (128, 64),
                                                      (256, 2), (256, 16)]} == {16}


def decode_exact_inputs(b, kv, r, d, device):
    """L = D slots, k_j = e_j, and query head r of (b, g) q = 2048 e_j* at
    j* = (7 r + 3 g + 5 b) % D: its score is 2048 / sqrt(D) on slot j* and 0
    elsewhere, whose weights exp(-2048 / sqrt(D)) are 0 in float32, so the
    output must equal v[j*] bit for bit."""
    q = torch.zeros((b, kv, r, d), dtype=torch.bfloat16, device=device)
    k = torch.zeros((b, d, kv, d), dtype=torch.bfloat16, device=device)
    slots = torch.arange(d, device=device)
    k[:, slots, :, slots] = 1.0
    v = _normal(6, (b, d, kv, d), torch.bfloat16, device)
    want = torch.empty_like(q)
    for bi in range(b):
        for g in range(kv):
            for ri in range(r):
                j = (7 * ri + 3 * g + 5 * bi) % d
                q[bi, g, ri, j] = 2048.0
                want[bi, g, ri] = v[bi, j, g]
    pos = torch.arange(d, dtype=torch.int32, device=device)
    return q, k, v, pos, want


@pytest.mark.parametrize("r", [2, 16, 20])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_mma_exact_case_returns_v(cuda, d, r):
    """The decode counterpart of flash's exact case: a fragment, swizzle or
    lane-map fault in the ``mma`` split pass, or a wrong merge of the
    splits, cannot reproduce v bit for bit."""
    q, k, v, pos, want = decode_exact_inputs(2, 2, r, d, cuda)
    before = decode.LAUNCHES_BY_VARIANT["mma"]
    got = decode.decode_attention(q, k, v, pos, d - 1)
    torch.cuda.synchronize()
    assert decode.LAUNCHES_BY_VARIANT["mma"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cur,window", [(-1, None), (2000, 10)])
def test_decode_fully_masked_cache_returns_the_mean_of_v(cuda, cur, window, dtype):
    """No valid slot (every position past cur, or before the window): every
    score is -2e38, so each split weighs its slots alike and the output is
    the mean of v over the cache, as in the TPU kernel."""
    q, k, v, _ = _decode_inputs(2, 2, 4, 128, 700, 699, False, dtype, cuda)
    pos = torch.arange(700, dtype=torch.int32, device=cuda)
    got = decode.decode_attention(q, k, v, pos, cur, window=window)
    want = v.float().mean(dim=1)[:, :, None, :].expand(q.shape)
    torch.testing.assert_close(got.float(), want, **TOL[dtype])
    torch.testing.assert_close(got, decode.decode_attention_plain(
        q, k, v, pos, cur, window=window), **TOL[dtype])


def test_attention_wrappers_raise_instead_of_falling_back(cuda):
    q = _normal(0, (1, 64, 4, 64), torch.float32, cuda)
    k = _normal(1, (1, 64, 2, 64), torch.float32, cuda)
    before = (flash.LAUNCHES, decode.LAUNCHES)
    with pytest.raises(ValueError):  # not contiguous
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError):  # a head_dim the kernel is not built for
        flash.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                              k[..., :48].contiguous())
    with pytest.raises(ValueError):  # another device
        flash.flash_attention(q, k.cpu(), k)
    dq = _normal(2, (1, 2, 2, 64), torch.float32, cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        decode.decode_attention(dq, k, k, pos.cpu(), 10)
    with pytest.raises(ValueError):
        decode.decode_attention(dq[..., :32].contiguous(), k[..., :32].contiguous(),
                                k[..., :32].contiguous(), pos, 10)
    assert (flash.LAUNCHES, decode.LAUNCHES) == before


def test_engine_on_card_gives_the_cpu_engine_tokens(cuda):
    """Smoke gemma2-2b with GQA in float32: greedy tokens on the card (both
    kernels) equal those on the CPU (plain versions)."""
    cfg = dataclasses.replace(smoke_variant(get_config("gemma2-2b")), num_kv_heads=2,
                              dtype="float32")
    params = tfm.init_params(cfg, seed=3, device="cpu")
    tokens = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params.to(dev), batch_slots=2, max_seq=48, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(20 + 3 * i) % cfg.vocab_size,
                               max_new_tokens=12))
        before = (flash.LAUNCHES, decode.LAUNCHES)
        tokens[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        launched = (flash.LAUNCHES - before[0], decode.LAUNCHES - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (2 * 2, 2 * 2 * 12))
    assert tokens["cpu"] == tokens[str(cuda)]


# ---- the SSD and RG-LRU scans ------------------------------------------------
#
# The SSD kernel and its plain version cut S into the same chunks and differ
# in the order of their float32 sums: float32 at the reference's kernel
# limits (atol 2e-4, rtol 1e-3); bfloat16 y one bf16 ulp more (rtol 2^-7),
# since both round the float32 result once.  The RG-LRU kernel runs the same
# multiply-adds, composed chunk by chunk: 2e-5.

SSD_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=2e-4, rtol=1e-3 + 2.0 ** -7)}
RGLRU_TOL = dict(atol=2e-5, rtol=2e-5)


def _ssd_inputs(b, s, h, p, n, dtype, device, with_h0=True):
    """Bm and Cm as column slices of one (B, S, 2N) tensor, as the model passes them."""
    x = _normal(0, (b, s, h, p), dtype, device)
    dt = torch.nn.functional.softplus(_normal(1, (b, s, h), torch.float32, device))
    A = -torch.exp(0.5 * _normal(2, (h,), torch.float32, device))
    bc = (0.5 * _normal(3, (b, s, 2 * n), torch.float32, device)).to(dtype)
    h0 = 0.1 * _normal(4, (b, h, p, n), torch.float32, device) if with_h0 else None
    return x, dt, A, bc[..., :n], bc[..., n:], h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (4, 1024, 64, 64, 128, 128, True),   # mamba2-1.3b's served prefill
    (4, 1024, 64, 64, 128, 128, False),
    (2, 1000, 8, 64, 128, 128, True),    # ragged
    (2, 7, 8, 64, 128, 128, True),       # one short chunk
    (2, 256, 4, 64, 32, 64, True),       # tests/test_kernels.py:68-70
    (1, 128, 2, 32, 128, 128, True),
    (1, 256, 2, 64, 64, 32, True),
    (2, 77, 3, 32, 32, 32, False),
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, with_h0, dtype):
    args = _ssd_inputs(b, s, h, p, n, dtype, cuda, with_h0)
    before = ssd.LAUNCHES
    y, hf = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == before + 1
    y_p, h_p = ssd.ssd_scan_plain(*args, chunk=chunk)
    assert y.dtype == dtype and hf.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(hf, h_p, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("p", [32, 64])
def test_ssd_each_variant_matches_plain_over_the_grid(cuda, p, n, chunk, dtype):
    """Every built (P, N, chunk) on the dtype's variant, its launch counted
    under that variant: three chunks, the last partial, with h0."""
    args = _ssd_inputs(2, 2 * chunk + 5, 3, p, n, dtype, cuda)
    before = dict(ssd.LAUNCHES_BY_VARIANT)
    y, hf = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    variant = ssd._variant(dtype)
    assert {v: c - before[v] for v, c in ssd.LAUNCHES_BY_VARIANT.items()} == {
        v: int(v == variant) for v in before}
    y_p, h_p = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(hf, h_p, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_unaligned_strided_b_and_c(cuda, with_h0, dtype):
    """B and C as views one element into a (B, S, 2N + 3) tensor: rows that
    are not 16-byte aligned, which the ``mma`` variant copies element by
    element; the partial last chunk is 7 rows."""
    b, s, h, p, n = 2, 263, 4, 64, 128
    x, dt, A, _, _, h0 = _ssd_inputs(b, s, h, p, n, dtype, cuda, with_h0)
    bc = (0.5 * _normal(7, (b, s, 2 * n + 3), torch.float32, cuda)).to(dtype)
    Bm, Cm = bc[..., 1:n + 1], bc[..., n + 2:2 * n + 2]
    y, hf = ssd.ssd_scan(x, dt, A, Bm, Cm, h0)
    y_p, h_p = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, h0)
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(hf, h_p, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("b,s,w,with_h0", [
    (4, 1024, 4096, True),  # recurrentgemma-9b's served prefill
    (4, 1000, 4096, True),  # a partial last box
    (2, 7, 100, False),     # one partial box, no h0
    (3, 130, 77, True),     # ragged W: the cp_async variant
])
def test_rglru_kernel_matches_plain(cuda, b, s, w, with_h0):
    a = torch.sigmoid(_normal(0, (b, s, w), torch.float32, cuda))
    bb = 0.3 * _normal(1, (b, s, w), torch.float32, cuda)
    h0 = 0.1 * _normal(2, (b, w), torch.float32, cuda) if with_h0 else None
    variant = rglru._variant(w)
    before = rglru.LAUNCHES, rglru.LAUNCHES_BY_VARIANT[variant]
    got = rglru.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert (rglru.LAUNCHES, rglru.LAUNCHES_BY_VARIANT[variant]) == (before[0] + 1,
                                                                    before[1] + 1)
    torch.testing.assert_close(got, rglru.rglru_scan_plain(a, bb, h0), **RGLRU_TOL)


@pytest.mark.parametrize("variant", ["tma", "cp_async"])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("b,s,w,with_h0", [(4, 1024, 4096, True), (2, 65, 100, False),
                                           (1, 1, 4096, True), (3, 1000, 256, True)])
def test_rglru_each_variant_matches_plain(cuda, monkeypatch, b, s, w, with_h0, lanes,
                                          variant):
    """Both variants at both CTA widths on the same inputs (every W here is
    a multiple of 4, so both can run): ragged S, one step, h0 absent."""
    a = torch.sigmoid(_normal(3, (b, s, w), torch.float32, cuda))
    bb = 0.3 * _normal(4, (b, s, w), torch.float32, cuda)
    h0 = 0.1 * _normal(5, (b, w), torch.float32, cuda) if with_h0 else None
    monkeypatch.setattr(rglru, "_variant", lambda w, aligned=True: variant)
    monkeypatch.setattr(rglru, "_lanes", lambda bsz, w, n_sms: lanes)
    before = rglru.LAUNCHES_BY_VARIANT[variant]
    got = rglru.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert rglru.LAUNCHES_BY_VARIANT[variant] == before + 1
    torch.testing.assert_close(got, rglru.rglru_scan_plain(a, bb, h0), **RGLRU_TOL)


def test_rglru_misaligned_base_takes_cp_async(cuda):
    """a and b at a 4-byte offset: TMA cannot take them, so the shape check
    picks cp_async before the launch; forcing TMA there raises."""
    buf = torch.sigmoid(_normal(6, (2 * 64 * 256 + 1,), torch.float32, cuda))
    a = buf[1:].view(2, 64, 256)  # contiguous, 4 bytes past an aligned base
    assert a.data_ptr() % 16 and a.is_contiguous()
    before = rglru.LAUNCHES_BY_VARIANT["cp_async"]
    got = rglru.rglru_scan(a, a)
    torch.cuda.synchronize()
    assert rglru.LAUNCHES_BY_VARIANT["cp_async"] == before + 1
    torch.testing.assert_close(got, rglru.rglru_scan_plain(a, a), **RGLRU_TOL)
    fn = rglru._kernel_fn("tma")
    rc = fn(0, 64, a.data_ptr(), a.data_ptr(), None, torch.empty_like(a).data_ptr(), 2, 64,
            256, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_scan_wrappers_raise_instead_of_falling_back(cuda):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(1, 64, 2, 64, 64, torch.float32, cuda)
    before = (ssd.LAUNCHES, rglru.LAUNCHES)
    with pytest.raises(TypeError):  # a dtype the kernel is not built for
        ssd.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), h0)
    with pytest.raises(ValueError):  # P = 48
        ssd.ssd_scan(x[..., :48], dt, A, Bm, Cm, h0[:, :, :48])
    with pytest.raises(ValueError):  # N = 48
        ssd.ssd_scan(x, dt, A, Bm[..., :48], Cm[..., :48], h0[..., :48].contiguous())
    with pytest.raises(ValueError):  # chunk 16
        ssd.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=16)
    with pytest.raises(ValueError):  # x not contiguous
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, h0)
    with pytest.raises(ValueError):  # Bm strided along N
        ssd.ssd_scan(x, dt, A, Bm.transpose(0, 2).contiguous().transpose(0, 2), Cm, h0)
    with pytest.raises(ValueError):  # another device
        ssd.ssd_scan(x, dt.cpu(), A, Bm, Cm, h0)
    a = torch.rand(2, 16, 64, device=cuda)
    with pytest.raises(TypeError):
        rglru.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError):
        rglru.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), a)
    with pytest.raises(ValueError):
        rglru.rglru_scan(a, a, torch.zeros(2, 64))
    assert (ssd.LAUNCHES, rglru.LAUNCHES) == before


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_recurrent_engines_on_card_give_the_cpu_engine_tokens(cuda, arch):
    """Smoke mamba2-1.3b (its chunk raised to 32, a size the SSD kernel is
    built for) and recurrentgemma-9b in float32: greedy tokens on the card
    (every kernel) equal those on the CPU (plain versions), prompts past
    one chunk and decode past the 16-slot windows."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32", ssm_chunk=32)
    params = tfm.init_params(cfg, seed=3, device="cpu")
    tokens = {}
    kinds = {k: cfg.layer_pattern.count(k) * cfg.num_groups
             for k in ("attention", "ssd", "recurrent")}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params.to(dev), batch_slots=2, max_seq=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(30 + 7 * i) % cfg.vocab_size,
                               max_new_tokens=12))
        mods = (flash, decode, ssd, rglru)
        before = [m.LAUNCHES for m in mods]
        tokens[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        launched = [m.LAUNCHES - n for m, n in zip(mods, before)]
        waves, steps = 2, 2 * 12
        want = [kinds["attention"] * waves, kinds["attention"] * steps, kinds["ssd"] * waves,
                kinds["recurrent"] * waves]
        assert launched == ([0, 0, 0, 0] if dev == "cpu" else want)
    assert tokens["cpu"] == tokens[str(cuda)]


# ---- the grouped GEMM ----------------------------------------------------------
#
# Kernel and plain version both accumulate in float32 and round once to the
# input type; they differ in the order of their sums, so they share the
# attention kernels' limits (`TOL`): 2e-5 in float32; one bf16 ulp (rtol
# 2^-7) plus atol 1e-4 in bfloat16.  The weights are N(0, 1/K), as the
# model draws them, so outputs are O(1) at any K.


def _ragged(counts, k, f, dtype, device, tail=0):
    """x sorted by expert (``tail`` rows past the last segment), w and offsets."""
    n = sum(counts) + tail
    x = _normal(0, (n, k), dtype, device)
    w = _normal(1, (len(counts), k, f), torch.float32, device) / np.sqrt(k)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    return x, w.to(dtype), offsets.to(device)


#: Segments of 0, 1, 63, 64, 65, 129 and 320 rows: one short of, at and past
#: the kernels' row tiles (128, 64 a warpgroup).
EDGE_SEGMENTS = [0, 1, 63, 64, 65, 129, 320]


def _launch_checked(x, w, offsets, variant=None):
    """The kernel (``variant`` forced, or the one `_variant` picks), with
    its variant's launch count checked; rows outside the segments zero."""
    k, f = w.shape[1:]
    want = variant or gg._variant(k, f, x.dtype)
    before = dict(gg.LAUNCHES_BY_VARIANT)
    got = (gg._dispatch(x, w, offsets, variant) if variant
           else gg.grouped_gemm_ragged(x, w, offsets))
    torch.cuda.synchronize()
    assert {v: gg.LAUNCHES_BY_VARIANT[v] - before[v] for v in before} == {
        v: int(v == want) for v in before}
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not got[:lo].any() and not got[hi:].any()  # rows outside every segment
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts,k,f,tail", [
    ([256] * 128, 2048, 768, 0),                   # qwen3's prefill gate/up: wgmma in bf16
    ([300, 0, 0, 171, 90, 0, 400, 63], 768, 2048, 17),  # empty experts, drops, long rows
    ([1, 0, 2, 0, 0, 1] + [0] * 122, 2048, 768, 28),  # decode: wgmma in bf16
    ([5, 0, 3, 9], 100, 77, 3),                    # ragged K and F: simt
    ([0, 0, 0, 0], 64, 64, 6),                     # every expert empty
    (EDGE_SEGMENTS + [0], 2048, 136, 5),           # N = 647; F = 136: a partial column tile
    (EDGE_SEGMENTS, 768, 2048, 3),                 # down's shape
    (EDGE_SEGMENTS + [0] * 643, 256, 136, 7),      # 650 experts
    ([0, 0, 4096, 0], 2048, 768, 0),               # all rows on one expert
    ([0] * 100 + [32] + [0] * 27, 2048, 768, 0),   # a decode step on one expert
    ([100, 200, 0, 50], 72, 64, 9),                # K = 72: a K tail of 8
])
def test_grouped_gemm_kernel_matches_plain(cuda, counts, k, f, tail, dtype):
    x, w, offsets = _ragged(counts, k, f, dtype, cuda, tail)
    before = gg.LAUNCHES
    got = _launch_checked(x, w, offsets)
    assert gg.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), gg.grouped_gemm_plain(x, w, offsets).float(),
                               **TOL[dtype])
    assert not got[sum(counts):].any()  # rows past the last segment stay zero


@pytest.mark.parametrize("variant,dtype", [
    ("wgmma", torch.bfloat16), ("simt", torch.bfloat16), ("simt", torch.float32)])
@pytest.mark.parametrize("k,f", [(2048, 768), (768, 136)])
def test_grouped_gemm_each_variant_matches_plain(cuda, variant, dtype, k, f):
    """Every kernel on the same inputs, whatever `_variant` would pick:
    the edge segments, a leading empty expert and dropped rows."""
    counts = [0] + EDGE_SEGMENTS + [2, 0]
    x, w, offsets = _ragged(counts, k, f, dtype, cuda, tail=11)
    got = _launch_checked(x, w, offsets, variant)
    torch.testing.assert_close(got.float(), gg.grouped_gemm_plain(x, w, offsets).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("variant", ["wgmma", "simt"])
@pytest.mark.parametrize("k,f", [(2048, 768), (256, 136)])
def test_grouped_gemm_identity_weights_are_exact(cuda, variant, k, f):
    """w[e] is the identity, its columns rotated by e: out[r, j] must be
    x[r, (j - e) mod F] exactly, in bf16.  A B tile read transposed, with
    the wrong swizzle or the wrong expert, cannot pass."""
    counts = [70, 0, 129, 1, 64, 200]
    x, _, offsets = _ragged(counts, k, f, torch.bfloat16, cuda, tail=4)
    e_n = len(counts)
    w = torch.zeros((e_n, k, f), dtype=torch.bfloat16, device=cuda)
    rows = torch.arange(min(k, f), device=cuda)
    for e in range(e_n):
        w[e, rows, (rows + e) % f] = 1.0
    got = _launch_checked(x, w, offsets, variant)
    want = torch.zeros_like(got)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    cols = torch.arange(f, device=cuda)
    for e in range(e_n):
        lo, hi = int(bounds[e]), int(bounds[e + 1])
        src = (cols - e) % f
        want[lo:hi] = torch.where(src < k, x[lo:hi, src.clamp(max=k - 1)], 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("block_t", [64, 128])
def test_grouped_gemm_reference_contract_matches_plain(cuda, block_t):
    """`pad_and_sort_tokens` then the adapter: every padded row computed."""
    t, d, e, f = 512, 128, 8, 256
    x = _normal(0, (t, d), torch.bfloat16, cuda)
    w = (_normal(1, (e, d, f), torch.float32, cuda) / np.sqrt(d)).bfloat16()
    eids = torch.from_numpy(np.random.RandomState(2).randint(0, e, size=t)).to(cuda)
    eids[eids == 3] = 4  # an empty expert
    xs, bmap, inv = gg.pad_and_sort_tokens(x, eids, e, block_t=block_t)
    before = gg.LAUNCHES
    got = gg.grouped_gemm(xs, w, bmap, block_t=block_t)
    torch.cuda.synchronize()
    assert gg.LAUNCHES == before + 1
    want = (x.float()[:, None, :] @ w.float()[eids]).squeeze(1).bfloat16()
    torch.testing.assert_close(got[inv.long()].float(), want.float(), **TOL[torch.bfloat16])


def test_grouped_gemm_reference_contract_takes_blocks_in_any_order(cuda):
    """A ``block_expert`` that is not nondecreasing: the adapter gathers the
    blocks into expert order, runs one ragged product and scatters the
    output back, block for block the product with its own expert."""
    block_t, d, e, f = 64, 256, 4, 128
    bmap = torch.tensor([2, 0, 2, 1, 3, 0], dtype=torch.int32, device=cuda)
    x = _normal(0, (block_t * len(bmap), d), torch.bfloat16, cuda)
    w = (_normal(1, (e, d, f), torch.float32, cuda) / np.sqrt(d)).bfloat16()
    before = gg.LAUNCHES
    got = gg.grouped_gemm(x, w, bmap, block_t=block_t)
    torch.cuda.synchronize()
    assert gg.LAUNCHES == before + 1
    for i, ex in enumerate(bmap.tolist()):
        rows = slice(i * block_t, (i + 1) * block_t)
        want = (x[rows].float() @ w[ex].float()).bfloat16()
        torch.testing.assert_close(got[rows].float(), want.float(), **TOL[torch.bfloat16])


def test_grouped_gemm_wrapper_raises_instead_of_falling_back(cuda):
    x, w, offsets = _ragged([4, 4], 64, 32, torch.float32, cuda)
    before = gg.LAUNCHES
    with pytest.raises(ValueError):  # not contiguous
        gg.grouped_gemm_ragged(x.t().contiguous().t(), w, offsets)
    with pytest.raises(ValueError):  # another device
        gg.grouped_gemm_ragged(x, w, offsets.cpu())
    with pytest.raises(TypeError):  # a dtype the kernel is not built for
        gg.grouped_gemm_ragged(x.half(), w.half(), offsets)
    assert gg.LAUNCHES == before


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_engines_on_card_give_the_cpu_engine_tokens(cuda, arch):
    """Smoke qwen3-moe-30b-a3b and grok-1-314b in float32: greedy tokens on
    the card (flash, flash-decode, the grouped GEMM) equal those on the CPU
    (plain versions); the prefills drop pairs at capacity."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    params = tfm.init_params(cfg, seed=3, device="cpu")
    tokens = {}
    layers = cfg.num_layers
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params.to(dev), batch_slots=2, max_seq=64, device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(16 + 5 * i) % cfg.vocab_size,
                               max_new_tokens=12))
        mods = (flash, decode, gg)
        before = [m.LAUNCHES for m in mods]
        tokens[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        launched = [m.LAUNCHES - n for m, n in zip(mods, before)]
        waves, steps = 2, 2 * 12
        want = [layers * waves, layers * steps, 3 * layers * (waves + steps)]
        assert launched == ([0, 0, 0] if dev == "cpu" else want)
    assert tokens["cpu"] == tokens[str(cuda)]


# ---- calibration and the analysis programs ------------------------------

def _random_workloads(name, n, seed):
    """FLOPs and bytes log-uniform over 1e3-1e16, memory inside the preset
    catalog's largest capacity (as tests/test_torch_calibration.py draws)."""
    catalog = cal.PRESETS[name].catalog_fn()
    caps = cal._max_caps((bt.name, tuple(float(c) for c in bt.capacity)) for bt in catalog)
    rng = np.random.RandomState(seed)
    mem_cap = max(caps[1], caps[3])
    return tuple(
        cal.ProgramWorkload(f"w{i}", float(10.0 ** rng.uniform(3, 16)),
                            float(10.0 ** rng.uniform(3, 16)),
                            float(rng.uniform(1e-3, mem_cap)))
        for i in range(n)
    )


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "raw"])
@pytest.mark.parametrize("name", sorted(cal.PRESETS))
def test_calibrate_torch_on_card_equals_numpy(cuda, monkeypatch, name, quantized):
    """On CUDA a tensor over a CPU scalar multiplies by the reciprocal; the
    torch path divides tensor by tensor, so it must equal the scalar path
    bit for bit, before quantization too."""
    if not quantized:
        monkeypatch.setattr(cal, "_quant", float)
    preset = cal.PRESETS[name]
    kwargs = dict(cpu=preset.cpu, roofline=preset.roofline,
                  host_cores_fraction=preset.host_cores_fraction)
    for workloads in (preset.workloads_fn(), _random_workloads(name, 256, len(name))):
        np_art = cal.calibrate(preset.catalog_fn(), workloads, impl="numpy", **kwargs)
        card = cal.calibrate(preset.catalog_fn(), workloads, impl="torch", **kwargs)
        assert card.entries == np_art.entries


def test_calibrated_allocation_on_card_equals_cpu_plan(cuda):
    art = cal.load_or_calibrate("ec2")
    vgg, zf = AnalysisProgram("vgg16", "vgg16"), AnalysisProgram("zf", "zf")
    streams = ([StreamSpec(f"v{i}", vgg, 0.2) for i in range(20)]
               + [StreamSpec(f"z{i}", zf, 5.0) for i in range(20)])
    before = knapsack.LAUNCHES
    card = ResourceManager(paper_ec2_catalog(), calibration=art,
                           solver="colgen").allocate(streams)
    assert knapsack.LAUNCHES > before
    cpu = ResourceManager(paper_ec2_catalog(), calibration=art, solver="colgen",
                          device="cpu").allocate(streams)
    a, b = plan_to_plain(card), plan_to_plain(cpu)
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key
    assert card.hourly_cost == pytest.approx(3.9, abs=1e-9) and card.optimal


@pytest.mark.parametrize("program_id", ["vgg16", "zf"])
def test_analysis_program_on_card_matches_cpu(cuda, program_id):
    frame = ap.make_frame(ap.FrameSize(640, 480))
    out = ap.PROGRAMS[program_id](frame)
    assert out.device.type == "cuda" and out.shape == (1, 105)
    want = ap.PROGRAMS[program_id](frame, device="cpu")
    got = out.cpu()
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-3 * scale, rtol=0)


# ---- the live loop: the pack scan and the placement scores ----------------
#
# Both kernels do adds, a division and compares in float64, each rounded
# once, so each must equal its plain version bit for bit.

def _scan_inputs(seed, b_n, n, c, n_bt, dim=4, pad_items=True):
    """A random padded batch as `heuristics._pad_fleets` lays it out."""
    rng = np.random.RandomState(seed)
    caps = rng.uniform(4.0, 12.0, size=(n_bt, dim))
    costs = rng.uniform(0.2, 2.0, size=n_bt)
    req = rng.uniform(0.05, 1.0, size=(b_n, n, c, dim)) * caps.min(axis=0)
    mask = rng.rand(b_n, n, c) < 0.8
    mask[..., 0] = True
    if pad_items:
        for b in range(b_n):
            mask[b, n - b:] = False  # fleet b has b padding items
    req[~mask] = np.inf
    score = rng.uniform(0.1, 2.0, size=(b_n, n, n_bt, c))
    score[:, :, :, :] = np.where(mask[:, :, None, :], score, np.inf)
    order = np.stack([rng.permutation(n) for _ in range(b_n)])
    return req, mask, score, order, caps, costs


def _assert_scan_equals_plain(args, device, best_fit, variant=None, monkeypatch=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
    if variant is not None:
        monkeypatch.setattr(pack, "_variant", lambda n, c, dim: variant)
    before = pack.LAUNCHES_BY_VARIANT.copy()
    recs, n_open, total = pack.pack_scan(*t, best_fit=best_fit)
    torch.cuda.synchronize()
    p_recs, p_open, p_total = pack.pack_scan_plain(*t, best_fit=best_fit)
    for a, b in zip(recs, p_recs):
        assert torch.equal(a, b)
    assert torch.equal(n_open, p_open) and torch.equal(total, p_total)
    if variant is not None:
        assert pack.LAUNCHES_BY_VARIANT[variant] == before[variant] + 1


@pytest.mark.parametrize("best_fit", [False, True], ids=["ffd", "bfd"])
@pytest.mark.parametrize("b_n,n,c,n_bt", [(1, 1, 1, 1), (3, 17, 2, 3), (8, 120, 3, 5),
                                          (2, 600, 2, 10)])
def test_pack_scan_kernel_equals_plain(cuda, b_n, n, c, n_bt, best_fit):
    _assert_scan_equals_plain(_scan_inputs(n + b_n, b_n, n, c, n_bt), cuda, best_fit)


@pytest.mark.parametrize("best_fit", [False, True], ids=["ffd", "bfd"])
def test_pack_scan_global_variant_equals_plain(cuda, monkeypatch, best_fit):
    """The global-memory variant, forced at a shape the shared one takes."""
    _assert_scan_equals_plain(_scan_inputs(5, 4, 90, 2, 4), cuda, best_fit, "global",
                              monkeypatch)


def test_pack_scan_takes_global_memory_past_shared_memory(cuda):
    """A fleet whose loads and capacities outgrow a CTA's shared memory."""
    assert pack._variant(4000, 2, 4) == "global"
    assert pack._variant(500, 2, 4) == "shared"
    args = _scan_inputs(9, 1, 4000, 2, 3, pad_items=False)
    _assert_scan_equals_plain(args, cuda, False)


def test_pack_scan_on_a_500_stream_forecast_cone(cuda):
    """A what-if cone at the live loop's scale: 500 streams, 3 forecast
    joins by 2 leaves, through `batched_fleet_costs` on the card and the
    plain scan on the card, and the numpy packer per fleet."""
    fleet = _camera_fleet(500)
    joins = tuple(_camera_fleet(503)[500:])
    joins = tuple(dataclasses.replace(s, name=f"f{i}") for i, s in enumerate(joins))
    from repro_torch.core.streams import StreamForecast, forecast_cone

    fleets = forecast_cone(fleet, StreamForecast(joins=joins, leaves=("cam3", "cam7")))
    mgr = ResourceManager(paper_ec2_catalog(), paper_profile_table())
    problems = [mgr.formulate(list(f)) for f in fleets]
    ts = [p.tensors() for p in problems]
    padded = heuristics._pad_fleets(problems, ts)
    for best_fit in (False, True):
        _assert_scan_equals_plain(padded + (ts[0].caps, ts[0].costs), cuda, best_fit)
        before = pack.LAUNCHES
        costs = heuristics.batched_fleet_costs(problems, best_fit=best_fit)
        assert pack.LAUNCHES == before + 1
        assert costs.tolist() == [heuristics._pack(p, best_fit).cost for p in problems]


@pytest.mark.parametrize("k,c,p", [(1, 1, 1), (3, 2, 40), (500, 2, 64), (37, 3, 1029)])
def test_placement_kernel_equals_plain(cuda, k, c, p):
    rng = np.random.RandomState(k + p)
    req = rng.uniform(0.0, 2.0, size=(k, c, 4))
    mask = rng.rand(k, c) < 0.8
    req[~mask] = np.inf
    resid = rng.uniform(0.0, 2.0, size=(p, 4))
    resid[0] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (req, mask, resid)]
    before = placement.LAUNCHES
    got = placement.placement_scores(*args)
    assert placement.LAUNCHES == before + 1
    want = placement.placement_scores_plain(*args)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  heuristics.placement_scores_np(req, mask, resid))


def test_placement_routes_by_size_on_the_card(cuda, monkeypatch):
    rng = np.random.RandomState(3)
    small = (rng.rand(1, 2, 4), np.ones((1, 2), dtype=bool), rng.rand(3, 4) + 1.0)
    k = heuristics._CUDA_MIN_CANDIDATES // 2 + 1
    large = (rng.rand(k, 2, 4), np.ones((k, 2), dtype=bool), rng.rand(1, 4) + 1.0)
    monkeypatch.setitem(heuristics.PLACEMENT_ROUTES, "kernel", 0)
    monkeypatch.setitem(heuristics.PLACEMENT_ROUTES, "numpy", 0)
    for req, mask, resid in (small, large):
        got = heuristics.placement_scores(req, mask, resid)
        assert got.flags.writeable
        np.testing.assert_array_equal(got, heuristics.placement_scores_np(req, mask, resid))
    assert heuristics.PLACEMENT_ROUTES == {"kernel": 1, "numpy": 1}


def test_live_kernel_wrappers_raise_instead_of_falling_back(cuda):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in _scan_inputs(1, 2, 9, 2, 3)]
    before = (pack.LAUNCHES, placement.LAUNCHES)
    with pytest.raises(TypeError):
        pack.pack_scan(args[0].float(), *args[1:], best_fit=False)
    with pytest.raises(ValueError):
        pack.pack_scan(args[0], args[1].cpu(), *args[2:], best_fit=False)
    with pytest.raises(KernelError):  # only the kernel refuses it
        pack.pack_scan(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:],
                       best_fit=False)
    req = args[0][0]
    with pytest.raises(KernelError):  # only the kernel refuses it
        placement.placement_scores(req.transpose(0, 1).contiguous().transpose(0, 1),
                                   args[1][0], args[4])
    assert (pack.LAUNCHES, placement.LAUNCHES) == before


def test_short_replay_on_card_equals_the_cpu_replay(cuda):
    """The acting autoscaler over a 40-stream growth trace: every what-if on
    the pack scan, on the card and with ``device="cpu"``; the whole
    `simulate_churn` output equal."""
    from repro_torch.core.lifecycle import BillingModel
    from repro_torch.core.policy import ActingAutoscaler
    from repro_torch.core.simulator import simulate_churn
    from repro_torch.core.streams import StreamAdded, StreamForecast, synthetic_timed_trace

    vgg, zf = AnalysisProgram("VGG-16", "vgg16"), AnalysisProgram("ZF", "zf")
    kinds = [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]
    initial = [StreamSpec(f"s{i}", *kinds[i % 5]) for i in range(40)]
    trace = synthetic_timed_trace(
        initial, np.random.RandomState(2618), n_events=20, mean_gap_hours=0.03, p_join=0.6,
        p_leave=0.15, make_join=lambda i: StreamSpec(f"g{i}", *kinds[i % 5]), burst=3)
    adds = [(ev.at, ev.stream) for ev in trace if isinstance(ev, StreamAdded)]

    def forecast(fleet, event):
        now = event.at if event is not None else 0.0
        live = {s.name for s in fleet}
        return StreamForecast(joins=tuple(
            s for t, s in adds if now < t <= now + 0.15 and s.name not in live)[:3])

    outs = []
    for device in (None, "cpu"):
        mgr = ResourceManager(paper_ec2_catalog(), paper_profile_table(), device=device)
        mgr.controller(gap_threshold=0.3)
        before = pack.LAUNCHES
        outs.append(simulate_churn(
            mgr, initial, trace, paper_profile_table(),
            policy=ActingAutoscaler(forecast=forecast, max_spares=3),
            billing=BillingModel(boot_hours=2.0 / 60.0, quantum_hours=1.0)))
        assert (pack.LAUNCHES > before) == (device is None)
    assert outs[0] == outs[1]


# ---- the flash backward kernel and the training step -------------------------


def _grads_close(got, want, dtype):
    """dq, dk, dv within the forward's limits relative to the largest |grad|
    of the three (chip_smoke.py's `BWD_TOLERANCE`): at S = 1 dq is zero
    but for rounding, which no scale of its own can judge."""
    share, rtol = (1e-4, 2.0 ** -7) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=share * scale,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,window,softcap", [
    (1, 512, 8, 4, 256, None, 50.0),
    (1, 700, 8, 4, 256, 256, 50.0),
    (2, 300, 16, 8, 128, None, None),
    (2, 77, 4, 2, 64, 16, 30.0),
    (1, 1, 2, 1, 64, None, None),
    (2, 129, 4, 1, 128, 1, None),
])
def test_flash_backward_kernel_matches_plain(cuda, b, s, h, kv, d, window, softcap, dtype):
    """The forward's lse against the plain logsumexp, and the backward's
    three passes (counted) against `flash_attention_backward_plain` on the
    same inputs: ragged S, GQA 1-4, windows binding and not, softcaps."""
    q, k, v, do = (_normal(i, (b, s, n, d), dtype, cuda) for i, n in enumerate((h, kv, kv, h)))
    out, lse = flash._dispatch(q, k, v, window, softcap, with_lse=True)
    _, want_lse = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=softcap,
                                              return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    before, passes = flash.BWD_LAUNCHES, dict(flash.BWD_PASSES)
    got = flash.flash_attention_backward(q, k, v, out, lse, do, window=window,
                                         logit_softcap=softcap)
    torch.cuda.synchronize()
    assert flash.BWD_LAUNCHES == before + 1
    assert all(flash.BWD_PASSES[n] == passes[n] + 1 for n in passes)
    want = flash.flash_attention_backward_plain(q, k, v, out, lse, do, window=window,
                                                logit_softcap=softcap)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_backward_tiles_follow_the_library(cuda, d):
    """Ranges written for other tiles than the kernel's own are refused."""
    q = _normal(0, (1, 96, 2, d), torch.float32, cuda)
    out, lse = flash._dispatch(q, q, q, None, None, with_lse=True)
    flash.flash_attention_backward(q, q, q, out, lse, q)
    bq, bk = flash.BWD_TILES[d]
    flash.BWD_TILES[d] = (2 * bq, bk)
    try:
        with pytest.raises(KernelError):
            flash.flash_attention_backward(q, q, q, out, lse, q)
    finally:
        flash.BWD_TILES[d] = (bq, bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_on_card_launches_both_kernels(cuda, dtype):
    """With grad, `flash_attention` runs the forward kernel with lse and its
    backward kernel once; under no_grad it writes no lse (the serving
    route) and gives the same output."""
    q, k, v = (_normal(i, (2, 96, 4, 64), dtype, cuda).requires_grad_()
               for i in range(3))
    do = _normal(3, (2, 96, 4, 64), dtype, cuda)
    before = (flash.LAUNCHES, flash.BWD_LAUNCHES)
    out = flash.flash_attention(q, k, v, window=40, logit_softcap=50.0)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        assert torch.equal(flash.flash_attention(q, k, v, window=40, logit_softcap=50.0), out)
        _, lse = flash._dispatch(q, k, v, 40, 50.0, with_lse=True)
        want = flash.flash_attention_backward_plain(q, k, v, out, lse, do, window=40,
                                                    logit_softcap=50.0)
    _grads_close((q.grad, k.grad, v.grad), want, dtype)


def test_flash_backward_wrapper_raises_instead_of_falling_back(cuda):
    q = _normal(0, (1, 64, 4, 64), torch.float32, cuda)
    k = _normal(1, (1, 64, 2, 64), torch.float32, cuda)
    out, lse = flash._dispatch(q, k, k, None, None, with_lse=True)
    before = flash.BWD_LAUNCHES
    with pytest.raises(ValueError):  # lse of the wrong type
        flash.flash_attention_backward(q, k, k, out, lse.double(), q)
    with pytest.raises(ValueError):  # lse on another device
        flash.flash_attention_backward(q, k, k, out, lse.cpu(), q)
    with pytest.raises(ValueError):  # not contiguous
        flash.flash_attention_backward(q.transpose(1, 2).contiguous().transpose(1, 2), k, k,
                                       out, lse, q)
    with pytest.raises(ValueError):  # a head_dim the kernel is not built for
        flash.flash_attention_backward(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                       k[..., :48].contiguous(), out[..., :48].contiguous(),
                                       lse, q[..., :48].contiguous())
    assert flash.BWD_LAUNCHES == before


def test_train_step_on_card_equals_the_cpu_step(cuda):
    """Smoke internlm2-1.8b with GQA in float32: two train steps on the card
    (both flash kernels) and on the CPU (plain versions), from the same
    weights and batches: losses, grad norms and weights within 1e-4."""
    from repro_torch.data import BatchSpec, make_batch
    from repro_torch.interop import param_leaves
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import batch_to_device, make_train_step

    cfg = dataclasses.replace(smoke_variant(get_config("internlm2-1.8b")), num_kv_heads=2,
                              dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    out = {}
    for dev in ("cpu", cuda):
        model = tfm.init_params(cfg, seed=0, device="cpu").to(dev)
        state = {"params": model, "opt": init_opt_state(param_leaves(cfg, model))}
        step = make_train_step(cfg, opt, remat=dev != "cpu")
        before = flash.BWD_LAUNCHES
        hist = []
        for i in range(2):
            state, m = step(state, batch_to_device(make_batch(cfg, BatchSpec(2, 64), seed=i),
                                                   dev))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(dev)] = (hist, [p.detach().cpu() for p in model.parameters()],
                         flash.BWD_LAUNCHES - before)
    (cpu_hist, cpu_w, cpu_bwd), (card_hist, card_w, card_bwd) = out["cpu"], out[str(cuda)]
    assert cpu_bwd == 0 and card_bwd == 2 * cfg.num_layers
    np.testing.assert_allclose(card_hist, cpu_hist, rtol=1e-4)
    for a, b in zip(card_w, cpu_w):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
