"""The port's model stack against the JAX reference, on the CPU.

The reference's parameters (`repro.models.transformer.init_params`) are
carried across with `repro_torch.interop.params_from_plain`, the same
numpy-seeded tokens go through both `forward_prefill`/`forward_decode`,
and the logits are compared.  In float32 the two differ only in the order
of float32 sums (the reference's blocked online softmax against the
port's plain attention), so the tolerance is 1e-4.  In bfloat16 the
reference rounds attention scores and probabilities to bfloat16 where the
port's kernels keep float32, so the comparison uses the reference's own
serving tolerance, ``TOL = 0.08`` (`tests/test_serving_consistency.py`).

The smoke variants of gemma2-2b and internlm2-1.8b have as many KV heads
as query heads, so the GQA cases replace ``num_kv_heads`` with 2.

mamba2-1.3b, recurrentgemma-9b, qwen3-moe-30b-a3b and grok-1-314b run
their smoke variants as they are.  In bf16 the reference's ``ssd_chunked``
also rounds its block products and chunk states to bf16
(`repro/models/ssm.py:68-74`), and its MoE einsums round where the port's
grouped GEMM accumulates in float32, so ``TOL = 0.08`` holds there too.
The MoE smoke variants have 4 experts, top-2: a prefill of 16 prompt
tokens over 2 rows makes 16 dispatch groups of 2 tokens with capacity 1,
so pairs are dropped; 14 tokens make one group with capacity 17.  In
bf16 a near tie of two router logits can round either way in the two
packages and flip an expert choice, which changes a token's output
entirely: the reference notes this (`tests/test_serving_consistency.py:
38-41`) and runs its own MoE serving check in float32.  So the bf16 MoE
comparison gives the port the reference's expert choices (the port's own
probabilities at those choices) and checks that every choice the port
would have made otherwise is such a near tie.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.roofline import analysis as janalysis
from repro.serving import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_plain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.roofline import analysis as tanalysis
from repro_torch.serving import kvcache as tkv

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=0.08, rtol=0.08)  # test_serving_consistency.TOL
KEY = jax.random.PRNGKey(0)


def _smoke(arch, dtype="float32"):
    return dataclasses.replace(jconfigs.smoke_variant(jconfigs.get_config(arch)), dtype=dtype)


def _gqa_smoke(arch, dtype="float32"):
    return dataclasses.replace(_smoke(arch, dtype), num_kv_heads=2)


@functools.cache
def _both_params(cfg, seed=0):
    jp = jtfm.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_plain(cfg, tree, device="cpu")


@functools.cache
def _jitted(cfg):
    """The reference's prefill and decode step, jitted once per config."""
    return (jax.jit(lambda p, bt, c: jtfm.forward_prefill(p, cfg, bt, c)),
            jax.jit(lambda p, tok, pos, c: jtfm.forward_decode(p, cfg, tok, pos, c)))


def _run_both(cfg, b, prompt, total, seed=0):
    """(reference logits, port logits) of a prefill of ``prompt`` tokens
    then decode steps up to ``total`` positions."""
    jp, tp = _both_params(cfg, seed)
    prefill, step = _jitted(cfg)
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, total))
    jc = jtfm.init_serve_cache(cfg, b, cache_len=total)
    tc = ttfm.init_serve_cache(cfg, b, total, device="cpu")
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks[:, :prompt])}, jc)
    tl, tc = ttfm.forward_prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :prompt])}, tc)
    pairs = [(np.asarray(jl, np.float32), tl.numpy())]
    for t in range(prompt, total):
        jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), jc)
        tl, tc = ttfm.forward_decode(tp, cfg, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        pairs.append((np.asarray(jl, np.float32), tl.numpy()))
    return pairs, jc, tc


@pytest.mark.parametrize("arch", ["gemma2-2b", "internlm2-1.8b"])
def test_prefill_and_decode_match_reference_float32(arch):
    """14 prefill positions, then 16 decode steps.  Gemma2's smoke windows
    are 16 slots, so its local layers' ring wraps during decode."""
    cfg = _gqa_smoke(arch)
    pairs, jc, tc = _run_both(cfg, b=2, prompt=14, total=30)
    assert len(pairs) == 17
    for t, (want, got) in enumerate(pairs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, err_msg=f"{arch} step {t}", **F32_TOL)
    # The caches agree too: the ring's slots and positions, layer by layer.
    for i, cache in enumerate(tc):
        grp, slot = divmod(i, len(cfg.layer_pattern))
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[slot][key][grp]),
                                       **F32_TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jc[slot]["pos"][grp]))
    if arch == "gemma2-2b":
        assert tc[0]["k"].shape[1] == 16 and int(tc[0]["pos"].max()) == 29  # wrapped


def _assert_caches_match(cfg, jc, tc):
    """Every leaf of every layer's cache: K/V rings and positions, SSD and
    RG-LRU states and conv tails."""
    for i, cache in enumerate(tc):
        grp, slot = divmod(i, len(cfg.layer_pattern))
        assert set(cache) == set(jc[slot])
        for key, leaf in cache.items():
            want = np.asarray(jc[slot][key][grp], np.float32)
            assert str(leaf.dtype).replace("torch.", "") == str(jc[slot][key].dtype)
            if key == "pos":
                np.testing.assert_array_equal(leaf.numpy(), want)
            else:
                np.testing.assert_allclose(leaf.float().numpy(), want, err_msg=f"{i} {key}",
                                           **F32_TOL)


@pytest.mark.parametrize("arch,prompt,total", [
    ("mamba2-1.3b", 14, 18),        # one short chunk (smoke chunk 16)
    ("mamba2-1.3b", 32, 36),        # two full chunks
    ("mamba2-1.3b", 40, 44),        # ragged: the reference takes one chunk of 40
    ("recurrentgemma-9b", 14, 30),  # decode past the 16-slot window wraps the ring
])
def test_recurrent_archs_match_reference_float32(arch, prompt, total):
    cfg = _smoke(arch)
    pairs, jc, tc = _run_both(cfg, b=2, prompt=prompt, total=total)
    assert len(pairs) == total - prompt + 1
    for t, (want, got) in enumerate(pairs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, err_msg=f"{arch} step {t}", **F32_TOL)
    _assert_caches_match(cfg, jc, tc)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("prompt,total", [(16, 24), (14, 30)])
def test_moe_archs_match_reference_float32(arch, prompt, total):
    """Attention plus routed experts: prefill with capacity drops (16
    dispatch groups) or one group, then dropless decode steps."""
    cfg = _smoke(arch)
    pairs, jc, tc = _run_both(cfg, b=2, prompt=prompt, total=total)
    assert len(pairs) == total - prompt + 1
    for t, (want, got) in enumerate(pairs):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, err_msg=f"{arch} step {t}", **F32_TOL)
    _assert_caches_match(cfg, jc, tc)


def test_prefill_longer_than_window_keeps_the_trailing_ring():
    """A prompt longer than the local layers' 16-slot window: prefill keeps
    the trailing window in ring order, then decode continues on it."""
    cfg = _gqa_smoke("gemma2-2b")
    pairs, jc, tc = _run_both(cfg, b=1, prompt=21, total=34, seed=3)
    for want, got in pairs:
        np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_array_equal(tc[0]["pos"].numpy(), np.asarray(jc[0]["pos"][0]))


@pytest.mark.parametrize("cfg", [_gqa_smoke("gemma2-2b", "bfloat16"),
                                 _smoke("mamba2-1.3b", "bfloat16"),
                                 _smoke("recurrentgemma-9b", "bfloat16")],
                         ids=["gemma2-2b", "mamba2-1.3b", "recurrentgemma-9b"])
def test_prefill_and_decode_match_reference_bfloat16(cfg):
    pairs, _, _ = _run_both(cfg, b=2, prompt=12, total=24)
    for t, (want, got) in enumerate(pairs):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **BF16_TOL)


def _reference_logits_and_choices(cfg, b, prompt, total, seed, monkeypatch):
    """The reference's logits of a prefill then decode steps, run eagerly
    with its router's top-k choices recorded, one array per `moe_ffn` call."""
    jp, _ = _both_params(cfg, seed)
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, total))
    choices, route = [], jmoe._route

    def recording(logits, k):
        out = route(logits, k)
        choices.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(jmoe, "_route", recording)
    jc = jtfm.init_serve_cache(cfg, b, cache_len=total)
    with jax.disable_jit():
        jl, jc = jtfm.forward_prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :prompt])}, jc)
        logits = [np.asarray(jl, np.float32)]
        for t in range(prompt, total):
            jl, jc = jtfm.forward_decode(jp, cfg, jnp.asarray(toks[:, t:t + 1]),
                                         jnp.asarray(t, jnp.int32), jc)
            logits.append(np.asarray(jl, np.float32))
    return toks, logits, choices


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_archs_match_reference_bfloat16_on_its_routing(arch, monkeypatch):
    cfg = _smoke(arch, "bfloat16")
    b, prompt, total = 2, 16, 24
    toks, want, choices = _reference_logits_and_choices(cfg, b, prompt, total, 0, monkeypatch)
    _, tp = _both_params(cfg, 0)
    calls, near_ties, route = iter(choices), [], tmoe._route

    def forced(logits, k):
        probs, _, own = route(logits, k)
        top_i = torch.tensor(next(calls), dtype=torch.int64)
        flipped = (own.sort(-1).values != top_i.sort(-1).values).any(-1)
        ranked = logits.float().sort(-1, descending=True).values
        near_ties.extend((ranked[flipped, k - 1] - ranked[flipped, k]).tolist())
        top_p = probs.gather(-1, top_i)
        return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_i

    monkeypatch.setattr(tmoe, "_route", forced)
    tc = ttfm.init_serve_cache(cfg, b, total, device="cpu")
    tl, tc = ttfm.forward_prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :prompt])}, tc)
    got = [tl.float().numpy()]
    for t in range(prompt, total):
        tl, tc = ttfm.forward_decode(tp, cfg, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        got.append(tl.float().numpy())
    assert next(calls, None) is None and len(choices) == cfg.num_layers * (1 + total - prompt)
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, err_msg=f"{arch} step {t}", **BF16_TOL)
    # A choice the port would have made otherwise is a near tie of its
    # router logits at the k-th place: within a few bf16 roundings of the
    # activations (logits are O(1)).
    assert all(gap < 0.05 for gap in near_ties), near_ties


def test_attention_train_matches_reference():
    cfg = _gqa_smoke("gemma2-2b")
    jp, tp = _both_params(cfg)
    x = np.random.RandomState(1).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, window=16,
              logit_softcap=cfg.attn_logit_softcap, norm_eps=cfg.norm_eps)
    want = jattn.attention_train(jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"]),
                                 jnp.asarray(x), jnp.arange(40, dtype=jnp.int32), **kw)
    got = tattn.attention_train(tp.blocks[0].attn, torch.from_numpy(x),
                                torch.arange(40, dtype=torch.int32), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_activations_match_reference(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jlayers.activation_fn(name)(jnp.asarray(x)))
    got = tlayers.activation_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_rope_and_rms_norm_match_reference():
    rng = np.random.RandomState(2)
    pos = np.arange(0, 4096, 37, dtype=np.int32)
    sin_j, cos_j = jlayers.rope(jnp.asarray(pos), 256, 10_000.0)
    sin_t, cos_t = tlayers.rope(torch.from_numpy(pos), 256, 10_000.0)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-4)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-4)
    x = rng.standard_normal((2, len(pos), 3, 256)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), sin_t, cos_t).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), sin_j, cos_j)), atol=1e-3)
    w = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-5, rtol=1e-5)


def test_params_carry_across_exactly_in_bfloat16():
    cfg = _gqa_smoke("gemma2-2b", dtype="bfloat16")
    jp, tp = _both_params(cfg)
    np.testing.assert_array_equal(tp.embed.float().numpy(), np.asarray(jp["embed"], np.float32))
    wq = np.asarray(jp["blocks"][1]["attn"]["wq"][0], np.float32)
    np.testing.assert_array_equal(tp.blocks[1].attn.wq.float().numpy(), wq)
    assert tp.blocks[1].attn.wq.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["gemma2-2b", "internlm2-1.8b", "nemotron-4-15b",
                                  "llava-next-mistral-7b", "musicgen-large", "yi-34b",
                                  "mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "grok-1-314b"])
def test_init_params_has_the_reference_shapes(arch):
    """Every parameter has the reference leaf's shape and type: the model's
    bf16, except the float32 leaves of the SSD, RG-LRU and MoE blocks."""
    cfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    jp = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), KEY)
    tp = ttfm.init_params(cfg, seed=0, device="cpu")
    sd = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in tp.state_dict().items()}

    def spec(leaf, stacked=False):
        return tuple(leaf.shape[1:] if stacked else leaf.shape), str(leaf.dtype)

    assert sd.pop("embed") == spec(jp["embed"])
    assert sd.pop("final_norm") == spec(jp["final_norm"])
    for key in ("unembed", "vision_proj"):
        assert sd.pop(key, None) == (spec(jp[key]) if key in jp else None)
    flat = jax.tree_util.tree_flatten_with_path(jp["blocks"])[0]
    want = {}
    for path, leaf in flat:
        slot, *rest = [getattr(p, "idx", getattr(p, "key", None)) for p in path]
        for grp in range(cfg.num_groups):
            name = ".".join(["blocks", str(grp * len(cfg.layer_pattern) + slot), *rest])
            want[name] = spec(leaf, stacked=True)
    assert sd == want
    assert sum(v.numel() for v in tp.state_dict().values()) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_meta_init_has_the_cpu_init_shapes_and_types(arch):
    """``init_params(cfg, device="meta")``: every tensor on meta (no memory,
    no generator), with the shape and type of a CPU init's, and the same
    `interop.plain_shapes`."""
    from repro_torch.interop import plain_shapes

    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    cpu = ttfm.init_params(cfg, seed=0, device="cpu")
    meta = ttfm.init_params(cfg, device="meta")
    assert {p.device.type for p in meta.parameters()} == {"meta"}
    assert plain_shapes(cfg, meta) == plain_shapes(cfg, cpu)
    assert [(k, v.shape, v.dtype) for k, v in meta.state_dict().items()] == [
        (k, v.shape, v.dtype) for k, v in cpu.state_dict().items()]


def test_params_from_plain_keeps_the_reference_types():
    """Carried across, each leaf takes the reference's type: bf16, and
    float32 for the SSD, RG-LRU and MoE (``router``) leaves that the
    reference keeps so."""
    for arch in ("mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b", "grok-1-314b"):
        cfg = _smoke(arch, "bfloat16")
        jp, tp = _both_params(cfg)
        flat = jax.tree_util.tree_flatten_with_path(jp["blocks"])[0]
        for path, leaf in flat:
            slot, *rest = [getattr(p, "idx", getattr(p, "key", None)) for p in path]
            got = tp.blocks[slot].get_parameter(".".join(rest))
            assert str(got.dtype).replace("torch.", "") == str(leaf.dtype), rest
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf[0], np.float32))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_registry_is_the_reference(arch):
    want = jconfigs.get_config(arch)
    got = tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tconfigs.smoke_variant(got)) == dataclasses.asdict(
        jconfigs.smoke_variant(want))
    assert got.param_count() == want.param_count()
    for tokens in (1, 2048):
        assert tanalysis.model_flops(got, tokens) == janalysis.model_flops(want, tokens)
        assert tanalysis.model_kv_bytes(got, tokens) == janalysis.model_kv_bytes(want, tokens)
        assert tanalysis.model_hbm_bytes(got, tokens) == janalysis.model_hbm_bytes(want, tokens)
    assert tconfigs.DEFAULT_TOKENS_PER_FRAME == jconfigs.DEFAULT_TOKENS_PER_FRAME


def _reference_slot_bytes(cfg, cache_len, long_context):
    """The reference's `slot_kv_bytes`, counted on shapes: at full width its
    arrays would take hundreds of MB."""
    shapes = jax.eval_shape(
        lambda: jtfm.init_serve_cache(cfg, 1, cache_len, long_context=long_context))
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch,cache_len,long_context", [
    ("gemma2-2b", 2064, False), ("gemma2-2b", 8192, False), ("internlm2-1.8b", 528, False),
    ("yi-34b", 64, True), ("nemotron-4-15b", 96, False), ("mamba2-1.3b", 1040, False),
    ("recurrentgemma-9b", 1040, False), ("recurrentgemma-9b", 4096, False),
    ("qwen3-moe-30b-a3b", 1040, False), ("grok-1-314b", 96, True),
])
def test_cache_bytes_match_reference(arch, cache_len, long_context):
    full = jconfigs.get_config(arch)
    smoke = jconfigs.smoke_variant(full)
    kw = dict(long_context=long_context)
    assert tkv.slot_kv_bytes(smoke, cache_len, **kw) == jkv.slot_kv_bytes(smoke, cache_len, **kw)
    assert tkv.slot_kv_bytes(full, cache_len, **kw) == _reference_slot_bytes(
        full, cache_len, long_context)
    assert tkv.cache_bytes(tkv.make_cache(smoke, 3, cache_len, device="cpu", **kw)) == \
        jkv.cache_bytes(jkv.make_cache(smoke, 3, cache_len, **kw))


def test_reset_slot_zeroes_one_row_and_keeps_positions():
    cfg = _gqa_smoke("internlm2-1.8b")
    cache = tkv.make_cache(cfg, 3, 8, device="cpu")
    for layer in cache:
        layer["k"].normal_()
        layer["v"].normal_()
        layer["pos"].copy_(torch.arange(8))
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    tkv.reset_slot(cache, 1)
    for layer, old in zip(cache, before):
        for key in ("k", "v"):
            assert not layer[key][1].any()
            torch.testing.assert_close(layer[key][[0, 2]], old[key][[0, 2]])
        torch.testing.assert_close(layer["pos"], old["pos"])


def test_reset_slot_zeroes_recurrent_states_and_conv_tails():
    """recurrentgemma-9b holds ``h`` and ``conv`` (RG-LRU layers) beside
    ``k``/``v``/``pos``; mamba2-1.3b holds ``ssm`` and ``conv``.  One row of
    each batch-indexed leaf is zeroed, the other rows and ``pos`` are kept."""
    seen = set()
    for arch in ("recurrentgemma-9b", "mamba2-1.3b"):
        cache = tkv.make_cache(_smoke(arch), 3, 20, device="cpu")
        for layer in cache:
            for key, leaf in layer.items():
                leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape) + 1)
        before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        tkv.reset_slot(cache, 2)
        for layer, old in zip(cache, before):
            for key, leaf in layer.items():
                seen.add(key)
                if key == "pos":
                    torch.testing.assert_close(leaf, old[key])
                    continue
                assert not leaf[2].any(), key
                torch.testing.assert_close(leaf[:2], old[key][:2])
    assert seen == {"k", "v", "pos", "ssm", "conv", "h"}
