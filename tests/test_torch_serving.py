"""The port's serving engine and launcher against the JAX reference, on the CPU.

The engine's greedy tokens must equal the reference engine's on the same
weights (carried across with `params_from_plain`) and prompts, in float32
(`tests/test_serving_consistency.py:102-115`'s 5 requests over 2 slots),
for attention-only models, mamba2-1.3b, recurrentgemma-9b and the MoE
models qwen3-moe-30b-a3b and grok-1-314b (whose prefills drop pairs at
capacity, as the reference's do).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_variant
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.interop import params_from_plain
from repro_torch.launch import serve
from repro_torch.models import transformer as ttfm
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.sampling import sample

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _requests(cls, vocab, n=5):
    return [cls(rid=i, prompt=np.arange(4 + i) % vocab, max_new_tokens=3 + i % 2)
            for i in range(n)]


@pytest.mark.parametrize("arch,kv_heads", [("internlm2-1.8b", None), ("gemma2-2b", 2),
                                           ("mamba2-1.3b", None), ("recurrentgemma-9b", None),
                                           ("qwen3-moe-30b-a3b", None), ("grok-1-314b", None)])
def test_engine_greedy_tokens_equal_reference(arch, kv_heads):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    if kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    jp = jtfm.init_params(jax.random.PRNGKey(7), cfg)
    tp = params_from_plain(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                           device="cpu")
    ref = JEngine(cfg, jp, batch_slots=2, max_seq=64)
    eng = ServingEngine(cfg, tp, batch_slots=2, max_seq=64, device="cpu")
    for r in _requests(JRequest, cfg.vocab_size):
        ref.submit(r)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    want = {r.rid: (r.tokens, r.prompt_len) for r in ref.run()}
    got = {r.rid: (r.tokens, r.prompt_len) for r in eng.run()}
    assert got == want
    assert [len(got[i][0]) for i in range(5)] == [3 + i % 2 for i in range(5)]


def test_engine_stops_at_max_seq():
    cfg = smoke_variant(get_config("internlm2-1.8b"))
    eng = ServingEngine(cfg, ttfm.init_params(cfg, seed=0, device="cpu"), batch_slots=2,
                        max_seq=12, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(8), max_new_tokens=10))
    (res,) = eng.run()
    assert len(res.tokens) == 4 and res.prompt_len == 8


def test_sampling_at_a_temperature_is_valid_and_seeded():
    cfg = smoke_variant(get_config("gemma2-2b"))
    params = ttfm.init_params(cfg, seed=1, device="cpu")

    def run(seed):
        eng = ServingEngine(cfg, params, batch_slots=3, max_seq=32, seed=seed, device="cpu")
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(5 + i), max_new_tokens=6,
                               temperature=1.5))
        return {r.rid: r.tokens for r in eng.run()}

    first = run(0)
    assert all(len(t) == 6 and all(0 <= x < cfg.vocab_size for x in t)
               for t in first.values())
    assert run(0) == first


def test_sample_greedy_and_top_k():
    logits = torch.tensor([[1.0, 5.0, 2.0, 5.0], [0.1, 0.0, 3.0, -1.0]])
    assert sample(None, logits, temperature=0.0).tolist() == [1, 2]  # first maximum
    gen = torch.Generator().manual_seed(0)
    assert sample(gen, logits[:, :3], temperature=0.5, top_k=1).tolist() == [1, 2]
    codebooks = torch.randn(2, 4, 16)
    out = sample(gen, codebooks, temperature=1.0)
    assert tuple(out.shape) == (2, 4) and int(out.max()) < 16


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b"])
def test_launcher_serves_on_the_cpu(capsys, arch):
    out = serve.main(["--arch", arch, "--streams", "2", "--requests", "2",
                      "--new-tokens", "3", "--device", "cpu"])
    members = {}
    for p in out["plan"].placements:
        members[p.instance_index] = members.get(p.instance_index, 0) + 1
    assert out["tokens"] == 3 * 2 * sum(members.values())
    assert sorted(out["results"]) == list(range(len(out["plan"].instances)))
    assert "hourly cost" in capsys.readouterr().out


def test_launcher_smoke_weights_flag_can_be_turned_off():
    assert serve.parse_args([]).smoke_weights is True
    assert serve.parse_args(["--smoke-weights"]).smoke_weights is True
    assert serve.parse_args(["--no-smoke-weights"]).smoke_weights is False
    assert serve.parse_args([]).device is None  # the card


def test_engine_and_launcher_without_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    body = """
import numpy as np
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import ServingEngine
cfg = smoke_variant(get_config("internlm2-1.8b"))
params = tfm.init_params(cfg, device="cpu")
for call in (lambda: ServingEngine(cfg, params, batch_slots=2, max_seq=16),
             lambda: serve.main(["--streams", "1"]),
             lambda: tfm.init_params(cfg)):
    try:
        call()
    except RuntimeError as exc:
        print("raised:", exc)
    else:
        raise SystemExit("no error without a CUDA device")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", body], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert proc.stdout.count("raised:") == 3
