"""Batched serving engine: the data plane the resource manager schedules.

Mirrors `repro/serving/engine.py`.  One ``ServingEngine`` is the software
that runs on one allocated cloud instance.  It serves a single model
(analysis program) for a set of co-located streams/requests with
synchronized batched decode — the fleet view lives in
`repro_torch.core.manager`, and `repro_torch.launch.serve` wires the two
together.

Fixed batch of slots, prefill-on-admit in waves, batched one-token decode
steps, per-slot completion and recycling (continuous batching).  PyTorch
runs eagerly, so the reference's ``jax.jit`` wrappers have no counterpart.
The decode position is a host integer and sampled tokens stay on the
device until the wave ends, so a wave's decode loop never waits on the
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer as tfm
from ..models.config import ModelConfig
from . import kvcache, sampling

__all__ = ["Request", "Result", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) or (P, K) token ids
    max_new_tokens: int
    temperature: float = 0.0


@dataclasses.dataclass
class Result:
    rid: int
    tokens: list  # generated token ids
    prompt_len: int


class ServingEngine:
    """Continuous-batching engine for one model on one instance.

    ``params`` (a `repro_torch.models.transformer.Transformer`) must lie on
    ``device`` (default: the card, see `resolve_device`).
    """

    def __init__(self, cfg: ModelConfig, params: tfm.Transformer, *, batch_slots: int,
                 max_seq: int, seed: int = 0, device=None) -> None:
        self.device = resolve_device(device)
        param_dev = params.embed.device
        if param_dev.type != self.device.type or (
                self.device.index is not None and param_dev.index != self.device.index):
            raise ValueError(f"params are on {param_dev}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._queue: list[Request] = []
        self._results: list[Result] = []
        # One batch=batch_slots cache per admission wave, with a synchronized
        # position cursor; `_run_wave` makes it.
        self.cache: list[dict] | None = None

    # -- public API ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def run(self) -> list[Result]:
        """Drain the queue: admit in waves, decode until all complete."""
        while self._queue:
            wave = [self._queue.pop(0) for _ in range(
                min(self.batch_slots, len(self._queue)))]
            self._run_wave(wave)
        out, self._results = self._results, []
        return out

    # -- internals ---------------------------------------------------------------

    def _run_wave(self, wave: list[Request]) -> None:
        cfg = self.cfg
        b = self.batch_slots
        plen = max(len(r.prompt) for r in wave)
        # Left-pad prompts to a common length (pad id 0; positions align right).
        tok_shape = (b, plen) if wave[0].prompt.ndim == 1 else (
            b, plen, cfg.num_codebooks)
        tokens = np.zeros(tok_shape, np.int64)
        for i, r in enumerate(wave):
            tokens[i, plen - len(r.prompt):] = r.prompt
        self.cache = kvcache.make_cache(cfg, b, self.max_seq, device=self.device)
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        logits, self.cache = tfm.forward_prefill(self.params, cfg, batch, self.cache)

        max_new = max(r.max_new_tokens for r in wave)
        sampled: list[torch.Tensor] = []
        last_logits = logits[:, -1].clone()  # a view would keep all the logits alive
        del logits
        cur = plen
        for _ in range(max_new):
            nxt = sampling.sample(self._gen, last_logits, temperature=wave[0].temperature)
            sampled.append(nxt)
            tok = nxt[:, None] if nxt.dim() == 1 else nxt[:, None, :]
            step_logits, self.cache = tfm.forward_decode(
                self.params, cfg, tok, cur, self.cache)
            last_logits = step_logits[:, -1]
            cur += 1
            if cur >= self.max_seq:
                break
        generated = (torch.stack(sampled, dim=1).cpu().numpy() if sampled
                     else np.zeros((b, 0), np.int64))  # (B, steps[, K])
        for i, r in enumerate(wave):
            self._results.append(
                Result(rid=r.rid, tokens=generated[i, : r.max_new_tokens].tolist(),
                       prompt_len=len(r.prompt))
            )
