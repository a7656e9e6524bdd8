"""Training loop: the train step (loss, grads, AdamW) and a host loop.

Mirrors `repro/train/train_loop.py` on one device (the card unless the
caller passes ``device="cpu"``).  The reference jits its step and donates
the state; the port runs eagerly, computes the gradients with autograd
(the backward kernels of flash attention, the SSD scan, the RG-LRU scan
and the grouped GEMM under `FlashAttentionFn`, `SsdScanFn`, `RglruScanFn`
and `GroupedGemmFn`) and updates the
parameters and moments in place.  Seeds go through a `torch.Generator`
(`init_params`), so equal seeds do not give the reference's weights: the
parity tests carry those across with `repro_torch.interop.params_from_plain`
and pass them in as ``state``.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator

import torch

from ..device import resolve_device
from ..interop import param_leaves
from ..models import transformer as tfm
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["make_train_step", "train", "init_state", "batch_to_device", "TrainState"]

TrainState = dict  # {"params": Transformer, "opt": optimizer state}


def batch_to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (`repro_torch.data.make_batch`) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _micro_batches(batch: dict, microbatches: int) -> list[dict]:
    """``batch`` cut on its batch dim into ``microbatches`` equal parts, in
    order (the reference's reshape to (M, B/M, ...))."""
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into {microbatches} micro-batches")
    n = rows // microbatches
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, remat: bool = False,
                    microbatches: int = 1) -> Callable:
    """``step(state, batch, events=None) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device.  ``events``, four CUDA
    events when given, are recorded at the step's start and after its
    forward, backward and optimizer update (for timing them apart).
    Metrics (``loss``, ``ce``, ``router_aux``, ``grad_norm``, ``lr``) are
    0-d tensors on the device: reading one waits for the step.

    ``microbatches=M > 1`` accumulates the gradients of M sequential
    micro-batches (the batch cut on its batch dim) as the reference's
    `launch/steps.py` does: summed in float32 and divided by M, the loss
    and its parts averaged over the micro-batches, then one AdamW update,
    which so gets float32 gradients (with M = 1 it gets them in the
    parameters' type, as the reference's does).  With M > 1 the forwards
    and backwards interleave: events 1 and 2 are both recorded after the
    last backward.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")

    def record(events, i):
        if events is not None:
            events[i].record()

    def grad(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def per_tensor(fn, leaf):
        return fn(leaf) if isinstance(leaf, torch.Tensor) else [fn(p) for p in leaf]

    def accumulate(params, batch):
        """(mean loss, mean parts, float32 gradients / M) over the micro-batches."""
        leaves = param_leaves(cfg, params)
        sums = {path: per_tensor(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), leaf)
                for path, leaf in leaves.items()}
        totals, parts = [], []
        for one in _micro_batches(batch, microbatches):
            total, part = tfm.loss_fn(params, cfg, one, remat=remat)
            total.backward()
            for path, leaf in leaves.items():
                pairs = ([(sums[path], leaf)] if isinstance(leaf, torch.Tensor)
                         else zip(sums[path], leaf))
                for acc, p in pairs:
                    if p.grad is not None:
                        acc.add_(p.grad)  # widened to float32 exactly
            params.zero_grad(set_to_none=True)
            totals.append(total.detach())
            parts.append({k: v.detach() for k, v in part.items()})
        grads = {path: per_tensor(lambda acc: acc.div_(microbatches), leaf)
                 for path, leaf in sums.items()}
        total = sum(totals[1:], totals[0]) / microbatches
        parts = {k: torch.stack([row[k] for row in parts]).mean() for k in parts[0]}
        return total, parts, leaves, grads

    def train_step(state: TrainState, batch: dict, events=None):
        params = state["params"]
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        record(events, 0)
        if microbatches == 1:
            total, parts = tfm.loss_fn(params, cfg, batch, remat=remat)
            record(events, 1)
            total.backward()
            record(events, 2)
            leaves = param_leaves(cfg, params)
            grads = {path: per_tensor(grad, leaf) for path, leaf in leaves.items()}
        else:
            total, parts, leaves, grads = accumulate(params, batch)
            record(events, 1)
            record(events, 2)
        _, opt, opt_metrics = adamw_update(opt_cfg, leaves, grads, state["opt"])
        params.zero_grad(set_to_none=True)  # frees the gradients before the next forward
        record(events, 3)
        metrics = {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_state(seed: int, cfg: ModelConfig, *, device=None) -> TrainState:
    """Weights from `init_params` (seed ``seed``, trainable) and zero moments."""
    params = tfm.init_params(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(param_leaves(cfg, params))}


def train(
    cfg: ModelConfig,
    batches: Iterator[dict],
    *,
    steps: int,
    opt_cfg: AdamWConfig | None = None,
    seed: int = 0,
    log_every: int = 10,
    log_fn=print,
    device=None,
    state: TrainState | None = None,
) -> tuple[TrainState, list[dict]]:
    """``steps`` train steps over ``batches`` (numpy batches), from
    ``state`` or, without one, from `init_state(seed, cfg)`; the history
    holds the metrics of every ``log_every``-th step and of the last."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    dev = resolve_device(device)
    state = state or init_state(seed, cfg, device=dev)
    step_fn = make_train_step(cfg, opt_cfg)
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = batch_to_device(next(batches), dev)
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            log_fn(
                f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}"
            )
    return state, history
