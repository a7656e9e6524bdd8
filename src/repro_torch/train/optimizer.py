"""AdamW + cosine schedule + global-norm clipping (no external deps).

Mirrors `repro/train/optimizer.py` as torch operations on the parameter
tensors, under `torch.no_grad`, updating in place: float32 moments, the
global-norm clip in float32, and each update computed in float32 and cast
back to the parameter's type.  The reference does this in jnp outside any
Pallas kernel, so it has no kernel here either.  ``torch.optim.AdamW``
is not this function: it decays weights by ``lr * wd * p`` before the
Adam step, where the reference adds ``wd * p`` to the bias-corrected step.

The port's model keeps one tensor per layer where the reference stacks a
leaf over layer groups, so the optimizer works on
`repro_torch.interop.param_leaves`' form: ``{path: tensor}`` for a
top-level leaf and ``{path: [tensor per group]}`` for a block leaf, keyed
by the reference's leaf paths.  The moments ``mu`` and ``nu`` are one
float32 tensor per path, stacked as the reference stacks them; a layer's
update works on its group's row in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * progress))


def _pairs(leaf):
    """A leaf's tensors with their row of the stacked moment (None: the
    whole moment)."""
    if isinstance(leaf, torch.Tensor):
        return [(None, leaf)]
    return list(enumerate(leaf))


def init_opt_state(params: dict) -> dict:
    """Zero float32 moments for `param_leaves`' ``{path: leaf}``, each
    stacked over a block leaf's groups, and ``step`` 0 (int32)."""
    def zeros(leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
        return torch.zeros((len(leaf),) + tuple(leaf[0].shape), dtype=torch.float32,
                           device=leaf[0].device)

    device = next(t for _, t in _pairs(next(iter(params.values())))).device
    return {
        "mu": {path: zeros(leaf) for path, leaf in params.items()},
        "nu": {path: zeros(leaf) for path, leaf in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict, *,
                 global_sq=None):
    """Returns (params, state, metrics), the parameters and moments updated
    in place.  ``params`` and ``grads`` are ``{path: leaf}`` with the same
    paths and structure (`init_opt_state`); metrics ``grad_norm`` and
    ``lr`` are float32 scalars on the parameters' device.  ``global_sq``,
    given ``grads``, returns their float32 sum of squares over the whole
    model, where each rank holds shards of it (a sharded step); by default
    it is summed over ``grads``."""
    # Global-norm clip in fp32.
    if global_sq is None:
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for leaf in grads.values() for _, g in _pairs(leaf)))
    else:
        gnorm = torch.sqrt(global_sq(grads))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    for path, leaf in params.items():
        grad_leaf = dict(_pairs(grads[path]))
        for row, p in _pairs(leaf):
            mu = state["mu"][path] if row is None else state["mu"][path][row]
            nu = state["nu"][path] if row is None else state["nu"][path][row]
            g = grad_leaf[row].float() * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g.square())
            mhat = mu / bc1
            nhat = nu / bc2
            delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
