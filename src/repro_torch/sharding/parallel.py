"""The context of a sharded step, and the collectives its layers call.

A step over a mesh of more than one rank runs each layer on this rank's
local shards (`repro_torch.sharding.execute`), Megatron-style: the
activations are split over the data axes on their batch dim and
replicated over ``model``; a column-parallel product makes local
columns, a row-parallel one a partial sum that an all-reduce completes.
The layers of `repro_torch.models` read the active context with
`current()`: ``None`` (every single-device call) leaves them as they were.

Every collective is a ``_c10d_functional`` op (the ones DTensor issues),
so `torch.distributed.tensor.debug.CommDebugMode` counts them, and each
has a gradient of its own:

* `enter(x)`: identity forward, all-reduce backward (Megatron's ``f``):
  for a tensor replicated over ``model`` that feeds a sharded region, whose
  ranks each return the gradient of their own share;
* `leave(x)`: all-reduce forward, identity backward (``g``): a partial sum
  whose result every rank then uses alike;
* `reduce_both(x)`: all-reduce both ways: a sum whose result feeds sharded
  work again (the gated RMSNorm's sum of squares over d_inner);
* `row_parallel(x, w)`: a row-parallel product, its partials summed in
  float32;
* `gather(x, dim)`: all-gather forward, reduce-scatter backward (each
  rank uses the result for its own share); `gather_alike`, whose result
  every rank uses alike, keeps its slice of the gradient;
* `from_owner(x, owner)`: the owner's tensor on every rank of the group,
  gradients summed back to the owner.

Gloo on CUDA tensors fails the all-gather (`ALL_REDUCE_GATHER`); there a
gather is an all-reduce of zero-padded slices.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

__all__ = ["Parallel", "current", "active", "enter", "leave", "reduce_both", "gather",
           "gather_alike", "row_parallel", "slice_of", "from_owner", "all_reduce", "ALL_REDUCE_GATHER",
           "CollectiveCounter", "COLLECTIVES"]

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_parallel", default=None)

#: (backend, device type) pairs whose functional all-gather is replaced by
#: an all-reduce of zero-padded slices: gloo's on CUDA tensors
#: (torch 2.11, ranks sharing one card) ends its process with SIGSEGV,
#: while its all-reduce and reduce-scatter run
#: (`scripts/torch_gloo_cuda_probe.py` tries each in a group of its own).
ALL_REDUCE_GATHER = {("gloo", "cuda")}


@dataclasses.dataclass(frozen=True)
class Parallel:
    """Which ranks hold what in the running step.

    ``mesh`` is the `DeviceMesh`; ``batch_dims`` the mesh dims that split
    the batch rows (empty when the batch is replicated, as a decode batch
    too small to shard); ``seq_dims`` the mesh dims that split an
    attention cache's slots in decode (context parallelism, merged by
    log-sum-exp).  ``model`` is the tensor-parallel dim's name.
    """

    mesh: object
    batch_dims: tuple = ()
    seq_dims: tuple = ()
    model: str = "model"

    def size(self, dim: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(dim))

    def rank(self, dim: str) -> int:
        return self.mesh.get_local_rank(dim)

    def group(self, dim: str):
        return self.mesh.get_group(dim)

    @property
    def model_size(self) -> int:
        return self.size(self.model)

    @property
    def model_rank(self) -> int:
        return self.rank(self.model)

    @property
    def batch_shards(self) -> int:
        """Ranks the batch rows are split over (1: replicated)."""
        n = 1
        for dim in self.batch_dims:
            n *= self.size(dim)
        return n

    @property
    def batch_rank(self) -> int:
        """This rank's shard of the batch rows, in mesh order."""
        r = 0
        for dim in self.batch_dims:
            r = r * self.size(dim) + self.rank(dim)
        return r


def current() -> Parallel | None:
    """The context of the running sharded step, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def active(par: Parallel):
    """Run the body (forward and backward) under ``par``."""
    token = _CURRENT.set(par)
    try:
        yield par
    finally:
        _CURRENT.reset(token)


# ---- the collectives, forward only ------------------------------------------------


def _ops():
    return torch.ops._c10d_functional


def _gather_by_all_reduce(pg, device: torch.device) -> bool:
    return (dist.get_backend(pg), device.type) in ALL_REDUCE_GATHER


def all_reduce(x: torch.Tensor, pg, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op``) of ``x`` over ``pg``; no gradient."""
    if dist.get_world_size(pg) == 1:
        return x
    return _ops().wait_tensor(_ops().all_reduce(x.contiguous(), op, pg.group_name))


def _gather(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    n = dist.get_world_size(pg)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    if _gather_by_all_reduce(pg, x.device):
        r = dist.get_group_rank(pg, dist.get_rank())
        buf = x.new_zeros((n,) + tuple(x.shape))
        buf[r] = x
        out = all_reduce(buf, pg).reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    else:
        out = _ops().wait_tensor(_ops().all_gather_into_tensor(x, n, pg.group_name))
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    n = dist.get_world_size(pg)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = _ops().wait_tensor(_ops().reduce_scatter_tensor(x, "sum", n, pg.group_name))
    return out.movedim(0, dim).contiguous()


def slice_of(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """This rank's 1/n of ``x`` along ``dim`` over ``pg``."""
    n = dist.get_world_size(pg)
    if n == 1:
        return x
    return x.chunk(n, dim)[dist.get_group_rank(pg, dist.get_rank())].contiguous()


# ---- with their gradients ------------------------------------------------------------


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.pg), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return all_reduce(x, pg)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Both(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return all_reduce(x, pg)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.pg), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _gather(x, dim, pg)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.dim, ctx.pg), None, None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _gather(x, dim, pg)

    @staticmethod
    def backward(ctx, dy):
        return slice_of(dy, ctx.dim, ctx.pg), None, None


class _FromOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, owner, pg):
        ctx.owner, ctx.pg = owner, pg
        mine = dist.get_group_rank(pg, dist.get_rank()) == owner
        return all_reduce(x if mine else torch.zeros_like(x), pg)

    @staticmethod
    def backward(ctx, dy):
        total = all_reduce(dy, ctx.pg)
        mine = dist.get_group_rank(ctx.pg, dist.get_rank()) == ctx.owner
        return (total if mine else torch.zeros_like(total)), None, None


def _trivial(pg) -> bool:
    return pg is None or dist.get_world_size(pg) == 1


def enter(x: torch.Tensor, pg) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``pg``."""
    return x if _trivial(pg) else _Enter.apply(x, pg)


def leave(x: torch.Tensor, pg) -> torch.Tensor:
    """The sum over ``pg``; the backward passes the gradient as it is."""
    return x if _trivial(pg) else _Leave.apply(x, pg)


def reduce_both(x: torch.Tensor, pg) -> torch.Tensor:
    """The sum over ``pg``, and the gradient summed over it too."""
    return x if _trivial(pg) else _Both.apply(x, pg)


def gather(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order; the
    backward reduce-scatters."""
    return x if _trivial(pg) else _Gather.apply(x, dim, pg)


def row_parallel(x: torch.Tensor, w: torch.Tensor, pg) -> torch.Tensor:
    """``x @ w`` over this rank's rows of ``w`` (and columns of ``x``),
    summed over ``pg``: in float32, rounded once to x's type, as one
    device's product rounds its float32 sum once (a bf16 partial rounded
    before the sum would round twice)."""
    if x.dtype == torch.float32:
        return leave(x @ w, pg)
    return leave(x.float() @ w.float(), pg).to(x.dtype)


def gather_alike(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """`gather` for a result every rank then uses alike: the backward keeps
    this rank's slice of the (equal) gradients."""
    return x if _trivial(pg) else _GatherAlike.apply(x, dim, pg)


def from_owner(x: torch.Tensor, owner: int, pg) -> torch.Tensor:
    """Group rank ``owner``'s ``x`` on every rank (the others pass a tensor
    of its shape and type); the backward sums the gradient to the owner."""
    return x if _trivial(pg) else _FromOwner.apply(x, owner, pg)


# ---- counting ---------------------------------------------------------------------------

#: The functional collectives `CollectiveCounter` counts.
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")


def _counter_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {op: {"count": 0, "bytes": 0.0} for op in COLLECTIVES}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            namespace, _, name = func.name().partition("::")
            name = name.split(".")[0]
            if namespace == "_c10d_functional" and name in self.counts:
                self.counts[name]["count"] += 1
                self.counts[name]["bytes"] += float(out.numel() * out.element_size())
            return out

    return Counter


def CollectiveCounter():  # noqa: N802 - a mode class made on first use
    """A dispatch mode that counts each functional collective this rank
    issues and its result bytes (``counts``: ``{op: {"count", "bytes"}}``,
    the reference's `parse_collectives` form without its total); on meta
    tensors under a fake process group it counts what a real group would
    send."""
    return _counter_mode()()
