"""Checkpointing: parameters <-> .npz with a path manifest.

The reference's file format (`repro/train/checkpoint.py`): one ``.npz``
whose arrays are keyed by the parameter pytree's ``/``-joined paths
(``blocks/[0]/attn/wq``), block leaves stacked over layer groups, bf16
stored exactly as float32, and a ``.manifest.json`` beside it with each
array's ``dtypes`` and the caller's ``metadata``.  A checkpoint written
here restores through the reference's ``restore`` and the other way
round.  The port's model goes through `repro_torch.interop.params_to_plain`
and `params_from_plain`; a plain tree (nested dicts and tuples of arrays
or tensors) is stored as it is.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..interop import (flatten_plain, params_from_plain, params_to_plain, plain_shapes,
                       unflatten_plain)
from ..models.transformer import Transformer

__all__ = ["save", "restore"]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # npz cannot hold bf16; float32 holds it exactly.
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, metadata: dict | None = None, *, cfg=None) -> None:
    """Write ``tree`` — the port's `Transformer` (with its ``cfg``) or a
    plain tree — to ``path`` (``.npz`` appended if missing) and its
    manifest."""
    if isinstance(tree, Transformer):
        if cfg is None:
            raise ValueError("save: a Transformer needs its cfg")
        tree = params_to_plain(cfg, tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _as_numpy(v) for k, v in flatten_plain(tree).items()}
    np.savez(_npz_path(path), **flat)
    manifest = {
        "paths": list(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(_manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=1)


def _load(path: str, shapes: dict) -> dict:
    """The arrays of ``shapes``' paths, each checked against its shape."""
    with np.load(_npz_path(path)) as npz:
        flat = {}
        for key, shape in shapes.items():
            if key not in npz:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = npz[key]
            if arr.shape != tuple(shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(shape)}")
            flat[key] = arr
    return flat


def restore(path: str, like: Any, *, cfg=None) -> Any:
    """Restore into the structure of ``like`` (shape-checked: `ValueError`;
    a leaf missing from the file: `KeyError`).

    For the port's `Transformer` (with its ``cfg``) the result is a new
    `Transformer` on ``like``'s device with its types; for a plain tree, a
    tree of the same structure whose leaves take each ``like`` leaf's type
    (and, for a tensor, its device).
    """
    if isinstance(like, Transformer):
        if cfg is None:
            raise ValueError("restore: a Transformer needs its cfg")
        flat = _load(path, plain_shapes(cfg, like))
        return params_from_plain(cfg, unflatten_plain(flat), device=like.embed.device)
    like_flat = flatten_plain(like)
    flat = _load(path, {k: tuple(np.shape(v)) for k, v in like_flat.items()})
    out = {}
    for key, leaf in like_flat.items():
        if isinstance(leaf, torch.Tensor):
            out[key] = torch.from_numpy(flat[key]).to(device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = flat[key].astype(np.asarray(leaf).dtype)
    return unflatten_plain(out)
