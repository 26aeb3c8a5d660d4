"""Checkpoint / resume (torch counterpart of
``chargeflux_tpu.utils.checkpoint``).

A state (an ``MDState``, a system, bonded terms, or a nest of dataclasses,
named tuples, tuples, lists and dicts of them) is flattened into its
tensor leaves in field order, ``None`` fields skipped, as JAX flattens a
pytree, and saved as ``leaf_0 .. leaf_k`` in an ``.npz`` beside a
``.meta.json`` sidecar (step, leaf count, the structure string, extras).
An ``MDState`` therefore gives the same ``.npz`` from either package.
Loading validates against a template: its structure string, its leaf count
and every leaf's shape.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _is_leaf(obj) -> bool:
    return torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic))


def _flatten(obj, leaves: list) -> str:
    """Append ``obj``'s leaves to ``leaves`` in order; return its
    structure string (leaves as ``*``, other values by ``repr``)."""
    if _is_leaf(obj):
        leaves.append(obj)
        return "*"
    if obj is None:
        return "None"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        parts = [f"{f.name}={_flatten(getattr(obj, f.name), leaves)}"
                 for f in dataclasses.fields(obj) if f.init]
        return f"{type(obj).__name__}({', '.join(parts)})"
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        parts = [f"{k}={_flatten(v, leaves)}"
                 for k, v in zip(obj._fields, obj)]
        return f"{type(obj).__name__}({', '.join(parts)})"
    if isinstance(obj, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in obj)
        return f"({inner})" if isinstance(obj, tuple) else f"[{inner}]"
    if isinstance(obj, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(obj[k], leaves)}"
                               for k in sorted(obj)) + "}"
    return repr(obj)


def _unflatten(like, it):
    """``like``'s structure with its leaves taken from the iterator ``it``
    (each cast to the template leaf's type and device)."""
    if _is_leaf(like):
        arr = next(it)
        if torch.is_tensor(like):
            return torch.as_tensor(arr).to(dtype=like.dtype,
                                           device=like.device)
        return np.asarray(arr, dtype=like.dtype)
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name), it)
                             for f in dataclasses.fields(like) if f.init})
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    return like


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str | os.PathLike, state: Any, step: int = 0,
                    extra: dict | None = None):
    """Save ``state``'s leaves to ``path`` (.npz + .meta.json sidecar)."""
    path = os.fspath(path)
    leaves: list = []
    structure = _flatten(state, leaves)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                        **arrays)
    meta = {"step": step, "n_leaves": len(leaves), "treedef": structure,
            "extra": extra or {}}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str | os.PathLike, like: Any):
    """Load a checkpoint of :func:`save_checkpoint` into the structure of
    ``like`` (types and devices follow ``like``'s leaves).  The template
    is validated: the saved structure string, the leaf count and every
    leaf's shape must match, else this raises ``ValueError``.  Returns
    (state, step)."""
    path = os.fspath(path)
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves: list = []
    structure = _flatten(like, leaves)
    if len(leaves) != len(npz.files):
        raise ValueError(f"checkpoint has {len(npz.files)} leaves, template "
                         f"has {len(leaves)}")
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    saved = meta.get("treedef")
    if saved is not None and saved != structure:
        raise ValueError(
            "checkpoint structure does not match the template:\n"
            f"  saved:    {saved}\n  template: {structure}")
    arrays = []
    for i, leaf in enumerate(leaves):
        arr = npz[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {i} has shape "
                             f"{tuple(arr.shape)}, template expects "
                             f"{tuple(leaf.shape)}")
        arrays.append(arr)
    return _unflatten(like, iter(arrays)), int(meta.get("step", 0))


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
