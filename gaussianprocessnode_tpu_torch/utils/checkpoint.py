"""Checkpoint and resume of training state.

Counterpart of ``gaussianprocessnode_tpu/utils/checkpoint.py``. A tree of
tensors (nested dicts, tuples, lists and NamedTuples, with tensors, numpy
arrays or numbers for leaves: θ, the natural parameters of q(v), q(w), an
optimizer's state dict, a trainer's carry) round-trips through one ``.npz``
file: the leaves as arrays, and a structure string (the containers, the
NamedTuple types, the dict keys) that :func:`load_pytree` checks against
the tree it is given, so a mismatch raises instead of assigning leaves to
the wrong places.
"""

import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in order and return its
    structure string (dict keys sorted, as JAX's treedef orders them)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__ + "(" + ",".join(_flatten(v, leaves) for v in tree) + ")")
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    leaves.append(tree)
    return "*"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    arr = next(it)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(arr, device=device)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors/arrays/numbers to ``path`` (.npz: the leaves
    and the structure string)."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __treedef__=np.frombuffer(structure.encode(), dtype=np.uint8), **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Load a checkpoint saved with :func:`save_pytree`, in the structure of
    ``like`` (e.g. a freshly initialised state of the same shape); each
    leaf a tensor of its saved dtype on the device of ``like``'s leaf (the
    CPU where that is not a tensor). Raises ValueError where the saved
    structure is not ``like``'s."""
    with np.load(path) as data:
        leaves_like: list = []
        structure = _flatten(like, leaves_like)
        stored = bytes(data["__treedef__"]).decode()
        if stored != structure:
            raise ValueError("checkpoint pytree structure does not match `like`:\n"
                             f"  stored: {stored}\n  like:   {structure}")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    return _unflatten(like, iter(arrays))
