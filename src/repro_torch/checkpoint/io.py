"""Checkpointing: trees of tensors as ``.npz`` plus a JSON meta file.

The port of ``repro.checkpoint.io``, in its file format: leaves flattened in
``jax.tree_util``'s order (dict keys sorted, NamedTuple fields and list or
tuple items in order, ``None`` holding no leaf), saved as ``leaf{i}`` with
their key strings, as ``jax.tree_util.keystr`` writes them (``['params']
['embed']``, ``.scores``, ``[0]``), in ``__keys__``. A file either package
writes loads into the other's template of the same structure.

Tensors go to numpy on save and come back on the template leaf's device and
dtype on load. bf16 has no numpy dtype: it is stored as the reference's
``np.savez`` stores JAX's bf16 arrays, its 16 bits as the 2-byte void dtype
``|V2``, and a ``|V2`` leaf loads as those bf16 bits (cast to the template's
dtype). The reference's own ``load_pytree`` cannot cast ``|V2`` back (numpy
has no cast for it), so it loads no bf16 leaf, its own files' included.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) pairs in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for key in sorted(tree) for pair in _flatten(tree[key], f"{path}[{key!r}]")]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields
                for pair in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, sub in enumerate(tree) for pair in _flatten(sub, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {key: _unflatten(template[key], leaves) for key in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, name), leaves)
                                for name in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(sub, leaves) for sub in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:      # bf16 bits
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(arr, dtype=like.dtype)
    return arr


def save_pytree(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Serialize a tree of tensors (or arrays) to ``<path>.npz``."""
    flat = _flatten(tree)
    arrays = {f"leaf{i}": _to_numpy(v) for i, (_, v) in enumerate(flat)}
    keys = [k for k, _ in flat]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, __keys__=np.array(json.dumps(keys)), **arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_pytree(path: str, template: Any) -> Any:
    """Restore into the structure of ``template`` (leaf order must match);
    tensors on each template leaf's device and dtype."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        keys = json.loads(str(data["__keys__"]))
        flat_t = _flatten(template)
        t_keys = [k for k, _ in flat_t]
        if keys != t_keys:
            raise ValueError(
                f"checkpoint structure mismatch: {len(keys)} leaves vs {len(t_keys)}; "
                f"first diff: {next((a, b) for a, b in zip(keys, t_keys) if a != b)}"
            )
        leaves = [_from_numpy(data[f"leaf{i}"], t) for i, (_, t) in enumerate(flat_t)]
    return _unflatten(template, iter(leaves))


def load_meta(path: str) -> Optional[Dict]:
    p = path + ".meta.json"
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None
