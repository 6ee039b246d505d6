"""Parameter interchange with the JAX package, as numpy.

The reference keeps parameters as nested dicts of arrays, with
``LutqState(w, d, a, sid, act)`` leaves and the layers stacked along a
leading axis. :func:`from_jax` loads such a tree, handed over as numpy
(any namedtuple with those five fields stands for a LutqState), into
the port's modules, splitting each ``(L, ...)`` stack per layer;
:func:`to_numpy` goes the other way. This module imports neither JAX
nor the JAX package: trees cross as numpy only.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.lutq import LutqState
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_lm
from repro_torch.nn.tree import logical_path, set_leaf, tree_paths


def _is_state(x) -> bool:
    return tuple(getattr(x, "_fields", ())[:3]) == ("w", "d", "a")


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as the reference stores it
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _convert(leaf, device, i=None):
    """Leaf (or its i-th stack slice) as a tensor or torch LutqState."""
    def one(x):
        if x is None:
            return None
        return _tensor(np.asarray(x) if i is None else np.asarray(x)[i],
                       device)

    if _is_state(leaf):
        return LutqState(*(one(getattr(leaf, f)) for f in LutqState._fields))
    return one(leaf)


def from_jax(tree, cfg: ModelConfig, *, device="cpu") -> nn.Module:
    """The port's model holding the parameters of a reference tree."""
    model = init_lm(None, cfg, device="meta")
    for path, leaf in _walk(tree):
        if path[0] == "layers":
            for i in range(cfg.n_layers):
                set_leaf(model, ("layers", str(i)) + path[1:],
                         _convert(leaf, device, i))
        else:
            set_leaf(model, path, _convert(leaf, device))
    missing = [".".join(p) for p, v in tree_paths(model)
               if v is not None and not isinstance(v, LutqState)
               and v.is_meta]
    if missing:
        raise KeyError(f"from_jax: the tree has no value for {missing}")
    return model


def to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The reference's tree layout as numpy: nested dicts, per-layer
    leaves restacked along a leading axis, LutqState leaves as the
    port's LutqState of numpy arrays."""
    groups: Dict[Tuple[str, ...], List] = defaultdict(list)
    stacked: Dict[Tuple[str, ...], int] = {}
    for path, leaf in tree_paths(model):
        lpath, nstack = logical_path(path)
        groups[lpath].append(leaf)
        stacked[lpath] = nstack

    def merge(leaves, nstack):
        if _is_state(leaves[0]):
            return LutqState(*(
                None if getattr(leaves[0], f) is None
                else merge([getattr(x, f) for x in leaves], nstack)
                for f in LutqState._fields))
        arrs = [_numpy(t) for t in leaves]
        return np.stack(arrs) if nstack else arrs[0]

    out: Dict[str, Any] = {}
    for lpath, leaves in groups.items():
        node = out
        for k in lpath[:-1]:
            node = node.setdefault(k, {})
        node[lpath[-1]] = merge(leaves, stacked[lpath])
    return out
