"""Parameter and train-state interchange with the JAX package, as numpy.

The reference keeps parameters as nested dicts of arrays, with
``LutqState(w, d, a, sid, act)`` leaves and the layers stacked along a
leading axis. :func:`from_jax` loads such a tree, handed over as numpy
(any namedtuple with those five fields stands for a LutqState), into
the port's modules, splitting each ``(L, ...)`` stack per layer;
:func:`to_numpy` goes the other way.

A paged KV cache crosses with :func:`paged_cache_from_jax` /
:func:`paged_cache_to_numpy`: the reference stacks each pool leaf over
the layers, ``{"pool": {"k", "v"[, "k_scale", "v_scale"]}: (L, P,
page, Hkv[, dh]), "block", "len"}``; the port keeps one pool dict per
layer.

A train state crosses in the reference's ``state_flat`` layout
(``{"trainable", "static", "opt_state", "step"}``, what its checkpoints
hold): :func:`train_state_to_numpy` builds it from a port
:class:`~repro_torch.optim.train_state.TrainState` and
:func:`load_train_state` copies one into a port state in place. There
the masters sit in ``trainable`` at the leaf's own path, a LutqState's
static part is ``{"__lutq_d", "__lutq_a"[, "__lutq_sid", "__lutq_act"]}``,
a float leaf's static entry is None, and the optimizer moments mirror
``trainable``. This module imports neither JAX nor the JAX package:
trees cross as numpy only.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.lutq import LutqState
from repro_torch.core.policy import merge_trainable
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_lm
from repro_torch.nn.tree import (QuantKernel, layer_split, logical_path,
                                 set_leaf, tree_paths)


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


def paged_cache_from_jax(cache, cfg: ModelConfig, *, device="cpu"
                         ) -> Dict[str, Any]:
    """A reference paged cache (as numpy) in the port's layout: the
    stacked pool split into one dict per layer; block and len as int32
    tensors."""
    pool = [{key: _tensor(np.asarray(leaf)[i], device)
             for key, leaf in cache["pool"].items()}
            for i in range(cfg.n_layers)]
    return {"pool": pool,
            "block": _tensor(np.asarray(cache["block"], np.int32), device),
            "len": _tensor(np.asarray(cache["len"], np.int32), device)}


def paged_cache_to_numpy(cache) -> Dict[str, Any]:
    """The port's paged cache in the reference's layout, as numpy: pool
    leaves restacked over the layers."""
    keys = cache["pool"][0].keys()
    return {"pool": {k: np.stack([_numpy(c[k]) for c in cache["pool"]])
                     for k in keys},
            "block": _numpy(cache["block"]), "len": _numpy(cache["len"])}


# ---------------------------------------------------------------------------
# train states (the reference's state_flat layout)
# ---------------------------------------------------------------------------

_STATIC_KEYS = {"d": "__lutq_d", "a": "__lutq_a", "sid": "__lutq_sid",
                "act": "__lutq_act"}

Key = Tuple[str, Tuple[str, ...], Optional[int]]


def _ref_keys(model: nn.Module) -> Dict[str, Key]:
    """{state-dict name: ("trainable" | "static", reference path, layer
    index)} for every parameter and buffer of ``model``; plus, under
    ``"static"``, a None-valued entry for each plain float leaf."""
    quant = {n for n, m in model.named_modules()
             if isinstance(m, QuantKernel)}
    out: Dict[str, Key] = {}
    for name, _ in model.named_parameters():
        parent = name.rpartition(".")[0]
        path = parent if parent in quant else name
        out[name] = ("trainable",) + layer_split(tuple(path.split(".")))
    for name, _ in model.named_buffers():
        parent, _, field = name.rpartition(".")
        path = (tuple(parent.split(".")) + (_STATIC_KEYS[field],)
                if parent in quant else tuple(name.split(".")) + ("__static",))
        out[name] = ("static",) + layer_split(path)
    return out


def _nest(items) -> Dict[str, Any]:
    """Nested dicts from (reference path, layer index, array or None)
    items; per-layer arrays of one path are stacked in layer order (a
    None stays one None)."""
    groups: Dict[Tuple[str, ...], List] = defaultdict(list)
    for path, i, arr in items:
        groups[path].append((i, arr))
    out: Dict[str, Any] = {}
    for path, entries in groups.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        i0, a0 = entries[0]
        if i0 is None or a0 is None:
            node[path[-1]] = a0
        else:
            node[path[-1]] = np.stack([a for _, a in sorted(
                entries, key=lambda e: e[0])])
    return out


def train_state_to_numpy(state) -> Dict[str, Any]:
    """A port TrainState as the reference's ``state_flat`` tree of numpy
    arrays (what ``repro.checkpoint.ckpt.save`` writes)."""
    model = state.model
    keys = _ref_keys(model)
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    trainable = [(p, i, _numpy(named[n])) for n, (sec, p, i) in keys.items()
                 if sec == "trainable"]
    static = [(p, i, _numpy(named[n])) for n, (sec, p, i) in keys.items()
              if sec == "static"]
    masters = {p for p, _, _ in static if p[-1] == "__lutq_d"}
    static += [(p, i, None) for p, i, _ in trainable
               if p + ("__lutq_d",) not in masters]
    opt = {k: _nest((keys[n][1], keys[n][2], _numpy(t))
                    for n, t in moments.items())
           for k, moments in state.opt_state.items()}
    return {"trainable": _nest(trainable), "static": _nest(static),
            "opt_state": opt, "step": np.asarray(state.step, np.int32)}


def _fetch(tree, path: Tuple[str, ...], i: Optional[int]) -> np.ndarray:
    node = tree
    for k in path:
        node = node[k]
    arr = np.asarray(node)
    return arr if i is None else arr[i]


def load_train_state(state, tree) -> None:
    """Copy a reference ``state_flat`` tree (numpy, as a checkpoint
    restores it) into a port TrainState in place: parameters and buffers
    through :func:`repro_torch.core.policy.merge_trainable`, the
    optimizer moments, and the step."""
    model = state.model
    # a calibrated tree's act pairs land in a model that has none yet
    for name, mod in model.named_modules():
        if isinstance(mod, QuantKernel) and mod.act is None:
            path, i = layer_split(tuple(name.split(".")) + ("__lutq_act",))
            node = tree["static"]
            for k in path[:-1]:
                node = node[k]
            if "__lutq_act" not in node:  # not calibrated
                continue
            act = _fetch(node, path[-1:], i)
            mod.act = torch.empty(act.shape, dtype=torch.float32,
                                  device=mod.d.device)
    keys = _ref_keys(model)
    parts: Dict[str, Dict[str, torch.Tensor]] = {"trainable": {},
                                                 "static": {}}
    for name, (sec, path, i) in keys.items():
        parts[sec][name] = _tensor(_fetch(tree[sec], path, i), "cpu")
    merge_trainable(model, parts["trainable"], parts["static"])
    with torch.no_grad():
        for k, moments in state.opt_state.items():
            for name, t in moments.items():
                _, path, i = keys[name]
                t.copy_(_tensor(_fetch(tree["opt_state"][k], path, i), "cpu"))
    state.step = int(np.asarray(tree["step"]))
