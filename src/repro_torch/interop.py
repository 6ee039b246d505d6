"""Parameter and train-state interchange with the JAX package, as numpy.

The reference keeps parameters as nested dicts of arrays, with
``LutqState(w, d, a, sid, act)`` leaves and the layers stacked along a
leading axis. :func:`from_jax` loads such a tree, handed over as numpy
(any namedtuple with those five fields stands for a LutqState), into
the port's modules, splitting each ``(L, ...)`` stack per layer (L =
``n_layers - first_dense``; a config's leading dense layers are the
reference's unstacked ``prefix_layers/<i>`` dicts, the port's
``prefix_layers.<i>`` modules; an encoder-decoder's ``encoder`` and
``decoder`` stacks split the same way, a layer at a time; a hybrid's
``mamba_layers`` stack (n_super, attn_every, ...) splits over both axes
into ``mamba_layers.<s>.<i>``, and its unstacked ``shared`` block loads
once; an ssm's ``layers`` stack splits as a dense one, its bare decay
LoRA leaves ``layers/mix/w1`` and ``w2`` among them);
:func:`to_numpy` goes the other way.

A slot decode cache crosses with :func:`cache_from_jax` /
:func:`cache_to_numpy`: the reference stacks each leaf over the
stacked layers (``{"layers": {...: (L, B, S, ...)}, "len"[,
"prefix_layers": {"<i>": {...}}]}``); the port keeps one dict per layer
in execution order, the prefix layers first. An encdec cache's layers
hold ``xk`` / ``xv`` (the cross K/V) beside ``k`` / ``v``, and its
``src_len`` (B,) crosses as ``len`` does. A hybrid cache crosses from
the reference's ``{"mamba": {"ssm", "conv": (n_super, attn_every, B,
...)}, "attn": {"k", "v": (n_super, B, S, Hkv, dh)}, "len"}`` to one
dict an entry in execution order: a super-block's ``attn_every`` Mamba
states, then its application of the shared block's K/V. An ssm cache's
``{"layers": {"shift_t", "shift_c": (L, B, 1, D), "wkv": (L, B, H, dk,
dv)}, "len"}`` splits a layer at a time, as a dense one.

A paged KV cache crosses with :func:`paged_cache_from_jax` /
:func:`paged_cache_to_numpy`: the reference stacks each pool leaf over
the layers, ``{"pool": {"k", "v"[, "k_scale", "v_scale"]}: (L, P,
page, Hkv[, dh]), "block", "len"}``; the port keeps one pool dict per
layer. An encdec paged cache's ``xk`` / ``xv`` slabs (L, B, src_len,
Hkv, dh) become one tensor a layer, and ``src_len`` crosses as ``len``.

A train checkpoint's parameters (``ckpt.restore_params``: the
``trainable`` and ``static`` subtrees, memory-mapped) become a serve
model with :func:`from_train_params`, which copies each quantized leaf's
``d``, ``a``, ``sid`` and ``act`` one layer at a time to the device and
never materialises a master; :func:`trainable_shapes` gives the
``trainable`` keys and shapes a config expects.

A ResNet-20 of the vision family crosses with :func:`resnet_from_jax`:
its ``BNParams`` leaves become ``....p.gamma`` / ``....p.beta`` and its
running statistics a ``{name: BNStats}`` dict.

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
from repro_torch.models.encdec import init_encdec, n_encoder
from repro_torch.models.lm import init_lm, n_stacked
from repro_torch.models.rwkv import init_rwkv
from repro_torch.models.zamba import init_zamba, n_super
from repro_torch.nn.tree import (QuantKernel, layer_split, set_leaf,
                                 tree_paths)


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


def walk(tree, prefix=()):
    """Yield (path, leaf) of a tree of nested dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, prefix + (k,))
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


def _stacks(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """{stacked top-level key: its stack shape} of a config's tree."""
    if cfg.family == "encdec":
        return {"encoder": (n_encoder(cfg),), "decoder": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        return {"mamba_layers": (n_super(cfg), cfg.attn_every)}
    return {"layers": (n_stacked(cfg),)}


def _skeleton(cfg: ModelConfig) -> nn.Module:
    """The config's model on the meta device, to load weights into."""
    if cfg.family == "encdec":
        return init_encdec(None, cfg, device="meta")
    if cfg.family == "hybrid":
        return init_zamba(None, cfg, device="meta")
    if cfg.family == "ssm":
        return init_rwkv(None, cfg, device="meta")
    return init_lm(None, cfg, device="meta")


def _slices(key: str, stacks) -> List[Optional[Tuple[int, ...]]]:
    """The stack indices of a top-level key (None where unstacked)."""
    return list(np.ndindex(stacks[key])) if key in stacks else [None]


def _layer_path(lpath: Tuple[str, ...], idx) -> Tuple[str, ...]:
    """The per-layer path of slice ``idx`` of a reference path."""
    if idx is None:
        return lpath
    return lpath[:1] + tuple(str(i) for i in idx) + lpath[1:]


def _restack(entries) -> np.ndarray:
    """(stack indices, array) pairs as one array of shape (*stack,
    *array), in index order."""
    entries = sorted(entries, key=lambda e: e[0])
    dims = tuple(max(e[0][k] for e in entries) + 1
                 for k in range(len(entries[0][0])))
    arr = np.stack([a for _, a in entries])
    return arr.reshape(dims + arr.shape[1:])


def from_jax(tree, cfg: ModelConfig, *, device="cpu") -> nn.Module:
    """The port's model holding the parameters of a reference tree."""
    model = _skeleton(cfg)
    stacks = _stacks(cfg)
    for path, leaf in walk(tree):
        for idx in _slices(path[0], stacks):
            set_leaf(model, _layer_path(path, idx),
                     _convert(leaf, device, idx))
    missing = [".".join(p) for p, v in tree_paths(model)
               if v is not None and not isinstance(v, LutqState)
               and v.is_meta]
    if missing:
        raise KeyError(f"from_jax: the tree has no value for {missing}")
    return model


def to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The reference's tree layout as numpy: nested dicts, per-layer
    leaves restacked along their leading stack axes, LutqState leaves as
    the port's LutqState of numpy arrays."""
    groups: Dict[Tuple[str, ...], List] = defaultdict(list)
    for path, leaf in tree_paths(model):
        lpath, idx = layer_split(path)
        groups[lpath].append((idx, leaf))

    def merge(entries):
        if _is_state(entries[0][1]):
            return LutqState(*(
                None if getattr(entries[0][1], f) is None
                else merge([(i, getattr(x, f)) for i, x in entries])
                for f in LutqState._fields))
        if entries[0][0] is None:
            return _numpy(entries[0][1])
        return _restack([(i, _numpy(t)) for i, t in entries])

    out: Dict[str, Any] = {}
    for lpath, entries in groups.items():
        node = out
        for k in lpath[:-1]:
            node = node.setdefault(k, {})
        node[lpath[-1]] = merge(entries)
    return out


def paged_cache_from_jax(cache, cfg: ModelConfig, *, device="cpu"
                         ) -> Dict[str, Any]:
    """A reference paged cache (as numpy) in the port's layout: the
    stacked pool split into one dict per layer; block and len as int32
    tensors."""
    pool = [{key: _tensor(np.asarray(leaf)[i], device)
             for key, leaf in cache["pool"].items()}
            for i in range(cfg.n_layers)]
    out = {"pool": pool}
    for key in ("xk", "xv"):
        if key in cache:
            out[key] = [_tensor(np.asarray(cache[key])[i], device)
                        for i in range(cfg.n_layers)]
    for key in ("block", "len", "src_len"):
        if key in cache:
            out[key] = _tensor(np.asarray(cache[key], np.int32), device)
    return out


def cache_from_jax(cache, cfg: ModelConfig, *, device="cpu"
                   ) -> Dict[str, Any]:
    """A reference slot cache (as numpy) in the port's layout: the
    prefix layers' dicts, then the stacked leaves split per layer (a
    hybrid's Mamba states and shared-block K/V interleaved in execution
    order)."""
    if cfg.family == "hybrid":
        layers = []
        for s in range(n_super(cfg)):
            layers += [{key: _tensor(np.asarray(leaf)[s, i], device)
                        for key, leaf in cache["mamba"].items()}
                       for i in range(cfg.attn_every)]
            layers.append({key: _tensor(np.asarray(leaf)[s], device)
                           for key, leaf in cache["attn"].items()})
    else:
        prefix = [{key: _tensor(leaf, device) for key, leaf in
                   cache["prefix_layers"][str(i)].items()}
                  for i in range(cfg.first_dense)]
        layers = prefix + [{key: _tensor(np.asarray(leaf)[i], device)
                            for key, leaf in cache["layers"].items()}
                           for i in range(n_stacked(cfg))]
    out = {"layers": layers}
    for key in ("len", "src_len"):
        if key in cache:
            out[key] = _tensor(np.asarray(cache[key], np.int32), device)
    return out


def cache_to_numpy(cache, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's slot cache in the reference's layout, as numpy: the
    first ``first_dense`` layers under ``prefix_layers``, the others
    restacked (a hybrid's under ``mamba`` and ``attn``)."""
    def restack(entries):
        return {k: np.stack([_numpy(c[k]) for c in entries])
                for k in entries[0]}

    if cfg.family == "hybrid":
        per = cfg.attn_every + 1
        entries = cache["layers"]
        mamba = restack([c for j, c in enumerate(entries)
                         if j % per != per - 1])
        return {"mamba": {k: v.reshape((n_super(cfg), cfg.attn_every)
                                       + v.shape[1:])
                          for k, v in mamba.items()},
                "attn": restack(entries[per - 1::per]),
                "len": _numpy(cache["len"])}
    n = cfg.first_dense
    out = {"layers": restack(cache["layers"][n:]),
           "len": _numpy(cache["len"])}
    if "src_len" in cache:
        out["src_len"] = _numpy(cache["src_len"])
    if n:
        out["prefix_layers"] = {str(i): {k: _numpy(v) for k, v in c.items()}
                                for i, c in enumerate(cache["layers"][:n])}
    return out


def paged_cache_to_numpy(cache) -> Dict[str, Any]:
    """The port's paged cache in the reference's layout, as numpy: pool
    leaves restacked over the layers."""
    keys = cache["pool"][0].keys()
    out = {"pool": {k: np.stack([_numpy(c[k]) for c in cache["pool"]])
                    for k in keys}}
    for key in ("xk", "xv"):
        if key in cache:
            out[key] = np.stack([_numpy(t) for t in cache[key]])
    for key in ("block", "len", "src_len"):
        if key in cache:
            out[key] = _numpy(cache[key])
    return out


# ---------------------------------------------------------------------------
# train states (the reference's state_flat layout)
# ---------------------------------------------------------------------------

_STATIC_KEYS = {"d": "__lutq_d", "a": "__lutq_a", "sid": "__lutq_sid",
                "act": "__lutq_act"}

Key = Tuple[str, Tuple[str, ...], Optional[Tuple[int, ...]]]


def _ref_keys(model: nn.Module) -> Dict[str, Key]:
    """{state-dict name: ("trainable" | "static", reference path, stack
    indices)} for every parameter and buffer of ``model``; plus, under
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
    """Nested dicts from (reference path, stack indices, array or None)
    items; per-layer arrays of one path are stacked in index order (a
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
            node[path[-1]] = _restack(entries)
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


def _fetch(tree, path: Tuple[str, ...], i: Optional[Tuple[int, ...]]
           ) -> np.ndarray:
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


# ---------------------------------------------------------------------------
# train checkpoint -> serve model
# ---------------------------------------------------------------------------

def trainable_shapes(cfg: ModelConfig) -> Dict[Tuple[str, ...], Tuple]:
    """{reference path: stacked shape} of the ``trainable`` tree a train
    checkpoint of ``cfg`` holds. Built on the meta device; a LUT-Q master
    sits at its kernel's own path with its kernel's shape, so the
    quantization policy changes neither the keys nor the shapes."""
    model = _skeleton(cfg)
    stacks = _stacks(cfg)
    named = dict(model.named_parameters())
    out: Dict[Tuple[str, ...], Tuple] = {}
    for name, (sec, path, i) in _ref_keys(model).items():
        if sec == "trainable":
            shape = tuple(named[name].shape)
            out[path] = shape if i is None else stacks[path[0]] + shape
    return out


def _param_leaves(trainable, static, prefix=()):
    """(reference path, trainable leaf, static node) of every leaf of a
    ``state_flat`` params pair, walked as the reference's
    ``merge_trainable`` walks it: a static ``{"__lutq_d", ...}`` node is
    a LutqState (its master in ``trainable``), a ``{"__static"}`` node an
    integer leaf, and a None static entry a float leaf."""
    if isinstance(static, dict) and ("__lutq_d" in static
                                     or "__static" in static):
        yield prefix, trainable, static
    elif isinstance(trainable, dict):
        for k, v in trainable.items():
            yield from _param_leaves(
                v, None if static is None else static.get(k), prefix + (k,))
    else:
        yield prefix, trainable, None


def _meta_like(arr, i: Optional[Tuple[int, ...]]
               ) -> Optional[torch.Tensor]:
    """An unmaterialised tensor of the shape and dtype of ``arr`` (or of
    its stack slice ``i``): nothing is read."""
    if arr is None:
        return None
    shape = arr.shape if i is None else arr.shape[len(i):]
    dtype = _tensor(np.zeros(0, arr.dtype), "cpu").dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def from_train_params(params, cfg: ModelConfig, *, pack4: bool = False,
                      policy=None, device="cuda") -> nn.Module:
    """The port's model holding the parameters of a train checkpoint,
    counterpart of the reference's ``merge_trainable(params["trainable"],
    params["static"])`` on the tree ``ckpt.restore_params`` returns.

    Each quantized leaf's ``d``, ``a``, ``sid`` and ``act``, and each
    float leaf, is copied one layer at a time from the (memory-mapped)
    stacked arrays to ``device``, so the host holds one layer's copy.
    Masters stay unmaterialised (meta tensors): the model serves through
    :func:`repro_torch.core.policy.serve_view`, which drops them, and
    neither the masters nor the optimizer moments reach the device.
    ``pack4`` / ``policy``: pack the assignments that ``serve_view(
    pack4=pack4, policy=policy)`` would pack as each layer lands, so the
    int8 form of a packed leaf is never whole on the device
    (``core/policy.packs``; serve_view keeps them as they are).
    """
    from repro_torch.core.policy import packs
    from repro_torch.core.rules import as_policy
    from repro_torch.kernels.ref import pack4_kin

    pol = as_policy(policy)
    model = _skeleton(cfg)
    stacks = _stacks(cfg)
    for lpath, tr, st in _param_leaves(params["trainable"],
                                       params["static"]):
        for i in _slices(lpath[0], stacks):
            path = _layer_path(lpath, i)
            if st is None:
                set_leaf(model, path, _convert(tr, device, i))
            elif "__static" in st:
                set_leaf(model, path, _convert(st["__static"], device, i))
            else:
                d = _convert(st["__lutq_d"], device, i)
                a = _convert(st["__lutq_a"], device, i)
                if packs(pol, lpath, a, d.shape[-1], pack4):
                    a = pack4_kin(a)
                set_leaf(model, path, LutqState(
                    w=_meta_like(tr, i), d=d, a=a,
                    sid=_convert(st.get("__lutq_sid"), device, i),
                    act=_convert(st.get("__lutq_act"), device, i)))
    missing = [".".join(p) for p, v in tree_paths(model)
               if v is not None and not isinstance(v, LutqState)
               and v.is_meta]
    if missing:
        raise KeyError(f"from_train_params: no value for {missing}")
    return model


# ---------------------------------------------------------------------------
# the vision family
# ---------------------------------------------------------------------------

def _out_dim(leaf) -> int:
    return int(np.shape(leaf.a if _is_state(leaf) else leaf)[-1])


def resnet_from_jax(params, stats, *, device="cpu"):
    """(model, {name: BNStats}) of the port holding a reference ResNet-20
    tree (``repro.models.resnet.init_resnet20``'s params and stats, as
    numpy): train-form, serve-form, packed or pow2-plane leaves; a
    ``BNParams`` leaf becomes ``....p.gamma`` / ``....p.beta``. The
    widths, blocks and classes are read from the tree; a leaf or a
    statistic the geometry needs and the tree lacks raises KeyError."""
    from repro_torch.core.mlbn import BNStats
    from repro_torch.models.resnet import init_resnet20

    widths = []
    while f"s{len(widths)}b0" in params:
        widths.append(_out_dim(params[f"s{len(widths)}b0"]["conv1"]["kernel"]))
    blocks = 0
    while f"s0b{blocks}" in params:
        blocks += 1
    model, want = init_resnet20(
        None, widths=tuple(widths), blocks=blocks,
        n_classes=_out_dim(params["fc"]["kernel"]), device="meta")
    for path, leaf in walk(params):
        if tuple(getattr(leaf, "_fields", ())) == ("gamma", "beta"):
            for f in leaf._fields:
                set_leaf(model, path + (f,), _convert(getattr(leaf, f),
                                                      device))
        else:
            set_leaf(model, path, _convert(leaf, device))
    missing = [".".join(p) for p, v in tree_paths(model)
               if v is not None and not isinstance(v, LutqState)
               and v.is_meta]
    missing += [f"stats[{k!r}]" for k in want if k not in stats]
    if missing:
        raise KeyError(f"resnet_from_jax: the tree has no value for "
                       f"{missing}")
    return model, {k: BNStats(_tensor(stats[k].mean, device),
                              _tensor(stats[k].var, device)) for k in want}
