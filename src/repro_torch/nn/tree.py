"""Module-tree utilities shared by the layer library.

The reference keeps parameters as nested dicts of arrays; the port keeps
them in ``nn.Module``s whose attribute names are the reference's dict
keys, so a state-dict key is the reference's pytree path with dots
(``layers.0.attn.q.kernel``). A leaf is either a tensor (parameter or
buffer) or a :class:`QuantKernel`, the module that holds one
:class:`LutqState`: its fp master ``w`` as a parameter, ``d``, ``a``,
``sid`` and ``act`` as buffers (``....kernel.w``, ``....kernel.d``).
Float leaves are trainable parameters, as the reference's
``split_trainable`` puts them in the trainable tree; a serve-form state
(``w`` None) holds no parameter.

The reference stacks the layers along a leading axis; the port keeps one
module per layer in an ``nn.ModuleList``. A hybrid's Mamba layers are
stacked over two axes there, (super-block, layer in it); the port keeps
them as an ``nn.ModuleList`` of ``nn.ModuleList``s
(``mamba_layers.<s>.<i>``). :func:`logical_path` maps a per-layer path
back to the reference's stacked path, which is what policy rules, size
floors and backend manifests are resolved against.
A MoE layer's expert kernels (``moe/wi``, ``moe/wg``, ``moe/wo``) keep
the expert axis in front, as the reference's ``"expert"`` stack axis:
one (E, Din, Dout) leaf a layer with one dictionary an expert.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Iterator, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.lutq import LutqState

Path = Tuple[str, ...]

#: Module-list names whose children are the reference's stacked layers
#: (an encoder-decoder stacks its ``encoder`` and ``decoder`` layers; a
#: hybrid its ``mamba_layers`` over two axes, one index each).
STACKS = frozenset({"layers", "encoder", "decoder", "mamba_layers"})
#: Leaves of a ``moe`` module stacked over the experts (the reference's
#: ``("expert", ...)`` logical axes); the shared experts are not.
EXPERT_LEAVES = frozenset({"wi", "wg", "wo"})


class QuantKernel(nn.Module):
    """One quantized weight: the master ``w`` (a parameter, or None in
    the serve form) and ``d``, ``a``, ``sid``, ``act`` as buffers."""

    def __init__(self, state: LutqState):
        super().__init__()
        self.register_parameter(
            "w", None if state.w is None else nn.Parameter(state.w))
        for name in LutqState._fields[1:]:
            self.register_buffer(name, getattr(state, name))

    @property
    def state(self) -> LutqState:
        return LutqState(self.w, self.d, self.a, self.sid, self.act)


def leaf(module: nn.Module, name: str):
    """The tensor or :class:`LutqState` stored under ``name``."""
    v = getattr(module, name)
    return v.state if isinstance(v, QuantKernel) else v


def tree_paths(module: nn.Module, prefix: Path = ()
               ) -> Iterator[Tuple[Path, Any]]:
    """Yield (path, leaf); a QuantKernel counts as one LutqState leaf."""
    if isinstance(module, QuantKernel):
        yield prefix, module.state
        return
    for name, t in module.named_parameters(recurse=False):
        yield prefix + (name,), t
    for name, t in module.named_buffers(recurse=False):
        yield prefix + (name,), t
    for name, child in module.named_children():
        yield from tree_paths(child, prefix + (name,))


def _parent(module: nn.Module, path: Path) -> nn.Module:
    for k in path[:-1]:
        module = getattr(module, k)
    return module


def set_leaf(module: nn.Module, path: Path, value) -> None:
    """Store a LutqState, a float tensor (as a trainable parameter) or
    another tensor (as a buffer) at ``path``."""
    parent, name = _parent(module, path), path[-1]
    if hasattr(parent, name):
        delattr(parent, name)
    if isinstance(value, LutqState):
        setattr(parent, name, QuantKernel(value))
    elif value.is_floating_point():
        setattr(parent, name, nn.Parameter(value))
    else:
        parent.register_buffer(name, value)


def map_with_path(fn: Callable, module: nn.Module) -> nn.Module:
    """Replace every leaf by ``fn(path, leaf)``, in place; returns module."""
    for path, old in list(tree_paths(module)):
        new = fn(path, old)
        if new is not old:
            set_leaf(module, path, new)
    return module


def clone_structure(module: nn.Module) -> nn.Module:
    """A new module tree that shares every tensor with ``module``.

    Leaves replaced in the clone (by :func:`map_with_path`) leave the
    original untouched, at no copy of the weights.
    """
    memo = {id(t): t for t in list(module.parameters())
            + list(module.buffers())}
    return copy.deepcopy(module, memo)


def layer_split(path: Path) -> Tuple[Path, Optional[Tuple[int, ...]]]:
    """(reference path, stack indices or None) of a per-layer path.

    ``("layers", "3", "attn", "q", "kernel")`` is slice (3,) of the
    reference's stacked leaf ``("layers", "attn", "q", "kernel")``;
    ``("mamba_layers", "1", "0", "mamba", "conv_w")`` is slice (1, 0) of
    ``("mamba_layers", "mamba", "conv_w")``.
    """
    for i, k in enumerate(path[:-1]):
        if k in STACKS and path[i + 1].isdigit():
            j = i + 1
            while j < len(path) and path[j].isdigit():
                j += 1
            return (path[:i + 1] + path[j:],
                    tuple(int(x) for x in path[i + 1:j]))
    return path, None


def expert_dims(path: Path) -> int:
    """1 for an expert-stacked leaf (``.../moe/wi``, ``wg``, ``wo``),
    else 0."""
    return int(len(path) >= 2 and path[-2] == "moe"
               and path[-1] in EXPERT_LEAVES)


def logical_path(path: Path) -> Tuple[Path, int]:
    """(reference path, number of stack axes) of a per-layer path: the
    layer axes the port splits off (two for a hybrid's Mamba layers),
    plus the expert axis a leaf keeps."""
    lpath, idx = layer_split(path)
    return lpath, len(idx or ()) + expert_dims(lpath)


def module_device(module: nn.Module) -> Optional[torch.device]:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None
