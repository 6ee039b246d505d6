"""Quantization policy application over a module tree.

Counterpart of ``repro.core.policy``: :func:`quantize_tree` installs a
:class:`LutqState` on every eligible kernel, :func:`kmeans_tree` runs
the paper's step 4 on every quantized leaf under its rule,
:func:`split_trainable` / :func:`merge_trainable` separate the trained
masters from the static state, :func:`serve_view` keeps only the
dictionary and the int8 or packed 4-bit assignments,
:func:`backend_manifest` records which kernel each leaf resolves to,
and the report helpers feed the serve CLI.

Leaves are resolved against the reference's *stacked* path
(:func:`repro_torch.nn.tree.logical_path`): per-layer leaves of one
stacked kernel get the same rule, their size floor is checked against
the stacked size, and manifests carry one record per stacked kernel, so
they are JSON-equal to the reference's.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.lutq import LutqState, init_state, update_state
from repro_torch.core.rules import QuantLike, QuantPolicy, as_policy
from repro_torch.core.spec import QuantSpec
from repro_torch.nn.tree import (QuantKernel, clone_structure, logical_path,
                                 map_with_path, tree_paths)

# Parameters that never get quantized regardless of size (norm gains,
# biases, routers, ...). The paper quantizes affine/conv *weights* only.
_EXCLUDE = re.compile(
    r"(bias|scale|ln|norm|router|A_log|dt_bias|^D$|w0|^u$|mix_|conv_b|gamma|beta)"
)

_POW2_TODO = ("backend='pow2' serving (sign+exponent dictionary planes and "
              "the shift-add kernel) is not ported yet: ROADMAP queue 1 "
              "item 4, queue 2 kernel 4")


def default_predicate(path: Tuple[str, ...], leaf) -> bool:
    name = path[-1] if path else ""
    if _EXCLUDE.search(name):
        return False
    return hasattr(leaf, "ndim") and leaf.ndim >= 2


def _stacked_sizes(model: nn.Module) -> Dict[Tuple[str, ...], int]:
    """Element count of each leaf's stacked (reference) form."""
    sizes: Dict[Tuple[str, ...], int] = defaultdict(int)
    for path, leaf in tree_paths(model):
        if leaf is not None and not isinstance(leaf, LutqState):
            sizes[logical_path(path)[0]] += leaf.numel()
    return sizes


def quantize_tree(model: nn.Module, quant: QuantLike,
                  predicate: Callable = default_predicate) -> nn.Module:
    """Convert eligible kernels to LutqState, in place; returns model.

    Each per-layer kernel gets its own dictionary, as each slice of the
    reference's stacked kernel does. The fp master stays as ``w``.
    """
    policy = as_policy(quant)
    if policy is None:
        return model
    sizes = _stacked_sizes(model)

    def convert(path, leaf):
        if isinstance(leaf, LutqState) or not predicate(path, leaf):
            return leaf
        lpath, _ = logical_path(path)
        rid, spec = policy.resolve(lpath, size=sizes[lpath])
        if spec is None:
            return leaf
        st = init_state(leaf.detach(), spec)
        return st._replace(sid=torch.tensor(rid, dtype=torch.int32,
                                            device=leaf.device))

    return map_with_path(convert, model)


def _resolve_for_state(policy: QuantPolicy, path) -> Optional[QuantSpec]:
    """Spec governing an existing LutqState leaf (path re-resolution).

    Size floors are ignored: the leaf is already quantized, so the rule's
    spec applies regardless of how the floor would gate fresh conversion.
    """
    i = policy.match(path)
    if i is None:
        return None
    return policy.rules[i].spec


def kmeans_tree(model: nn.Module, quant: QuantLike,
                impl: Optional[str] = None) -> nn.Module:
    """Paper step 4 over every train-form quantized leaf, honoring each
    leaf's rule; returns model.

    ``impl`` forces the per-leaf k-means implementation ("dense" |
    "segsum" | "stats"); default is the structural choice of
    :func:`repro_torch.core.lutq.resolve_kmeans_impl`. Runs under
    ``torch.no_grad()`` and writes the new ``d`` and ``a`` into each
    leaf's buffers in place (the reference returns a new tree). A leaf
    no rule covers keeps its (d, A) frozen.
    """
    policy = as_policy(quant)
    if policy is None:
        return model
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, QuantKernel) or mod.w is None:
                continue
            lpath, _ = logical_path(tuple(name.split(".")))
            spec = _resolve_for_state(policy, lpath)
            if spec is None:
                continue
            new = update_state(mod.state, spec, impl=impl)
            mod.d.copy_(new.d)
            mod.a.copy_(new.a)
    return model


def split_trainable(model: nn.Module):
    """(trainable, static) views of a model, keyed by state-dict name.

    trainable: the parameters that require grad: the LUT-Q masters
    (``....kernel.w``, the paper's W) and the float leaves. static: the
    buffers: dictionaries, assignments, rule ids, activation pairs. The
    tensors are the model's own, not copies; :func:`merge_trainable`
    writes such views back into a model.
    """
    trainable = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
    static = dict(model.named_buffers())
    return trainable, static


def merge_trainable(model: nn.Module, trainable, static) -> nn.Module:
    """Copy a (trainable, static) pair into ``model`` by name, in place;
    every parameter and buffer must be given. Returns model."""
    model.load_state_dict({**trainable, **static}, strict=True)
    return model


def _leaf_rule(pol: Optional[QuantPolicy], path):
    """(spec, requested_backend) for a leaf under the policy."""
    if pol is None:
        return None, "auto"
    i = pol.match(path)
    if i is None:
        return None, "auto"
    return pol.rules[i].spec, pol.rules[i].resolved_backend


def _record(leaf: LutqState, backend: str, requested: str, nstack: int):
    K = leaf.d.shape[-1]
    return {
        "backend": backend,
        "requested": requested,
        "packed": bool(leaf.a.dtype == torch.uint8),
        "encoding": "pow2" if leaf.d.dtype == torch.int8 else "float",
        "act_frozen": bool(leaf.act is not None),
        "K": int(K),
        "bits": int(math.ceil(math.log2(max(K, 2)))),
        "stack": int(nstack),
    }


def serve_view(model: nn.Module, *, pack4: bool = False,
               policy: Optional[QuantLike] = None,
               with_manifest: bool = False):
    """Deployment form: drop the fp masters, keep (d, A).

    Returns a new module tree that shares every unchanged tensor with
    ``model``. With ``pack4=True`` (K <= 16 only) two 4-bit indices pack
    per byte along axis -2, the reduction axis, which is the layout the
    packed kernel streams (uint8 == packed; int8 == raw). ``policy``
    gates packing per leaf as in the reference: a rule asking for
    ``fused``/``decode`` keeps int8, a rule asking for ``packed4`` packs
    even without the flag. A rule asking for ``pow2`` raises
    NotImplementedError. ``with_manifest=True`` also returns the
    ``{path: {backend, requested, packed, ...}}`` record.
    """
    from repro_torch.kernels.ops import resolve_backend
    from repro_torch.kernels.ref import pack4_kin

    pol = as_policy(policy)
    manifest: Dict[str, Dict] = {}

    def conv(path, leaf):
        if not isinstance(leaf, LutqState):
            return leaf
        lpath, nstack = logical_path(path)
        a = leaf.a
        K = leaf.d.shape[-1]
        spec, requested = _leaf_rule(pol, lpath)
        packable = (a.dtype != torch.uint8 and K <= 16
                    and a.ndim >= 2 and a.shape[-2] % 2 == 0)
        if requested == "pow2":
            raise NotImplementedError(_POW2_TODO)
        if requested == "packed4":
            pack = packable
        elif requested in ("fused", "decode"):
            pack = False
        else:  # auto
            pack = packable and pack4
            if pack and pol is not None:
                pack = spec is not None and spec.index_bits <= 4
        if pack:
            a = pack4_kin(a)
        out = LutqState(w=None, d=leaf.d, a=a, sid=leaf.sid, act=leaf.act)
        if with_manifest:
            manifest["/".join(lpath)] = _record(
                out, resolve_backend(out, "auto"), requested, nstack)
        return out

    tree = map_with_path(conv, clone_structure(model))
    if with_manifest:
        return tree, manifest
    return tree


def backend_manifest(model: nn.Module, policy: Optional[QuantLike] = None,
                     override: Optional[str] = None) -> Dict[str, Dict]:
    """Per-leaf kernel-backend resolution for an existing (serve) tree.

    ``override``: a model-wide kernel backend (the CLI's
    ``--kernel-backend``), which at apply time supersedes per-rule
    requests.
    """
    from repro_torch.kernels.ops import resolve_backend

    pol = as_policy(policy)
    out: Dict[str, Dict] = {}
    effective = override if override is not None else "auto"
    for path, leaf in tree_paths(model):
        if not isinstance(leaf, LutqState):
            continue
        lpath, nstack = logical_path(path)
        _, requested = _leaf_rule(pol, lpath)
        out["/".join(lpath)] = _record(
            leaf, resolve_backend(leaf, effective), requested, nstack)
    return out


def lutq_weight_count(leaf: LutqState) -> int:
    """Number of logical weights a LutqState covers (uint8 == 2 per byte)."""
    if leaf.w is not None:
        return leaf.w.numel()
    n = leaf.a.numel()
    if leaf.a.dtype == torch.uint8:
        n *= 2
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantized_fraction(model: nn.Module) -> float:
    """Fraction of parameters covered by LUT-Q (for reporting)."""
    q = t = 0
    for _, leaf in tree_paths(model):
        if isinstance(leaf, LutqState):
            n = lutq_weight_count(leaf)
            q += n
            t += n
        elif leaf is not None:
            t += leaf.numel()
    return q / max(t, 1)


def effective_bits(model: nn.Module) -> float:
    """Average index bits per quantized weight."""
    bits = n = 0
    for _, leaf in tree_paths(model):
        if isinstance(leaf, LutqState):
            cnt = lutq_weight_count(leaf)
            bits += cnt * max(1, math.ceil(math.log2(leaf.d.shape[-1])))
            n += cnt
    return bits / n if n else 0.0


def rule_breakdown(model: nn.Module, quant: QuantLike) -> List[Dict]:
    """Per-rule coverage/memory report over a (quantized) tree: one row
    per rule plus a trailing "unmatched" row, with the resident bytes of
    each leaf as it exists in the tree."""
    policy = as_policy(quant)
    rows = [{"rule": r.rule_name, "pattern": r.pattern,
             "index_bits": (0 if r.spec is None else r.spec.index_bits),
             "n_params": 0, "n_quantized": 0, "serve_bytes": 0}
            for r in policy.rules]
    rows.append({"rule": "(unmatched)", "pattern": "-", "index_bits": 0,
                 "n_params": 0, "n_quantized": 0, "serve_bytes": 0})
    for path, leaf in tree_paths(model):
        if leaf is None:
            continue
        i = policy.match(logical_path(path)[0])
        row = rows[i if i is not None else -1]
        if isinstance(leaf, LutqState):
            n = lutq_weight_count(leaf)
            row["n_params"] += n
            row["n_quantized"] += n
            row["serve_bytes"] += sum(_nbytes(t) for t in
                                      (leaf.d, leaf.a, leaf.sid, leaf.act)
                                      if t is not None)
        else:
            row["n_params"] += leaf.numel()
            row["serve_bytes"] += _nbytes(leaf)
    return rows


def format_breakdown(rows: List[Dict]) -> str:
    lines = [f"{'rule':24s} {'params':>12s} {'quantized':>12s} "
             f"{'bits':>5s} {'serve MiB':>10s}"]
    for r in rows:
        if r["n_params"] == 0:
            continue
        bits = str(r["index_bits"]) if r["n_quantized"] else "fp"
        lines.append(f"{r['rule']:24s} {r['n_params']:12d} "
                     f"{r['n_quantized']:12d} {bits:>5s} "
                     f"{r['serve_bytes']/2**20:10.3f}")
    return "\n".join(lines)
