"""Quantization policy application over a module tree.

Counterpart of ``repro.core.policy``: :func:`quantize_tree` installs a
:class:`LutqState` on every eligible kernel, :func:`kmeans_tree` runs
the paper's step 4 on every quantized leaf under its rule,
:func:`split_trainable` / :func:`merge_trainable` separate the trained
masters from the static state, :func:`serve_view` keeps only the
dictionary and the int8 or packed 4-bit assignments,
:func:`backend_manifest` records which kernel each leaf resolves to,
:func:`draft_view` makes the coarse view that drafts for self-speculative
decoding, and the report helpers feed the serve CLI.

Leaves are resolved against the reference's *stacked* path
(:func:`repro_torch.nn.tree.logical_path`): per-layer leaves of one
stacked kernel get the same rule, their size floor is checked against
the stacked size, and manifests carry one record per stacked kernel, so
they are JSON-equal to the reference's. An expert-stacked leaf keeps
its expert axis (:func:`repro_torch.nn.tree.expert_dims`): each expert
gets its own dictionary, as each slice of the reference's vmapped
``init_state`` does.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.lutq import (LutqState, init_state, pow2_encode,
                                   update_state)
from repro_torch.core.rules import QuantLike, QuantPolicy, as_policy
from repro_torch.core.spec import QuantSpec
from repro_torch.nn.tree import (QuantKernel, clone_structure, expert_dims,
                                 logical_path, map_with_path, tree_paths)

# Parameters that never get quantized regardless of size (norm gains,
# biases, routers, ...). The paper quantizes affine/conv *weights* only.
_EXCLUDE = re.compile(
    r"(bias|scale|ln|norm|router|A_log|dt_bias|^D$|w0|^u$|mix_|conv_b|gamma|beta)"
)

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
    reference's stacked kernel does, and so does each expert of an
    expert stack (d (E, K), sid (E,)). The fp master stays as ``w``.
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
        st = init_state(leaf.detach(), spec, expert_dims(lpath))
        return st._replace(sid=torch.full(st.d.shape[:-1], rid,
                                          dtype=torch.int32,
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


def pow2_guard_bits(code: torch.Tensor, kin: int) -> int:
    """Bits the shift-add int32 accumulator needs: ``7 + span +
    ceil(log2 Kin)``, span the largest max-min nonzero exponent spread
    of the sign+exponent planes ``code`` (..., K) over their leading
    axes (|acc| <= 127 * 2^span * Kin)."""
    mag = code.to(torch.int32).abs()
    has = (mag > 0).any(-1)
    mx = mag.max(-1).values
    mn = torch.where(mag > 0, mag, torch.full_like(mag, 2**31 - 1)
                     ).min(-1).values
    span = int(torch.where(has, mx - mn, torch.zeros_like(mx)).max())
    return 7 + span + math.ceil(math.log2(max(kin, 2)))


def _pow2_encodable(d: torch.Tensor, kin: int):
    """(int8 plane, fits) for pow2 serve encoding of the dictionaries
    ``d`` (L, K) of every layer of one logical leaf ((L, E, K) for an
    expert stack).

    ``fits`` is the shift-add int32 overflow guard,
    :func:`pow2_guard_bits` <= 31, decided over all layers (and experts)
    at once as the reference decides it over a stacked leaf: either
    every slice of a logical leaf is encoded or none is.
    """
    code = pow2_encode(d)
    return code, pow2_guard_bits(code, kin) <= 31


def _pow2_planes(model: nn.Module, pol: Optional[QuantPolicy]):
    """{per-layer path: int8 plane} of every leaf whose rule asks for
    the pow2 backend on a pow2 dictionary and whose logical leaf passes
    the overflow guard."""
    groups: Dict[Tuple[str, ...], List] = defaultdict(list)
    for path, leaf in tree_paths(model):
        if isinstance(leaf, LutqState):
            groups[logical_path(path)[0]].append((path, leaf))
    planes = {}
    for lpath, items in groups.items():
        spec, requested = _leaf_rule(pol, lpath)
        a = items[0][1].a
        if (requested != "pow2" or a.dtype == torch.uint8 or spec is None
                or spec.constraint != "pow2" or a.ndim < 2):
            continue
        code, fits = _pow2_encodable(torch.stack([x.d for _, x in items]),
                                     int(a.shape[-2]))
        if fits:
            planes.update((path, code[i]) for i, (path, _) in
                          enumerate(items))
    return planes


def packs(pol: Optional[QuantPolicy], lpath, a: torch.Tensor, K: int,
          pack4: bool) -> bool:
    """Whether :func:`serve_view` packs the assignments ``a`` (of a
    dictionary of ``K`` entries) of the leaf at reference path ``lpath``
    two to a byte: a rule asking for ``packed4`` packs even without
    ``pack4``, one asking for ``fused``/``decode``/``pow2`` never (pow2
    planes carry int8 assignments); otherwise ``pack4`` does, for a rule
    of at most 4 index bits. Only int8 assignments of K <= 16 with an
    even reduction axis pack."""
    spec, requested = _leaf_rule(pol, lpath)
    packable = (a.dtype != torch.uint8 and K <= 16
                and a.ndim >= 2 and a.shape[-2] % 2 == 0)
    if requested == "packed4":
        return packable
    if requested in ("fused", "decode", "pow2"):
        return False
    pack = packable and pack4
    if pack and pol is not None:
        pack = spec is not None and spec.index_bits <= 4
    return pack


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
    even without the flag. A rule asking for ``pow2`` on a pow2
    dictionary stores it as its int8 sign+exponent plane (int8 ``d`` ==
    pow2-encoded, the twin of uint8 ``a`` == packed) with int8
    assignments, when the shift-add accumulator provably cannot
    overflow (:func:`_pow2_encodable`, decided per logical leaf);
    otherwise the float dictionary stays and the leaf resolves to fused.
    ``with_manifest=True`` also returns the ``{path: {backend,
    requested, packed, encoding, act_frozen, ...}}`` record.
    """
    from repro_torch.kernels.ops import resolve_backend
    from repro_torch.kernels.ref import pack4_kin

    pol = as_policy(policy)
    manifest: Dict[str, Dict] = {}
    planes = _pow2_planes(model, pol)

    def conv(path, leaf):
        if not isinstance(leaf, LutqState):
            return leaf
        lpath, nstack = logical_path(path)
        a = leaf.a
        if packs(pol, lpath, a, leaf.d.shape[-1], pack4):
            a = pack4_kin(a)
        out = LutqState(w=None, d=planes.get(path, leaf.d), a=a,
                        sid=leaf.sid, act=leaf.act)
        if with_manifest:
            manifest["/".join(lpath)] = _record(
                out, resolve_backend(out, "auto", sliced=True),
                _leaf_rule(pol, lpath)[1], nstack)
        return out

    tree = map_with_path(conv, clone_structure(model))
    if with_manifest:
        return tree, manifest
    return tree


def draft_view(model: nn.Module, *, draft_bits: int = 3,
               with_report: bool = False):
    """Coarse low-bit view of a serve tree for self-speculative decoding.

    Each :class:`LutqState` leaf's K entries are re-clustered into
    ``K' = 2**draft_bits`` (:func:`repro_torch.core.lutq.
    coarsen_dictionary`) and its stored indices remapped through the
    monotone fine->coarse map, packed two to a byte when K' <= 16 and
    the reduction axis is even. A pow2 sign+exponent plane is decoded to
    floats first (coarse centroids are means, so the draft leaf carries
    a float dictionary); K = 256 indices are read unsigned. Leaves with
    K <= K' and float leaves are shared with ``model`` (0 extra bytes);
    ``sid`` and ``act`` are carried through. Returns a new module tree,
    and with ``with_report=True`` also ``{path: {K, draft_K, shared,
    draft_bytes}}`` per reference (stacked) path, the bytes summed over
    the layers, as the reference reports its stacked leaves.
    """
    from repro_torch.core.lutq import coarsen_dictionary, index_of, pow2_decode
    from repro_torch.kernels.ref import pack4_kin, unpack4_kin

    k_out = 1 << int(draft_bits)
    report: Dict[str, Dict] = {}

    def conv(path, leaf):
        if not isinstance(leaf, LutqState):
            return leaf
        key = "/".join(logical_path(path)[0])
        K = leaf.d.shape[-1]
        if k_out >= K:
            report[key] = {"K": int(K), "draft_K": int(K), "shared": True,
                           "draft_bytes": 0}
            return leaf
        d = leaf.d
        if d.dtype == torch.int8:  # pow2 sign+exponent plane -> floats
            d = pow2_decode(d)
        a = leaf.a
        if a.dtype == torch.uint8:
            a = unpack4_kin(a)
        ai = index_of(a)
        dc, fmap = coarsen_dictionary(d, ai, k_out)
        ac = fmap[ai].to(torch.int8)
        if k_out <= 16 and ac.ndim >= 2 and ac.shape[-2] % 2 == 0:
            ac = pack4_kin(ac)
        rec = report.setdefault(key, {"K": int(K), "draft_K": int(k_out),
                                      "shared": False, "draft_bytes": 0})
        rec["draft_bytes"] += _nbytes(dc) + _nbytes(ac)
        return LutqState(w=None, d=dc, a=ac, sid=leaf.sid, act=leaf.act)

    tree = map_with_path(conv, clone_structure(model))
    if with_report:
        return tree, report
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
            leaf, resolve_backend(leaf, effective, sliced=True), requested,
            nstack)
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
