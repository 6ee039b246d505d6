"""Multiply audit of multiplier-less serving (counterpart of
``repro.kernels.audit``).

The pow2 backend's claim (dictionary applied by shifts, int32
accumulation, one fp scale at the epilogue) is checked against what
runs, not against what the Python source says. The reference lowers a
jitted forward to StableHLO and parses it; the port runs eagerly, so
:func:`record` runs the function under a ``TorchDispatchMode`` that sees
every aten op, on the CPU and on CUDA. The hand-written kernels are
``ctypes`` calls the dispatcher never sees: each kernel wrapper adds a
note where it launches its kernel (:func:`note`: the kernel's name, the
dtype of its product, its operands' and output's logical dims), at the
cost of one check of :data:`RECORDER` when no audit runs.
:func:`multiply_report` classifies the op stream by element type and
shape, and :func:`audit_multiplierless` asserts the reference's three
rules:

* no floating-point dot touches a quantized weight shape (the
  decoded-weight matmul must not exist);
* no floating-point elementwise multiply is weight-shaped (no
  decoded-weight scaling either);
* at least one integer dot is present (the shift-add accumulation).

fp multiplies *are* allowed at the boundary (activation quantization,
M x Kin, and the epilogue scale, M x N) and in unquantized layers (norms,
attention, fp-by-policy embed and head), as in the reference.

The audit never passes on ops it did not see. :func:`record` raises if
it starts while a CUDA stream is capturing (the ops would run later, in
a graph), and if the kernels' launch counts
(:func:`repro_torch.kernels.ops.count_delta`) grew by more than the
launches it was told of (a replayed CUDA graph adds its launches with
no wrapper running). ``runtime.engine.Engine`` raises where it would
capture or replay a graph while an audit records: audit its steps under
``runtime.engine.disable_graphs()``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Set, Tuple)

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.lutq import LutqState
from repro_torch.nn.tree import tree_paths

FP_TYPES = ("f64", "f32", "f16", "bf16")

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.float16: "f16", torch.bfloat16: "bf16",
                torch.int64: "i64", torch.int32: "i32", torch.int16: "i16",
                torch.int8: "i8", torch.uint8: "ui8", torch.bool: "i1"}

_aten = torch.ops.aten
#: dot-shaped aten ops and the positions of their (lhs, rhs) operands
DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
        _aten.baddbmm: (1, 2), _aten.mv: (0, 1), _aten.dot: (0, 1),
        _aten._int_mm: (0, 1), _aten.convolution: (0, 1)}
#: elementwise multiplies (counted where their output is floating point)
MULTIPLIES = ("mul", "mul_", "addcmul", "addcmul_")

#: the running audit's recorder, or None: kernel wrappers call
#: :func:`note` only when it is set
RECORDER: Optional["_Recorder"] = None


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else _DTYPE_NAMES.get(dtype, str(dtype))


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (list, tuple)):
        for x in out:
            if isinstance(x, torch.Tensor):
                return x
    return None


class _Recorder(TorchDispatchMode):
    """Appends one entry a dispatched aten op to ``stream``."""

    def __init__(self):
        super().__init__()
        self.stream: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference_mode a composite op (matmul, einsum, linear)
        # reaches the mode whole: record the ops it is made of instead
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        t = _first_tensor(out)
        ops = DOTS.get(func.overloadpacket)
        self.stream.append({
            "op": func.overloadpacket.__name__, "kernel": False,
            "dtype": _dtype_name(None if t is None else t.dtype),
            "out": () if t is None else tuple(t.shape),
            "lhs": None if ops is None else tuple(args[ops[0]].shape),
            "rhs": None if ops is None else tuple(args[ops[1]].shape)})
        return out


def note(kernel: str, dtype, lhs, rhs, out) -> None:
    """Add a kernel launch to the running audit's stream: ``dtype`` is
    the dtype of the kernel's product (int32 for the shift-add kernel,
    the output's float dtype for the others), ``lhs`` / ``rhs`` / ``out``
    its operands' and output's logical dims (a weight by its (Kin, N),
    not its packed bytes; an expert stack's E C rows against one expert's
    (Kin, N), so that its flops are E C Kin N; ``lhs`` None for a kernel
    that is no product).
    Wrappers call it only while :data:`RECORDER` is set."""
    RECORDER.stream.append({
        "op": kernel, "kernel": True, "dtype": _dtype_name(dtype),
        "out": tuple(out), "lhs": None if lhs is None else tuple(lhs),
        "rhs": None if rhs is None else tuple(rhs)})


def _stream_capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def kernel_launches(delta) -> Dict[str, int]:
    """Kernel launches by note name from an ``ops.count_delta``."""
    mm, gp, sh, km, _, variants, fa, _, mme, gpe, she = delta
    return {"lutq_matmul": mm["launches"],
            "lutq_gemv_packed": gp["launches"],
            "lutq_shift": sh["launches"], "kmeans_stats": km["launches"],
            **variants, "flash_attention": fa["launches"],
            "lutq_matmul_experts": mme["launches"],
            "lutq_gemv_packed_experts": gpe["launches"],
            "lutq_shift_experts": she["launches"]}


def record(fn, *args, **kwargs) -> Tuple[object, List[dict]]:
    """Run ``fn(*args, **kwargs)`` eagerly; return (its output, the op
    stream: one entry an aten op and one a kernel launch, each with
    ``op``, ``kernel``, ``dtype`` and the ``out``, ``lhs`` and ``rhs``
    dims, the last two None but for a product).

    Raises RuntimeError when a CUDA stream is capturing, when an audit is
    already recording, and when the kernels launched more often than
    they noted."""
    global RECORDER
    from repro_torch.kernels import ops

    if RECORDER is not None:
        raise RuntimeError("audit.record: an audit is already recording")
    if _stream_capturing():
        raise RuntimeError(
            "audit.record: a CUDA stream is capturing; its ops would run "
            "later, in a graph that no audit sees")
    before = ops.read_counts()
    rec = _Recorder()
    RECORDER = rec
    try:
        with rec:
            out = fn(*args, **kwargs)
    finally:
        RECORDER = None
    noted = Counter(e["op"] for e in rec.stream if e["kernel"])
    unseen = {k: n - noted[k]
              for k, n in kernel_launches(ops.count_delta(before)).items()
              if n > noted[k]}
    if unseen:
        raise RuntimeError(
            f"audit.record: the kernels launched {unseen} more times than "
            f"the audit was told of (a replayed CUDA graph, or a launch "
            f"without a note): the audit does not pass on ops it did not "
            f"see")
    return out, rec.stream


def _flops(lhs, rhs, out) -> int:
    """sqrt(|lhs| |rhs| |out|) rounded (exact for plain and shared-batch
    matmuls, where it is a whole number)."""
    p = math.prod(lhs) * math.prod(rhs) * math.prod(out)
    r = math.isqrt(p)
    return r + (p - r * r > r)


def multiply_report(stream: Iterable[dict]) -> Dict[str, List[dict]]:
    """Classify every multiply-shaped op of a :func:`record` stream.

    Returns ``{"fp_dots": [...], "int_dots": [...], "fp_multiplies":
    [...]}``: a dot (an aten product or a kernel's note) carries ``op``,
    ``kernel``, ``dtype``, ``lhs``, ``rhs``, ``out`` and ``flops``
    (``sqrt(|lhs| |rhs| |out|)``, the reference's estimate); an fp
    multiply ``op``, ``dtype``, ``dims`` and ``elems``."""
    fp_dots, int_dots, fp_multiplies = [], [], []
    for e in stream:
        if e["lhs"] is not None:
            rec = dict(e, flops=_flops(e["lhs"], e["rhs"], e["out"]))
            (fp_dots if e["dtype"] in FP_TYPES else int_dots).append(rec)
        elif e["op"] in MULTIPLIES and not e["kernel"] \
                and e["dtype"] in FP_TYPES:
            fp_multiplies.append({"op": e["op"], "dtype": e["dtype"],
                                  "dims": e["out"],
                                  "elems": math.prod(e["out"])})
    return {"fp_dots": fp_dots, "int_dots": int_dots,
            "fp_multiplies": fp_multiplies}


def count_ops(report: Dict[str, List[dict]]) -> Dict[str, int]:
    """Scalar multiply budget of a :func:`multiply_report` (the Table 2
    quantities)."""
    return {
        "fp_dot_flops": sum(d["flops"] for d in report["fp_dots"]),
        "int_dot_flops": sum(d["flops"] for d in report["int_dots"]),
        "fp_multiply_elems": sum(m["elems"]
                                 for m in report["fp_multiplies"]),
        "n_fp_dots": len(report["fp_dots"]),
        "n_int_dots": len(report["int_dots"]),
    }


def _states(tree) -> Iterator[LutqState]:
    if isinstance(tree, LutqState):
        yield tree
    elif isinstance(tree, nn.Module):
        for _, leaf in tree_paths(tree):
            if isinstance(leaf, LutqState):
                yield leaf
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _states(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _states(v)


def quantized_weight_dims(params) -> Set[Tuple[int, ...]]:
    """Trailing-2D shapes (and transposes) of every LUT-Q leaf's
    assignment plane in a model, a LutqState or dicts and lists of them
    (an expert stack's (E, Din, Dout): each expert's (Din, Dout)):
    the shapes a multiplier-less forward must never touch with an fp dot
    or an fp weight-shaped multiply. A packed uint8 plane holds two rows
    a byte: its Kin is twice its rows."""
    shapes: Set[Tuple[int, ...]] = set()
    for st in _states(params):
        if st.a.ndim >= 2:
            kin, n = int(st.a.shape[-2]), int(st.a.shape[-1])
            if st.a.dtype == torch.uint8:
                kin *= 2
            shapes.add((kin, n))
            shapes.add((n, kin))
    return shapes


def _touches(dims_list: Iterable[Tuple[int, ...]],
             weight_shapes: Set[Tuple[int, ...]]) -> bool:
    return any(d[-2:] in weight_shapes for d in dims_list if len(d) >= 2)


def audit_multiplierless(
    fn,
    *args,
    weight_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
    params=None,
    require_int_dot: bool = True,
    **kwargs,
) -> Dict[str, List[dict]]:
    """Assert the quantized matmul path of ``fn(*args, **kwargs)``, run
    once through :func:`record`, is multiplier-less.

    ``weight_shapes`` (or ``params``, from which they are collected by
    :func:`quantized_weight_dims`) scope the claim to the quantized
    leaves: fp dots and fp weight-shaped multiplies touching those shapes
    fail the audit; boundary fp multiplies and fp-by-policy layers pass.
    Returns the :func:`multiply_report`.

    Raises ``AssertionError`` with the offending ops on failure, and
    :func:`record`'s RuntimeError where it cannot see every op.
    """
    if weight_shapes is None:
        assert params is not None, "pass weight_shapes or params"
        wset = quantized_weight_dims(params)
    else:
        wset = {tuple(s) for s in weight_shapes}
        wset |= {s[::-1] for s in wset}
    _, stream = record(fn, *args, **kwargs)
    rep = multiply_report(stream)
    bad_dots = [d for d in rep["fp_dots"]
                if _touches((d["lhs"], d["rhs"]), wset)]
    assert not bad_dots, (
        f"fp dot ops touch quantized weight shapes (decoded-weight matmul "
        f"survived): {bad_dots}")
    bad_muls = [m for m in rep["fp_multiplies"]
                if _touches((m["dims"],), wset)]
    assert not bad_muls, (
        f"fp weight-shaped multiplies present (decoded-weight scaling "
        f"survived): {bad_muls}")
    if require_int_dot:
        assert rep["int_dots"], (
            "no integer dot in the lowering — shift-add accumulation missing")
    return rep
