"""Quantization specifications for LUT-Q (copy of ``repro.core.spec``).

A ``QuantSpec`` describes how one weight tensor is quantized:
dictionary size, constraint family (free / pow2 / binary / ternary),
optional pruning fraction and the number of k-means refresh iterations
run after every optimizer step (paper Table 1, step 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Configuration of LUT-Q for a single tensor (or a family of tensors).

    Attributes:
      bits: dictionary address width; K = 2**bits entries.
      constraint: 'none' (free dictionary, paper's plain LUT-Q),
        'pow2' (entries are ±2^b, b integer — multiplier-less),
        'binary' ({-1,+1}, fixed), 'ternary' ({-1,0,+1}, fixed).
      prune_frac: fraction of weights pinned to a zero dictionary entry
        (0.0 disables pruning). Implies one dictionary slot is fixed at 0.
      kmeans_iters: M in the paper — k-means iterations per minibatch.
      min_size: tensors with fewer elements are left unquantized
        (biases, norm gains; the paper quantizes affine/conv weights).
      backend: serving kernel backend for tensors under this spec
        ('auto' | 'decode' | 'fused' | 'packed4' | 'pow2', see
        kernels/ops.py). 'auto' resolves structurally per leaf; explicit
        choices degrade gracefully where a kernel cannot apply.
      act_bits: activation quantization width at this tensor's matmul
        boundary (32 = full precision). Part of the quantization
        *regime*: the layer contract (``nn/linear.dot_kernel``) applies
        it at the kernel boundary instead of models hand-placing
        ``fake_quant`` calls.
      act_frozen: freeze the activation scale from a calibration batch
        (``core/actquant.capture_act_scales`` →
        ``actquant.apply_act_scales``) instead of recomputing the max-abs
        scale per call. Required for deployment and for the integer
        ``pow2`` kernel path under K-sharded SPMD.
    """

    bits: int = 4
    constraint: str = "none"
    prune_frac: float = 0.0
    kmeans_iters: int = 1
    min_size: int = 4096
    # For fixed dictionaries: learn a per-tensor scale alpha so the
    # effective values are alpha * {-1[,0],1} (TWN's {-a,0,a}; BWN's
    # scaled binary). False = literal {-1[,0],1} (BinaryConnect).
    fixed_scale: bool = False
    backend: str = "auto"
    act_bits: int = 32
    act_frozen: bool = False

    def __post_init__(self):
        if self.constraint not in ("none", "pow2", "binary", "ternary"):
            raise ValueError(f"unknown constraint {self.constraint!r}")
        if self.backend not in ("auto", "decode", "fused", "packed4", "pow2"):
            raise ValueError(f"unknown kernel backend {self.backend!r}")
        if self.backend == "pow2" and self.constraint != "pow2":
            raise ValueError("backend='pow2' requires constraint='pow2' "
                             "(the shift-add kernel needs ±2^k entries)")
        if not (1 <= self.act_bits <= 32):
            raise ValueError("act_bits must be in [1, 32]")
        if self.constraint == "binary" and self.bits != 1:
            raise ValueError("binary constraint requires bits=1")
        if self.constraint == "ternary" and self.bits != 2:
            raise ValueError("ternary constraint requires bits=2")
        if not (0.0 <= self.prune_frac < 1.0):
            raise ValueError("prune_frac must be in [0, 1)")
        if self.bits < 1 or self.bits > 8:
            raise ValueError("bits must be in [1, 8] (K <= 256, int8 assignments)")

    @property
    def K(self) -> int:
        if self.constraint == "ternary":
            return 3
        return 2 ** self.bits

    @property
    def fixed_dictionary(self) -> bool:
        return self.constraint in ("binary", "ternary")

    @property
    def index_bits(self) -> int:
        """Bits per stored assignment: ceil(log2 K)."""
        return max(1, math.ceil(math.log2(self.K)))


def spec_to_dict(spec: QuantSpec) -> dict:
    """JSON-serializable form (QuantPolicy / checkpoint manifests)."""
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> QuantSpec:
    known = {f.name for f in dataclasses.fields(QuantSpec)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown QuantSpec fields {sorted(unknown)}")
    return QuantSpec(**d)


# Common presets used throughout the experiments / configs.
LUTQ_4BIT = QuantSpec(bits=4)
LUTQ_2BIT = QuantSpec(bits=2)
LUTQ_4BIT_POW2 = QuantSpec(bits=4, constraint="pow2")
LUTQ_2BIT_POW2 = QuantSpec(bits=2, constraint="pow2")
# Multiplier-less serving regime: pow2 dictionary served as sign+exponent
# planes through the shift-add kernel, int8 activations at frozen scales.
SERVING_POW2 = QuantSpec(bits=4, constraint="pow2", backend="pow2",
                         act_bits=8, act_frozen=True)
BINARY = QuantSpec(bits=1, constraint="binary")
TERNARY = QuantSpec(bits=2, constraint="ternary")
TERNARY_SCALED = QuantSpec(bits=2, constraint="ternary", fixed_scale=True)
