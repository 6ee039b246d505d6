"""Analytic memory/compute accounting (paper section 1 formulas).

The port's own copy of ``repro.core.memory`` (plain arithmetic; its
``policy_footprint`` resolves rules through ``repro_torch.core.rules``).

Storage of one LUT-Q layer with N weights and K dictionary entries:
    bits = K * B_float + N * ceil(log2 K)
vs. N * B_float unquantized. Multiplications per affine output neuron
drop from I to K (group-by-entry summation).

These functions drive the Table 2 reproduction (ResNet-50 @ 2-bit
weights + 8-bit activations = 7.4 MB vs 97.5 MB full precision).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple


def lutq_layer_bits(n_params: int, K: int, b_float: int = 32) -> int:
    """Storage bits for one LUT-Q quantized tensor."""
    return K * b_float + n_params * max(1, math.ceil(math.log2(K)))


def dense_layer_bits(n_params: int, b_float: int = 32) -> int:
    return n_params * b_float


def pow2_layer_bits(n_params: int, K: int, *, act_pair: bool = True) -> int:
    """Storage bits for one pow2-encoded LUT-Q tensor (serving_pow2).

    The dictionary ships as an int8 sign+exponent plane (8 bits/entry
    instead of ``b_float``); indices are unchanged. ``act_pair`` adds the
    frozen per-leaf activation ``[scale, qmax]`` f32 pair.
    """
    bits = K * 8 + n_params * max(1, math.ceil(math.log2(K)))
    if act_pair:
        bits += 2 * 32
    return bits


def affine_shift_ops(out_features: int, in_features: int,
                     K: int | None = None) -> Dict[str, int]:
    """Multiplier-less op budget for one affine layer forward.

    Group-by-entry summation costs O*I integer adds; applying the pow2
    dictionary is O*K bit-shifts (exponent adds) instead of O*K
    multiplications; the only fp multiplies left are the epilogue scale —
    one per output neuron. ``K=None`` is the dense baseline (all MACs).
    """
    if K is None:
        return {"adds": out_features * in_features,
                "shifts": 0, "fp_mults": out_features * in_features}
    return {"adds": out_features * in_features,
            "shifts": out_features * K, "fp_mults": out_features}


def conv_shift_ops(out_ch: int, in_ch: int, kh: int, kw: int, oh: int,
                   ow: int, K: int | None = None) -> Dict[str, int]:
    """Conv analogue of :func:`affine_shift_ops` (per example)."""
    pix = oh * ow * out_ch
    taps = in_ch * kh * kw
    if K is None:
        return {"adds": pix * taps, "shifts": 0, "fp_mults": pix * taps}
    return {"adds": pix * taps, "shifts": pix * K, "fp_mults": pix}


def affine_mults(out_features: int, in_features: int, K: int | None = None) -> int:
    """Multiplications for one affine layer forward (per example).

    Standard: O*I. LUT-Q: O*K (sum inputs per dictionary entry first,
    then K multiplications per output neuron).
    """
    if K is None:
        return out_features * in_features
    return out_features * K


def conv_mults(
    out_ch: int, in_ch: int, kh: int, kw: int, oh: int, ow: int, K: int | None = None
) -> int:
    """Multiplications for a conv layer forward (per example).

    Standard: oh*ow*out_ch*(in_ch*kh*kw). LUT-Q: each output pixel+channel
    needs only K multiplications after grouping taps by dictionary entry.
    """
    if K is None:
        return oh * ow * out_ch * in_ch * kh * kw
    return oh * ow * out_ch * K


def footprint_mb(
    layer_sizes: Iterable[Tuple[str, int]],
    *,
    weight_bits: int | None,
    K: int | None,
    act_elems: int = 0,
    act_bits: int = 32,
    b_float: int = 32,
    quantize_all: bool = True,
) -> float:
    """Total footprint in MB (10^6 bytes? No — paper uses MiB-as-MB; we use MiB).

    layer_sizes: (name, n_params) of every affine/conv weight tensor.
    weight_bits/K: None -> full precision; else LUT-Q with K entries.
    act_elems: peak activation working-set elements (inference, batch 1).
    """
    bits = 0
    for _, n in layer_sizes:
        if K is None or not quantize_all:
            bits += dense_layer_bits(n, b_float)
        else:
            bits += lutq_layer_bits(n, K, b_float)
    bits += act_elems * act_bits
    return bits / 8 / 2**20


def policy_footprint(
    layer_sizes: Iterable[Tuple[str, int]],
    policy,
    *,
    b_float: int = 32,
) -> Dict[str, Dict]:
    """Per-rule storage breakdown under a QuantPolicy (analytic).

    layer_sizes: (name, n_params) pairs; names are treated as
    pytree-style paths (split on '/') for rule matching. Returns
    {rule_name: {n_params, n_tensors, bits_per_weight, mib}} plus an
    '(unmatched)' row for tensors no rule claims (stored full-precision)
    and a '(total)' row.
    """
    from repro_torch.core.rules import as_policy

    pol = as_policy(policy)
    rows: Dict[str, Dict] = {}

    def row(name, bits_per_weight):
        return rows.setdefault(name, {"n_params": 0, "n_tensors": 0,
                                      "bits_per_weight": bits_per_weight,
                                      "bits": 0})

    for name, n in layer_sizes:
        path = tuple(name.split("/"))
        i, spec = pol.resolve(path, size=n)
        if spec is None:
            if i is None:
                label = "(unmatched)"
            elif pol.rules[i].spec is not None:
                # claimed by a spec rule but under its size floor: keep
                # these fp leaves in their own row so each row's
                # bits_per_weight stays homogeneous
                label = f"{pol.rules[i].rule_name} (fp<floor)"
            else:
                label = pol.rules[i].rule_name
            r = row(label, b_float)
            r["bits"] += dense_layer_bits(n, b_float)
        else:
            r = row(pol.rules[i].rule_name, spec.index_bits)
            r["bits"] += lutq_layer_bits(n, spec.K, b_float)
        r["n_params"] += n
        r["n_tensors"] += 1

    total = {"n_params": sum(r["n_params"] for r in rows.values()),
             "n_tensors": sum(r["n_tensors"] for r in rows.values()),
             "bits_per_weight": None,
             "bits": sum(r["bits"] for r in rows.values())}
    rows["(total)"] = total
    for r in rows.values():
        r["mib"] = r["bits"] / 8 / 2**20
    return rows
