"""Multiplier-less edge serving: the ``serving_pow2`` preset end to end
(counterpart of the reference's ``examples/serve_edge.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_edge            # card
    PYTHONPATH=src python -m repro_torch.launch.serve_edge --device cpu

Builds a reduced model under the ``serving_pow2`` policy (fp embeddings
and readout, 4-bit pow2-constrained body on the shift-add backend,
frozen 8-bit activations), calibrates activation scales from one short
batch, then:

1. prints the per-leaf backend manifest (every body matmul should
   resolve ``pow2`` with ``act_frozen``) and the sign+exponent-plane
   storage win (``memory.pow2_layer_bits``);
2. prints the per-layer op budget: integer adds and bit-shifts instead
   of MACs, fp multiplies only at the epilogue scale
   (``memory.affine_shift_ops``);
3. records every aten op and kernel launch of a prefill and runs the
   multiply audit (``kernels/audit.py``), proving the quantized matmul
   path holds **no** floating-point multiplication: on the card its
   products are ``lutq_shift`` launches, on the CPU that kernel's plain
   version, an int32 matmul;
4. generates a few tokens and checks that the shift-add path is
   token-identical to the integer decode oracle
   (``kernel_backend="decode"``), or exits 1.

On the card the run also fails if any kernel's plain version ran. The
full-width audit is ``chip_smoke.py``'s phase 3k.

The audit rules by shape, so a float leaf with a quantized leaf's shape
fails it. Reduced deepseek-v2-lite-16b under the preset's floor (4096
elements) has one: its prefix layer's ``dkv`` (64 x 32) stays float
while the stacked ``dkv`` (2 x 64 x 32) is quantized, and the reference's
example fails the same way. ``--min-size 0`` quantizes every body leaf,
and ``--calib-len 20`` keeps the audited prompt off kv_lora's 24:

    PYTHONPATH=src python -m repro_torch.launch.serve_edge \
        --arch deepseek-v2-lite-16b --min-size 0 --calib-len 20 --device cpu
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import memory
from repro_torch.core.lutq import LutqState
from repro_torch.core.policy import lutq_weight_count
from repro_torch.core.rules import serving_pow2, with_size_floor
from repro_torch.device import resolve_device
from repro_torch.kernels import audit, ops
from repro_torch.models import api
from repro_torch.models.reduce import reduced
from repro_torch.nn.tree import logical_path, tree_paths
from repro_torch.runtime.serving import generate


def logical_leaves(view) -> Dict[str, List[LutqState]]:
    """The model's LutqState leaves by the reference's (stacked) path:
    one list of per-layer leaves a logical leaf."""
    groups: Dict[str, List[LutqState]] = {}
    for path, leaf in tree_paths(view):
        if isinstance(leaf, LutqState):
            groups.setdefault("/".join(logical_path(path)[0]), []).append(
                leaf)
    return groups


def storage_bits(view) -> Tuple[int, int]:
    """(pow2 bits, f32 bits) of the quantized leaves, one
    ``memory.pow2_layer_bits`` a logical leaf, as the reference counts a
    stacked leaf: its weights over every layer, one dictionary and one
    activation pair."""
    q_bits = dense_bits = 0
    for leaves in logical_leaves(view).values():
        n = sum(lutq_weight_count(x) for x in leaves)
        dense_bits += memory.dense_layer_bits(n)
        q_bits += memory.pow2_layer_bits(n, int(leaves[0].d.shape[-1]),
                                         act_pair=leaves[0].act is not None)
    return q_bits, dense_bits


def op_budget(view):
    """(rows of (logical path, {adds, shifts, fp_mults}) over its layers,
    their totals, the dense model's multiplies) of one token's forward,
    from ``memory.affine_shift_ops``."""
    rows, dense_mults = [], 0
    tot = {"adds": 0, "shifts": 0, "fp_mults": 0}
    for path, leaves in sorted(logical_leaves(view).items()):
        a = leaves[0].a
        if a.ndim < 2:
            continue
        kin, nout = int(a.shape[-2]), int(a.shape[-1])
        if a.dtype == torch.uint8:
            kin *= 2  # packed rows
        per = memory.affine_shift_ops(nout, kin, int(leaves[0].d.shape[-1]))
        row = {k: v * len(leaves) for k, v in per.items()}
        for k in tot:
            tot[k] += row[k]
        dense_mults += kin * nout * len(leaves)
        rows.append((path, row))
    return rows, tot, dense_mults


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=list_archs())
    ap.add_argument("--calib-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--min-size", type=int, default=None,
                    help="size floor of the preset's quantized rules "
                         "(default: the preset's own)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to serve; cuda raises when no card is found")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    policy = serving_pow2()
    if args.min_size is not None:
        policy = with_size_floor(policy, args.min_size)
    cfg = reduced(get_config(args.arch)).replace(
        quant=policy, act_bits=8, remat=False)
    rng = np.random.default_rng(0)
    calib = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(2, args.calib_len)).astype(np.int32)).to(dev)

    print(f"[edge] {cfg.name}: serving_pow2 preset on {dev.type}, "
          f"calibrating on {tuple(calib.shape)} tokens")
    start = ops.read_counts()
    sv, man = api.serve_state(cfg, seed=0, with_manifest=True,
                              calib_batch={"tokens": calib}, device=dev)

    # 1. manifest + storage ---------------------------------------------
    print("\nper-leaf backend manifest:")
    for path, rec in sorted(man.items()):
        print(f"  {path:42s} backend={rec['backend']:6s} "
              f"encoding={rec['encoding']:5s} K={rec['K']:2d} "
              f"act_frozen={rec['act_frozen']}")
    q_bits, dense_bits = storage_bits(sv)
    if q_bits:
        print(f"\nquantized-leaf storage: {q_bits/8/2**20:.3f} MiB pow2 "
              f"vs {dense_bits/8/2**20:.3f} MiB f32 "
              f"({dense_bits/q_bits:.1f}x)")

    # 2. per-layer op budget --------------------------------------------
    print("\nper-layer multiply/shift/add budget (one token):")
    rows, tot, dense_mults = op_budget(sv)
    for path, row in rows:
        print(f"  {path:42s} adds={row['adds']:>10d} "
              f"shifts={row['shifts']:>7d} fp_mults={row['fp_mults']:>7d}")
    print(f"  {'(total)':42s} adds={tot['adds']:>10d} "
          f"shifts={tot['shifts']:>7d} fp_mults={tot['fp_mults']:>7d}")
    if tot["fp_mults"]:
        print(f"  fp multiplies: {dense_mults} dense -> {tot['fp_mults']} "
              f"epilogue-only ({dense_mults/tot['fp_mults']:.0f}x fewer)")

    # 3. multiply audit of every op a prefill runs ----------------------
    toks = calib[:1]
    with torch.inference_mode():
        report = audit.audit_multiplierless(
            lambda p, t: api.prefill(p, cfg, {"tokens": t})[0],
            sv, toks, params=sv)
    counts = audit.count_ops(report)
    launched = sum(d["kernel"] for d in report["int_dots"])
    print(f"\nmultiply audit of prefill (every aten op and kernel launch): "
          f"PASS ({counts['n_int_dots']} integer dots, {launched} of them "
          f"lutq_shift launches, 0 fp ops on quantized weight shapes, "
          f"{counts['n_fp_dots']} fp dots and "
          f"{counts['fp_multiply_elems']} fp multiply elems outside them: "
          f"epilogue scales, norms, attention, fp-by-policy layers)")

    # 4. shift-add vs integer-oracle token parity -----------------------
    batch = {"tokens": toks}
    ys_auto = generate(sv, cfg.replace(kernel_backend="auto"), batch,
                       steps=args.gen, device=dev)
    ys_ref = generate(sv, cfg.replace(kernel_backend="decode"), batch,
                      steps=args.gen, device=dev)
    same = torch.equal(ys_auto, ys_ref)
    print(f"generate({args.gen} tokens) shift-add vs decode oracle: "
          f"{'token-identical' if same else 'MISMATCH'}")
    delta = ops.count_delta(start)
    plain = sum(c.get("plain", 0) for c in delta)
    print(f"lutq_shift launches "
          f"{audit.kernel_launches(delta)['lutq_shift']}, kernel plain "
          f"versions run {plain}")
    if dev.type == "cuda" and plain:
        print("a kernel's plain version ran on the card", file=sys.stderr)
        return 1
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
