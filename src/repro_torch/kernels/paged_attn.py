"""Paged decode attention through the block table.

Counterpart of ``repro.kernels.paged_attn``: :func:`paged_attention_tpu`
(kernel 6) and ``_paged_attention_multipass`` (kernel 7) become the two
variants of the hand-written CUDA kernel in ``csrc/paged_attn.cu`` (its
body in ``csrc/paged_attn.cuh``):

``paged_attention``            each split's scores in shared memory;
``paged_attention_multipass``  each split's scores in a global f32
                               workspace ``(B, Hkv, G, span)``, for
                               chunks whose scores outgrow the
                               shared-memory budget.

Each (sequence, KV head) row is split across blocks:
:func:`split_plan` picks ``nsplit`` chunks of ``chunk`` positions from
static shapes only (the block table's width, the page, the window, the
batch, the KV heads and the card's SM count: about
:data:`BLOCKS_PER_SM` blocks an SM, chunks of at least one page), never
from the lengths, so a launch reads nothing back from the card and can
be captured in a CUDA graph. :func:`split_bounds` gives the positions
each split owns. Every split computes its partial max, exponent sum and
unnormalised ``sum exp(s - m) v`` in f32; the last block of a row to
finish (an integer ticket, reset by that block) merges them in a fixed
order, so a call gives the same bits every time. :func:`smem_plan`, the counterpart of ``vmem_plan``, is plain
host arithmetic that picks the variant from a chunk's score bytes
against ``smem_budget_bytes`` (default :data:`DEFAULT_SMEM_BUDGET`, all
that a block can opt into on sm_90; ``smem_budget_bytes=0`` forces the
workspace). On a CUDA tensor :func:`paged_attention` launches the
kernel or raises; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.paged_attention_ref`.

The kernel reads only the valid positions ``[max(0, len - window),
len)`` of each row: dead block entries and pages behind the window are
never read, and a row with ``len = 0`` gives 0. It takes groups of up
to 16 query heads a KV head (mistral-large-123b's 96 over 8 is 12) and
head dims up to 128; one block reads a K/V row once for its whole
group.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import audit, build
from repro_torch.kernels.ref import paged_attention_ref

TRASH_PAGE = 0

#: launches of either kernel variant, and calls that ran the plain version
COUNTS = {"launches": 0, "plain": 0}
#: launches of each variant (they sum to COUNTS["launches"])
VARIANTS = {"paged_attention": 0, "paged_attention_multipass": 0}

#: dynamic shared memory a block can opt into on sm_90
MAX_SMEM = 232448
#: default shared-memory budget of a chunk's scores (bytes): they stay in
#: shared memory wherever the block fits, since the workspace variant,
#: which reads its scores back from L2, is slower on the same chunk
DEFAULT_SMEM_BUDGET = MAX_SMEM
#: blocks an SM that :func:`split_plan` aims for
BLOCKS_PER_SM = 2
# the kernel's block shape (csrc/paged_attn.cuh): warps, most query heads
# per KV head (kMaxGroup: one block reads a K/V row once for all of
# them), most head-dim columns, most partial dot products of a K row,
# positions of a ring stage, ring stages, most splits of a row
_WARPS, _MAX_GROUP, _MAX_DH, _MAX_PARTS = 8, 16, 128, 8
TILE, STAGES, MAX_SPLITS = 64, 4, 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: per device: the rows' merge tickets, zero between calls (the kernel's
#: last block of a row resets its ticket)
_TICKETS: dict = {}


def score_span(nb: int, page: int, window: Optional[int] = None) -> int:
    """Width of one score row: the most valid positions a row can have."""
    return min(nb * page, window) if window else nb * page


def split_plan(B: int, hkv: int, nb: int, page: int,
               window: Optional[int] = None, *, sms: int,
               per_sm: Optional[int] = None) -> dict:
    """How the kernel splits each (sequence, KV head) row across blocks,
    from static shapes only (never the lengths).

    Aim at ``per_sm`` (default :data:`BLOCKS_PER_SM`) blocks on each of
    ``sms`` SMs, at most :data:`MAX_SPLITS` splits a row, with chunks of
    at least one page; a chunk longer than a ring stage is a whole
    number of stages. Returns ``span`` (the most valid positions a row
    can have), ``chunk``, ``nsplit`` (``nsplit * chunk >= span``) and
    ``blocks`` (the grid: ``B * hkv * nsplit``).
    """
    span = score_span(nb, page, window)
    rows = B * hkv
    per_sm = BLOCKS_PER_SM if per_sm is None else int(per_sm)
    want = max(1, min(MAX_SPLITS, -(-per_sm * sms // rows)))
    chunk = max(page, -(-span // want))
    if chunk > TILE:
        chunk = -(-chunk // TILE) * TILE
    chunk = min(chunk, span)
    nsplit = -(-span // chunk)
    return {"span": span, "chunk": chunk, "nsplit": nsplit,
            "blocks": rows * nsplit}


def split_bounds(cache_len: int, nb: int, page: int,
                 window: Optional[int], chunk: int, nsplit: int) -> list:
    """The positions ``[c0, c1)`` that each split of a row with
    ``cache_len`` valid positions owns, as the kernel computes them
    (``c1 <= c0``: the split has none): split ``s`` takes ``[lo + s *
    chunk, min(hi, lo + (s + 1) * chunk))`` of the valid range ``[lo,
    hi) = [max(0, len - window), min(len, nb * page))``."""
    hi = min(cache_len, nb * page)
    lo = max(0, cache_len - window) if window else 0
    return [(lo + s * chunk, min(hi, lo + (s + 1) * chunk))
            for s in range(nsplit)]


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_plan(nb: int, page: int, dh: int, g: int, *,
              window: Optional[int] = None, chunk: Optional[int] = None,
              nsplit: int = 1, itemsize: int = 4,
              budget_bytes: Optional[int] = None) -> dict:
    """Pick the kernel variant for one split of ``chunk`` positions
    (default: the whole row, one split) of pools of ``itemsize``-byte
    elements.

    A block holds, beside a split's f32 scores (``g x chunk``): the
    scaled queries, the ring of :data:`STAGES` stages of :data:`TILE`
    K or V rows (which then takes the warp partials of the PV pass),
    the staged scales (int8 pools), the reduction slots, every split's
    max and sum for the merge (``nsplit > 1``), the split's
    block-table entries and a tile's partial scores
    (csrc/paged_attn.cuh's ``Smem``). When the scores outgrow
    ``budget_bytes``, or the block would outgrow what sm_90 allows,
    they move to a global workspace of ``g x span`` floats a row
    (``multipass``). ``ws_bytes`` is that workspace per row.
    """
    budget = DEFAULT_SMEM_BUDGET if budget_bytes is None else int(budget_bytes)
    span = score_span(nb, page, window)
    chunk = span if chunk is None else int(chunk)
    score_bytes = 4 * g * chunk
    stage = _a16(TILE * dh * itemsize)
    ring = max(STAGES * stage, _WARPS * g * dh * 4)
    nbs = min(nb, chunk // page + 2)
    pieces = max(1, dh * itemsize // 16)  # a K row's partial dot products
    per = -(-pieces // _MAX_PARTS)
    parts = -(-pieces // per)
    fixed = (_a16(4 * g * dh) + _a16(ring)
             + (STAGES * TILE * 4 if itemsize == 1 else 0)
             + _a16(4 * ((_WARPS + 2) * _MAX_GROUP + 1))
             + _a16(8 * nsplit * g if nsplit > 1 else 0) + _a16(4 * nbs)
             + _a16(4 * TILE * parts * g))
    multipass = score_bytes > budget or fixed + _a16(score_bytes) > MAX_SMEM
    return {"multipass": multipass, "span": span, "chunk": chunk,
            "score_bytes": score_bytes,
            "smem_bytes": fixed + (0 if multipass else _a16(score_bytes)),
            "ws_bytes": 4 * g * span if multipass else 0}


def launch_plan(B: int, hkv: int, nb: int, page: int, dh: int, g: int, *,
                window: Optional[int] = None, itemsize: int = 4, sms: int,
                budget_bytes: Optional[int] = None) -> dict:
    """:func:`split_plan` and :func:`smem_plan` of one launch, with the
    global scratch it needs: ``part_bytes`` of split partials (``nsplit
    > 1``: each split's ``g x dh`` sum and its ``g`` maxima and exponent
    sums, f32) and ``ws_bytes`` of score workspace (multipass), for all
    ``B x hkv`` rows."""
    split = split_plan(B, hkv, nb, page, window, sms=sms)
    plan = smem_plan(nb, page, dh, g, window=window, chunk=split["chunk"],
                     nsplit=split["nsplit"], itemsize=itemsize,
                     budget_bytes=budget_bytes)
    rows = B * hkv
    part = (4 * rows * split["nsplit"] * g * (dh + 2)
            if split["nsplit"] > 1 else 0)
    return dict(split, **dict(plan, ws_bytes=rows * plan["ws_bytes"]),
                part_bytes=part)


def live_pages(cache_len: int, page: int, nb: int,
               window: Optional[int] = None) -> int:
    """Pages holding a valid position of a row: what the CUDA kernel
    reads (0 for an empty row)."""
    if cache_len <= 0:
        return 0
    first = 0 if window is None else max(0, (cache_len - window) // page)
    last = (min(cache_len, nb * page) - 1) // page
    return max(0, last - first + 1)


def pages_read_per_step(cache_len: int, page: int, nb: int,
                        window: Optional[int] = None) -> int:
    """The reference's model of the distinct KV pages its kernel streams
    for one row's decode step (the gather oracle always reads ``nb``):
    the live span, plus the trash page once when any entry is dead. The
    CUDA kernel never reads the trash page; :func:`live_pages` counts
    what it reads."""
    if cache_len <= 0:
        return 1
    live = live_pages(cache_len, page, nb, window)
    return live + (1 if live < nb else 0)


def _check(name, t, ref):
    if t.device != ref.device:
        raise ValueError(f"paged_attention: {name} is on {t.device}, q on "
                         f"{ref.device}")
    if not t.is_contiguous():
        raise ValueError(f"paged_attention: {name} must be contiguous")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block: torch.Tensor,
                    cache_len: torch.Tensor, *, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    smem_budget_bytes: Optional[int] = None) -> torch.Tensor:
    """One-token GQA decode attention over a paged pool.

    q: (B, 1, H, dh) float32 or bfloat16; k_pool/v_pool: (P, page, Hkv,
    dh) float32, bfloat16, or int8 with bf16 scale planes ``k_scale`` /
    ``v_scale`` (P, page, Hkv); block: (B, NB) int32; cache_len: (B,)
    int32. Returns (B, 1, H, dh) in q.dtype.
    """
    B, _, H, dh = q.shape
    _, page, Hkv, _ = k_pool.shape
    NB = block.shape[1]
    if H % Hkv:
        raise ValueError(f"paged_attention: {H} query heads over {Hkv} KV "
                         f"heads")
    if (k_scale is None) != (k_pool.dtype != torch.int8) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: int8 pools come with both scale "
                         "planes, other pools with none")
    if scale is None:
        scale = dh ** -0.5
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    if q.device.type == "cpu":
        COUNTS["plain"] += 1
        return paged_attention_ref(q, k_pool, v_pool, block, cl,
                                   window=window, scale=scale,
                                   k_scale=k_scale, v_scale=v_scale)
    G = H // Hkv
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: q is on {q.device}, expected a "
                         f"CUDA tensor")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: pools must share a float32, "
                        f"bfloat16 or int8 dtype, got {k_pool.dtype} and "
                        f"{v_pool.dtype}")
    if G > _MAX_GROUP or dh > _MAX_DH:
        raise ValueError(f"paged_attention: the kernel takes up to "
                         f"{_MAX_GROUP} query heads per KV head and head "
                         f"dim {_MAX_DH}, got {G} and {dh}")
    cl = cl.to(torch.int32).contiguous()
    blk = block if block.dtype == torch.int32 else block.to(torch.int32)
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "block": blk,
               "cache_len": cl}
    if k_scale is not None:
        if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
            raise TypeError("paged_attention: scale planes must be bfloat16")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        _check(name, t, q)
    plan = launch_plan(B, Hkv, NB, page, dh, G, window=window,
                       itemsize=k_pool.element_size(),
                       sms=build.sm_count(q.device),
                       budget_bytes=smem_budget_bytes)
    span, nsplit = plan["span"], plan["nsplit"]
    out = torch.empty_like(q)
    ws = (torch.empty((B, Hkv, G, span), dtype=torch.float32,
                      device=q.device) if plan["multipass"] else None)
    part = (torch.empty(plan["part_bytes"] // 4, dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    ticket = _tickets(q.device, B * Hkv) if nsplit > 1 else None
    vec = int(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
              and (dh * k_pool.element_size()) % 16 == 0)
    svec = int(k_scale is not None and Hkv % 2 == 0
               and k_scale.data_ptr() % 4 == 0 and v_scale.data_ptr() % 4 == 0)
    # the scale in q's dtype, as jnp's ``q * scale`` takes it
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_launch(
        q.device.index, q.data_ptr(), _DTYPE_CODE[q.dtype], k_pool.data_ptr(),
        v_pool.data_ptr(), _DTYPE_CODE[k_pool.dtype],
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), blk.data_ptr(),
        cl.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ticket is None else ticket.data_ptr(), B, Hkv, G, dh, page,
        NB, int(window or 0), span, plan["chunk"], nsplit, scale_q, vec, svec,
        int(plan["multipass"]), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention: CUDA error {rc} at launch "
                           f"(B={B}, Hkv={Hkv}, G={G}, dh={dh}, page={page}, "
                           f"NB={NB}, plan={plan})")
    variant = ("paged_attention_multipass" if plan["multipass"]
               else "paged_attention")
    COUNTS["launches"] += 1
    VARIANTS[variant] += 1
    if audit.RECORDER is not None:  # q against the keys the table reaches
        audit.note(variant, q.dtype, q.shape, (B, NB * page, Hkv, dh),
                   out.shape)
    return out


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's merge tickets (int32, zero between calls), at least
    ``n`` of them. Made once and grown rarely: the kernel leaves them
    zero, so a call, or a CUDA graph replaying one, needs no reset."""
    return build.zeroed_tickets(_TICKETS, device.index, n, device)
