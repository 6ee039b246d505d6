"""Paged decode attention through the block table.

Counterpart of ``repro.kernels.paged_attn``: :func:`paged_attention_tpu`
(kernel 6) and ``_paged_attention_multipass`` (kernel 7) become the two
variants of the hand-written CUDA kernel in ``csrc/paged_attn.cu``:

``paged_attention``            the score row in shared memory;
``paged_attention_multipass``  the score row in a global f32 workspace,
                               for rows whose score row outgrows the
                               shared-memory budget.

:func:`smem_plan` is the counterpart of ``vmem_plan``: plain host
arithmetic that picks the variant from the score row's bytes against
``smem_budget_bytes`` (default :data:`DEFAULT_SMEM_BUDGET`, all that a
block can opt into on sm_90, so the workspace variant runs only for a
score row that cannot fit: full-width danube's rows, at most 64 KiB of
scores under its 4096 window, never do; ``smem_budget_bytes=0`` forces
the workspace). On a CUDA tensor
:func:`paged_attention` launches the kernel or raises; on a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.
paged_attention_ref`.

The kernel reads only the valid positions ``[max(0, len - window),
len)`` of each row: dead block entries and pages behind the window are
never read, and a row with ``len = 0`` gives 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

TRASH_PAGE = 0

#: launches of either kernel variant, and calls that ran the plain version
COUNTS = {"launches": 0, "plain": 0}
#: launches of each variant (they sum to COUNTS["launches"])
VARIANTS = {"paged_attention": 0, "paged_attention_multipass": 0}

#: dynamic shared memory a block can opt into on sm_90
MAX_SMEM = 232448
#: default shared-memory budget of the score row (bytes): the score row
#: stays in shared memory wherever the block fits, since the workspace
#: variant, which reads its scores back from L2, is slower on the same row
DEFAULT_SMEM_BUDGET = MAX_SMEM
# the kernel's block shape (csrc/paged_attn.cu): warps, most query heads
# per KV head, most head-dim columns
_WARPS, _MAX_GROUP, _MAX_DH = 8, 8, 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def score_span(nb: int, page: int, window: Optional[int] = None) -> int:
    """Width of one score row: the most valid positions a row can have."""
    return min(nb * page, window) if window else nb * page


def smem_plan(nb: int, page: int, dh: int, g: int, *,
              window: Optional[int] = None,
              budget_bytes: Optional[int] = None) -> dict:
    """Pick the kernel variant for one (batch, kv-head) row.

    The single-pass kernel holds the f32 score row (``g x span``) in
    shared memory beside its fixed scratch (the scaled queries, the
    reduction slots, pass B's warp partials and the row's ``nb``
    block-table entries). When the score row
    outgrows ``budget_bytes``, or the block would outgrow what sm_90
    allows, the plan moves the score row to a global workspace of
    ``g x span`` floats per row (``multipass``).
    """
    budget = DEFAULT_SMEM_BUDGET if budget_bytes is None else int(budget_bytes)
    span = score_span(nb, page, window)
    score_bytes = 4 * g * span
    fixed = 4 * (g * dh + _WARPS * _MAX_GROUP + _MAX_GROUP + _WARPS * g * dh
                 + nb)
    multipass = score_bytes > budget or fixed + score_bytes > MAX_SMEM
    return {"multipass": multipass, "span": span, "score_bytes": score_bytes,
            "smem_bytes": fixed + (0 if multipass else score_bytes)}


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
    plan = smem_plan(NB, page, dh, G, window=window,
                     budget_bytes=smem_budget_bytes)
    span = plan["span"]
    out = torch.empty_like(q)
    ws = (torch.empty((B, Hkv, G, span), dtype=torch.float32,
                      device=q.device) if plan["multipass"] else None)
    vec = int(k_pool.data_ptr() % 16 == 0
              and (dh * k_pool.element_size()) % 16 == 0)
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
        B, Hkv, G, dh, page, NB, int(window or 0), span, scale_q, vec,
        int(plan["multipass"]), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention: CUDA error {rc} at launch "
                           f"(B={B}, Hkv={Hkv}, G={G}, dh={dh}, page={page}, "
                           f"NB={NB}, plan={plan})")
    COUNTS["launches"] += 1
    VARIANTS["paged_attention_multipass" if plan["multipass"]
             else "paged_attention"] += 1
    return out
