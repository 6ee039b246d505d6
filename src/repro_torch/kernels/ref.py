"""Plain PyTorch versions of the kernels, the 4-bit packing layout and
the pow2 shift-add dictionary.

``lutq_matmul_ref``, ``lutq_gemv_packed_ref``, ``lutq_shift_ref``,
their expert-stacked forms (``*_experts_ref``: one product an expert,
each through the plain version above), ``kmeans_stats_ref``,
``paged_attention_ref`` and ``flash_attention_ref`` are what the kernel
wrappers run for a tensor on the CPU, and what the kernels are held
against on the card; ``lutq_shift_planes_ref`` emulates the shift-add
kernel's digit-plane arithmetic beside its plain version,
``flash_attention_exp2_ref`` the base-2 softmax order of the bf16
flash-attention kernel on tensor cores, and ``kmeans_stats_order_ref``
the k-means kernel's f32 summation order (tests only). Like the TPU
kernels the float GEMMs cast each decoded weight to ``x.dtype`` before
the product and accumulate in float32: the matmul runs on float32
copies of the operands, which holds every bf16 value exactly (``jnp``'s
``x @ w`` in the reference oracle rounds a bf16 product to bf16
instead).
"""
from __future__ import annotations

import torch

from repro_torch.core.lutq import (POW2_MIN_EXP, _bucketize, decode,
                                   exact_exp2, index_of)


def lutq_matmul_ref(x: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """y = x @ d[a] in float32. x: (M, Kin); a: (Kin, N) int8; d: (K,).

    A one-row product runs as two equal rows: BLAS takes another path
    for one row (a GEMV) than for several, and its sums then differ in
    the last bits from the same row inside a larger product. With this,
    each row of a product of up to 64 rows at the reduced shapes is the
    bits it has alone (``tests/test_torch_speculative.py``), which the
    speculative verify window relies on."""
    w = decode(d, a).to(x.dtype).float()
    xf = x.float()
    if xf.shape[0] == 1:
        return torch.matmul(xf.repeat(2, 1), w)[:1]
    return torch.matmul(xf, w)


def pack4_kin(a: torch.Tensor) -> torch.Tensor:
    """Pack two 4-bit indices per byte along axis -2 (the reduction axis).

    Row 2i goes in the low nibble and row 2i+1 in the high nibble; the
    serve-time convention is uint8 dtype == packed, int8 == raw indices.
    """
    assert a.shape[-2] % 2 == 0, a.shape
    lo = a[..., 0::2, :].to(torch.uint8) & 0xF
    hi = a[..., 1::2, :].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack4_kin(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4_kin`: uint8 pairs -> int8 indices."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    out = torch.stack([lo, hi], dim=-2)  # (..., Kin/2, 2, N)
    return out.reshape(*p.shape[:-2], p.shape[-2] * 2, p.shape[-1])


def lutq_gemv_packed_ref(x: torch.Tensor, packed: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """y = x @ d[unpack(packed)] in float32. packed: (Kin/2, N) uint8."""
    return lutq_matmul_ref(x, unpack4_kin(packed), d)


def _pow2_min_mag(code: torch.Tensor, keepdim: bool):
    """(|code| as int32, smallest nonzero |code| over the last axis, 1
    where a dictionary has no nonzero entry)."""
    mag = code.to(torch.int32).abs()
    big = torch.where(mag > 0, mag, torch.full_like(mag, 2**31 - 1))
    minm = torch.where((mag > 0).any(-1, keepdim=keepdim),
                       big.min(-1, keepdim=keepdim).values,
                       torch.ones((), dtype=torch.int32, device=code.device))
    return mag, minm


def pow2_shift_weights(code: torch.Tensor) -> torch.Tensor:
    """Shifted-integer dictionary of the shift-add path.

    ``code`` is an int8 sign+exponent plane
    (:func:`repro_torch.core.lutq.pow2_encode`) of shape (..., K).
    Returns int32 ``sign * (1 << (|code| - minm))`` per entry (0 stays
    0), where ``minm`` is the smallest nonzero magnitude over the last
    axis: every entry becomes an integer left shift relative to the
    smallest exponent. The matching epilogue scale is
    :func:`pow2_shift_scale`.
    """
    mag, minm = _pow2_min_mag(code, keepdim=True)
    shift = torch.where(mag > 0, mag - minm, torch.zeros_like(mag))
    return torch.sign(code.to(torch.int32)) * (torch.ones_like(shift) << shift)


def pow2_shift_scale(code: torch.Tensor) -> torch.Tensor:
    """float32 epilogue scale matching :func:`pow2_shift_weights`:
    ``2^(minm - 1 + POW2_MIN_EXP)`` per dictionary (shape
    ``code.shape[:-1]``), the one float multiply of the whole matmul."""
    _, minm = _pow2_min_mag(code, keepdim=False)
    return exact_exp2(minm - 1 + POW2_MIN_EXP)


def lutq_shift_ref(xq: torch.Tensor, a: torch.Tensor, wsh: torch.Tensor
                   ) -> torch.Tensor:
    """Integer decode oracle of the shift-add kernel: the exact int32
    accumulator ``xq @ wsh[a]``.

    xq: (M, Kin) int8; a: (Kin, N) int8 assignments (read as unsigned
    bytes, as the reference's ``jnp.take`` wraps negative indices);
    wsh: (K,) int32 (:func:`pow2_shift_weights`). On the CPU the product
    is an int32 ``torch.matmul`` of int32 operands, as the reference's
    int32 ``dot_general``: the serve-time guard (``7 + span +
    ceil(log2 Kin) <= 31``) keeps every partial sum inside int32, so the
    sum is exact in any order, and no floating-point product touches the
    decoded weight (``kernels/audit.py``). PyTorch has no integer matmul
    on CUDA, so there the product runs on float64 copies: every product
    and partial sum is an integer below 2^53, which gives the same bits,
    but the multiply audit reports that product as a floating-point dot
    on the weight's shape; the card's multiplier-less path is the
    kernel.
    """
    w = wsh[index_of(a)]
    if xq.device.type == "cpu":
        return torch.matmul(xq.to(torch.int32), w.to(torch.int32))
    return torch.matmul(xq.to(torch.float64), w.to(torch.float64)).to(
        torch.int32)


#: bits of one digit plane of the shift-add kernel (base 2^7: s8 digits)
SHIFT_DIGIT_BITS = 7


def shift_planes(wsh: torch.Tensor) -> int:
    """Digit planes of base 2^7 the shift-add kernel takes for ``wsh``:
    ceil(bit length of max |wsh| / 7), at least 1 (a pow2 dictionary of
    span s: s // 7 + 1). A host read: the caller derives it once a
    dictionary."""
    big = int(wsh.to(torch.int64).abs().max())
    return max(1, -(-big.bit_length() // SHIFT_DIGIT_BITS))


def shift_digits(wsh: torch.Tensor, planes: int) -> torch.Tensor:
    """(planes, K) int8 digit planes of ``wsh``, sign-magnitude in base
    2^7: plane p holds sign(v) * ((|v| >> 7p) & 127), so that
    ``wsh = sum_p digit_p << 7p`` and every digit fits s8."""
    v = wsh.to(torch.int64)
    shifts = SHIFT_DIGIT_BITS * torch.arange(planes, device=wsh.device)
    mag = (v.abs()[None, :] >> shifts[:, None]) & 127
    return (torch.sign(v)[None, :] * mag).to(torch.int8)


def lutq_shift_planes_ref(xq: torch.Tensor, a: torch.Tensor,
                          wsh: torch.Tensor, planes: int = None
                          ) -> torch.Tensor:
    """The shift-add kernel's arithmetic in plain torch: one s8 x s8 ->
    s32 product a digit plane (:func:`shift_digits`), combined by
    Horner from the highest plane down, ``acc = (acc << 7) + plane``,
    modulo 2^32 as the kernel's unsigned shifts and adds are. Equals
    :func:`lutq_shift_ref` bit for bit for every dictionary the
    serve-time guard admits; no plane's sum leaves int32 (asserted)."""
    planes = shift_planes(wsh) if planes is None else planes
    idx = index_of(a)
    x = xq.to(torch.float64)
    acc = torch.zeros((xq.shape[0], a.shape[1]), dtype=torch.int64,
                      device=xq.device)
    for dig in shift_digits(wsh, planes).flip(0):  # the highest first
        part = torch.matmul(x, dig[idx].to(torch.float64)).to(torch.int64)
        assert bool((part.abs() < 2**31).all()), "a plane's sum overflows"
        acc = ((acc << SHIFT_DIGIT_BITS) + part) & 0xFFFFFFFF
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def _per_expert(fn, x, a, d):
    return torch.stack([fn(x[e], a[e], d[e]) for e in range(x.shape[0])])


def lutq_matmul_experts_ref(x: torch.Tensor, a: torch.Tensor,
                            d: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ d[e][a[e]] in float32 for every expert e. x (E, C,
    Kin); a (E, Kin, N) int8; d (E, K); y (E, C, N)."""
    return _per_expert(lutq_matmul_ref, x, a, d)


def lutq_gemv_packed_experts_ref(x: torch.Tensor, packed: torch.Tensor,
                                 d: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ d[e][unpack(packed[e])] in float32. packed (E,
    Kin/2, N) uint8."""
    return _per_expert(lutq_gemv_packed_ref, x, packed, d)


def lutq_shift_experts_ref(xq: torch.Tensor, a: torch.Tensor,
                           wsh: torch.Tensor) -> torch.Tensor:
    """acc[e] = xq[e] @ wsh[e][a[e]], int32, for every expert e. xq (E,
    C, Kin) int8; a (E, Kin, N) int8; wsh (E, K) int32."""
    return _per_expert(lutq_shift_ref, xq, a, wsh)


def kmeans_stats_ref(w: torch.Tensor, d: torch.Tensor, write_a: bool = True):
    """One assignment pass over flat w against sorted d.

    Returns (assignments int8 (N,), sums (K,) f32, counts (K,) f32):
    each weight's nearest entry (ties to the lower one), then the sum
    and number of the weights assigned to each entry. Indices >= 128 of
    a K=256 dictionary wrap to negative int8, as the reference's
    ``astype(int8)`` does. Counts are exact integers rounded to f32
    once; sums accumulate in float64 and round to f32 once, so the plain
    version is the accurate side of a comparison (an f32 ``index_add_``
    over millions of weights drifts by ~1e-4 of the sum). With
    ``write_a=False`` the assignments are None, as the kernel then
    writes none.
    """
    idx = _bucketize(w, d)
    K = d.shape[0]
    sums = torch.zeros(K, dtype=torch.float64, device=w.device)
    sums.index_add_(0, idx, w.double())
    counts = torch.bincount(idx, minlength=K).float()
    return idx.to(torch.int8) if write_a else None, sums.float(), counts


def kmeans_thread_elements(plan: dict) -> torch.Tensor:
    """(blocks, threads, S) int64: the elements each thread of the
    ``kmeans_stats`` kernel takes under ``plan``
    (:func:`repro_torch.kernels.kmeans_stats.plan`), in the order it adds
    them, -1 where it has none: its float4 vectors t, t + threads, ...
    of its block's range, four elements each, then block 0's threads
    0 .. head + tail - 1 one head or tail element each."""
    T, B, chunk = plan["threads"], plan["blocks"], plan["chunk"]
    head, nvec, tail = plan["head"], plan["nvec"], plan["tail"]
    b = torch.arange(B)[:, None, None]
    v = (b * chunk + torch.arange(T)[None, :, None]
         + torch.arange(-(-chunk // T))[None, None, :] * T)
    ok = v < torch.clamp((b + 1) * chunk, max=nvec)
    e = head + 4 * v[..., None] + torch.arange(4)
    e = torch.where(ok[..., None], e, -1).reshape(B, T, -1)
    extra = torch.full((B, T, 1), -1, dtype=torch.int64)
    tt = torch.arange(head + tail)
    extra[0, : head + tail, 0] = torch.where(tt < head, tt,
                                             4 * nvec + tt)
    return torch.cat([e, extra], dim=2)


def kmeans_stats_order_ref(w: torch.Tensor, d: torch.Tensor, plan: dict):
    """The ``kmeans_stats`` kernel's f32 summation order in plain torch
    (CPU, tests only), under ``plan``. Each thread adds its weights into
    its private (sum, count) column of their entry in the order it takes
    them (:func:`kmeans_thread_elements`); a block folds its columns, lane
    l of an entry adding columns l, l + lanes, ... in turn, then the lanes
    by an adjacent-pairs tree (the kernel's xor-shuffle butterfly); the
    last block adds the partial rows in block order, slice s of
    ceil(blocks / slices) rows at a time, then the slices by a halving
    tree. Counts are exact. Returns what :func:`kmeans_stats_ref` does,
    with the kernel's sums."""
    w = w.reshape(-1).float()
    K = d.shape[0]
    idx = _bucketize(w, d)
    E = kmeans_thread_elements(plan)
    B, T, _ = E.shape
    cols = torch.zeros(B, T, K)
    cnt = torch.zeros(B, T, K, dtype=torch.int64)
    for s in range(E.shape[2]):
        e = E[:, :, s]
        ok = e >= 0
        ec = e.clamp(min=0)
        hot = torch.nn.functional.one_hot(idx[ec], K).bool() & ok[..., None]
        cols = torch.where(hot, cols + w[ec][..., None], cols)
        cnt += hot
    L = plan["lanes"]
    v = cols.view(B, T // L, L, K)
    part = torch.zeros(B, L, K)
    for m in range(T // L):
        part = part + v[:, m]
    while part.shape[1] > 1:
        part = part[:, 0::2] + part[:, 1::2]
    rows = part[:, 0]
    S = plan["slices"]
    rps = -(-B // S)
    acc = torch.zeros(S, K)
    for r in range(rps):
        rr = torch.arange(S) * rps + r
        acc = torch.where((rr < B)[:, None],
                          acc + rows[rr.clamp(max=B - 1)], acc)
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return idx.to(torch.int8), acc[0], cnt.sum((0, 1)).float()


def paged_attention_ref(q, k_pool, v_pool, block, cache_len, *, window=None,
                        scale=None, k_scale=None, v_scale=None):
    """Paged decode attention as the reference's gather oracle computes
    it (``repro.kernels.ops.paged_attention_reference``): gather each
    row through the block table, dequantize int8 pages once as a bf16
    product, then :func:`repro_torch.nn.attention.decode_attention`.
    Positions past ``cache_len`` read whatever their pages hold and are
    masked; a row with ``cache_len = 0`` averages its gathered row (0
    when it points at a zero trash page)."""
    from repro_torch.nn.attention import decode_attention, gather_pages

    kc = gather_pages(k_pool, block)
    vc = gather_pages(v_pool, block)
    if k_scale is not None:
        kc = kc.to(torch.bfloat16) * gather_pages(k_scale, block)[..., None]
        vc = vc.to(torch.bfloat16) * gather_pages(v_scale, block)[..., None]
    return decode_attention(q, kc, vc, cache_len, window=window, scale=scale)


FLASH_NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, scale=None, bq=128, bk=128):
    """Blocked online-softmax attention as the reference's
    ``repro.kernels.flash_attn._kernel`` computes it, block by block.

    q: (BH, S, D); k, v: (BH, Skv, D), all float32 or all bfloat16.
    For each q block i and kv block j (kv innermost): scores ``q @ k^T``
    in float32 times ``scale``; under ``causal`` the scores where
    ``i*bq + r < j*bk + c`` become -1e30 (no offset when ``Skv != S``)
    and the kv blocks with ``j*bk >= (i+1)*bq`` are skipped, never read;
    the running max, ``p = exp(s - m_new)``, ``alpha = exp(m_prev -
    m_new)``, ``l = l*alpha + sum(p)`` and ``acc = acc*alpha + p.to(v's
    dtype) @ v`` in float32; the output is ``acc / max(l, 1e-30)`` in
    q's dtype. Products run on float32 copies (every bf16 product is
    exact in float32). The caller checks shapes and block sizes.
    """
    return _flash_blocks(q, k, v, causal, scale, bq, bk, exp2=False)


def flash_attention_exp2_ref(q, k, v, *, causal=True, scale=None, bq=128,
                             bk=128):
    """:func:`flash_attention_ref` in the arithmetic order of the bf16
    kernel on tensor cores (``flash_wgmma``), for tests: the running max
    ``m`` over the raw scores ``q @ k^T`` (masked ones -inf),
    ``p = 2^(fma(s, c, -m*c))`` with ``c = scale * log2(e)`` in float32
    (the fused multiply-add emulated in float64, rounded once) and
    ``alpha = 2^(m_prev*c - m*c)``; ``m*c`` is 0 for a row with no score
    yet. Since ``scale > 0`` the max moves where the reference's moves.
    """
    return _flash_blocks(q, k, v, causal, scale, bq, bk, exp2=True)


def _flash_blocks(q, k, v, causal, scale, bq, bk, *, exp2):
    BH, S, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    bq, bk = min(bq, S), min(bk, Skv)
    dev = q.device
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    masked = float("-inf") if exp2 else FLASH_NEG_INF
    out = torch.empty_like(q)
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq].float()
        q_pos = i * bq + torch.arange(bq, device=dev)
        m = torch.full((BH, bq, 1), masked, device=dev)
        l = torch.zeros((BH, bq, 1), device=dev)
        acc = torch.zeros((BH, bq, D), device=dev)
        for j in range(Skv // bk):
            if causal and j * bk >= (i + 1) * bq:
                continue  # strictly above the diagonal: never read
            kj = k[:, j * bk:(j + 1) * bk].float()
            vj = v[:, j * bk:(j + 1) * bk]
            s = torch.matmul(qi, kj.transpose(1, 2))
            if not exp2:
                s = s * scale
            if causal:
                k_pos = j * bk + torch.arange(bk, device=dev)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                torch.full_like(s, masked))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            if exp2:
                cd = c.to(dev)
                ms = torch.where(m_new == float("-inf"),
                                 torch.zeros_like(m_new), m_new * cd)
                p = torch.exp2((s.double() * cd.double() - ms.double())
                               .float())
                alpha = torch.exp2(m * cd - ms)
            else:
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(vj.dtype).float(),
                                             vj.float())
            m = m_new
        out[:, i * bq:(i + 1) * bq] = (acc / torch.clamp(l, min=1e-30)
                                       ).to(q.dtype)
    return out
