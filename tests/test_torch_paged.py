"""Port parity, paged KV: attention through the block table, the host
bookkeeping, and the paged model functions, against the JAX package.

The same numpy inputs go through both packages; pools and weights cross
with ``interop``. Every pool pins its trash page 0 to zeros, as the JAX
tests do (the engine never writes live data there).

Tolerances:
  * ``ops.paged_attention`` (plain version, f32 queries) against
    ``paged_attention_reference`` and the Pallas kernel in interpret
    mode: 1e-5 of max|reference| (f32 sums in another order).
  * ``PagedKV``: rows, refcounts, hits and stats equal.
  * paged decode step: logits within 1e-4 of max|logits| (the tolerance
    of ``test_torch_slice.py``); the scattered int8 pages bit-exact and
    their bf16 scales equal; f32 pages within 1e-5 of max|page|.
  * prefill chunk, splice and hydrate: workspaces within 1e-5 of their
    largest entry; int8 pages bit-exact, scales equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, cfg_pair, jax_quantized, one_thread,
                                to_np)

from repro.core.policy import serve_view as j_serve_view
from repro.kernels import ops as j_ops
from repro.kernels.paged_attn import pages_read_per_step as j_pages_read
from repro.kernels.paged_attn import paged_attention_tpu
from repro.models import api as japi
from repro.models import lm as j_lm
from repro.runtime import paged_kv as j_paged_kv
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_attn
from repro_torch.models import api as tapi
from repro_torch.models import lm as t_lm
from repro_torch.runtime import paged_kv as t_paged_kv


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _attn_case(seed, page, g, pool, B=5, nb=3, hkv=1, dh=16):
    """numpy operands: ragged lengths (one token, a page edge, a full
    row), distinct live pages, dead entries on the zero trash page."""
    rng = np.random.RandomState(seed)
    P = 1 + B * nb
    if pool == "int8":
        kp = rng.randint(-127, 128, (P, page, hkv, dh)).astype(np.int8)
        vp = rng.randint(-127, 128, (P, page, hkv, dh)).astype(np.int8)
        ks = (np.abs(rng.randn(P, page, hkv)) * 0.05).astype(np.float32)
        vs = (np.abs(rng.randn(P, page, hkv)) * 0.05).astype(np.float32)
        for a in (kp, vp, ks, vs):
            a[0] = 0
    else:
        kp = rng.randn(P, page, hkv, dh).astype(np.float32)
        vp = rng.randn(P, page, hkv, dh).astype(np.float32)
        kp[0] = vp[0] = 0
        ks = vs = None
    q = rng.randn(B, 1, hkv * g, dh).astype(np.float32)
    block = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    cl = np.array([1, page - 1, page, 2 * page + 3, nb * page], np.int32)
    for b in range(B):
        block[b, -(-cl[b] // page):] = 0
    return q, kp, vp, ks, vs, block, cl


def _jax_operands(q, kp, vp, ks, vs, block, cl, pool):
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[pool]
    j = [jnp.asarray(q), jnp.asarray(kp).astype(dt), jnp.asarray(vp).astype(dt),
         jnp.asarray(block), jnp.asarray(cl)]
    scales = (None, None) if ks is None else (
        jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(vs).astype(jnp.bfloat16))
    return j, scales


def _port_operands(q, kp, vp, ks, vs, block, cl, pool):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]
    t = [torch.from_numpy(q), torch.from_numpy(kp).to(dt),
         torch.from_numpy(vp).to(dt), torch.from_numpy(block),
         torch.from_numpy(cl)]
    scales = (None, None) if ks is None else (
        torch.from_numpy(ks).to(torch.bfloat16),
        torch.from_numpy(vs).to(torch.bfloat16))
    return t, scales


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [None, 12, 24])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_attention_plain_matches_jax(page, pool, window, g):
    """The port's plain version (what a CPU tensor runs) against the
    reference's gather oracle, and against its Pallas kernel in
    interpret mode on the single-pass plan for the window-24 cases."""
    args = _attn_case(page * 7 + g, page, g, pool)
    (jq_, jk, jv, jb, jc), (jks, jvs) = _jax_operands(*args, pool)
    (tq, tk, tv, tb, tc), (tks, tvs) = _port_operands(*args, pool)
    want = np.asarray(j_ops.paged_attention_reference(
        jq_, jk, jv, jb, jc, window=window, k_scale=jks, v_scale=jvs))
    before = paged_attn.COUNTS["plain"]
    got = t_ops.paged_attention(tq, tk, tv, tb, tc, window=window,
                                k_scale=tks, v_scale=tvs)
    assert paged_attn.COUNTS["plain"] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    gather = t_ops.paged_attention(tq, tk, tv, tb, tc, window=window,
                                   k_scale=tks, v_scale=tvs, backend="gather")
    np.testing.assert_array_equal(gather.numpy(), got.numpy())
    if window == 24:
        kern = np.asarray(paged_attention_tpu(
            jq_, jk, jv, jb, jc, window=window, k_scale=jks, v_scale=jvs,
            interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=tol)


def test_paged_attention_rejects_unknown_backend():
    args, (ks, vs) = _port_operands(*_attn_case(0, 8, 2, "f32"), "f32")
    with pytest.raises(ValueError):
        t_ops.paged_attention(*args, backend="pallas")


def test_smem_plan_properties():
    """A split's scores (``g x chunk`` f32) live in shared memory under
    the default budget (all the shared memory sm_90 lets a block opt
    into) for test-sized rows and every danube chunk the split plan
    makes, run (c)'s 4096-wide row included; an unsplit row past what a
    block can hold (16384 positions) takes the workspace; the score
    row's width is the window where that is shorter than the row;
    shrinking the budget moves a chunk to the workspace and never back;
    the block's bytes are the kernel's layout (csrc/paged_attn.cuh
    ``Smem``) and always fit what sm_90 allows."""
    p = paged_attn.smem_plan(3, 8, 16, 2)
    assert not p["multipass"] and p["span"] == p["chunk"] == 24
    assert paged_attn.smem_plan(69, 64, 80, 4, window=4096)["span"] == 4096
    assert paged_attn.smem_plan(9, 64, 80, 4, window=4096)["span"] == 576
    for B, nb in ((1, 69), (8, 9), (8, 69)):
        split = paged_attn.split_plan(B, 8, nb, 64, 4096, sms=132)
        plan = paged_attn.smem_plan(nb, 64, 80, 4, window=4096,
                                    chunk=split["chunk"],
                                    nsplit=split["nsplit"], itemsize=1)
        assert not plan["multipass"] and plan["ws_bytes"] == 0
    assert paged_attn.smem_plan(256, 64, 80, 4)["multipass"]
    # run (c): q 1280 + ring max(4 x 5120, 8 x 4 x 80 x 4) + int8 scales
    # 1024 + reductions 656 (the warps' and the split's slots for the
    # kernel's 16 heads, (8 + 2) x 16 + 1 floats) + the splits' maxima
    # and sums 32 x 4 x 8 + 4 block entries (16) + a tile's partial
    # scores 64 x 5 x 4 x 4 + scores 4 x 128 x 4
    c = paged_attn.smem_plan(69, 64, 80, 4, window=4096, chunk=128,
                             nsplit=32, itemsize=1)
    assert c["smem_bytes"] == (1280 + 20480 + 1024 + 656 + 1024 + 16 + 5120
                               + 2048)
    last = False
    for budget in (4096, 400, 200, 192, 100, 0):
        p = paged_attn.smem_plan(3, 8, 16, 2, chunk=8, nsplit=3,
                                 budget_bytes=budget)
        assert p["score_bytes"] == 4 * 2 * 8
        assert p["multipass"] == (p["score_bytes"] > budget)
        assert p["ws_bytes"] == (4 * 2 * 24 if p["multipass"] else 0)
        assert p["multipass"] or not last
        last = p["multipass"]
    for nb in (1, 64, 512, 4096):
        for itemsize in (1, 2, 4):
            p = paged_attn.smem_plan(nb, 64, 128, 8, itemsize=itemsize,
                                     budget_bytes=paged_attn.MAX_SMEM)
            assert p["smem_bytes"] <= paged_attn.MAX_SMEM


# (B, hkv, nb, page, window, sms): the paged test's reduced rows, danube's
# run (a) and run (c) geometries, and plans with one split
SPLIT_GEOMETRIES = [(5, 1, 3, 8, None, 132), (5, 1, 3, 8, 12, 132),
                    (6, 1, 4, 16, 24, 3), (8, 8, 9, 64, 4096, 132),
                    (1, 8, 69, 64, 4096, 132), (1, 1, 69, 64, 4096, 132),
                    (2, 2, 69, 64, None, 7), (3, 2, 12, 16, 100, 1)]


@pytest.mark.parametrize("B,hkv,nb,page,window,sms", SPLIT_GEOMETRIES)
def test_split_plan_covers_every_position_once(B, hkv, nb, page, window,
                                               sms):
    """Every valid position of a row falls in exactly one split, in
    order, for lengths 0, 1, a page +- 1, the split edges +- 1, the
    whole table, and window rows whose first valid position is not on
    a page or split edge; no split owns more than ``chunk``."""
    plan = paged_attn.split_plan(B, hkv, nb, page, window, sms=sms)
    chunk, nsplit, span = plan["chunk"], plan["nsplit"], plan["span"]
    assert nsplit * chunk >= span > (nsplit - 1) * chunk
    assert chunk >= min(page, span) and nsplit <= paged_attn.MAX_SPLITS
    full = nb * page
    lens = {0, 1, page - 1, page, page + 1, full - 1, full}
    for k in range(1, nsplit + 1):
        lens |= {k * chunk - 1, k * chunk, k * chunk + 1}
    if window:
        lens |= {window + 1, window + page + 3, window + chunk + 1}
    for L in sorted(x for x in lens if 0 <= x <= full):
        lo = max(0, L - window) if window else 0
        bounds = paged_attn.split_bounds(L, nb, page, window, chunk, nsplit)
        assert len(bounds) == nsplit
        owned = [i for c0, c1 in bounds for i in range(c0, c1)]
        assert owned == list(range(lo, min(L, full))), L
        assert all(c1 - c0 <= chunk for c0, c1 in bounds)


def test_split_plan_reads_static_shapes_only():
    """The plan takes no length (a launch reads nothing back from the
    card), gives danube's run (c) row ~2 blocks an SM in chunks of two
    ring stages and run (a)'s batch five splits a row, and its scratch
    is as stated: the partials are each split's g x dh sum plus its g
    maxima and exponent sums (f32), the workspace g x span f32 a row,
    and a plan with one split needs no partials."""
    import inspect

    assert set(inspect.signature(paged_attn.split_plan).parameters) == {
        "B", "hkv", "nb", "page", "window", "sms", "per_sm"}
    c = paged_attn.split_plan(1, 8, 69, 64, 4096, sms=132)
    assert (c["chunk"], c["nsplit"], c["blocks"]) == (128, 32, 256)
    a = paged_attn.split_plan(8, 8, 9, 64, 4096, sms=132)
    assert (a["chunk"], a["nsplit"], a["blocks"]) == (128, 5, 320)
    assert paged_attn.split_plan(8, 8, 9, 64, 4096, sms=132,
                                 per_sm=1)["nsplit"] == 3
    for budget in (None, 0):
        p = paged_attn.launch_plan(8, 8, 9, 64, 80, 4, window=4096,
                                   itemsize=1, sms=132, budget_bytes=budget)
        assert p["part_bytes"] == 4 * 8 * 8 * 5 * 4 * (80 + 2)
        assert p["ws_bytes"] == (4 * 8 * 8 * 4 * 576 if budget == 0 else 0)
    one = paged_attn.launch_plan(5, 1, 3, 8, 16, 2, sms=1)
    assert one["nsplit"] == 1 and one["part_bytes"] == 0


def _split_merge(q, kp, vp, ks, vs, block, cl, window, chunk, nsplit):
    """Float32 emulation of the CUDA kernel's order of operations (f32
    queries): each split of each (sequence, KV head) row forms its
    scores over the positions ``split_bounds`` gives it, its max m_s,
    l_s = sum exp(s - m_s) and acc_s = sum exp(s - m_s) v; the merge
    takes m = max m_s, w_s = exp(m_s - m) (0 for an empty split), L =
    sum w_s l_s and o = sum w_s acc_s / L in split order (0 where L =
    0)."""
    B, _, H, dh = q.shape
    _, page, hkv, _ = kp.shape
    nb = block.shape[1]
    g = H // hkv
    if ks is not None:  # int8 pages dequantized as a bf16 product
        kp = kp.to(torch.bfloat16) * ks[..., None]
        vp = vp.to(torch.bfloat16) * vs[..., None]
    kp, vp = kp.float(), vp.float()
    qs = q.float().reshape(B, hkv, g, dh) * dh ** -0.5
    out = torch.zeros(B, hkv, g, dh)
    for b in range(B):
        bounds = paged_attn.split_bounds(int(cl[b]), nb, page, window,
                                         chunk, nsplit)
        for h in range(hkv):
            parts = []
            for c0, c1 in bounds:
                if c1 <= c0:
                    parts.append(None)
                    continue
                pos = torch.arange(c0, c1)
                rows = block[b, pos // page].long()
                k = kp[rows, pos % page, h]
                v = vp[rows, pos % page, h]
                s = qs[b, h] @ k.T
                m = s.amax(-1)
                e = torch.exp(s - m[:, None])
                parts.append((m, e.sum(-1), e @ v))
            live = [p for p in parts if p is not None]
            if not live:
                continue
            m = torch.stack([p[0] for p in live]).amax(0)
            L = torch.zeros(g)
            o = torch.zeros(g, dh)
            for mi, li, acc in live:
                w = torch.exp(mi - m)
                L = L + w * li
                o = o + w[:, None] * acc
            out[b, h] = o / L[:, None]
    return out.reshape(B, 1, H, dh)


#: (pool, window, g) -> the gather oracle's output and the Pallas
#: kernel's on its single-pass and multipass plans
_JAX_OUTPUTS: dict = {}


@pytest.mark.parametrize("sms", [132, 8, 1])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [None, 12, 24])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_split_merge_order_matches_jax(pool, window, g, sms):
    """The kernel's split-and-merge order, emulated in f32 at the split
    plan of ``sms`` SMs (many one-page splits, a few, one), against the
    reference's gather oracle and its Pallas kernel in interpret mode on
    both its single-pass and its multipass plan (a 1-byte VMEM budget
    forces the latter): within 1e-5 of each row's max."""
    page = 8
    q, kp, vp, ks, vs, block, cl = _attn_case(page * 7 + g, page, g, pool)
    (jq_, jk, jv, jb, jc), (jks, jvs) = _jax_operands(
        q, kp, vp, ks, vs, block, cl, pool)
    (tq, tk, tv, tb, tc), (tks, tvs) = _port_operands(
        q, kp, vp, ks, vs, block, cl, pool)
    B, nb, hkv = q.shape[0], block.shape[1], kp.shape[2]
    plan = paged_attn.split_plan(B, hkv, nb, page, window, sms=sms)
    got = _split_merge(tq, tk, tv, tks, tvs, tb, tc, window, plan["chunk"],
                       plan["nsplit"]).numpy()
    key = (pool, window, g)
    if key not in _JAX_OUTPUTS:  # the same operands for every sms
        _JAX_OUTPUTS[key] = [np.asarray(j_ops.paged_attention_reference(
            jq_, jk, jv, jb, jc, window=window, k_scale=jks, v_scale=jvs))] + [
            np.asarray(paged_attention_tpu(
                jq_, jk, jv, jb, jc, window=window, k_scale=jks, v_scale=jvs,
                interpret=True, vmem_budget_bytes=budget))
            for budget in (None, 1)]
    want = _JAX_OUTPUTS[key]
    tol = 1e-5 * np.abs(want[0]).max(-1, keepdims=True)
    for i, ref in enumerate(want):
        assert np.all(np.abs(got - ref) <= tol), i


def test_split_merge_order_matches_jax_long_row():
    """One danube-shaped long row (Hkv 1, G 4, dh 80, page 64, int8
    pages, len 4415 past a 4096 window: the first valid position is not
    on a page edge) in 64 one-page splits and in 2, against the gather
    oracle within 1e-5 of each row's max."""
    rng = np.random.RandomState(17)
    page, nb, dh, g, L, window = 64, 69, 80, 4, 4415, 4096
    P = 1 + nb
    kp = rng.randint(-127, 128, (P, page, 1, dh)).astype(np.int8)
    vp = rng.randint(-127, 128, (P, page, 1, dh)).astype(np.int8)
    ks = (np.abs(rng.randn(P, page, 1)) * 0.05).astype(np.float32)
    vs = (np.abs(rng.randn(P, page, 1)) * 0.05).astype(np.float32)
    for a in (kp, vp, ks, vs):
        a[0] = 0
    q = rng.randn(1, 1, g, dh).astype(np.float32)
    block = (1 + rng.permutation(nb)).reshape(1, nb).astype(np.int32)
    cl = np.array([L], np.int32)
    (jq_, jk, jv, jb, jc), (jks, jvs) = _jax_operands(
        q, kp, vp, ks, vs, block, cl, "int8")
    (tq, tk, tv, tb, tc), (tks, tvs) = _port_operands(
        q, kp, vp, ks, vs, block, cl, "int8")
    want = np.asarray(j_ops.paged_attention_reference(
        jq_, jk, jv, jb, jc, window=window, k_scale=jks, v_scale=jvs))
    tol = 1e-5 * np.abs(want).max(-1, keepdims=True)
    for sms, nsplit in ((132, 64), (1, 2)):
        plan = paged_attn.split_plan(1, 1, nb, page, window, sms=sms)
        assert plan["nsplit"] == nsplit
        got = _split_merge(tq, tk, tv, tks, tvs, tb, tc, window,
                           plan["chunk"], plan["nsplit"]).numpy()
        assert np.all(np.abs(got - want) <= tol), sms


@pytest.mark.parametrize("window", [None, 24])
def test_pages_read_per_step_matches_reference(window):
    """The reference's page model is copied; the pages the CUDA kernel
    reads are those, less the trash page it never touches."""
    for cl in range(0, 5 * 8 + 3):
        want = j_pages_read(cl, 8, 5, window)
        assert paged_attn.pages_read_per_step(cl, 8, 5, window) == want
        live = paged_attn.live_pages(cl, 8, 5, window)
        assert want == (live + (live < 5) if cl > 0 else 1)


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------

def _pkv_state(pkv):
    out = {"rows": [None if r is None else list(r) for r in pkv.rows],
           "refs": pkv.alloc.refs.tolist(), "free": sorted(pkv.alloc._free),
           "lens": list(pkv.lens), "hit_tokens": list(pkv.hit_tokens),
           "stats": pkv.stats()}
    if pkv.prefix is not None:
        out["nodes"] = sorted((n.page, n.n_children, n.stamp)
                              for n in pkv.prefix._nodes.values())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_matches_jax(seed):
    """Random admit / retire / window-release / prefix-insert sequences
    over a shared system prompt leave both packages' PagedKV in the same
    state after every operation (rows, refcounts, free pages, trie,
    hits, stats), with the allocator invariants holding."""
    rng = np.random.RandomState(seed)
    page, nb, cap, n_pages = 4, 8, 3, 14
    sys_prompt = rng.randint(0, 50, 9)
    kvs = [mod.PagedKV(n_pages, page, nb, cap, prefix_cache=True)
           for mod in (j_paged_kv, t_paged_kv)]
    for _ in range(60):
        op = rng.randint(4)
        slot = rng.randint(cap)
        if op < 2:
            if kvs[0].rows[slot] is not None:
                continue
            tail = rng.randint(0, 50, rng.randint(1, 8))
            toks = np.concatenate([sys_prompt, tail]) if op == 0 else tail
            total = min(len(toks) + rng.randint(1, 6), nb * page)
            got = [kv.admit(slot, toks, total) for kv in kvs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                np.testing.assert_array_equal(got[0][0], got[1][0])
                assert got[0][1] == got[1][1]
                for kv in kvs:
                    kv.insert_prefix(slot, toks)
                    kv.lens[slot] = len(toks)
        elif op == 2:
            for kv in kvs:
                kv.release_slot(slot)
        else:
            freed = []
            for kv in kvs:
                if kv.rows[slot] is not None:
                    kv.lens[slot] += 5
                freed.append(kv.release_behind_window(slot, 6))
            assert freed[0] == freed[1]
        assert _pkv_state(kvs[0]) == _pkv_state(kvs[1])
        kvs[1].alloc.check()
    assert kvs[1].prefix.hits > 0


def test_chunk_schedule_matches_jax():
    for length in (1, 15, 16, 17, 100, 257):
        for start in (0, 16, 32):
            if start >= length:
                continue
            assert (t_paged_kv.chunk_plan(length, start, 64)
                    == j_paged_kv.chunk_plan(length, start, 64))
    assert t_paged_kv.prefill_buckets(256) == j_paged_kv.prefill_buckets(256)
    assert (t_paged_kv.workspace_len(4416, 69, 64)
            == j_paged_kv.workspace_len(4416, 69, 64) == 16384)
    for bits in (8, 16):
        jcfg, tcfg = cfg_pair(kv_cache_bits=bits)
        assert (t_paged_kv.kv_bytes_per_token(tcfg)
                == j_paged_kv.kv_bytes_per_token(jcfg))


# ---------------------------------------------------------------------------
# paged model functions
# ---------------------------------------------------------------------------

PAGE, NB, NPAGES, B = 8, 4, 12, 2


def _views(jq, view, kv_bits):
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_bits,
                          kernel_backend="decode" if view == "decode"
                          else "auto")
    pack4 = view == "packed4"
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _filled_cache(jcfg, seed):
    """A reference paged cache with live content: random K/V (int8 with
    scales, or floats) on pages 1..; trash page 0 zero; two rows of
    ragged length over distinct pages."""
    rng = np.random.RandomState(seed)
    cache = j_lm.init_paged_cache(jcfg, B, NPAGES, PAGE, NB)
    pool = {}
    for key, leaf in cache["pool"].items():
        shape = leaf.shape
        if leaf.dtype == jnp.int8:
            a = rng.randint(-127, 128, shape).astype(np.int8)
        elif key.endswith("_scale"):
            a = (np.abs(rng.randn(*shape)) * 0.05).astype(np.float32)
        else:
            a = rng.randn(*shape).astype(np.float32) * 0.5
        a[:, 0] = 0
        pool[key] = jnp.asarray(a).astype(leaf.dtype)
    block = np.zeros((B, NB), np.int32)
    block[0, :3] = [3, 7, 1]
    block[1, :2] = [5, 2]
    return {"pool": pool, "block": jnp.asarray(block),
            "len": jnp.asarray([19, 9], jnp.int32)}


def _compare_pools(jpool, tcache, quant):
    got = interop.paged_cache_to_numpy(tcache)["pool"]
    for key, want in jpool.items():
        want = np.asarray(want)
        have = got[key]
        if quant:  # int8 pages and their bf16 scales, bit for bit
            np.testing.assert_array_equal(have.astype(np.float32),
                                          want.astype(np.float32), err_msg=key)
        else:
            np.testing.assert_allclose(
                have.astype(np.float32), want.astype(np.float32), rtol=0,
                atol=1e-5 * np.abs(want.astype(np.float32)).max(),
                err_msg=key)


@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("view", ["packed4", "fused", "decode"])
def test_paged_decode_step_matches_jax(jq, view, kv_bits):
    """Three decode steps through the block table from the same filled
    cache: logits, and every page after the scatters."""
    jcfg, tcfg, js, model = _views(jq, view, kv_bits)
    jcache = _filled_cache(jcfg, seed=kv_bits)
    tcache = interop.paged_cache_from_jax(to_np(jcache), tcfg)
    step = jax.jit(lambda p, t, c: japi.paged_decode_step(p, jcfg, t, c),
                   compiler_options=STRICT)
    tok = np.asarray([[5], [17]], np.int32)
    for _ in range(3):
        jl, jcache = step(js, jnp.asarray(tok), jcache)
        with torch.inference_mode():
            tl, tcache = tapi.paged_decode_step(model, tcfg,
                                                torch.from_numpy(tok), tcache)
        jl = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        _compare_pools(jcache["pool"], tcache, kv_bits == 8)
        tok = jl[:, -1].argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_prefill_chunk_splice_hydrate_match_jax(jq, kv_bits):
    """A 23-token prompt prefilled in chunks of 16 and 16 (7 real) into
    the workspace, spliced to a block row from position 8 (a one-page
    prefix hit), then a 16-token hydrate from those pages."""
    jcfg, tcfg, js, model = _views(jq, "fused", kv_bits)
    wws = j_paged_kv.workspace_len(32, NB, PAGE)
    toks = np.random.RandomState(3).randint(0, jcfg.vocab, 23).astype(np.int32)
    jws = j_lm.init_paged_workspace(jcfg, wws)
    tws = t_lm.init_paged_workspace(tcfg, wws)
    chunk = jax.jit(lambda p, t, w, s, n: j_lm.lm_paged_prefill_chunk(
        p, jcfg, t, w, s, n), compiler_options=STRICT)
    for start, n_real in ((0, 16), (16, 7)):
        t = np.zeros((1, 16), np.int32)
        t[0, :n_real] = toks[start:start + n_real]
        jl, jws = chunk(js, jnp.asarray(t), jws, jnp.int32(start),
                        jnp.int32(n_real))
        with torch.inference_mode():
            tl, tws = t_lm.lm_paged_prefill_chunk(
                model, tcfg, torch.from_numpy(t), tws, start, n_real)
        jl = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
    for key in ("k", "v"):
        want = np.asarray(jws[key])[:, 0, :23]
        got = np.stack([w[key][0, :23].numpy() for w in tws])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # splice through a row whose first page is a prefix hit (not rewritten)
    jcache = _filled_cache(jcfg, seed=11)
    tcache = interop.paged_cache_from_jax(to_np(jcache), tcfg)
    # workspaces crossed from JAX, so the splice sees the same values
    tws = [{k: torch.from_numpy(np.array(jws[k][i])) for k in ("k", "v")}
           for i in range(tcfg.n_layers)]
    row = np.array([6, 4, 9, 0], np.int32)
    jpool = j_lm.lm_paged_splice(jcfg, jcache["pool"], jws, jnp.asarray(row),
                                 8, 23)
    t_lm.lm_paged_splice(tcfg, tcache["pool"], tws, torch.from_numpy(row), 8,
                         23)
    # the reference sends positions outside [8, 23) to the trash page;
    # the port writes nothing there: compare the live pages
    jpool = {k: np.asarray(v)[:, 1:] for k, v in jpool.items()}
    tpool = {"pool": [{k: v[1:] for k, v in c.items()}
                      for c in tcache["pool"]],
             "block": tcache["block"], "len": tcache["len"]}
    _compare_pools(jpool, tpool, kv_bits == 8)
    jh = j_lm.lm_paged_hydrate(jcfg, {k: jnp.asarray(v) for k, v in
                                      interop.paged_cache_to_numpy(
                                          tcache)["pool"].items()},
                               jnp.asarray(row), 16, wws)
    th = t_lm.lm_paged_hydrate(tcfg, tcache["pool"], torch.from_numpy(row), 16,
                               t_lm.init_paged_workspace(tcfg, wws))
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            np.stack([w[key].numpy() for w in th]), np.asarray(jh[key]))
