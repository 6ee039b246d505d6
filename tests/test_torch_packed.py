"""Port parity, packed prefill: several queued prompts' tails in ONE
prefill call of the paged engine, with segment-masked attention over a
workspace whose segment bases are aligned to the attention's kv block.

* ``flash_attention`` with per-token positions and segments equals the
  JAX reference's within 1e-5 of max|out| (f32), over segments longer
  than reduced danube's window of 24 and a width that pads; each
  segment's rows equal its own unpacked call's bit for bit;
* ``lm_paged_prefill_packed`` equals the reference's (logits within
  1e-4 of max|logit|; the pool outside the trash page within 1e-5 of
  max|page| in f32, bit for bit in int8) with a prefix hit and an
  inactive segment; the trash page is written with zeros only;
* the engine (reduced danube, 4 slots, max_len 20, 24 pages of 16, as
  the reference's ``tests/test_paged_attn.py`` packed cases): packed
  tokens equal unpacked tokens, the JAX packed engine's and solo
  ``generate``'s, request by request, with fewer prefill calls, and the
  dispatch and step statistics equal the JAX engine's; with int8 KV and
  the prefix cache off; through a 4-bit LUT-Q packed4 serve view (and
  the JAX plain loop); a group whose members hit the prefix cache; a
  page shortfall that defers the head with FIFO kept; a speculative
  paged engine; ``act_bits=8`` turns packing off;
* the engine's packed step over its own buffers equals a direct call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, cfg_pair, jax_quantized,
                                jax_reference, one_thread, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro.models import lm as j_lm
from repro.nn.attention import flash_attention as j_flash
from repro.runtime.engine import Engine as JEngine
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.models import api as tapi
from repro_torch.models import lm as t_lm
from repro_torch.nn.attention import flash_attention
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

#: the reference's packed-prefill geometry: 4 prompts for 4 slots,
#: max_len 20, 24 pages of 16 (workspace 64: four 16-position spans)
PACK_LENS = [5, 7, 6, 8]
GEOM = dict(capacity=4, max_len=20, kv_pages=24, page_size=16)
#: statistics a packed engine must share with the JAX engine
STATS = ("packed_groups", "packed_requests", "prefill_chunk_calls",
         "decode_steps", "admitted", "completed", "new_tokens",
         "prefix_hits", "prefix_queries", "pages_peak")


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp():
    """Float reduced danube in both packages (no quantization)."""
    jcfg, tcfg = cfg_pair(act_bits=32, remat=False)
    jcfg, tcfg = jcfg.replace(quant=None), tcfg.replace(quant=None)
    params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, interop.from_jax(to_np(params), tcfg)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


def _serve_pair(jq, pack4, kv_bits=16):
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_bits)
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _run(eng, prompts, max_new):
    """Serve ``prompts``: (tokens a request, stats). A port engine's
    trace counts stay as they were (the JAX engines here trace lazily)."""
    traces = eng.paged_trace_counts()
    for p, g in zip(prompts, max_new):
        eng.submit(p, max_new=g)
    res = eng.run()
    if isinstance(eng, Engine):
        assert eng.paged_trace_counts() == traces
    eng.pkv.alloc.check()
    return [r["tokens"] for r in res], eng.stats()


def _pack_prompts(cfg, seed):
    toks = tokens(cfg, 4, 8, seed=seed)
    return [toks[i, :L] for i, L in enumerate(PACK_LENS)]


# ---------------------------------------------------------------------------
# attention with per-token positions and segments
# ---------------------------------------------------------------------------

def _segment_layout(lens, kvb, wws, width):
    """Packed queries (rows back to back, padding to ``width``) and a
    workspace with each segment at a kv_block-aligned base."""
    q_pos = np.full(width, -1, np.int32)
    q_seg = np.full(width, -2, np.int32)
    kv_pos = np.full(wws, 10**6, np.int32)
    kv_seg = np.full(wws, len(lens), np.int32)  # no query's segment
    row = base = 0
    bases = []
    for s, L in enumerate(lens):
        q_pos[row:row + L] = np.arange(L)
        q_seg[row:row + L] = s
        kv_pos[base:base + L] = np.arange(L)
        kv_seg[base:base + L] = s
        bases.append(base)
        row += L
        base += -(-L // kvb) * kvb
    return q_pos, q_seg, kv_pos, kv_seg, bases


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
def test_flash_attention_segments_match_jax(window):
    """Three segments (30, 9 and 40 tokens: two longer than the window)
    packed into 90 queries (padded in blocks of 16) over a 128-position
    workspace in kv blocks of 16; f32."""
    lens, kvb, wws, width = [30, 9, 40], 16, 128, 90
    rng = np.random.RandomState(7)
    q = rng.randn(1, width, 4, 16).astype(np.float32)
    k = rng.randn(1, wws, 2, 16).astype(np.float32)
    v = rng.randn(1, wws, 2, 16).astype(np.float32)
    q_pos, q_seg, kv_pos, kv_seg, bases = _segment_layout(lens, kvb, wws,
                                                          width)
    assert sum(lens) < width and bases == [0, 32, 48]
    kw = dict(window=window, q_block=16, kv_block=kvb)
    want = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
        q_segments=jnp.asarray(q_seg), kv_segments=jnp.asarray(kv_seg),
        **kw))
    t = torch.from_numpy
    got = flash_attention(t(q), t(k), t(v), q_positions=t(q_pos),
                          kv_positions=t(kv_pos), q_segments=t(q_seg),
                          kv_segments=t(kv_seg), **kw)
    real = q_seg >= 0
    np.testing.assert_allclose(got.numpy()[:, real], want[:, real], rtol=0,
                               atol=1e-5 * np.abs(want[:, real]).max())
    # each segment's rows: its own unpacked call over its own kv blocks
    row = 0
    for L, base in zip(lens, bases):
        span = -(-L // kvb) * kvb
        kk = torch.zeros(1, span, 2, 16)
        vv = torch.zeros(1, span, 2, 16)
        kk[:, :L], vv[:, :L] = t(k[:, base:base + L]), t(v[:, base:base + L])
        alone = flash_attention(t(q[:, row:row + L]), kk, vv, **kw)
        assert torch.equal(got[:, row:row + L], alone), L
        row += L


def test_flash_attention_overrides_all_or_none():
    x = torch.zeros(1, 16, 2, 8)
    pos = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        flash_attention(x, x, x, q_positions=pos, kv_positions=pos)


# ---------------------------------------------------------------------------
# the packed call against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [8, 16])
def test_packed_prefill_matches_jax(jq, kv_bits):
    """Segment 0 hits 16 cached positions and prefills 4 more (a span of
    two kv blocks), segments 1 and 2 are fresh, segment 3 is inactive:
    logits of the active segments, and every page but the trash page,
    equal the reference's; the trash page holds zeros (and a zero
    entry's int8 scale) only."""
    jcfg, tcfg, js, model = _serve_pair(jq, pack4=False, kv_bits=kv_bits)
    quant = kv_bits == 8
    page, nb, n_pages, wws = 16, 2, 24, 64
    rng = np.random.RandomState(kv_bits)
    cache = j_lm.init_paged_cache(jcfg, 4, n_pages, page, nb)
    pool = {}
    for key, leaf in cache["pool"].items():
        if leaf.dtype == jnp.int8:
            a = rng.randint(-127, 128, leaf.shape).astype(np.int8)
        elif key.endswith("_scale"):
            a = (np.abs(rng.randn(*leaf.shape)) * 0.05).astype(np.float32)
        else:
            a = rng.randn(*leaf.shape).astype(np.float32) * 0.5
        a[:, 0] = 0
        pool[key] = jnp.asarray(a).astype(leaf.dtype)
    jcache = dict(cache, pool=pool)
    tcache = interop.paged_cache_from_jax(to_np(jcache), tcfg)
    blocks = np.array([[3, 4], [5, 6], [7, 0], [0, 0]], np.int32)
    bases = np.array([0, 32, 48, 64], np.int32)
    hists = np.array([16, 0, 0, 0], np.int32)
    lens = np.array([20, 6, 9, 0], np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :19] = rng.randint(0, jcfg.vocab, 19)
    call = jax.jit(lambda *a: j_lm.lm_paged_prefill_packed(
        a[0], jcfg, *a[1:], wws), compiler_options=STRICT)
    jl, jpool = call(js, jnp.asarray(toks), jcache["pool"],
                     *map(jnp.asarray, (blocks, bases, hists, lens)))
    t = torch.from_numpy
    with torch.inference_mode():
        got = t_lm.lm_paged_prefill_packed(
            model, tcfg, t(toks), tcache["pool"], t(blocks), t(bases),
            t(hists), t(lens), wws)
    assert got.shape == (4, 1, jcfg.vocab)
    jl = np.asarray(jl, np.float32)[:3]
    np.testing.assert_allclose(got.numpy()[:3], jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    have = interop.paged_cache_to_numpy(tcache)["pool"]
    for key, want in jpool.items():
        want = np.asarray(want).astype(np.float32)[:, 1:]
        h = have[key].astype(np.float32)[:, 1:]
        if quant:
            np.testing.assert_array_equal(h, want, err_msg=key)
        else:
            np.testing.assert_allclose(h, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        trash = np.unique(have[key][:, 0])
        assert trash.size == 1 and (key.endswith("_scale")
                                    or trash[0] == 0), (key, trash)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _jax_engine(params, jcfg, **kw):
    return JEngine(params, jcfg, warmup=False, **dict(GEOM, **kw))


def _engine(model, tcfg, **kw):
    return Engine(model, tcfg, device="cpu", **dict(GEOM, **kw))


def _same(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}, request {i}")


@pytest.mark.parametrize("kv_bits,prefix", [(16, True), (8, False)],
                         ids=["f32-kv", "int8-kv-no-prefix"])
def test_packed_engine_matches_unpacked_and_jax(fp, kv_bits, prefix):
    """One packed call replaces four chunk calls; the tokens equal the
    unpacked engine's, the JAX packed engine's and (f32 KV) solo
    generate's, and the statistics equal the JAX engine's."""
    jcfg, tcfg, params, model = fp
    jcfg = jcfg.replace(kv_cache_bits=kv_bits)
    tcfg = tcfg.replace(kv_cache_bits=kv_bits)
    prompts = _pack_prompts(tcfg, seed=1 + kv_bits)
    G = [4] * 4
    eng = _engine(model, tcfg, prefix_cache=prefix)
    assert eng.prefill_pack
    packed, sp = _run(eng, prompts, G)
    plain, su = _run(_engine(model, tcfg, prefix_cache=prefix,
                             prefill_pack=False), prompts, G)
    want, sj = _run(_jax_engine(params, jcfg, prefix_cache=prefix), prompts,
                    G)
    assert sp["packed_groups"] == 1 and sp["packed_requests"] == 4
    assert su["packed_groups"] == 0
    assert (sp["prefill_chunk_calls"] + sp["packed_groups"]
            < su["prefill_chunk_calls"])
    _same(packed, plain, "packed vs unpacked")
    _same(packed, want, "packed vs JAX packed engine")
    assert {k: sp.get(k) for k in STATS} == {k: sj.get(k) for k in STATS}
    if kv_bits == 16:
        for p, got in zip(prompts, packed):
            solo = tserving.generate(model, tcfg,
                                     {"tokens": torch.from_numpy(p[None])},
                                     steps=4, max_len=20, device="cpu")
            np.testing.assert_array_equal(got, solo[0].numpy())


def test_packed_engine_serve_view_packed4(jq):
    """A 4-bit LUT-Q packed4 serve view (the plain packed GEMM): packed
    tokens equal unpacked ones, the JAX plain loop's and solo
    generate's."""
    jcfg, tcfg, js, model = _serve_pair(jq, pack4=True, kv_bits=8)
    prompts = _pack_prompts(tcfg, seed=5)
    G = [3, 4, 2, 4]
    packed, sp = _run(_engine(model, tcfg, backend="packed4"), prompts, G)
    plain, _ = _run(_engine(model, tcfg, backend="packed4",
                            prefill_pack=False), prompts, G)
    assert sp["packed_groups"] == 1 and sp["packed_requests"] == 4
    _same(packed, plain, "packed4 view: packed vs unpacked")
    for p, g, got in zip(prompts, G, packed):
        _, want = jax_reference(jcfg, js, p[None], g)
        np.testing.assert_array_equal(got, want[0])
        solo = tserving.generate(model, tcfg.replace(kernel_backend="packed4"),
                                 {"tokens": torch.from_numpy(p[None])},
                                 steps=g, max_len=20, device="cpu")
        np.testing.assert_array_equal(got, solo[0].numpy())


def test_packed_group_with_prefix_hits(fp):
    """A first request publishes a 16-token page; the next group packs a
    request that hits it (its segment hydrates the page, prefills only
    its tail and spans two kv blocks) beside two fresh ones: the tokens
    equal unpacked serving and the JAX engine, with the same hits and
    dispatches."""
    jcfg, tcfg, params, model = fp
    rng = np.random.RandomState(9)
    sys_p = rng.randint(0, tcfg.vocab, 16)
    first = np.concatenate([sys_p, rng.randint(0, tcfg.vocab, 2)])
    group = [np.concatenate([sys_p, rng.randint(0, tcfg.vocab, 3)]),
             rng.randint(0, tcfg.vocab, 5), rng.randint(0, tcfg.vocab, 6)]
    group = [g.astype(np.int32) for g in group]
    out = {}
    for name, eng in (("packed", _engine(model, tcfg)),
                      ("plain", _engine(model, tcfg, prefill_pack=False)),
                      ("jax", _jax_engine(params, jcfg))):
        head, _ = _run(eng, [first.astype(np.int32)], [2])
        rest, st = _run(eng, group, [1, 3, 1])
        out[name] = (head + rest, st)
    sp, su, sj = (out[k][1] for k in ("packed", "plain", "jax"))
    assert sp["packed_groups"] == 1 and sp["packed_requests"] == 3
    assert sp["prefix_hits"] == su["prefix_hits"] >= 1
    assert sp["prefill_chunk_calls"] < su["prefill_chunk_calls"]
    _same(out["packed"][0], out["plain"][0], "hits: packed vs unpacked")
    _same(out["packed"][0], out["jax"][0], "hits: packed vs JAX")
    assert {k: sp.get(k) for k in STATS} == {k: sj.get(k) for k in STATS}


def test_page_shortfall_defers_the_head_fifo(fp):
    """Five allocatable pages for requests of two pages each: the
    planned group of four commits two, the rest wait at the head (FIFO:
    admitted in submission order) until retirements free pages; tokens
    and statistics equal the unpacked engine's and the JAX engine's."""
    jcfg, tcfg, params, model = fp
    prompts = _pack_prompts(tcfg, seed=11)
    G = [12, 10, 11, 9]  # prompt + max_new in (16, 20]: two pages each
    kw = dict(kv_pages=6)
    eng = _engine(model, tcfg, **kw)
    traces = eng.paged_trace_counts()
    for p, g in zip(prompts, G):
        eng.submit(p, max_new=g)
    order = []
    while not eng.idle:
        eng.step()
        if len(eng.queue) == 2:  # after the first step: a group of two
            assert [r.rid for r in eng.queue] == [2, 3]
        order += [r.rid for r in eng.slots
                  if r is not None and r.rid not in order]
    assert order == [0, 1, 2, 3]
    assert eng.paged_trace_counts() == traces
    eng.pkv.alloc.check()
    packed, sp = [r["tokens"] for r in eng.run()], eng.stats()
    plain, su = _run(_engine(model, tcfg, prefill_pack=False, **kw),
                     prompts, G)
    want, sj = _run(_jax_engine(params, jcfg, **kw), prompts, G)
    assert sp["packed_groups"] >= 1 and sp["packed_requests"] < 4
    assert sp["pages_peak"] <= 5
    _same(packed, plain, "shortfall: packed vs unpacked")
    _same(packed, want, "shortfall: packed vs JAX")
    assert {k: sp.get(k) for k in STATS} == {k: sj.get(k) for k in STATS}


def test_speculative_paged_engine_packs(jq):
    """A speculative paged engine (k=2, 2-bit draft) packs its
    admissions and gives the tokens of k=0."""
    _, tcfg, _, model = _serve_pair(jq, pack4=True, kv_bits=16)
    prompts = _pack_prompts(tcfg, seed=13)
    G = [4, 3, 4, 2]
    spec = _engine(model, tcfg, max_len=22, speculative=2, draft_bits=2)
    got, ss = _run(spec, prompts, G)
    want, s0 = _run(_engine(model, tcfg, max_len=22), prompts, G)
    assert ss["packed_groups"] == s0["packed_groups"] == 1
    assert ss["spec_rounds"] > 0
    _same(got, want, "speculative vs k=0")


def test_dynamic_act_quant_turns_packing_off(fp):
    _, tcfg, _, model = fp
    eng = _engine(model, tcfg.replace(act_bits=8))
    assert eng.paged and not eng.prefill_pack
    assert "packed" not in eng.paged_trace_counts()
    got, st = _run(eng, _pack_prompts(tcfg, seed=3), [2] * 4)
    assert st["packed_groups"] == 0 and st["prefill_chunk_calls"] == 4


def test_packed_step_over_engine_buffers_equals_direct_call(fp):
    """The packed step the engine captures on CUDA (tokens in chunk_tok,
    block rows in pack_blocks, bases / hists / lens in pack_meta, logits
    into pack_logits) equals lm_paged_prefill_packed called on the same
    values as host arrays, logits and pool bit for bit."""
    _, tcfg, _, model = fp
    eng = _engine(model, tcfg)
    twin = _engine(model, tcfg)
    blocks = np.array([[2, 3], [4, 0], [5, 0], [0, 0]], np.int32)
    meta = np.array([[0, 32, 48, 64], [0, 0, 0, 0], [18, 9, 5, 0]],
                    np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :32] = tokens(tcfg, 1, 32, seed=4)[0]
    eng.chunk_tok[:, :32] = torch.from_numpy(toks)
    eng.pack_blocks.copy_(torch.from_numpy(blocks))
    eng.pack_meta.copy_(torch.from_numpy(meta))
    with torch.inference_mode():
        eng._packed_step(32)
        want = t_lm.lm_paged_prefill_packed(
            model, tcfg, torch.from_numpy(toks), twin.cache["pool"], blocks,
            meta[0], meta[1], meta[2], twin.wws)
    assert torch.equal(eng.pack_logits, want)
    for a, b in zip(eng.cache["pool"], twin.cache["pool"]):
        for key in a:
            assert torch.equal(a[key], b[key]), key
