"""Port parity, the paged engine's chunked prefill as functions of device
scalars: the functions a CUDA engine captures as graphs (one a chunk
width, the hydrate, the splice) and replays, run here on the CPU.

* ``flash_attention`` with a 0-dim tensor ``q_offset`` (the slab start
  clamped and the K/V blocks gathered on the device) equals the ``int``
  offset's output bit for bit, with and without a window;
* ``lm_paged_prefill_chunk`` with tensor ``start`` / ``n_real`` equals
  the ``int`` call bit for bit (logits and workspace), and the JAX
  reference's jitted chunk with traced int32 scalars within 1e-4 of
  max|logit| (workspace within 1e-5 of its largest entry, as
  ``test_torch_paged.py``), over starts on both sides of the window's
  slab edge;
* the fixed-shape splice (every workspace position written, those
  outside [start, length) as zeros to the trash page) equals the
  reference's on every page but the trash page, int8 pages and scales
  bit for bit, f32 pages within 1e-5 of max|page|; the masked hydrate
  equals it bit for
  bit at ``hist_len`` 0, mid-page and a full row;
* a paged engine's warmup runs the hydrate, every chunk width and the
  splice, and its prefill buffers keep their addresses across a serve
  (``test_torch_graph_step.py`` holds the same for the decode step's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, cfg_pair, jax_quantized, one_thread,
                                to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro.models import lm as j_lm
from repro.runtime import paged_kv as j_paged_kv
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import lm as t_lm
from repro_torch.nn.attention import flash_attention
from repro_torch.runtime import paged_kv as t_paged_kv
from repro_torch.runtime.engine import Engine

#: pages of the splice and hydrate cases: NB blocks of PAGE positions
PAGE, NB, NPAGES = 8, 4, 12


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


def _views(jq, view, kv_bits=16):
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_bits)
    pack4 = view == "packed4"
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


# ---------------------------------------------------------------------------
# flash attention at a device offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
def test_flash_attention_tensor_offset_equals_int(window, dtype):
    """Chunks of 16 and 32 queries against a 128-position workspace in
    blocks of 16: with a window of 24 the slab is 64 positions, so the
    offsets past 48 move its start (clamped at 0 below them)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(4)
    k = torch.from_numpy(rng.randn(1, 128, 2, 16).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.randn(1, 128, 2, 16).astype(np.float32)).to(dt)
    for S, offs in ((16, (0, 16, 40, 48, 64, 80, 112)), (32, (0, 32, 96))):
        q = torch.from_numpy(rng.randn(1, S, 4, 16).astype(np.float32)).to(dt)
        for off in offs:
            kw = dict(window=window, q_block=16, kv_block=16)
            want = flash_attention(q, k, v, q_offset=off, **kw)
            got = flash_attention(q, k, v, q_offset=_i32(off), **kw)
            assert got.dtype == want.dtype == dt
            assert torch.equal(got, want), (S, off)


# ---------------------------------------------------------------------------
# the chunk, splice and hydrate at device scalars
# ---------------------------------------------------------------------------

#: (start, width, n_real) of a 90-token prompt in a 128-position
#: workspace; with reduced danube's window of 24 in blocks of 16 the slab
#: is 64 positions, so the chunks at 64 and 80 read a moved slab
CHUNKS = ((0, 32, 32), (32, 16, 16), (48, 16, 16), (64, 16, 16),
          (80, 16, 10))
WWS = 128


@pytest.mark.parametrize("view", ["fused", "packed4"])
def test_chunk_at_tensor_start_equals_int_and_jax(jq, view):
    jcfg, tcfg, js, model = _views(jq, view)
    assert tcfg.window == 24 and tcfg.attn_kv_block == 16
    toks = np.random.RandomState(5).randint(0, jcfg.vocab, 90).astype(
        np.int32)
    chunk = jax.jit(lambda p, t, w, s, n: j_lm.lm_paged_prefill_chunk(
        p, jcfg, t, w, s, n), compiler_options=STRICT)
    jws = j_lm.init_paged_workspace(jcfg, WWS)
    ws_int = t_lm.init_paged_workspace(tcfg, WWS)
    ws_dev = t_lm.init_paged_workspace(tcfg, WWS)
    for start, width, n_real in CHUNKS:
        t = np.zeros((1, width), np.int32)
        t[0, :n_real] = toks[start:start + n_real]
        jl, jws = chunk(js, jnp.asarray(t), jws, jnp.int32(start),
                        jnp.int32(n_real))
        with torch.inference_mode():
            want, _ = t_lm.lm_paged_prefill_chunk(
                model, tcfg, torch.from_numpy(t), ws_int, start, n_real)
            got, _ = t_lm.lm_paged_prefill_chunk(
                model, tcfg, torch.from_numpy(t), ws_dev, _i32(start),
                _i32(n_real))
        assert torch.equal(got, want), start
        jl = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max(),
                                   err_msg=f"chunk at {start}")
    for key in ("k", "v"):
        for a, b in zip(ws_dev, ws_int):
            assert torch.equal(a[key], b[key])
        want = np.asarray(jws[key])[:, 0, :90]
        got = np.stack([w[key][0, :90].numpy() for w in ws_dev])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _pool_and_ws(jcfg, tcfg, seed):
    """A reference pool with live content on pages 1.. (trash page 0
    zero), its port copy, and a random workspace of 40 positions in
    both packages."""
    rng = np.random.RandomState(seed)
    cache = j_lm.init_paged_cache(jcfg, 2, NPAGES, PAGE, NB)
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
    L, hkv, dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.resolved_head_dim
    wk = rng.randn(L, 1, 40, hkv, dh).astype(np.float32)
    wv = rng.randn(L, 1, 40, hkv, dh).astype(np.float32)
    jws = {"k": jnp.asarray(wk), "v": jnp.asarray(wv)}
    tws = [{"k": torch.from_numpy(wk[i].copy()),
            "v": torch.from_numpy(wv[i].copy())} for i in range(L)]
    return jcache, tcache, jws, tws


def _live_pages(tcache):
    return interop.paged_cache_to_numpy(tcache)["pool"]


@pytest.mark.parametrize("span", [(8, 23), (0, 32), (5, 5)],
                         ids=["hit", "whole-row", "empty"])
@pytest.mark.parametrize("kv_bits", [8, 16])
def test_masked_splice_equals_jax(jq, kv_bits, span):
    """Workspace positions [start, length) through the row [6, 4, 9, 0]
    (a one-page prefix hit, the whole row, nothing): every page but the
    trash page equals the reference's; the trash page, where the other
    positions land, holds one value; tensor and int bounds write the
    same bits everywhere."""
    jcfg, tcfg, _, _ = _views(jq, "fused", kv_bits)
    quant = kv_bits == 8
    row = np.array([6, 4, 9, 0], np.int32)
    start, length = span
    jcache, tcache, jws, tws = _pool_and_ws(jcfg, tcfg, seed=kv_bits)
    _, tcache_int, _, _ = _pool_and_ws(jcfg, tcfg, seed=kv_bits)
    before = _live_pages(tcache)
    jpool = j_lm.lm_paged_splice(jcfg, jcache["pool"], jws, jnp.asarray(row),
                                 jnp.int32(start), jnp.int32(length))
    t_lm.lm_paged_splice(tcfg, tcache["pool"], tws, torch.from_numpy(row),
                         _i32(start), _i32(length))
    t_lm.lm_paged_splice(tcfg, tcache_int["pool"], tws,
                         torch.from_numpy(row), start, length)
    got, got_int = _live_pages(tcache), _live_pages(tcache_int)
    for key, want in jpool.items():
        want = np.asarray(want).astype(np.float32)[:, 1:]
        have = got[key].astype(np.float32)[:, 1:]
        np.testing.assert_array_equal(got[key], got_int[key], err_msg=key)
        if quant:
            np.testing.assert_array_equal(have, want, err_msg=key)
        else:
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        # every write to the trash page carries one value (zero, or a
        # zero entry's int8 scale), so their order cannot matter
        assert np.unique(got[key][:, 0]).size == 1, key
        if length <= start:  # nothing live written
            np.testing.assert_array_equal(got[key][:, 1:],
                                          before[key][:, 1:], err_msg=key)


@pytest.mark.parametrize("hist", [0, 11, NB * PAGE],
                         ids=["none", "mid-page", "full-row"])
@pytest.mark.parametrize("kv_bits", [8, 16])
def test_masked_hydrate_equals_jax(jq, kv_bits, hist):
    """The row [3, 7, 1, 5] hydrated into a 40-position workspace full of
    stale values: positions [0, hist) from the pages, zeros beyond (the
    8 positions past the row included), the reference's bits."""
    jcfg, tcfg, _, _ = _views(jq, "fused", kv_bits)
    row = np.array([3, 7, 1, 5], np.int32)
    jcache, tcache, _, tws = _pool_and_ws(jcfg, tcfg, seed=20 + kv_bits)
    _, _, _, tws_int = _pool_and_ws(jcfg, tcfg, seed=20 + kv_bits)
    jh = j_lm.lm_paged_hydrate(jcfg, jcache["pool"], jnp.asarray(row),
                               jnp.int32(hist), 40)
    t_lm.lm_paged_hydrate(tcfg, tcache["pool"], torch.from_numpy(row),
                          _i32(hist), tws)
    t_lm.lm_paged_hydrate(tcfg, tcache["pool"], torch.from_numpy(row), hist,
                          tws_int)
    for key in ("k", "v"):
        got = np.stack([w[key].numpy() for w in tws])
        np.testing.assert_array_equal(got, np.asarray(jh[key]), err_msg=key)
        np.testing.assert_array_equal(
            got, np.stack([w[key].numpy() for w in tws_int]))
        assert not got[:, :, hist:].any()


# ---------------------------------------------------------------------------
# the engine's prefill steps
# ---------------------------------------------------------------------------

def _engine(tcfg, model, **kw):
    return Engine(model, tcfg, capacity=2, max_len=kw.pop("max_len", 40),
                  kv_pages=16, page_size=8, prefill_pack=False,
                  device="cpu", **kw)


def _prefill_buffers(eng):
    out = {"tok": eng.chunk_tok, "start": eng.chunk_start,
           "n_real": eng.chunk_n_real, "hit": eng.chunk_hit,
           "length": eng.chunk_length, "row": eng.chunk_row,
           "logits": eng.chunk_logits}
    for i, w in enumerate(eng.ws):
        for key, t in w.items():
            out[f"ws{i}/{key}"] = t
    return out


def test_warmup_runs_every_prefill_step(jq):
    """The warmup calls the hydrate, one chunk of each bucket width and
    the splice (each captured there on CUDA), then the decode step; it
    leaves the prefill's scalars and logits zero and counts no launch."""
    _, tcfg, _, model = _views(jq, "fused", kv_bits=8)
    calls = []

    class Recording(Engine):
        def _hydrate_step(self):
            calls.append("hydrate")
            super()._hydrate_step()

        def _prefill_chunk(self, width):
            calls.append(f"chunk{width}")
            super()._prefill_chunk(width)

        def _splice_step(self):
            calls.append("splice")
            super()._splice_step()

        def _decode_step(self):
            calls.append("decode")
            super()._decode_step()

    before = ops.read_counts()
    eng = Recording(model, tcfg, capacity=2, max_len=40, kv_pages=16,
                    page_size=8, prefill_pack=False, device="cpu")
    assert ops.read_counts() == before
    assert eng.buckets == t_paged_kv.prefill_buckets(64) == (16, 32, 64)
    assert calls == ["hydrate", "chunk16", "chunk32", "chunk64", "splice",
                     "decode"]
    for name in ("start", "n_real", "hit", "length", "row", "logits"):
        assert not _prefill_buffers(eng)[name].any(), name
    assert eng.paged_trace_counts() == {"decode": 0, "chunk": 0,
                                        "hydrate": 0, "splice": 0}
    calls.clear()
    toks = tokens(tcfg, 1, 37, seed=3)
    eng.submit(toks[0], max_new=2)
    eng.run()
    # 37 tokens: one chunk padded to 64, then one decode step
    assert calls == ["hydrate", "chunk64", "splice", "decode"]


def test_prefill_buffers_keep_their_addresses(jq):
    """A queue with a prefix hit and prompts of one and two chunks: the
    buffers the prefill graphs read and write never move."""
    _, tcfg, _, model = _views(jq, "fused", kv_bits=8)
    eng = _engine(tcfg, model, max_chunk=16)
    bufs = _prefill_buffers(eng)
    ptrs = {k: t.data_ptr() for k, t in bufs.items()}
    toks = tokens(tcfg, 3, 36, seed=6)
    toks[1, :16] = toks[0, :16]  # two shared pages
    for i, L in enumerate((20, 36, 9)):
        eng.submit(toks[i, :L], max_new=4)
    while not eng.idle:
        eng.step()
        assert {k: t.data_ptr() for k, t in
                _prefill_buffers(eng).items()} == ptrs
    st = eng.stats()
    # chunks: 16 + 4 of the first prompt, 20 past the hit, 9
    assert st["prefix_hits"] > 0 and st["prefill_chunk_calls"] == 5


def test_prefill_workspace_from_the_paged_reference(jq):
    """The engine's chunked prefill of one prompt through its buffers
    leaves the logits and the workspace of the JAX reference's chunks
    (logits within 1e-4 of max|logit|, workspace within 1e-5)."""
    jcfg, tcfg, js, model = _views(jq, "fused", kv_bits=16)
    eng = _engine(tcfg, model, max_len=96, max_chunk=16)
    toks = tokens(tcfg, 1, 70, seed=8)[0]
    eng.submit(toks, max_new=1)
    eng.run()
    wws = j_paged_kv.workspace_len(96, eng.n_blocks, 8)
    assert wws == eng.wws
    chunk = jax.jit(lambda p, t, w, s, n: j_lm.lm_paged_prefill_chunk(
        p, jcfg, t, w, s, n), compiler_options=STRICT)
    jws = j_lm.init_paged_workspace(jcfg, wws)
    # chunks of 16 at 0..64: the last reads a slab moved past 0
    for start, width, n_real in j_paged_kv.chunk_plan(70, 0, 16):
        t = np.zeros((1, width), np.int32)
        t[0, :n_real] = toks[start:start + n_real]
        jl, jws = chunk(js, jnp.asarray(t), jws, jnp.int32(start),
                        jnp.int32(n_real))
    jl = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(eng.chunk_logits.numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    assert eng.results[0]["tokens"][0] == int(jl[0, -1].argmax())
    for key in ("k", "v"):
        want = np.asarray(jws[key])[:, 0, :70]
        got = np.stack([w[key][0, :70].numpy() for w in eng.ws])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
