"""Port parity, seamless-m4t-medium (the encdec family), the model: reduced
(2 encoder + 2 decoder layers, d_model 64, 4 / 4 heads of 16, d_ff 96,
vocab 211, tied readout) against the JAX package on the same
numpy-seeded inputs, weights through ``interop.from_jax``.

Held bit for bit: the config's fields; ``from_jax`` / ``to_numpy`` of
the ``encoder`` / ``decoder`` stacks; assignments, dictionaries and rule
ids after ``quantize``; a W = 4 decode window against 4 chained port
steps (logits and caches); the paged splice's pages (the trash page
aside: the port writes zeros there, see ``encdec_paged_splice``) and
cross K/V slabs against the reference's.

Tolerances (of max|reference|, float32 unless named):

* ``flash_attention(causal=False)``: 1e-6 (the same f32 online softmax,
  its sums in another order);
* ``encode`` and ``cross_kv``: 1e-5; ``encdec_prefill`` logits and
  caches with ragged target lengths: 1e-5 in float32, in bfloat16 2^-7
  (an ulp of the largest value: the port's bf16 products and norms round
  where XLA's do under ``STRICT``, each product summed in another order);
* decode logits along the reference's tokens at act_bits 32: 1e-4 (the
  error of each step's cache compounds), as the other families' tests;
* the window against the reference's ``encdec_decode_window``, the
  paged decode step against ``encdec_paged_decode_step`` and against the
  port's slot step: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import STRICT, cfg_pair, one_thread, to_np, tokens

from repro.configs import get_config as jget
from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro.models import encdec as jenc
from repro.models.reduce import reduced as jreduced
from repro.nn.attention import flash_attention as j_flash
from repro.runtime import serving as jserving
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tenc
from repro_torch.models import lm as tlm
from repro_torch.models.reduce import reduced as treduced
from repro_torch.nn.attention import flash_attention as t_flash
from repro_torch.nn.tree import logical_path
from repro_torch.runtime import serving as tserving

ARCH = "seamless-m4t-medium"
B, P, S_SRC, STEPS = 2, 9, 11, 4
LENS = np.array([9, 6], np.int32)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    """Reduced seamless, the config's 4-bit pow2 LUT-Q at the helpers'
    floor, act_bits 32 unless given (``quant=None``: float), both
    packages."""
    fp = "quant" in kw and kw.pop("quant") is None
    kw.setdefault("act_bits", 32)
    jcfg, tcfg = cfg_pair(dtype, arch=ARCH, constraint="pow2", remat=False,
                          **kw)
    if fp:
        return jcfg.replace(quant=None), tcfg.replace(quant=None)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ed():
    """The JAX float params and their quantized tree."""
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    return dict(params=params, jq=japi.quantize(params, jcfg, axes))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _inputs(seed=0, width=S_SRC):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, width, 64).astype(np.float32),
            tokens(_cfgs()[0], B, P, seed=seed + 1))


def _model(ed, tcfg, quant=True):
    return interop.from_jax(to_np(ed["jq" if quant else "params"]), tcfg)


def _served(ed, tcfg):
    """The int8 serve view: its products run the fused kernel's plain
    version, whose rows are the same bits in a product of any number of
    rows up to ``ROW_STABLE_M`` (a train-form leaf's float matmul is
    not)."""
    return t_serve_view(_model(ed, tcfg), policy=tapi.resolved_policy(tcfg))


def _jit(fn):
    return jax.jit(fn, compiler_options=STRICT)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield prefix + (f,), getattr(tree, f)
    else:
        yield prefix, tree


def assert_trees_equal(a, b, only=None):
    """Same structure, dtypes and bytes (None fields must match); with
    ``only`` the paths that hold that key."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if only is not None:
        la = {k: v for k, v in la.items() if only in k}
        lb = {k: v for k, v in lb.items() if only in k}
    assert sorted(la) == sorted(lb) and la
    for k in la:
        if la[k] is None or lb[k] is None:
            assert la[k] is None and lb[k] is None, k
            continue
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8),
                                      err_msg="/".join(k))


# ---------------------------------------------------------------------------
# config, tree, quantize
# ---------------------------------------------------------------------------

FIELDS = ("family", "n_layers", "enc_layers", "d_model", "n_heads",
          "n_kv_heads", "d_ff", "vocab", "head_dim", "rope_theta",
          "tie_embeddings", "act_bits", "quant", "window", "qkv_bias",
          "kv_cache_bits", "quantize_embed")


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_equals_reference(reduce):
    """Every field of the config (and of its reduced form: 2 + 2 layers,
    4 / 4 heads of 16) equals the reference's; the API admits it, pages
    it and admits its speculation at act_bits 32 only, as the reference;
    the decoder-only LM entry points refuse it."""
    ref, cfg = jget(ARCH), tget(ARCH)
    assert ARCH in list_archs()
    if reduce:
        ref, cfg = jreduced(ref), treduced(cfg)
        assert (cfg.n_layers, cfg.enc_layers, cfg.n_heads,
                cfg.n_kv_heads) == (2, 2, 4, 4)
    for f in FIELDS:
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    tapi._ported(cfg)
    assert tapi.paged_supported(cfg) and japi.paged_supported(ref)
    for ab in (8, 32):
        assert tapi.speculative_supported(cfg.replace(act_bits=ab)) == \
            japi.speculative_supported(ref.replace(act_bits=ab))
    with pytest.raises(ValueError, match="encoder-decoder"):
        tlm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        tlm.init_lm(None, cfg, device="meta")


def test_interop_round_trip_and_paths(ed):
    """from_jax / to_numpy carry the encoder and decoder stacks (split a
    layer at a time) both ways, bit for bit; state-dict keys and logical
    paths are the reference's."""
    _, tcfg = _cfgs()
    model = _model(ed, tcfg)
    assert len(model.encoder) == 2 and len(model.decoder) == 2
    keys = set(model.state_dict())
    assert {"embed.table.a", "encoder.1.attn.q.kernel.d",
            "decoder.0.xattn.k.kernel.a", "decoder.1.ln_x.scale",
            "enc_norm.scale", "final_norm.scale"} <= keys
    assert logical_path(("decoder", "1", "xattn", "o", "kernel")) == (
        ("decoder", "xattn", "o", "kernel"), 1)
    assert_trees_equal(to_np(ed["jq"]), interop.to_numpy(model))
    fp = _model(ed, _cfgs(quant=None)[1], quant=False)
    assert_trees_equal(to_np(ed["params"]), interop.to_numpy(fp))


def test_quantize_bit_exact(ed):
    """quantize on the same float params: masters, assignments,
    dictionaries and rule ids byte for byte, the tied table and every
    cross-attention leaf among them."""
    _, tcfg = _cfgs()
    model = tapi.quantize(_model(ed, _cfgs(quant=None)[1], quant=False),
                          tcfg)
    got = interop.to_numpy(model)
    for k in ("w", "d", "a", "sid"):
        assert_trees_equal(to_np(ed["jq"]), got, only=k)
    assert hasattr(got["embed"]["table"], "d")
    assert all(hasattr(got["decoder"]["xattn"][k]["kernel"], "d")
               for k in ("q", "k", "v", "o"))


# ---------------------------------------------------------------------------
# the blocks: unmasked attention, encoder, cross K/V, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,Skv,qb,kb", [(9, 11, 16, 16), (20, 13, 8, 4)])
def test_flash_attention_unmasked_matches(S, Skv, qb, kb):
    """causal=False: every query attends every key, the reference's
    blocked online softmax (padded kv blocks masked), within 1e-6."""
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 4, 16).astype(np.float32)
    k = rng.randn(2, Skv, 4, 16).astype(np.float32)
    v = rng.randn(2, Skv, 4, 16).astype(np.float32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, q_block=qb, kv_block=kb)
    got = t_flash(_t(q), _t(k), _t(v), causal=False, q_block=qb,
                  kv_block=kb)
    _close(got, want, 1e-6)


def test_encode_and_cross_kv_match(ed):
    """The encoder's memory and every decoder layer's cross K/V."""
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.replace(kernel_backend="decode")
    frames, _ = _inputs(3)
    jm = _jit(lambda p, f: jenc.encode(p, jcfg, f))(ed["jq"], frames)
    model = _model(ed, tcfg)
    with torch.no_grad():
        tm = tenc.encode(model, tcfg, _t(frames))
        _close(tm, jm, 1e-5)
        for i, layer in enumerate(model.decoder):
            jp = jax.tree.map(lambda x: x[i], ed["jq"]["decoder"]["xattn"])
            jk, jv = jenc.cross_kv(jp, jcfg, jm)
            tk, tv = tenc.cross_kv(layer.xattn, tcfg, tm)
            assert tk.shape == (B, S_SRC, 4, 16)
            _close(tk, jk, 1e-5)
            _close(tv, jv, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_ragged(ed, dtype):
    """encdec_prefill at ragged target lengths: last-real-token logits,
    every layer's k, v, xk, xv, len and src_len, in the reference's
    layout (``interop.cache_to_numpy``)."""
    jcfg, tcfg = _cfgs(dtype)
    frames, toks = _inputs(5)
    jl, jc = _jit(lambda p, f, t, n: jenc.encdec_prefill(
        p, jcfg.replace(kernel_backend="decode"), f, t, lengths=n))(
            ed["jq"], frames, toks, LENS)
    model = _model(ed, tcfg)
    with torch.no_grad():
        tl, tc = tapi.prefill(model, tcfg, {"frames": _t(frames),
                                            "tokens": _t(toks)},
                              lengths=_t(LENS))
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (B, 1, 211)
    _close(tl, jl, TOL[dtype])
    got = interop.cache_to_numpy(tc, tcfg)
    assert sorted(got) == sorted(jc) == ["layers", "len", "src_len"]
    for k in ("k", "v", "xk", "xv"):
        assert got["layers"][k].shape == jc["layers"][k].shape, k
        _close(got["layers"][k], jc["layers"][k], TOL[dtype])
    np.testing.assert_array_equal(got["len"], LENS)
    np.testing.assert_array_equal(got["src_len"], np.asarray(jc["src_len"]))
    back = interop.cache_from_jax(to_np(jc), tcfg)
    assert [sorted(c) for c in back["layers"]] == [["k", "v", "xk", "xv"]] * 2
    assert back["src_len"].tolist() == [S_SRC] * B


def test_adapt_prefill_cache_pads_cross_kv(ed):
    """adapt_prefill_cache grows k / v to max_len and xk / xv to the
    engine's src_len (zeros past the frames), keeps the prefill's
    src_len, and quantizes nothing, as the reference's."""
    jcfg, tcfg = _cfgs()
    frames, toks = _inputs(6)
    model = _model(ed, tcfg)
    with torch.no_grad():
        _, tc = tapi.prefill(model, tcfg, {"frames": _t(frames),
                                           "tokens": _t(toks)})
    for bits in (16, 8):
        out = tserving.adapt_prefill_cache(
            tcfg.replace(kv_cache_bits=bits), tc, B, P + 5, src_len=16)
        want = jserving.adapt_prefill_cache(
            jcfg.replace(kv_cache_bits=bits),
            jax.tree.map(jnp.asarray, interop.cache_to_numpy(tc, tcfg)), B,
            P + 5, src_len=16)
        got = interop.cache_to_numpy(out, tcfg)
        for path, w in _leaves(to_np(want)):
            g = dict(_leaves(got))[path]
            assert g.shape == w.shape and g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w, err_msg="/".join(path))
        assert out["layers"][0]["xk"].shape == (B, 16, 4, 16)
        assert out["src_len"].tolist() == [S_SRC] * B


# ---------------------------------------------------------------------------
# decode: steps, windows, the paged cache
# ---------------------------------------------------------------------------

def _jax_loop(jcfg, params, frames, toks, steps, max_len):
    """The reference's prefill -> adapt -> argmax -> decode loop, jitted
    with STRICT: (per-step logits (B, V), tokens (B, steps))."""
    prefill = _jit(lambda p, b: japi.prefill(p, jcfg, b))
    decode = _jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    logits, cache = prefill(params, {"frames": frames, "tokens": toks})
    cache = jserving.adapt_prefill_cache(jcfg, cache, B, max_len,
                                         src_len=frames.shape[1])
    outs, toks_out = [], []
    for t in range(steps):
        if t:
            logits, cache = decode(params, tok, cache)
        lg = logits[:, -1].astype(jnp.float32)
        outs.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        toks_out.append(np.asarray(tok))
    return outs, np.concatenate(toks_out, axis=1)


def _port_cache(model, tcfg, frames, toks, max_len):
    with torch.no_grad():
        logits, c = tapi.prefill(model, tcfg, {"frames": _t(frames),
                                               "tokens": _t(toks)})
    return logits, tserving.adapt_prefill_cache(tcfg, c, B, max_len,
                                                src_len=frames.shape[1])


def test_decode_logits_along_reference_tokens(ed):
    """At act_bits 32 the port's prefill and decode-step logits, fed the
    reference's greedy tokens, stay within 1e-4 of max|logit|."""
    jcfg, tcfg = _cfgs()
    frames, toks = _inputs(7)
    want_logits, want = _jax_loop(jcfg.replace(kernel_backend="decode"),
                                  ed["jq"], frames, toks, STEPS, P + STEPS)
    model = _model(ed, tcfg)
    logits, cache = _port_cache(model, tcfg, frames, toks, P + STEPS)
    got = [logits[:, -1].float().numpy()]
    with torch.no_grad():
        for t in range(1, STEPS):
            logits, cache = tapi.decode_step(model, tcfg,
                                             _t(want[:, t - 1:t]), cache)
            got.append(logits[:, -1].float().numpy())
    for t, (g, w) in enumerate(zip(got, want_logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"step {t}")


def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache.clone()


def test_window_equals_chained_steps_and_reference(ed):
    """A W = 4 window gives each row the bits of 4 chained one-token
    steps (logits and every cache leaf), and is within 1e-5 of the
    reference's ``encdec_decode_window``."""
    jcfg, tcfg = _cfgs()
    frames, toks = _inputs(8)
    model = _served(ed, tcfg)
    _, cache = _port_cache(model, tcfg, frames, toks, P + 6)
    win = np.random.RandomState(9).randint(0, 211, (B, 4)).astype(np.int32)
    a, b = _clone(cache), _clone(cache)
    with torch.no_grad():
        wl, wc = tapi.decode_window(model, tcfg, _t(win), a)
        steps = []
        for i in range(4):
            lg, b = tapi.decode_step(model, tcfg, _t(win[:, i:i + 1]), b)
            steps.append(lg)
    assert torch.equal(wl, torch.cat(steps, dim=1))
    assert torch.equal(wc["len"], b["len"]) and wc["len"].tolist() == [
        P + 4] * B
    for ca, cb in zip(wc["layers"], b["layers"]):
        for k in ca:
            assert torch.equal(ca[k], cb[k]), k
    jc = jax.tree.map(jnp.asarray, interop.cache_to_numpy(cache, tcfg))
    js = j_serve_view(ed["jq"], policy=japi.resolved_policy(jcfg))
    jl, _ = _jit(lambda p, t, c: jenc.encdec_decode_window(
        p, jcfg.replace(kernel_backend="decode"), t, c))(js, win, jc)
    _close(wl, jl, 1e-5)


def _jax_paged(jcfg, params, frames_list, toks_list, page, n_pages, nb,
               src_len):
    """A reference paged cache holding each request's prefill, spliced
    to its pages (request i: pages 1 + i * nb ...), its block row, len
    and src_len set; and the prefill layers."""
    cache = jenc.init_paged_encdec_cache(jcfg, B, n_pages, page, nb, src_len)
    prefills = []
    for i, (f, t) in enumerate(zip(frames_list, toks_list)):
        L = t.shape[0]
        width = 16
        tt = np.zeros((1, width), np.int32)
        tt[0, :L] = t
        _, pc = _jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n))(
            params, {"tokens": tt, "frames": f[None]},
            jnp.asarray([L], jnp.int32))
        row = np.zeros(nb, np.int32)
        row[:2] = [1 + 2 * i, 2 + 2 * i]
        prefills.append((pc["layers"], row, L, i))
        cache = jenc.encdec_paged_splice(jcfg, cache, pc["layers"],
                                         jnp.asarray(row), jnp.int32(L),
                                         jnp.int32(i))
        cache["block"] = cache["block"].at[i].set(jnp.asarray(row))
        cache["len"] = cache["len"].at[i].set(L)
        cache["src_len"] = cache["src_len"].at[i].set(f.shape[0])
    return cache, prefills


def test_paged_splice_and_decode_step_match(ed):
    """The port's splice of the reference's prefill layers gives its
    pages (but the trash page) and cross K/V slabs bit for bit, its
    block, len and src_len; one paged decode step is within 1e-5 of the
    reference's ``encdec_paged_decode_step`` in logits and pages."""
    jcfg, tcfg = _cfgs()
    jcfg = jcfg.replace(kernel_backend="decode")
    rng = np.random.RandomState(10)
    frames = [rng.randn(s, 64).astype(np.float32) for s in (11, 7)]
    toks = [rng.randint(0, 211, n).astype(np.int32) for n in (9, 5)]
    jcache, prefills = _jax_paged(jcfg, ed["jq"], frames, toks, 8, 6, 3, 12)
    tcache = tapi.init_paged_cache(tcfg, B, 6, 8, 3, src_len=12,
                                   device="cpu")
    for layers, row, L, slot in prefills:
        pl = interop.cache_from_jax(to_np({"layers": layers, "len": [L]}),
                                    tcfg)["layers"]
        tserving.paged_encdec_splice(tcfg, tcache, pl, _t(row), L, slot)
        tcache["block"][slot] = _t(row)
        tcache["len"][slot] = L
        tcache["src_len"][slot] = frames[slot].shape[0]
    got, want = interop.paged_cache_to_numpy(tcache), to_np(jcache)
    for k in ("xk", "xv", "block", "len", "src_len"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got["pool"][k][:, 1:],
                                      want["pool"][k][:, 1:], err_msg=k)
        assert not got["pool"][k][:, 0].any()
    tok = np.array([[3], [17]], np.int32)
    jl, jc = _jit(lambda p, t, c: jenc.encdec_paged_decode_step(
        p, jcfg, t, c))(ed["jq"], tok, jcache)
    model = _model(ed, tcfg)
    with torch.no_grad():
        tl, tc = tapi.paged_decode_step(model, tcfg, _t(tok), tcache)
    _close(tl, jl, 1e-5)
    assert tc["len"].tolist() == [10, 6]
    after = interop.paged_cache_to_numpy(tc)
    for k in ("k", "v"):
        _close(after["pool"][k][:, 1:], np.asarray(jc["pool"][k])[:, 1:],
               1e-5)


def test_paged_window_equals_chained_paged_steps(ed):
    """A W = 3 paged window gives the bits of 3 chained paged steps, and
    the paged steps the slot path's logits within 1e-5."""
    _, tcfg = _cfgs()
    model = _served(ed, tcfg)
    frames, toks = _inputs(11, width=12)
    _, slot = _port_cache(model, tcfg, frames, toks, P + 4)
    paged = tapi.init_paged_cache(tcfg, B, 6, 8, 2, src_len=12, device="cpu")
    with torch.no_grad():
        _, pc = tapi.prefill(model, tcfg, {"frames": _t(frames),
                                           "tokens": _t(toks)})
    for i in range(B):
        row = torch.tensor([1 + 2 * i, 2 + 2 * i], dtype=torch.int32)
        layers = [{k: v[i:i + 1] for k, v in c.items()} for c in pc["layers"]]
        tenc.encdec_paged_splice(tcfg, paged, layers, row, P, i)
        paged["block"][i] = row
        paged["len"][i] = P
        paged["src_len"][i] = 12
    win = _t(np.random.RandomState(12).randint(0, 211, (B, 3)).astype(
        np.int32))
    a, b = _clone(paged), _clone(paged)
    with torch.no_grad():
        wl, wc = tapi.paged_decode_window(model, tcfg, win, a)
        chained, slots = [], []
        for i in range(3):
            lg, b = tapi.paged_decode_step(model, tcfg, win[:, i:i + 1], b)
            chained.append(lg)
            sl, slot = tapi.decode_step(model, tcfg, win[:, i:i + 1], slot)
            slots.append(sl)
    assert torch.equal(wl, torch.cat(chained, dim=1))
    # the paged kernel's plain version and the slot path's attention sum
    # in other orders
    _close(torch.cat(chained, dim=1), torch.cat(slots, dim=1).numpy(), 1e-5)
    for ca, cb in zip(wc["pool"], b["pool"]):
        assert all(torch.equal(ca[k], cb[k]) for k in ca)
