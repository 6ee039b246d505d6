"""Port parity, self-speculative decoding: the draft view, the accept
rules, the verify windows and the speculative engine, against the JAX
package and against the port's own non-speculative decoding.

Weights: reduced h2o-danube-1.8b at 4-bit LUT-Q (``QuantSpec(bits=4,
min_size=1024)``, K = 16), float32 activations (``act_bits=32``: the
reference refuses speculation under activation quantization), from the
JAX init -> quantize -> ``serve_view`` that ``api.serve_state`` runs,
carried across by ``interop.from_jax``. Drafts come from a 2-bit view
(K' = 4), so rounds both accept and reject.

Tolerances: coarse dictionaries within 1e-6 relative of the JAX ones
(float32 sums of up to 16 terms in another order); remapped indices,
packed bytes, report bytes, tokens and acceptance counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import cfg_pair, one_thread, to_np

from repro.core.lutq import LutqState as JState
from repro.core.lutq import coarsen_dictionary as j_coarsen
from repro.core.lutq import pow2_encode as j_pow2_encode
from repro.core.lutq import pow2_round as j_pow2_round
from repro.core.spec import QuantSpec as JSpec
from repro.models import api as japi
from repro.runtime.engine import Engine as JEngine
from repro.runtime.speculative import greedy_accept as j_greedy_accept
from repro_torch import interop
from repro_torch.core.lutq import LutqState
from repro_torch.core.lutq import coarsen_dictionary
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels import build
from repro_torch.kernels.ref import (lutq_gemv_packed_ref, lutq_matmul_ref,
                                     pack4_kin)
from repro_torch.launch import serve as t_serve_cli
from repro_torch.models import api as tapi
from repro_torch.nn.tree import tree_paths
from repro_torch.runtime import speculative as spec
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.serving import generate

#: ragged prompt lengths of the engine runs (the reference suite's)
LENS = [6, 11, 9, 7]
#: danube's five products (Kin, N) and its head, at full width
DANUBE = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
          (2560, 32000)]
#: the reduced config's products and head
REDUCED = [(64, 64), (64, 16), (64, 96), (96, 64), (64, 211)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg, tcfg = cfg_pair(act_bits=32, remat=False, **kw)
    return (jcfg.replace(quant=JSpec(bits=4, min_size=1024)),
            tcfg.replace(quant=TSpec(bits=4, min_size=1024)))


@pytest.fixture(scope="module")
def sv():
    """(jcfg, tcfg, JAX int8 serve tree, port int8 model, port packed
    model): the JAX ``api.serve_state`` tree carried across, and its
    packed serve view in the port."""
    jcfg, tcfg = _cfgs()
    j8, _ = japi.serve_state(jax.random.PRNGKey(0), jcfg)
    model = interop.from_jax(to_np(j8), tcfg)
    return (jcfg, tcfg, j8, model,
            t_serve_view(model, pack4=True,
                         policy=tapi.resolved_policy(tcfg)))


def _jax_draft(tree, bits):
    """JAX ``api.draft_view(tree, with_report=True)`` under one jit (its
    eager per-leaf vmaps compile op by op, several times slower); the
    report is taken while it traces."""
    report = {}

    def fn(t):
        view, rep = japi.draft_view(t, draft_bits=bits, with_report=True)
        report.update(rep)
        return view
    return jax.jit(fn)(tree), report


@pytest.fixture(scope="module")
def jdraft(sv):
    """The JAX draft view (2 bits) of the serve tree, and its report."""
    return _jax_draft(sv[2], 2)


def _prompts(cfg, seed=3, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (L,)).astype(np.int32) for L in lens]


# ---------------------------------------------------------------------------
# part 0: rows of a window product equal the decode step's rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Kin,N", DANUBE + REDUCED)
def test_plan_splits_row_stable_up_to_64_rows(Kin, N):
    """Every product of at most ROW_STABLE_M rows (and, through the LUT
    GEMMs, of at most GEMM_STABLE_M rows) gets the split count and kchunk
    of an 8-row decode (so its rows have the decode step's bits on the
    card); wider ones keep their own plan."""
    assert build.GEMM_STABLE_M >= build.ROW_STABLE_M
    for sms in (132, 114):
        want = build.plan_splits(8, N, Kin, sms)
        for M in range(1, build.GEMM_STABLE_M + 1):
            plan = build.plan_splits(M, N, Kin, sms)
            assert (plan["splits"], plan["kchunk"]) == (
                want["splits"], want["kchunk"]), (M, sms)
            assert (plan["bm"] <= 16) == (M <= 16)
    assert build.plan_splits(build.GEMM_STABLE_M + 1, N, Kin,
                             132)["bm"] == 128


@pytest.mark.parametrize("Kin,N", REDUCED + [(64, 256)])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_gemm_rows_equal_for_1_to_16_rows(Kin, N, packed):
    """The plain GEMM gives each row the same bits alone and inside any
    product of up to 16 rows (and 64), the 1-row product included."""
    rng = np.random.default_rng(Kin * 1000 + N)
    d = torch.from_numpy(np.sort(rng.standard_normal(16)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 16, (Kin, N)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal((64, Kin)).astype(np.float32))
    if packed:
        fn, w = lutq_gemv_packed_ref, pack4_kin(a)
    else:
        fn, w = lutq_matmul_ref, a
    full = fn(x, w, d)
    for M in range(1, 17):
        y = fn(x[:M], w, d)
        assert torch.equal(y, full[:M]), M
        for i in range(M):
            assert torch.equal(fn(x[i:i + 1], w, d)[0], y[i]), (M, i)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_window_rows_equal_chained_steps(sv, paged):
    """One verify window over W tokens gives each position the logits
    and K/V of W chained one-token decode steps, bit for bit."""
    _window_vs_steps(sv, paged, B=3, W=3)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B,W", [(14, 5), (70, 2)])
def test_wide_decode_window_rows_equal_chained_steps(sv, paged, B, W):
    """Windows of more than ROW_STABLE_M rows: 14 slots x 5 positions run
    their products over 4 positions (56 rows), then 1; 70 slots over one
    position at a time. Each position keeps the bits of chained steps."""
    assert B * W > build.ROW_STABLE_M
    _window_vs_steps(sv, paged, B=B, W=W)


def _window_vs_steps(sv, paged, B, W, P=7):
    _, tcfg, _, model, _ = sv
    toks = torch.from_numpy(np.random.RandomState(B).randint(
        0, tcfg.vocab, (B, P + W)).astype(np.int32))

    def fresh():
        logits, pc = tapi.prefill(model, tcfg, {"tokens": toks[:, :P]})
        if not paged:
            from repro_torch.runtime.serving import adapt_prefill_cache
            return adapt_prefill_cache(tcfg, pc, B, 24)
        cache = tapi.init_paged_cache(tcfg, B, 3 * B + 1, 8, 3,
                                      device="cpu")
        cache["block"].copy_(torch.arange(1, 3 * B + 1).reshape(B, 3))
        from repro_torch.models.lm import init_paged_workspace
        from repro_torch.runtime.serving import paged_chunk, paged_splice
        for b in range(B):
            ws = init_paged_workspace(tcfg, 24, device="cpu")
            paged_chunk(model, tcfg, toks[b:b + 1, :P], ws, 0, P)
            paged_splice(tcfg, cache["pool"], ws, cache["block"][b], 0, P)
        cache["len"].fill_(P)
        return cache

    step = tapi.paged_decode_step if paged else tapi.decode_step
    window = tapi.paged_decode_window if paged else tapi.decode_window
    with torch.inference_mode():
        c1 = fresh()
        chained = []
        for i in range(W):
            lg, c1 = step(model, tcfg, toks[:, P + i:P + i + 1], c1)
            chained.append(lg[:, 0])
        c2 = fresh()
        lw, c2 = window(model, tcfg, toks[:, P:], c2)
    assert torch.equal(lw, torch.stack(chained, dim=1))
    assert torch.equal(c1["len"], c2["len"])
    key = "pool" if paged else "layers"
    for a, b in zip(c1[key], c2[key]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# nested dictionaries and the draft view, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,k_out,shape", [(16, 8, (64, 32)),
                                           (256, 16, (64, 211)), (4, 4, (8, 8))])
def test_coarsen_dictionary_matches_jax(K, k_out, shape):
    rng = np.random.default_rng(K + k_out)
    d = np.sort(rng.standard_normal(K)).astype(np.float32)
    # a skewed histogram, with unused entries
    a = np.minimum(rng.geometric(4.0 / K, shape) - 1, K - 1).astype(np.int32)
    jd, jf = j_coarsen(jnp.asarray(d), jnp.asarray(a), k_out)
    td, tf = coarsen_dictionary(torch.from_numpy(d), torch.from_numpy(a),
                                k_out)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.dtype == torch.int32 and td.shape == (k_out,)
    assert (np.diff(td.numpy()) >= 0).all() and (np.diff(tf.numpy()) >= 0).all()
    assert tf.min() >= 0 and tf.max() < k_out
    with pytest.raises(ValueError):
        coarsen_dictionary(torch.from_numpy(d), torch.from_numpy(a), 2 * K)


def _pow2_tree(tree):
    """The tree with every dictionary rounded to powers of two and stored
    as its int8 sign+exponent plane (a pow2-encoded serve tree)."""
    def one(leaf):
        if not isinstance(leaf, JState):
            return leaf
        return leaf._replace(d=j_pow2_encode(j_pow2_round(leaf.d)))
    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(x, JState))


def _k256_tree(tree):
    """The tree with every leaf given a sorted 256-entry dictionary and
    indices over all of it, stored as int8 two's complement (>= 128
    negative)."""
    rng = np.random.default_rng(7)

    def one(leaf):
        if not isinstance(leaf, JState):
            return leaf
        d = np.sort(rng.standard_normal(leaf.d.shape[:-1] + (256,)) * 0.05,
                    axis=-1).astype(np.float32)
        a = rng.integers(0, 256, leaf.a.shape).astype(np.uint8).view(np.int8)
        return leaf._replace(d=jnp.asarray(d), a=jnp.asarray(a))
    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(x, JState))


def _states(np_tree, prefix=()):
    """{path: numpy LutqState} of a numpy tree in the reference layout."""
    out = {}
    if isinstance(np_tree, dict):
        for k, v in np_tree.items():
            out.update(_states(v, prefix + (k,)))
    elif hasattr(np_tree, "_fields"):
        out["/".join(prefix)] = np_tree
    return out


@pytest.mark.parametrize("tree", ["int8", "pow2", "k256"])
def test_draft_view_matches_jax(sv, jdraft, tree):
    """The port's draft view of the same serve tree (int8 and packed
    indices; pow2 planes; K = 256 indices stored as negative int8):
    remapped indices and packed bytes equal byte for byte, coarse
    dictionaries within 1e-6 relative, and the report (K, draft_K,
    shared, bytes) equal."""
    jcfg, tcfg, j8, model8, model4 = sv
    jt = {"int8": j8, "pow2": _pow2_tree(j8), "k256": _k256_tree(j8)}[tree]
    if tree == "k256":
        assert int(jt["layers"]["mlp"]["wi"]["kernel"].a.min()) < 0
    bits = 4 if tree == "k256" else 2
    jd, jrep = jdraft if tree == "int8" else _jax_draft(jt, bits)
    want = _states(to_np(jd))
    # the draft of a packed tree reads the same indices: the same view
    models = ([model8, model4] if tree == "int8"
              else [interop.from_jax(to_np(jt), tcfg)])
    for model in models:
        _check_draft(model, bits, want, jrep)


def _check_draft(model, bits, want, jrep):
    td, trep = tapi.draft_view(model, draft_bits=bits, with_report=True)
    assert trep == jrep
    assert sum(not v["shared"] for v in trep.values()) > 0
    got = _states(interop.to_numpy(td))
    assert want.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        assert g.a.dtype == w.a.dtype and g.d.dtype == w.d.dtype, path
        np.testing.assert_array_equal(g.a, w.a, err_msg=path)
        np.testing.assert_allclose(g.d, w.d, rtol=1e-6, atol=0, err_msg=path)
        if w.sid is not None:
            np.testing.assert_array_equal(g.sid, w.sid)
    # leaves the draft shares hold the target's tensors
    src = dict(tree_paths(model))
    for path, leaf in tree_paths(td):
        if isinstance(leaf, LutqState) and leaf.d.shape[-1] > (1 << bits):
            assert leaf.a.data_ptr() == src[path].a.data_ptr()
    shared, rep = tapi.draft_view(model, draft_bits=8, with_report=True)
    assert all(v["shared"] and v["draft_bytes"] == 0 for v in rep.values())


# ---------------------------------------------------------------------------
# accept rules
# ---------------------------------------------------------------------------

def test_greedy_accept_matches_jax():
    rng = np.random.default_rng(0)
    B, k, V = 6, 3, 11
    p = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    tgt = p.argmax(-1)
    d = tgt[:, :k].copy()
    for b in range(B):  # rows that match 0, 1, .. k positions
        if b % (k + 1) < k:
            d[b, b % (k + 1)] = (d[b, b % (k + 1)] + 1) % V
    jo, jn = j_greedy_accept(jnp.asarray(d, jnp.int32), jnp.asarray(p))
    to, tn = spec.greedy_accept(torch.from_numpy(d).to(torch.int32),
                                torch.from_numpy(p))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.tolist() == [1, 2, 3, 4, 1, 2]


def test_rejection_sampler_marginal_matches_target():
    """Leviathan's guarantee, as ``tests/test_speculative.py`` checks it:
    the first emitted token of a round is distributed as softmax(p_0/T)
    whatever q is. Total variation of 4000 rounds (fixed seed) against
    the exact target below 0.08, the reference test's bound."""
    V, k, temp, N = 12, 3, 0.9, 4000
    rng = np.random.default_rng(11)
    q_log = torch.from_numpy(rng.standard_normal((k, V)).astype(np.float32)
                             * 1.5)
    p_log = torch.from_numpy(rng.standard_normal((k + 1, V)).astype(
        np.float32) * 1.5)
    gen = torch.Generator().manual_seed(11)
    qprob = torch.softmax(q_log / temp, dim=-1)
    d = torch.stack([torch.multinomial(qprob[i], N, replacement=True,
                                       generator=gen)
                     for i in range(k)], dim=1).to(torch.int32)
    out, n_acc = spec.rejection_accept(
        [gen] * N, d, q_log.expand(N, k, V), p_log.expand(N, k + 1, V), temp)
    emp = np.bincount(out[:, 0].numpy(), minlength=V) / N
    target = torch.softmax(p_log[0] / temp, dim=-1).numpy()
    assert 0.5 * np.abs(emp - target).sum() < 0.08
    assert int(n_acc.min()) >= 1 and int(n_acc.max()) <= k + 1
    # a round that accepts everything emits the drafts, then a bonus
    full = n_acc == k + 1
    assert full.any() and torch.equal(out[full, :k], d[full])


# ---------------------------------------------------------------------------
# the engine and generate, greedy
# ---------------------------------------------------------------------------

def _run(eng, prompts, max_new, eos=None):
    for p in prompts:
        eng.submit(p, max_new=max_new, eos_id=eos)
    return [r["tokens"].tolist() for r in eng.run()], eng.stats()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_speculative_matches_plain_and_jax(sv, jdraft, paged):
    """Ragged requests through a 3-slot speculative engine (slot reuse,
    mid-flight admission): tokens equal the port's non-speculative
    engine and the JAX speculative engine (drafting from the JAX draft
    view), and rounds, decode steps and acceptance equal the JAX
    engine's."""
    jcfg, tcfg, j8, model, _ = sv
    prompts = _prompts(tcfg)
    kw = dict(capacity=3, max_len=40)
    if paged:
        kw.update(kv_pages=64, page_size=8, prefill_pack=False)
    base, _ = _run(Engine(model, tcfg, device="cpu", **kw), prompts, 12)
    eng = Engine(model, tcfg, speculative=2, draft_bits=2, device="cpu", **kw)
    got, st = _run(eng, prompts, 12)
    want, jst = _run(JEngine(j8, jcfg, speculative=2, draft_bits=2,
                             draft_params=jdraft[0], warmup=False, **kw),
                     prompts, 12)
    assert got == base
    assert got == want
    keys = ["spec_rounds", "decode_steps", "acceptance_rate",
            "spec_tokens_per_round", "new_tokens"]
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    rep = jdraft[1].values()
    assert st["draft_extra_bytes"] == sum(v["draft_bytes"] for v in rep)
    assert st["draft_coarse_leaves"] == sum(not v["shared"] for v in rep)
    assert 0.0 < st["acceptance_rate"] < 1.0
    assert st["spec_rounds"] == st["decode_steps"]
    # nothing is captured on the CPU
    none = {"decode": 0, "spec": 0}
    if paged:
        none.update(chunk=0, hydrate=0, splice=0)
    assert eng.paged_trace_counts() == none


def test_engine_speculative_wide_window(sv):
    """A 14-slot engine at k = 4 verifies 70 rows a round, more than
    ROW_STABLE_M: its tokens equal the non-speculative engine's."""
    _, tcfg, _, model, _ = sv
    prompts = _prompts(tcfg, seed=8, lens=[6, 11, 9, 7, 5, 8, 10] * 3)
    kw = dict(capacity=14, max_len=40)
    base, _ = _run(Engine(model, tcfg, device="cpu", **kw), prompts, 10)
    got, st = _run(Engine(model, tcfg, speculative=4, draft_bits=2,
                          device="cpu", **kw), prompts, 10)
    assert got == base
    assert st["spec_rounds"] > 0


def test_engine_speculative_swa_ring_int8(sv):
    """The ring case: max_len beyond the window, generations that wrap
    the ring several times, int8 KV with per-entry scales. The round
    snapshots and restores the columns it clobbers."""
    _, _, _, model, _ = sv
    _, tcfg = _cfgs(kv_cache_bits=8)
    prompts = _prompts(tcfg, seed=5, lens=(6, 9))
    kw = dict(capacity=3, max_len=80)
    assert spec.ring_width(tcfg, 80) == tcfg.window < 80
    base, _ = _run(Engine(model, tcfg, device="cpu", **kw), prompts, 50)
    got, st = _run(Engine(model, tcfg, speculative=2, draft_bits=2,
                          device="cpu", **kw), prompts, 50)
    assert got == base
    assert 0.0 < st["acceptance_rate"] < 1.0


@pytest.mark.parametrize("B", [1, 3])
def test_generate_speculative_equals_plain(sv, B):
    _, tcfg, _, _, model4 = sv
    toks = torch.from_numpy(np.random.RandomState(B).randint(
        0, tcfg.vocab, (B, 9)).astype(np.int32))
    lengths = torch.tensor([9, 6, 8][:B])
    base = generate(model4, tcfg, {"tokens": toks}, steps=10,
                    lengths=lengths, device="cpu")
    got, stats = generate(model4, tcfg, {"tokens": toks}, steps=10,
                          lengths=lengths, speculative=2, draft_bits=2,
                          return_stats=True, device="cpu")
    assert torch.equal(got, base)
    assert stats["spec_rounds"] == stats["decode_steps"] > 0
    assert stats["draft_extra_bytes"] > 0


def test_eos_inside_accepted_block_retires_same_step(sv):
    """With the target as its own draft every round accepts all k + 1
    tokens; an EOS in the middle of the second round's block truncates
    it there and retires the request in that step, with the tokens of
    the port's non-speculative engine up to the EOS."""
    _, tcfg, _, model, _ = sv
    prompt = _prompts(tcfg, seed=4, lens=(7,))
    k, max_new = 3, 14
    (base,), _ = _run(Engine(model, tcfg, capacity=1, max_len=30,
                             device="cpu"), prompt, max_new)
    # out[0] comes from prefill; round r emits out[1 + 4 (r - 1) ..]
    i = next(i for i in (6, 7, 3, 2) if base[i] not in base[:i])
    eng = Engine(model, tcfg, capacity=1, max_len=30, speculative=k,
                 draft_params=model, device="cpu")
    eng.submit(prompt[0], max_new=max_new, eos_id=base[i])
    done = []
    while not done:
        done = eng.step()
    assert done[0]["tokens"].tolist() == base[:i + 1]
    assert done[0]["finish"] == "eos"
    assert eng.n_decode_steps == (i - 1) // (k + 1) + 1
    assert eng.stats()["acceptance_rate"] == 1.0


def test_engine_temperature_rounds_reproduce(sv):
    """Temperature rounds (eager; draft samples and the Leviathan accept
    draw from each request's generator): every request gets its
    max_new tokens in range, a request submitted with a seed gets the
    same tokens again alone, and acceptance stays in [0, 1]."""
    _, tcfg, _, model, _ = sv
    prompts = _prompts(tcfg, seed=6, lens=(5, 8, 7))
    runs = []
    for ps, seeds in ((prompts, (11, 12, 13)), (prompts[1:2], (12,))):
        eng = Engine(model, tcfg, capacity=3, max_len=30, temperature=0.8,
                     speculative=2, draft_bits=2, device="cpu")
        for p, seed in zip(ps, seeds):
            eng.submit(p, max_new=10, seed=seed)
        res = eng.run()
        assert all(r["n_new"] == 10 for r in res)
        assert all(((r["tokens"] >= 0) & (r["tokens"] < tcfg.vocab)).all()
                   for r in res)
        assert 0.0 <= eng.stats()["acceptance_rate"] <= 1.0
        runs.append([r["tokens"].tolist() for r in res])
    assert runs[1][0] == runs[0][1]


# ---------------------------------------------------------------------------
# refusals and surface
# ---------------------------------------------------------------------------

def test_refusals(sv):
    _, tcfg, _, model, _ = sv
    # dynamic activation quantization couples the window's rows
    cfg8 = tcfg.replace(act_bits=8)
    ok, why = tapi.speculative_supported(cfg8)
    assert not ok and "act" in why
    with pytest.raises(ValueError, match="activation"):
        Engine(model, cfg8, capacity=2, max_len=32, speculative=2,
               device="cpu")
    with pytest.raises(SystemExit, match="refused"):
        t_serve_cli.main(["--arch", "h2o-danube-1.8b", "--reduced",
                          "--speculative", "2", "--device", "cpu"])
    # k < 1
    with pytest.raises(ValueError, match="k must be"):
        Engine(model, tcfg, capacity=2, max_len=32, speculative=-1,
               device="cpu")
    cache = tapi.init_cache(tcfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        spec.spec_round(model, model, tcfg, 0, torch.zeros((2, 1),
                        dtype=torch.int32), cache, paged=False)
    # the verify window must fit the SWA ring
    eff = spec.ring_width(tcfg, 40)
    with pytest.raises(ValueError, match="ring"):
        Engine(model, tcfg, capacity=2, max_len=40, speculative=eff,
               device="cpu")
    Engine(model, tcfg, capacity=2, max_len=40, speculative=eff - 1,
           draft_bits=2, device="cpu")
    # k tokens of headroom a request
    eng = Engine(model, tcfg, capacity=2, max_len=20, speculative=3,
                 draft_bits=2, device="cpu")
    with pytest.raises(ValueError, match="headroom"):
        eng.submit(np.arange(1, 10, dtype=np.int32), max_new=9)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new=9)


def test_serve_state_appends_the_draft_view():
    """The draft model of a serve state is ``api.draft_view`` of it: a
    coarse 2-bit view, packed where the reduction axis is even."""
    _, tcfg = _cfgs()
    model = tapi.serve_state(tcfg, device="cpu")
    draft = tapi.draft_view(model, draft_bits=2)
    coarse = [x for _, x in tree_paths(draft) if isinstance(x, LutqState)]
    assert coarse and all(x.d.shape == (4,) for x in coarse)
    assert all(x.a.dtype == torch.uint8 for _, x in tree_paths(draft)
               if isinstance(x, LutqState) and x.a.shape[0] % 2 == 0)
