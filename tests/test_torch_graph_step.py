"""Port parity, the engine's decode step as one function over fixed
buffers: the function a CUDA engine captures as a graph and replays, run
here on the CPU, where it is called.

* every buffer the step reads or writes (``tok``, ``cache["len"]``,
  ``cache["block"]``, every pool, ring and scale plane, the logits), and
  a paged engine's prefill buffers and workspace, keep their addresses
  across a whole serve, as a replayed graph needs;
* pending tokens are copies: a queue whose first retirement decision
  comes only after several steps gives, request by request, the tokens
  of the JAX reference's plain prefill/decode loop
  (``torch_port_helpers.jax_reference``), exactly;
* a paged engine's warm step at construction (the prefill's hydrate,
  chunk widths and splice, then the decode step), the counterpart of the
  reference's ``_warm_paged``, leaves every page but the trash page zero,
  ``len`` and ``tok`` zero, and the kernels' launch counts unchanged;
* an engine step inside a calibration block runs the step function, so
  its decode forwards fold into the record; ``api.calibrate`` drives a
  prefill directly and is not affected.
The parity tests of ``test_torch_engine.py``, ``test_torch_paged.py``,
``test_torch_generate.py`` and ``test_torch_pow2.py`` run through the
same step function. Tokens are compared exactly.
"""
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_quantized, jax_reference,
                                one_thread, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core import actquant
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import (flash_attn, kmeans_stats, lutq_gemv_packed,
                                 lutq_matmul, lutq_shift, ops, paged_attn)
from repro_torch.models import api as tapi
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime.engine import Engine


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


def _serve_pair(jq, kv_bits, pack4=True):
    """(JAX config, port config, JAX serve tree, port serve model)."""
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_bits)
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _engine(tcfg, model, paged, **kw):
    extra = (dict(kv_pages=12, page_size=8, prefill_pack=False)
             if paged else {})
    return Engine(model, tcfg, capacity=2, max_len=kw.pop("max_len", 24),
                  device="cpu", **extra, **kw)


def _step_buffers(eng):
    """Every tensor the decode step reads or writes, by name, and a paged
    engine's prefill buffers (the chunk's, hydrate's and splice's inputs
    and outputs and the workspace)."""
    out = {"tok": eng.tok, "logits": eng.logits, "len": eng.cache["len"]}
    if eng.paged:
        out["block"] = eng.cache["block"]
        for name in ("tok", "start", "n_real", "hit", "length", "row",
                     "logits"):
            out[f"chunk_{name}"] = getattr(eng, f"chunk_{name}")
        for i, w in enumerate(eng.ws):
            for key, t in w.items():
                out[f"ws{i}/{key}"] = t
    layers = eng.cache["pool"] if eng.paged else eng.cache["layers"]
    for i, c in enumerate(layers):
        for key, t in c.items():
            out[f"layer{i}/{key}"] = t
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_step_buffers_keep_their_addresses(jq, paged):
    _, tcfg, _, model = _serve_pair(jq, kv_bits=8)
    eng = _engine(tcfg, model, paged)
    bufs = _step_buffers(eng)
    assert any(k.endswith("k_scale") for k in bufs)  # int8 KV: scales too
    ptrs = {k: t.data_ptr() for k, t in bufs.items()}
    toks = tokens(tcfg, 3, 14, seed=5)
    for i, L in enumerate((6, 14, 9)):
        eng.submit(toks[i, :L], max_new=5)
    while not eng.idle:
        eng.step()
        now = _step_buffers(eng)
        assert now.keys() == bufs.keys()
        assert {k: t.data_ptr() for k, t in now.items()} == ptrs
    assert eng.n_decode_steps > 0 and len(eng.results) == 3


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_pending_rows_are_copies_of_the_token_buffer(jq, paged):
    """No request carries an EOS and each runs 8 tokens, so the first
    retirement decision pulls 7 steps' pending rows at once; a row that
    aliased the token buffer would repeat the last step's tokens."""
    jcfg, tcfg, js, model = _serve_pair(jq, kv_bits=16)
    eng = _engine(tcfg, model, paged, max_len=22)
    pulled = []
    materialize = eng._materialize

    def counting():
        pulled.append(len(eng._pending))
        materialize()
    eng._materialize = counting
    toks = tokens(tcfg, 3, 14, seed=6)
    lens, G = (7, 14, 10), 8
    for i, L in enumerate(lens):
        eng.submit(toks[i, :L], max_new=G)
    res = eng.run()
    assert max(pulled) >= G - 1
    for i, L in enumerate(lens):
        _, want = jax_reference(jcfg, js, toks[i:i + 1, :L], G)
        np.testing.assert_array_equal(res[i]["tokens"], want[0],
                                      err_msg=f"request {i} vs JAX loop")


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_paged_warm_step_writes_only_the_trash_page(jq, kv_bits):
    _, tcfg, _, model = _serve_pair(jq, kv_bits=kv_bits)
    before = ops.read_counts()
    eng = _engine(tcfg, model, paged=True)
    assert ops.read_counts() == before  # the warm step is not counted
    assert eng.stats()["t_warmup_s"] > 0
    # no graph on the CPU
    assert eng.paged_trace_counts() == {"decode": 0, "chunk": 0,
                                        "hydrate": 0, "splice": 0}
    assert not eng.cache["len"].any() and not eng.tok.any()
    assert not eng.cache["block"].any()
    wrote = False
    for pool in eng.cache["pool"]:
        for key, t in pool.items():
            assert not t[1:].any(), f"{key}: the warm step left a page"
            wrote |= bool(t[0].any())
    assert wrote  # the step ran: its K/V landed on the trash page
    cold = _engine(tcfg, model, paged=True, warmup=False)
    assert cold.stats()["t_warmup_s"] == 0.0
    assert not any(t.any() for pool in cold.cache["pool"]
                   for t in pool.values())


def test_warm_engine_serves_the_cold_engines_tokens(jq):
    _, tcfg, _, model = _serve_pair(jq, kv_bits=8)
    toks = tokens(tcfg, 3, 14, seed=7)
    out = {}
    for warmup in (True, False):
        eng = _engine(tcfg, model, paged=True, warmup=warmup)
        for i, L in enumerate((5, 14, 11)):
            eng.submit(toks[i, :L], max_new=6)
        out[warmup] = [r["tokens"] for r in eng.run()]
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_disable_graphs_runs_the_same_step(jq, paged):
    _, tcfg, _, model = _serve_pair(jq, kv_bits=16)
    toks = tokens(tcfg, 2, 12, seed=8)
    out = []
    for off in (False, True):
        eng = _engine(tcfg, model, paged)
        for i in range(2):
            eng.submit(toks[i], max_new=6)
        if off:
            with t_engine.disable_graphs():
                with t_engine.disable_graphs():  # nests
                    assert t_engine._GRAPHS_OFF == 2
                res = eng.run()
        else:
            res = eng.run()
        out.append([r["tokens"] for r in res])
    assert t_engine._GRAPHS_OFF == 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        with t_engine.disable_graphs():
            raise RuntimeError
    assert t_engine._GRAPHS_OFF == 0


def test_count_helpers_cover_every_kernel():
    dicts = ops.count_dicts()
    for mod in (lutq_matmul, lutq_gemv_packed, lutq_shift, kmeans_stats,
                paged_attn, flash_attn, ops):
        assert any(d is mod.COUNTS for d in dicts), mod.__name__
    assert any(d is paged_attn.VARIANTS for d in dicts)
    before = ops.read_counts()
    lutq_matmul.COUNTS["launches"] += 3
    paged_attn.VARIANTS["paged_attention"] += 2
    delta = ops.count_delta(before)
    ops.set_counts(before)
    assert ops.read_counts() == before
    ops.add_counts(delta)
    ops.add_counts(delta)
    after = ops.count_delta(before)
    ops.set_counts(before)
    assert sum(sum(d.values()) for d in after) == 10
    assert after[0]["launches"] == 6


def test_engine_steps_inside_a_calibration_block_record(jq):
    """The decode steps of an engine run inside ``capture_act_scales``
    fold their activations into the record, beyond what the prefills
    alone record. ``api.calibrate`` drives a prefill forward directly
    inside the same block, with no engine step, and records the same
    leaves."""
    _, tcfg, _, model = _serve_pair(jq, kv_bits=16)
    toks = tokens(tcfg, 2, 12, seed=9)
    recs = []
    for max_new in (1, 8):  # 1: prefill only, no decode step
        eng = _engine(tcfg, model, paged=True)
        assert not actquant.capturing()
        with actquant.capture_act_scales(model) as rec:
            assert actquant.capturing()
            for i in range(2):
                eng.submit(toks[i], max_new=max_new)
            eng.run()
        assert (eng.n_decode_steps > 0) == (max_new > 1)
        recs.append(rec)
    assert recs[0].keys() == recs[1].keys() and recs[0]
    assert all(recs[1][k] >= recs[0][k] for k in recs[0])
    assert any(recs[1][k] > recs[0][k] for k in recs[0])
    with torch.no_grad(), actquant.capture_act_scales(model) as rec:
        tapi.prefill(model, tcfg, {"tokens": torch.from_numpy(toks)})
    assert rec.keys() == recs[1].keys()
