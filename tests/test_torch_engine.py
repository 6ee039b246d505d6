"""Port parity, serving engine: the continuous-batching ``Engine`` (slot
pool and paged KV) and ``generate`` on top of it, against the JAX
package and the serving contract of ``docs/serving.md``.

Oracles (the reference's own engine tests on serve-form weights and its
EOS tests are red, ROADMAP queue 3, so they are not used):
  * float params (no LUT-Q, f32 activations): the port's engine gives
    the JAX ``Engine``'s tokens, request by request, on the paged path
    (shared prompt prefix, so the prefix cache hits) and on the slot
    path; and the same prefix-cache and page statistics.
  * serve-form params (4-bit LUT-Q, f32 activations, the plain versions
    of the kernels): each request's tokens equal the JAX plain
    prefill/decode loop's (``torch_port_helpers.jax_reference``) and the
    port's own solo ``generate``.
  * EOS: the request retires in the decode step that produced EOS,
    finishes "eos", and ``generate`` pads the stream with ``eos_id``.
  * temperature: a request's samples come from its own generator, so it
    gives the same tokens alone as in a mixed queue.
Tokens are compared exactly; f32 logits of the two packages differ by
~1e-6 of their scale (``test_torch_slice.py``), far from any argmax tie
on these inputs.
"""
import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_quantized, jax_reference,
                                one_thread, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_synthetic
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import lutq_gemv_packed, paged_attn
from repro_torch.launch import serve as t_serve_cli
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine, synthetic_requests


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


def _prompts():
    """A shared 18-token system prompt with three 4-token tails, then
    two unrelated ragged prompts: five requests for two slots."""
    rng = np.random.RandomState(4)
    sys_p = rng.randint(0, 211, 18)
    out = [np.concatenate([sys_p, rng.randint(0, 211, 4)]).astype(np.int32)
           for _ in range(3)]
    return out + [rng.randint(0, 211, n).astype(np.int32) for n in (6, 11)]


GEN = [4, 6, 5, 3, 6]


@pytest.mark.parametrize("paged", [True, False])
def test_engine_matches_jax_on_float_params(fp, paged):
    jcfg, tcfg, params, model = fp
    kw = dict(capacity=2, max_len=32)
    if paged:
        kw.update(kv_pages=16, page_size=8, prefill_pack=False)
    jeng = JEngine(params, jcfg, warmup=False, **kw)
    teng = Engine(model, tcfg, device="cpu", **kw)
    for p, g in zip(_prompts(), GEN):
        jeng.submit(p, max_new=g)
        teng.submit(p, max_new=g)
    jres, tres = jeng.run(), teng.run()
    assert [r["rid"] for r in tres] == [0, 1, 2, 3, 4]
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t["tokens"], j["tokens"],
                                      err_msg=f"request {t['rid']}")
        assert t["finish"] == j["finish"] == "length"
        assert t["kv_pages"] == j["kv_pages"]
    js, ts = jeng.stats(), teng.stats()
    keys = ["admitted", "completed", "decode_steps", "new_tokens", "paged"]
    if paged:
        keys += ["prefix_hits", "prefix_queries", "prefix_nodes",
                 "pages_peak", "pages_in_use", "prefill_chunk_calls",
                 "kv_bytes_per_token"]
        assert ts["prefix_hits"] > 0 and ts["prefix_hit_rate"] > 0
        teng.pkv.alloc.check()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}


@pytest.mark.parametrize("path,view,kv_bits", [
    ("paged", "packed4", 8), ("paged", "fused", 16), ("slot", "packed4", 8)])
def test_engine_serve_form_matches_plain_loop(jq, path, view, kv_bits):
    """Ragged requests, more than the slots, through serve-form LUT-Q
    weights: each equals the JAX plain loop run on it alone and the
    port's solo generate."""
    jcfg, tcfg = cfg_pair(act_bits=32, kv_cache_bits=kv_bits)
    pack4 = view == "packed4"
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, 3, 14, seed=1)
    lens, G, max_len = [6, 14, 9], 4, 20
    kw = (dict(kv_pages=12, page_size=8, prefill_pack=False)
          if path == "paged" else {})
    eng = Engine(model, tcfg, capacity=2, max_len=max_len, backend=view,
                 device="cpu", **kw)
    for i, L in enumerate(lens):
        eng.submit(toks[i, :L], max_new=G)
    before = lutq_gemv_packed.COUNTS["plain"]
    res = eng.run()
    assert eng.paged == (path == "paged")
    assert (lutq_gemv_packed.COUNTS["plain"] > before) == pack4
    for i, L in enumerate(lens):
        _, want = jax_reference(jcfg, js, toks[i:i + 1, :L], G)
        np.testing.assert_array_equal(res[i]["tokens"], want[0],
                                      err_msg=f"request {i} vs JAX loop")
        solo = tserving.generate(model, tcfg.replace(kernel_backend=view),
                                 {"tokens": torch.from_numpy(toks[i:i + 1, :L])},
                                 steps=G, max_len=max_len, device="cpu")
        np.testing.assert_array_equal(res[i]["tokens"], solo[0].numpy())


def _first_new_index(stream):
    """Smallest k >= 1 whose token does not occur earlier in the stream:
    an EOS id that a correct engine must stop at exactly there."""
    for k in range(1, len(stream)):
        if stream[k] not in stream[:k]:
            return k
    raise AssertionError(f"no fresh token in {stream}")


@pytest.mark.parametrize("paged", [True, False])
def test_eos_retires_in_the_step_that_produced_it(fp, paged):
    _, tcfg, _, model = fp
    toks = tokens(tcfg, 2, 8, seed=1)
    solo = tserving.generate(model, tcfg, {"tokens": torch.from_numpy(toks[:1])},
                             steps=8, max_len=24, device="cpu")[0].tolist()
    k = _first_new_index(solo)
    eos = solo[k]
    kw = dict(kv_pages=8, page_size=8, prefill_pack=False) if paged else {}
    eng = Engine(model, tcfg, capacity=2, max_len=24, device="cpu", **kw)
    rid = eng.submit(toks[0], max_new=8, eos_id=eos)
    other = eng.submit(toks[1], max_new=8)  # no EOS: runs to max_new
    steps = 0
    while rid not in eng.results:
        eng.step()
        steps += 1
    r = eng.results[rid]
    assert r["finish"] == "eos" and r["n_new"] == k + 1
    assert steps == k  # token 0 from prefill, token k from decode step k
    np.testing.assert_array_equal(r["tokens"], solo[:k + 1])
    # slot 0 (the first admitted) was freed the same step
    assert eng.slots[0] is None and int(eng.cache["len"][0]) == 0
    assert not paged or eng.pkv.rows[0] is None
    eng.run()
    assert eng.results[other]["finish"] == "length"
    assert eng.results[other]["n_new"] == 8
    got = tserving.generate(model, tcfg, {"tokens": torch.from_numpy(toks[:1])},
                            steps=8, max_len=24, eos_id=eos, device="cpu")
    got = got[0].tolist()
    assert got[:k + 1] == solo[:k + 1] and got[k + 1:] == [eos] * (7 - k)


def test_temperature_request_alone_equals_mixed(fp):
    """Three sampled requests with their own seeds through a 2-slot
    paged engine; each alone in an engine of the same shape gives the
    same tokens, and sampling moved some token off the greedy choice."""
    _, tcfg, _, model = fp
    prompts = _prompts()[2:]
    seeds = [11, 12, 13]
    kw = dict(capacity=2, max_len=32, kv_pages=16, page_size=8,
              prefill_pack=False, device="cpu")
    mixed = Engine(model, tcfg, temperature=0.8, **kw)
    greedy = Engine(model, tcfg, **kw)
    for p, s in zip(prompts, seeds):
        mixed.submit(p, max_new=6, seed=s)
        greedy.submit(p, max_new=6)
    got = [r["tokens"] for r in mixed.run()]
    want_greedy = [r["tokens"] for r in greedy.run()]
    for p, s, toks in zip(prompts, seeds, got):
        alone = Engine(model, tcfg, temperature=0.8, **kw)
        alone.submit(p, max_new=6, seed=s)
        np.testing.assert_array_equal(alone.run()[0]["tokens"], toks)
    assert any((a != b).any() for a, b in zip(got, want_greedy))


def test_generate_temperature_stream_is_the_engine_request(fp):
    """generate's stream i samples from the generator a solo engine with
    the same seed gives its request i."""
    _, tcfg, _, model = fp
    toks = tokens(tcfg, 2, 10, seed=3)
    got = tserving.generate(model, tcfg, {"tokens": torch.from_numpy(toks)},
                            steps=5, temperature=0.7, seed=9, device="cpu")
    eng = Engine(model, tcfg, capacity=2, max_len=15, temperature=0.7,
                 seed=9, device="cpu")
    for i in range(2):
        eng.submit(toks[i], max_new=5)
    for i, r in enumerate(eng.run()):
        np.testing.assert_array_equal(got[i].numpy(), r["tokens"])


def test_paged_window_release_zeroes_device_entries(fp):
    """Past window + page the engine frees a live row's early pages and
    their device block entries read 0; the allocator stays consistent
    and, once idle, holds only prefix-cache pages."""
    _, tcfg, _, model = fp
    assert tcfg.window == 24
    toks = tokens(tcfg, 2, 30, seed=2)
    eng = Engine(model, tcfg, capacity=2, max_len=48, kv_pages=20,
                 page_size=8, prefill_pack=False, device="cpu")
    for i in range(2):
        eng.submit(toks[i], max_new=12)
    freed = 0
    while not eng.idle:
        eng.step()
        eng.pkv.alloc.check()
        block = eng.cache["block"].numpy()
        for slot, row in enumerate(eng.pkv.rows):
            if row is None or eng.slots[slot] is None:
                continue
            dead = [j for j, p in enumerate(row) if p == 0]
            freed = max(freed, len(dead))
            assert (block[slot, dead] == 0).all()
            np.testing.assert_array_equal(block[slot], row)
    assert freed >= 2
    held = {n.page for n in eng.pkv.prefix._nodes.values()}
    assert eng.pkv.alloc.pages_in_use == len(held)


def test_synthetic_requests_match_jax():
    jcfg, tcfg = cfg_pair()
    a = j_synthetic(jcfg, 6, max_prompt=40, max_new=16, seed=3, rate=2.0)
    b = synthetic_requests(tcfg, 6, max_prompt=40, max_new=16, seed=3,
                           rate=2.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        assert (x["max_new"], x["arrival_s"]) == (y["max_new"], y["arrival_s"])


def test_engine_refuses_unported_options(fp):
    _, tcfg, _, model = fp
    # speculative decoding is ported: it refuses what the reference
    # refuses (tests/test_torch_speculative.py holds the rest)
    with pytest.raises(ValueError, match="activation quantization"):
        Engine(model, tcfg.replace(act_bits=8), speculative=2, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, multi-GPU"):
        Engine(model, tcfg, mesh=object(), device="cpu")
    # packed prefill is ported: a paged engine at act_bits 32 packs
    # (tests/test_torch_packed.py holds it)
    assert Engine(model, tcfg, kv_pages=8, page_size=8,
                  device="cpu").prefill_pack
    eng = Engine(model, tcfg, device="cpu")
    # encdec frames and vlm prefixes are ported (tests/test_torch_encdec
    # .py, tests/test_torch_vlm.py); a dense engine refuses a prefix
    with pytest.raises(ValueError, match="prefix_embeds are for a vlm"):
        eng.submit(np.arange(4), max_new=2,
                   prefix_embeds=np.zeros((3, 64)))
    with pytest.raises(ValueError):
        eng.submit(np.arange(120), max_new=20)  # 120 + 20 > max_len 128
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32), max_new=1)


def test_cli_engine_serves_on_cpu(capsys):
    before = (paged_attn.COUNTS["launches"], paged_attn.COUNTS["plain"])
    assert t_serve_cli.main([
        "--arch", "h2o-danube-1.8b", "--reduced", "--engine", "--kv-pages",
        "24", "--page-size", "16", "--max-batch", "2", "--queue", "4",
        "--prompt-len", "30", "--gen", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] engine: 4/4 requests on 2 slots" in out
    assert "[serve] paged KV:" in out
    assert "paged_attention 0 |" in out and "device cpu" in out
    assert paged_attn.COUNTS["launches"] == before[0]
    assert paged_attn.COUNTS["plain"] > before[1]
