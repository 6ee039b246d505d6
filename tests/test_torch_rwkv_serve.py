"""Port parity, rwkv6-1.6b (the ssm family), serving: reduced (2 RWKV6
layers, d_model 64 = 4 WKV heads of 16, d_ff 128, vocab 211) against the
JAX package on the same numpy-seeded inputs.

Held: the reference's ``test_generate_continues_prefill_exactly`` and
``test_engine_ragged_parity`` (a float model at act_bits 32): the port's
``generate`` and 2-slot ``Engine`` give the reference's tokens, and
those of repeated full prefills and of lone runs; a decode step within
2e-3 of a prefill one token longer (``tests/test_arch_smoke.py``'s
oracle); a right-padded ``generate(lengths=)`` equal to per-stream runs
(each stream prefilled at its exact length) and to the reference's;
greedy tokens of each serve view at the config's act_bits 8 against the
reference's loop, through the plain products a forward should run; the
refusals (pages, speculation, a decode window, training); the serve CLI
(``--engine``, ``--pack4``, ``serving_pow2``, ``--ckpt-dir`` of the
reference trainer's checkpoint); the multiply audit and ``serve_edge``
against the reference's audit.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import STRICT, cfg_pair, one_thread, to_np

from repro.checkpoint import ckpt as jckpt
from repro.core.policy import merge_trainable as j_merge
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.core.spec import QuantSpec as JSpec
from repro.kernels import audit as jaudit
from repro.launch import train as j_train_cli
from repro.models import api as japi
from repro.runtime import engine as jengine
from repro.runtime import serving as jserving
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels import audit, ops
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

ARCH = "rwkv6-1.6b"
V = 211
B, P, G = 2, 12, 5
LENS = [6, 14, 9, 11]  # ragged on purpose; more requests than slots
#: count_dicts() index of each view's plain product
PLAIN = {"int8": 0, "packed4": 1, "pow2": 2}
DECODE = 7  # ops.COUNTS: the decode backend's calls
#: products a forward of reduced rwkv: r, k, v, g, o, w1, w2, cm_k, cm_v
#: and cm_r a layer, two layers
BODY = 10 * 2
CALIB = {"tokens": np.random.RandomState(1).randint(
    0, V, (2, 12)).astype(np.int32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(view="fp", **kw):
    """(JAX config, port config) of reduced rwkv: float at act_bits 32
    (``"fp"``), the config's 4-bit pow2 LUT-Q, or the serving_pow2
    policy (``"pow2"``)."""
    jcfg, tcfg = cfg_pair(arch=ARCH, remat=False, **kw)
    if view == "fp":
        return (jcfg.replace(quant=None, act_bits=32),
                tcfg.replace(quant=None, act_bits=32))
    if view == "pow2":
        return (jcfg.replace(quant=j_serving_pow2()),
                tcfg.replace(quant=t_serving_pow2()))
    spec = dict(bits=4, constraint="pow2")
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def rw():
    """The JAX float params (seed 0), the 4-bit pow2 tree and the
    calibrated serving_pow2 tree."""
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    qcfg, _ = _cfgs("int8")
    pcfg, _ = _cfgs("pow2")
    pq = japi.quantize(params, pcfg, axes)
    return dict(params=params, jq=japi.quantize(params, qcfg, axes),
                jcal=japi.calibrate(pq, pcfg,
                                    jax.tree.map(jnp.asarray, CALIB)))


def _views(rw, view, **kw):
    """(JAX config, port config, JAX serve tree, port serve model)."""
    jcfg, tcfg = _cfgs(view, **kw)
    if view == "fp":
        return jcfg, tcfg, rw["params"], interop.from_jax(
            to_np(rw["params"]), tcfg)
    src = rw["jcal"] if view == "pow2" else rw["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _t(x):
    return torch.from_numpy(np.array(x))


def _toks(seed, b=B, p=P):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(
        np.int32)


def _jax_loop(jcfg, tree, toks, steps):
    """The reference's prefill -> adapt -> argmax -> decode loop, jitted
    with STRICT: greedy tokens (B, steps)."""
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)
    logits, cache = prefill(tree, {"tokens": jnp.asarray(toks)})
    cache = jserving.adapt_prefill_cache(jcfg, cache, toks.shape[0],
                                         toks.shape[1] + steps)
    out = []
    for t in range(steps):
        if t:
            logits, cache = decode(tree, tok, cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
        tok = tok.astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


# ---------------------------------------------------------------------------
# the reference's serving tests, ported
# ---------------------------------------------------------------------------

def test_generate_continues_prefill_exactly(rw):
    """``test_generate_continues_prefill_exactly`` (rwkv6-1.6b): the
    port's generate gives the reference generate's tokens and those of
    re-running a full prefill for each new token."""
    jcfg, tcfg, params, model = _views(rw, "fp")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                         jcfg.vocab), np.int32)
    want = np.asarray(jserving.generate(params, jcfg,
                                        {"tokens": jnp.asarray(toks)},
                                        steps=G, max_len=P + G))
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=G,
                            max_len=P + G, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    cur, oracle = _t(toks), []
    with torch.no_grad():
        for _ in range(G):
            logits, _ = tapi.prefill(model, tcfg, {"tokens": cur})
            nxt = torch.argmax(logits[:, -1].float(), -1)[:, None]
            oracle.append(nxt.to(torch.int32))
            cur = torch.cat([cur, oracle[-1]], dim=1)
    np.testing.assert_array_equal(got.numpy(), torch.cat(oracle, 1).numpy())


def test_engine_ragged_parity(rw):
    """``test_engine_ragged_parity`` (rwkv6-1.6b): requests of 6, 14, 9
    and 11 tokens through a 2-slot engine (slot reuse, mid-flight
    admission, one prefill group a length) give each request the tokens
    of its lone generate and of the reference's engine; the engine's
    state tensors are the ones it was built with."""
    jcfg, tcfg, params, model = _views(rw, "fp")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 14), 0,
                                         jcfg.vocab), np.int32)
    steps, max_len = 4, 20
    jeng = jengine.Engine(params, jcfg, capacity=2, max_len=max_len)
    eng = Engine(model, tcfg, capacity=2, max_len=max_len, device="cpu")
    state = [dict(c) for c in eng.cache["layers"]]
    for i, L in enumerate(LENS):
        jeng.submit(toks[i, :L], max_new=steps)
        eng.submit(toks[i, :L], max_new=steps)
    want, res = jeng.run(), eng.run()
    assert [r["rid"] for r in res] == [0, 1, 2, 3]
    for i, L in enumerate(LENS):
        solo = tserving.generate(model, tcfg, {"tokens": _t(toks[i:i + 1,
                                                                 :L])},
                                 steps=steps, max_len=max_len, device="cpu")
        np.testing.assert_array_equal(res[i]["tokens"], want[i]["tokens"],
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(res[i]["tokens"], solo[0].numpy(),
                                      err_msg=f"request {i}")
    assert eng.stats()["paged"] is False
    assert all(c[k] is s[k] for c, s in zip(eng.cache["layers"], state)
               for k in s)


def test_engine_groups_by_exact_length(rw):
    """Admission groups ssm requests by exact prompt length: two 7-token
    prompts share one prefill, a 9-token one gets its own; each result
    equals its lone generate."""
    _, tcfg, _, model = _views(rw, "fp")
    toks = _toks(2, b=3, p=9)
    eng = Engine(model, tcfg, capacity=3, max_len=16, device="cpu")
    calls = []
    orig = tapi.prefill

    def counting(m, cfg, batch, lengths=None):
        calls.append(tuple(batch["tokens"].shape))
        return orig(m, cfg, batch, lengths=lengths)

    tapi.prefill = counting
    try:
        for row, L in zip(toks, (7, 9, 7)):
            eng.submit(row[:L], max_new=3)
        res = eng.run()
    finally:
        tapi.prefill = orig
    assert sorted(calls) == [(1, 9), (2, 7)]
    for r, row, L in zip(res, toks, (7, 9, 7)):
        solo = tserving.generate(model, tcfg, {"tokens": _t(row[None, :L])},
                                 steps=3, device="cpu")
        np.testing.assert_array_equal(r["tokens"], solo[0].numpy())


def test_decode_step_matches_a_longer_prefill(rw):
    """``test_arch_smoke``'s oracle: after a prefill of P tokens, a
    decode step of token P lies within 2e-3 of the prefill of P + 1
    tokens' last logits (float model, act_bits 32)."""
    _, tcfg, _, model = _views(rw, "fp")
    toks = _t(_toks(3, p=P + 1))
    with torch.no_grad():
        want, _ = tapi.prefill(model, tcfg, {"tokens": toks})
        _, cache = tapi.prefill(model, tcfg, {"tokens": toks[:, :P]})
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, P + 4)
        got, cache = tapi.decode_step(model, tcfg, toks[:, P:], cache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert cache["len"].tolist() == [P + 1] * B


def test_padded_generate_equals_per_stream_runs(rw):
    """A right-padded batch with ``lengths`` (12 and 7): each stream is
    prefilled alone at its exact length, giving its lone run's tokens
    and the reference's padded generate's; a padded prefill reads the
    right logits but its state has run over the padding."""
    jcfg, tcfg, params, model = _views(rw, "fp")
    toks = _toks(4)
    lengths = torch.tensor([12, 7])
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=G,
                            lengths=lengths, device="cpu")
    for i, L in enumerate(lengths.tolist()):
        solo = tserving.generate(model, tcfg, {"tokens": _t(toks[i:i + 1,
                                                                 :L])},
                                 steps=G, device="cpu")
        assert torch.equal(got[i], solo[0]), i
    want = jserving.generate(params, jcfg, {"tokens": jnp.asarray(toks)},
                             steps=G, lengths=jnp.asarray([12, 7]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        lp, padded = tapi.prefill(model, tcfg, {"tokens": _t(toks)},
                                  lengths=lengths)
        le, exact = tapi.prefill(model, tcfg, {"tokens": _t(toks[1:, :7])})
    # the logits are causal, the state is not: it has run over the pad
    torch.testing.assert_close(lp[1], le[0], rtol=0, atol=1e-5)
    assert not torch.allclose(padded["layers"][0]["wkv"][1],
                              exact["layers"][0]["wkv"][0], rtol=0,
                              atol=1e-3)


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_generate_tokens_and_plain_counts(rw, view):
    """Each view's generate gives the reference loop's greedy tokens at
    the config's act_bits 8, through the plain products a forward should
    run (10 a layer, w1 and w2 among them) and the tied head (int8, and
    packed4 at the odd vocab: a fused product; serving_pow2: a float
    product, outside the counts)."""
    jcfg, tcfg, js, model = _views(rw, view, act_bits=8)
    toks = _toks(9)
    want = _jax_loop(jcfg.replace(kernel_backend="decode"), js, toks, G)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=G,
                            device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    body = G * BODY
    head = 0 if view == "pow2" else G
    assert delta[PLAIN[view]]["plain"] == body + (head if view == "int8"
                                                  else 0)
    assert sum(delta[i]["plain"] for i in (0, 1, 2)) == body + head
    assert delta[DECODE]["decode"] == 0
    assert all(d.get("launches", 0) == 0 for d in delta)


def test_refusals_and_fallbacks(rw):
    """An engine asked for pages serves through its slot pool (paged
    False), as the reference's; speculation raises the reference's
    reason ("cannot rewind" at act_bits 32, the activation one at 8); a
    decode window raises; the training loss of the same model is
    finite."""
    jcfg, tcfg, _, model = _views(rw, "fp")
    eng = Engine(model, tcfg, capacity=2, max_len=16, kv_pages=8,
                 page_size=8, device="cpu")
    assert eng.paged is False and eng.stats()["paged"] is False
    toks = _toks(5)
    eng.submit(toks[0, :7], max_new=3)
    assert len(eng.run()[0]["tokens"]) == 3
    ok, why = tapi.speculative_supported(tcfg)
    jok, jwhy = japi.speculative_supported(jcfg)
    assert (ok, why) == (jok, jwhy) and not ok and "rewind" in why
    with pytest.raises(ValueError, match="cannot rewind"):
        Engine(model, tcfg, capacity=2, max_len=16, speculative=3,
               device="cpu")
    with pytest.raises(ValueError, match="activation quantization"):
        Engine(model, tcfg.replace(act_bits=8), capacity=2, max_len=16,
               speculative=3, device="cpu")
    cache = tapi.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="decode window"):
        tapi.decode_step(model, tcfg, _t(toks[:, :2]), cache)
    loss, _ = tapi.loss_fn(model, tcfg, {"tokens": _t(toks),
                                         "labels": _t(toks)})
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the multiply audit
# ---------------------------------------------------------------------------

def test_serving_pow2_audit_equals_the_reference(rw):
    """The calibrated serving_pow2 view's prefill (B x 11 tokens) and
    one decode step pass the multiply audit, as the reference's audit of
    its own prefill does: the same integer dots (the reference scans its
    layers, so its report holds one layer's 10), the WKV scan's float
    einsums allowed in both; the tied readout is the one float product
    on a weight."""
    jcfg, tcfg, js, model = _views(rw, "pow2")
    toks = _toks(11, p=11)
    jcfg_d = jcfg.replace(kernel_backend="decode")
    want = jaudit.audit_multiplierless(
        lambda p, b: japi.prefill(p, jcfg_d, b)[0], js,
        {"tokens": jnp.asarray(toks)}, params=js)
    assert len(want["int_dots"]) == 10
    assert model.layers[0].mix.w1.state.d.dtype == torch.int8
    with torch.no_grad():
        _, cache = tapi.prefill(model, tcfg, {"tokens": _t(toks)})
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, 13)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for name, fn in (("prefill", lambda: tapi.prefill(
            model, tcfg, {"tokens": _t(toks)})),
                     ("decode", lambda: tapi.decode_step(model, tcfg, tok,
                                                         cache))):
        with torch.no_grad():
            rep = audit.audit_multiplierless(fn, params=model)
        assert len(rep["int_dots"]) == BODY, name
        assert {d["rhs"] for d in rep["int_dots"]} == {
            tuple(d["rhs"]) for d in want["int_dots"]}, name
        heads = [d for d in rep["fp_dots"] if d["rhs"][-2:] in (
            (V, 64), (64, V))]
        assert len(heads) == 1, name


def test_serve_edge_counts_equal_the_reference_audit(capsys):
    """``launch/serve_edge --arch rwkv6-1.6b`` on the CPU: every body leaf
    (w1 and w2 among them) resolves pow2 with frozen pairs, as in the
    reference's manifest; its audit
    passes with the integer dots of the reference's audit of the same
    prefill through its decode oracle over both layers (its report holds
    one scanned layer's 10; its "auto" program on the CPU fuses the
    products' dots into 6 that are not one a product), and the
    shift-add path is token-identical to the decode oracle."""
    from repro.configs import get_config as jget
    from repro.models.reduce import reduced as jreduced
    from repro_torch.launch import serve_edge

    cfg = jreduced(jget(ARCH)).replace(quant=j_serving_pow2(), act_bits=8,
                                       remat=False)
    calib = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    js, _, jman = japi.serve_state(jax.random.PRNGKey(0), cfg,
                                   with_manifest=True,
                                   calib_batch={"tokens": calib})
    oracle = cfg.replace(kernel_backend="decode")
    rep = jaudit.audit_multiplierless(
        lambda p, t: japi.prefill(p, oracle, {"tokens": t})[0], js,
        calib[:1], params=js)
    assert len(rep["int_dots"]) == 10
    assert serve_edge.main(["--arch", ARCH, "--device", "cpu", "--gen",
                            "4"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"PASS \((\d+) integer dots", out)
    assert m and int(m.group(1)) == len(rep["int_dots"]) * cfg.n_layers
    assert "token-identical" in out
    rows = re.findall(r"^  (layers/mix/\S+)\s+backend=(\S+)\s+encoding="
                      r"(\S+)\s+K=\s*(\d+) act_frozen=(\S+)", out, re.M)
    assert {r[0] for r in rows} == {p for p in jman
                                    if p.startswith("layers/mix/")}
    assert {r[0] for r in rows} >= {"layers/mix/w1", "layers/mix/w2"}
    assert all(r[1:] == ("pow2", "pow2", "16", "True") for r in rows)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"]])
def test_cli_serves_on_cpu(capsys, flags):
    """The serve CLI on reduced rwkv in each view and through the engine
    (its slot pool: no paged line): plain versions, no launch."""
    from repro_torch.launch import serve as t_serve_cli

    before = ops.read_counts()
    assert t_serve_cli.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "3", "--device",
                             "cpu"] + flags) == 0
    out = capsys.readouterr().out
    delta = ops.count_delta(before)
    assert f"[serve] {ARCH}:" in out and "device cpu" in out
    assert any(d.get("plain", 0) > 0 for d in delta)
    assert all(d.get("launches", 0) == 0 for d in delta)
    if "--engine" in flags:
        assert "3/3 requests" in out and "[serve] paged KV" not in out


def test_reference_checkpoint_serves_the_in_memory_tokens(tmp_path, capsys):
    """Two steps of the reference's train CLI on reduced rwkv into a
    checkpoint: its trainable shapes are the port's (w1 and w2 among
    them); the serve CLI's ``--ckpt-dir`` (the manifest's policy, int8,
    packed4 and the engine) prints the tokens that the restored tree,
    merged in memory by the reference and crossed by
    ``interop.from_jax``, gives through ``generate``."""
    from repro_torch.launch import serve as t_serve_cli

    d = str(tmp_path / "ckpt")
    assert j_train_cli.main(["--arch", ARCH, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "12", "--vocab", "64",
                             "--ckpt-dir", d]) == 0
    params, step = jckpt.restore_params(d)
    assert step == 2
    policy = tckpt.load_policy(d)
    _, tcfg = _cfgs("int8", vocab=64)
    tcfg = tcfg.replace(quant=policy, act_bits=8)
    t_serve_cli.check_ckpt_shapes(tcfg, params["trainable"])
    assert set(interop.trainable_shapes(tcfg)) == {
        p for p, leaf in interop.walk(params["trainable"])
        if leaf is not None}
    assert ("layers", "mix", "w1") in interop.trainable_shapes(tcfg)
    mem = interop.from_jax(to_np(j_merge(params["trainable"],
                                         params["static"])), tcfg)
    toks = torch.randint(0, 64, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    for flags in ([], ["--pack4"]):
        capsys.readouterr()
        assert t_serve_cli.main(["--arch", ARCH, "--reduced", "--vocab",
                                 "64", "--batch", "2", "--prompt-len", "8",
                                 "--gen", "4", "--device", "cpu",
                                 "--ckpt-dir", d] + flags) == 0
        out = capsys.readouterr().out
        assert f"restored train checkpoint step 2 from {d}" in out
        view = t_serve_view(mem, pack4=bool(flags),
                            policy=tapi.resolved_policy(tcfg))
        want = tserving.generate(view, tcfg, {"tokens": toks}, steps=4,
                                 device="cpu")
        assert f"sample: {want[0, :8].tolist()}" in out, flags
    assert t_serve_cli.main(["--arch", ARCH, "--reduced", "--vocab", "64",
                             "--prompt-len", "8", "--gen", "3", "--device",
                             "cpu", "--ckpt-dir", d, "--engine",
                             "--max-batch", "2", "--queue", "3"]) == 0
    assert "3/3 requests" in capsys.readouterr().out
