"""Port parity, zamba2-2.7b (the hybrid family), serving: reduced (4
Mamba2 layers in 2 super-blocks, a shared attention block applied after
each, vocab 211) against the JAX package on the same numpy-seeded
inputs.

Held: the reference's ``test_generate_continues_prefill_exactly`` and
``test_engine_ragged_parity`` (a float model at act_bits 32): the port's
``generate`` and 2-slot ``Engine`` give the reference's tokens, and
those of repeated full prefills and of lone runs; a decode step within
2e-3 of a prefill one token longer (``tests/test_arch_smoke.py``'s
oracle); a right-padded ``generate(lengths=)`` equal to per-stream
runs (each stream prefilled at its exact length); greedy tokens of each
serve view at the config's act_bits 8 against the reference's loop,
through the plain products a forward should run; the refusals (pages,
speculation, training); the serve CLI (``--engine``, ``--pack4``,
``serving_pow2``, ``--ckpt-dir`` of the reference trainer's checkpoint);
the multiply audit's integer dots against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, cfg_pair, one_thread, pow2_floor,
                                to_np)

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

ARCH = "zamba2-2.7b"
B, P, G = 2, 12, 5
LENS = [6, 14, 9, 11]  # ragged on purpose; more requests than slots
#: count_dicts() index of each view's plain product
PLAIN = {"int8": 0, "packed4": 1, "pow2": 2}
DECODE = 7  # ops.COUNTS: the decode backend's calls
#: products a forward of reduced zamba: in_proj and out_proj a Mamba
#: layer (4), the shared block's 7 an application (2)
BODY = 2 * 4 + 7 * 2
CALIB = {"tokens": np.random.RandomState(1).randint(
    0, 211, (2, 12)).astype(np.int32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(view="fp", **kw):
    """(JAX config, port config) of reduced zamba: float at act_bits 32
    (``"fp"``), the config's 4-bit pow2 LUT-Q at min_size 1024, or the
    serving_pow2 policy with its floor at 1024 (``"pow2"``)."""
    jcfg, tcfg = cfg_pair(arch=ARCH, remat=False, **kw)
    if view == "fp":
        return (jcfg.replace(quant=None, act_bits=32),
                tcfg.replace(quant=None, act_bits=32))
    if view == "pow2":
        return (jcfg.replace(quant=pow2_floor(j_serving_pow2(), 1024)),
                tcfg.replace(quant=pow2_floor(t_serving_pow2(), 1024)))
    spec = dict(bits=4, constraint="pow2", min_size=1024)
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def zb():
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


def _views(zb, view, **kw):
    """(JAX config, port config, JAX serve tree, port serve model)."""
    jcfg, tcfg = _cfgs(view, **kw)
    if view == "fp":
        return jcfg, tcfg, zb["params"], interop.from_jax(
            to_np(zb["params"]), tcfg)
    src = zb["jcal"] if view == "pow2" else zb["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _t(x):
    return torch.from_numpy(np.array(x))


def _toks(seed, b=B, p=P):
    return np.random.RandomState(seed).randint(0, 211, (b, p)).astype(
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

def test_generate_continues_prefill_exactly(zb):
    """``test_generate_continues_prefill_exactly`` (zamba2-2.7b): the
    port's generate gives the reference generate's tokens and those of
    re-running a full prefill for each new token."""
    jcfg, tcfg, params, model = _views(zb, "fp")
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


def test_engine_ragged_parity(zb):
    """``test_engine_ragged_parity`` (zamba2-2.7b): requests of 6, 14, 9
    and 11 tokens through a 2-slot engine (slot reuse, mid-flight
    admission, one prefill group a length) give each request the tokens
    of its lone generate and of the reference's engine."""
    jcfg, tcfg, params, model = _views(zb, "fp")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 14), 0,
                                         jcfg.vocab), np.int32)
    steps, max_len = 4, 20
    jeng = jengine.Engine(params, jcfg, capacity=2, max_len=max_len)
    eng = Engine(model, tcfg, capacity=2, max_len=max_len, device="cpu")
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


def test_decode_step_matches_a_longer_prefill(zb):
    """``test_arch_smoke``'s oracle: after a prefill of P tokens, a
    decode step of token P lies within 2e-3 of the prefill of P + 1
    tokens' last logits (float model, act_bits 32)."""
    _, tcfg, _, model = _views(zb, "fp")
    toks = _t(_toks(3, p=P + 1))
    with torch.no_grad():
        want, _ = tapi.prefill(model, tcfg, {"tokens": toks})
        _, cache = tapi.prefill(model, tcfg, {"tokens": toks[:, :P]})
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, P + 4)
        got, cache = tapi.decode_step(model, tcfg, toks[:, P:], cache)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert cache["len"].tolist() == [P + 1] * B


def test_padded_generate_equals_per_stream_runs(zb):
    """A right-padded batch with ``lengths`` (12 and 7): each stream
    prefilled at its exact length gives its lone run's tokens; a padded
    prefill would have integrated the padding into the state."""
    _, tcfg, _, model = _views(zb, "fp")
    toks = _t(_toks(4))
    lengths = torch.tensor([12, 7])
    got = tserving.generate(model, tcfg, {"tokens": toks}, steps=G,
                            lengths=lengths, device="cpu")
    for i, L in enumerate(lengths.tolist()):
        solo = tserving.generate(model, tcfg, {"tokens": toks[i:i + 1, :L]},
                                 steps=G, device="cpu")
        assert torch.equal(got[i], solo[0]), i
    with torch.no_grad():
        lp, padded = tapi.prefill(model, tcfg, {"tokens": toks},
                                  lengths=lengths)
        le, exact = tapi.prefill(model, tcfg, {"tokens": toks[1:, :7]})
    # the logits are causal, the state is not: it has run over the pad
    torch.testing.assert_close(lp[1], le[0], rtol=0, atol=1e-5)
    assert not torch.allclose(padded["layers"][0]["ssm"][1],
                              exact["layers"][0]["ssm"][0], rtol=0,
                              atol=1e-3)


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_generate_tokens_and_plain_counts(zb, view):
    """Each view's generate gives the reference loop's greedy tokens at
    the config's act_bits 8, through the plain products a forward should
    run (in_proj and out_proj a Mamba layer, the shared block's seven
    each application) and the tied head (int8, and packed4 at the odd
    vocab: a fused product; serving_pow2: a float product)."""
    jcfg, tcfg, js, model = _views(zb, view, act_bits=8)
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


def test_engine_refusals_and_fallbacks(zb):
    """An engine asked for pages serves through its slot pool (paged
    False), as the reference's; speculation raises the reference's
    reason ("cannot rewind" at act_bits 32, the activation one at 8);
    the training loss of the same model is finite."""
    jcfg, tcfg, _, model = _views(zb, "fp")
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
    loss, _ = tapi.loss_fn(model, tcfg, {"tokens": _t(toks),
                                         "labels": _t(toks)})
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the multiply audit
# ---------------------------------------------------------------------------

def test_serving_pow2_audit_equals_the_reference(zb):
    """The calibrated serving_pow2 view's prefill (B x 11 tokens: no
    activation has a quantized leaf's rows) and one decode step pass the
    multiply audit, as the reference's audit of its own prefill does:
    the same integer dots (the reference scans its two stacks, so its
    report holds the Mamba layer's 2 and the shared block's 7 once),
    the SSD's float einsums and the conv's multiplies by the decoded
    conv_w (a (C,) row broadcast over (B, S, C)) allowed in both; the
    tied readout is the one float product on a weight."""
    jcfg, tcfg, js, model = _views(zb, "pow2")
    toks = _toks(11, p=11)
    jcfg_d = jcfg.replace(kernel_backend="decode")
    want = jaudit.audit_multiplierless(
        lambda p, b: japi.prefill(p, jcfg_d, b)[0], js,
        {"tokens": jnp.asarray(toks)}, params=js)
    assert len(want["int_dots"]) == 2 + 7
    assert model.mamba_layers[0][0].mamba.conv_w.state.d.dtype == torch.int8
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
            (211, 64), (64, 211))]
        assert len(heads) == 1, name


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"]])
def test_cli_serves_on_cpu(capsys, flags):
    """The serve CLI on reduced zamba in each view and through the engine
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
    """Two steps of the reference's train CLI on reduced zamba into a
    checkpoint: its trainable shapes are the port's; the serve CLI's
    ``--ckpt-dir`` (the manifest's policy, int8 and packed4) prints the
    tokens that the restored tree, merged in memory by the reference and
    crossed by ``interop.from_jax``, gives through ``generate``."""
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
