"""Port parity, seamless-m4t-medium (the encdec family), serving: reduced
(2 encoder + 2 decoder layers, d_model 64, 4 / 4 heads of 16, vocab 211,
a tied readout) under the config's 4-bit pow2 LUT-Q, against the JAX
package on the same numpy-seeded inputs.

Held bit for bit: the int8, packed4 and calibrated ``serving_pow2``
serve views (assignments, pack4 bytes, sign+exponent planes, frozen
activation pairs) and their manifests; greedy tokens of ``generate``
against the reference's prefill / decode loop at the config's act_bits
8 (a float ulp may move an 8-bit activation level, so there the tokens
are compared, as the other families' tests do; logits are held at
act_bits 32 in ``test_torch_encdec.py``); the slot and paged engines'
tokens, at act_bits 32, request by request against lone ``generate``s,
and speculative tokens against plain decoding; ``synthetic_requests``
against the reference's; the audit's integer-dot counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import STRICT, cfg_pair, one_thread, to_np, tokens

from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.models import api as japi
from repro.runtime import serving as jserving
from repro.runtime.engine import synthetic_requests as j_synthetic
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.kernels import audit, ops
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine, synthetic_requests

ARCH = "seamless-m4t-medium"
B, P, S_SRC, STEPS = 2, 9, 11, 4
#: count_dicts() index of each view's plain product
PLAIN = {"int8": 0, "packed4": 1, "pow2": 2}
DECODE = 7  # ops.COUNTS: the decode backend's calls
rng0 = np.random.RandomState(1)
CALIB = {"tokens": rng0.randint(0, 211, (2, 12)).astype(np.int32),
         "frames": rng0.randn(2, 10, 64).astype(np.float32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(view="int8", **kw):
    """Reduced seamless (the config's act_bits 8 unless given): 4-bit pow2
    LUT-Q, or under ``view="pow2"`` the serving_pow2 policy."""
    jcfg, tcfg = cfg_pair(arch=ARCH, constraint="pow2", remat=False, **kw)
    if view == "pow2":
        return (jcfg.replace(quant=j_serving_pow2()),
                tcfg.replace(quant=t_serving_pow2()))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def sv():
    """The JAX float params, their quantized tree and the calibrated
    serving_pow2 tree (calibrated on a batch with frames)."""
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    pcfg, _ = _cfgs("pow2")
    pq = japi.quantize(params, pcfg, axes)
    jcal = japi.calibrate(pq, pcfg, jax.tree.map(jnp.asarray, CALIB))
    return dict(params=params, jq=japi.quantize(params, jcfg, axes),
                pq=pq, jcal=jcal)


def _views(sv, view, **kw):
    """(JAX config, port config, JAX serve tree, port serve model)."""
    jcfg, tcfg = _cfgs(view, **kw)
    src = sv["jcal"] if view == "pow2" else sv["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield prefix + (f,), getattr(tree, f)
    else:
        yield prefix, tree


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
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


def _batch(seed, b=B, p=P, width=S_SRC):
    rng = np.random.RandomState(seed)
    return {"tokens": tokens(_cfgs()[0], b, p, seed=seed),
            "frames": rng.randn(b, width, 64).astype(np.float32)}


def _jax_tokens(jcfg, params, batch, steps):
    """The reference's prefill -> adapt -> argmax -> decode loop (jitted
    with STRICT): greedy tokens (B, steps)."""
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)
    b = jax.tree.map(jnp.asarray, batch)
    n, width = batch["tokens"].shape[0], batch["frames"].shape[1]
    logits, cache = prefill(params, b)
    cache = jserving.adapt_prefill_cache(
        jcfg, cache, n, batch["tokens"].shape[1] + steps, src_len=width)
    out = []
    for t in range(steps):
        if t:
            logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
        tok = tok.astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


# ---------------------------------------------------------------------------
# serve views, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_views_and_manifests_equal(sv, view):
    """Each serve view byte for byte (the packed tied table and the pow2
    planes with their frozen pairs among them) and its manifest; under
    serving_pow2 every body leaf is pow2-encoded and the tied table
    stays float."""
    jcfg, tcfg, js, model = _views(sv, view)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    src = sv["jcal"] if view == "pow2" else sv["jq"]
    _, tm = t_serve_view(interop.from_jax(to_np(src), tcfg),
                         pack4=view == "packed4",
                         policy=tapi.resolved_policy(tcfg),
                         with_manifest=True)
    _, jm = j_serve_view(src, pack4=view == "packed4",
                         policy=japi.resolved_policy(jcfg),
                         with_manifest=True)
    assert tm == jm
    if view == "pow2":
        body = [p for p in tm if p != "embed/table"]
        assert len(body) == 7 * 2 + 4 and "embed/table" not in tm
        assert all(tm[p]["encoding"] == "pow2" for p in body)
    if view == "packed4":
        # an odd vocab (211) does not pack (see the even-vocab test)
        assert model.embed.table.a.dtype == torch.int8
        assert tm["embed/table"]["backend"] == "fused"


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_generate_tokens_and_plain_counts(sv, view):
    """Each view's generate gives the reference loop's greedy tokens at
    act_bits 8, through the plain products a forward should run: 7 an
    encoder layer and 11 a decoder layer in a prefill, 9 a decoder
    layer in a decode step, and the tied head (int8, and packed4 at an
    odd vocab: one fused product; serving_pow2: a float product)."""
    jcfg, tcfg, js, model = _views(sv, view)
    batch = _batch(4)
    want = _jax_tokens(jcfg.replace(kernel_backend="decode"), js, batch,
                       STEPS)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {k: _t(v) for k, v in batch.items()},
                            steps=STEPS, device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    body = 7 * 2 + 11 * 2 + (STEPS - 1) * 9 * 2
    head = 0 if view == "pow2" else STEPS
    assert delta[PLAIN[view]]["plain"] == body + (head if view == "int8"
                                                  else 0)
    assert delta[0]["plain"] == (body if view == "int8" else 0) + head
    assert sum(delta[i]["plain"] for i in (0, 1, 2)) == body + head
    assert delta[DECODE]["decode"] == 0
    assert all(d.get("launches", 0) == 0 for d in delta)


def test_packed_tied_head_at_an_even_vocab():
    """At an even vocab (212 here, 256206 at full width) the pack4 view
    packs the tied table too, as the reference's; its transposed readout
    then resolves to the decode backend, one call a forward, and the
    greedy tokens still equal the reference loop's at act_bits 8."""
    jcfg, tcfg = _cfgs(vocab=212)
    params, axes = japi.init(jax.random.PRNGKey(2), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    pol_j, pol_t = japi.resolved_policy(jcfg), tapi.resolved_policy(tcfg)
    js, jm = j_serve_view(jq, pack4=True, policy=pol_j, with_manifest=True)
    model, tm = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=True,
                             policy=pol_t, with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    # the manifest names the leaf's backend as a product's rhs (both
    # packages); the readout's transposed use resolves to decode
    assert tm == jm and tm["embed/table"]["backend"] == "packed4"
    assert model.embed.table.a.dtype == torch.uint8
    batch = _batch(6)
    batch["tokens"] = batch["tokens"] % 212
    want = _jax_tokens(jcfg.replace(kernel_backend="decode"), js, batch,
                       STEPS)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {k: _t(v) for k, v in batch.items()},
                            steps=STEPS, device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    assert delta[1]["plain"] == 7 * 2 + 11 * 2 + (STEPS - 1) * 9 * 2
    assert delta[DECODE]["decode"] == STEPS and delta[0]["plain"] == 0


def test_speculative_generate_equals_plain(sv):
    """speculative=2 (draft_bits 2) gives plain decoding's tokens at
    act_bits 32, rejecting some drafts and accepting others, as the
    reference's ``test_generate_speculative_token_parity`` (encdec)."""
    _, tcfg, _, model = _views(sv, "int8", act_bits=32)
    batch = {k: _t(v) for k, v in _batch(5).items()}
    lengths = torch.tensor([9, 6])
    base = tserving.generate(model, tcfg, batch, steps=8, lengths=lengths,
                             device="cpu")
    spec, stats = tserving.generate(model, tcfg, batch, steps=8,
                                    lengths=lengths, speculative=2,
                                    draft_bits=2, return_stats=True,
                                    device="cpu")
    assert torch.equal(base, spec)
    assert 0.0 < stats["acceptance_rate"] < 1.0
    assert stats["spec_tokens_per_round"] > 1.0


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _ragged(widths=(10, 6, 13)):
    rng = np.random.RandomState(7)
    frames = [rng.randn(s, 64).astype(np.float32) for s in widths]
    toks = rng.randint(0, 211, (len(widths), 12)).astype(np.int32)
    return frames, toks, [5, 12, 8]


@pytest.mark.parametrize("kind", ["slot", "paged", "paged_spec"])
def test_engine_ragged_parity(sv, kind):
    """Requests with their own ragged sources (10, 6 and 13 frames under
    an engine src_len of 13) and prompts: the slot pool (2 slots: the
    first two sources differ in width, so they prefill apart), the paged
    engine and its speculative twin (k = 2) each give every request the
    tokens of its lone generate; a paged engine admits each request
    through one prefill and traces nothing while it serves."""
    _, tcfg, _, model = _views(sv, "int8", act_bits=32)
    frames, toks, lens = _ragged()
    G, max_len = 4, 20
    lone = [tserving.generate(
        model, tcfg, {"tokens": _t(toks[i:i + 1, :L]),
                      "frames": _t(frames[i][None])},
        steps=G, max_len=max_len, device="cpu")[0].numpy()
        for i, L in enumerate(lens)]
    kw = {"slot": {}, "paged": dict(kv_pages=12, page_size=8),
          "paged_spec": dict(kv_pages=12, page_size=8, speculative=2)}[kind]
    eng = Engine(model, tcfg, capacity=2, max_len=max_len, src_len=13,
                 device="cpu", **kw)
    assert eng.paged == (kind != "slot")
    traces = eng.paged_trace_counts()
    for i, L in enumerate(lens):
        eng.submit(toks[i, :L], max_new=G, frames=frames[i])
    res = eng.run()
    assert eng.paged_trace_counts() == traces
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r["tokens"], lone[i],
                                      err_msg=f"{kind} request {i}")
    st = eng.stats()
    assert st["src_len"] == 13 and st["completed"] == 3
    if kind != "slot":
        assert st["prefill_chunk_calls"] == 0 and st["packed_groups"] == 0


def test_engine_refusals_and_switches(sv):
    """An encdec request needs frames no wider than the engine's
    src_len; a paged encdec engine keeps its prefix cache and packed
    prefill off (its K/V depends on the frames); a vlm prefix is refused
    (the config is not vlm); speculation is refused at act_bits 8 with the reference's
    reason."""
    _, tcfg, _, model = _views(sv, "int8", act_bits=32)
    eng = Engine(model, tcfg, capacity=2, max_len=16, src_len=8,
                 device="cpu")
    with pytest.raises(ValueError, match="need `frames`"):
        eng.submit(np.arange(4), max_new=2)
    with pytest.raises(ValueError, match="exceed engine src_len 8"):
        eng.submit(np.arange(4), max_new=2, frames=np.zeros((9, 64)))
    with pytest.raises(ValueError, match="prefix_embeds are for a vlm"):
        eng.submit(np.arange(4), max_new=2, frames=np.zeros((3, 64)),
                   prefix_embeds=np.zeros((2, 64)))
    paged = Engine(model, tcfg, capacity=2, max_len=16, src_len=8,
                   kv_pages=8, page_size=8, device="cpu")
    assert paged.paged and paged.pkv.prefix is None
    assert not paged.prefill_pack and "prefix_hit_rate" not in paged.stats()
    assert paged.buckets == (16,) and not hasattr(paged, "ws")
    ok, why = tapi.speculative_supported(tcfg.replace(act_bits=8))
    assert not ok and "activation quantization" in why
    with pytest.raises(ValueError, match="activation quantization"):
        Engine(model, tcfg.replace(act_bits=8), src_len=8, speculative=2,
               device="cpu")


def test_synthetic_requests_equal_reference():
    """The reference's rng sequence: prompts, budgets and frames (widths
    in [src_len // 2, src_len]) equal for the same seed."""
    jcfg, tcfg = _cfgs()
    a = synthetic_requests(tcfg, 6, max_prompt=16, max_new=8, seed=3,
                           src_len=12)
    b = j_synthetic(jcfg, 6, max_prompt=16, max_new=8, seed=3, src_len=12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["frames"], y["frames"])
        assert x["max_new"] == y["max_new"] and 6 <= len(x["frames"]) <= 12


# ---------------------------------------------------------------------------
# the multiply audit, the CLI
# ---------------------------------------------------------------------------

def test_serving_pow2_audit_integer_dots(sv):
    """The calibrated serving_pow2 view's prefill (B x 10 tokens over 12
    frames: no activation has a quantized leaf's 64-row shape) and
    decode step pass the multiply audit with 7 integer dots an encoder
    layer and 11 a decoder layer (9 in a step: the cross K/V is cached);
    the tied readout is the one float product on a weight."""
    _, tcfg, _, model = _views(sv, "pow2")
    batch = {k: _t(v) for k, v in _batch(11, p=10, width=12).items()}
    with torch.no_grad():
        _, cache = tapi.prefill(model, tcfg, batch)
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, 12, src_len=12)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    runs = {"prefill": (lambda: tapi.prefill(model, tcfg, batch), 7 * 2 +
                        11 * 2),
            "decode": (lambda: tapi.decode_step(model, tcfg, tok, cache),
                       9 * 2)}
    for name, (fn, n) in runs.items():
        with torch.no_grad():
            rep = audit.audit_multiplierless(fn, params=model)
        assert len(rep["int_dots"]) == n, name
        heads = [d for d in rep["fp_dots"] if d["rhs"][-2:] in (
            (211, 64), (64, 211))]
        assert len(heads) == 1, name


@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"]])
def test_cli_serves_seamless_on_cpu(capsys, flags):
    """Both CLI modes on reduced seamless: generate over frames of the
    prompt's width, the paged engine over sources of up to --prompt-len
    frames; plain versions only."""
    from repro_torch.launch import serve as t_serve_cli

    before = ops.read_counts()
    assert t_serve_cli.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "3", "--device",
                             "cpu"] + flags) == 0
    out = capsys.readouterr().out
    delta = ops.count_delta(before)
    assert "device cpu" in out
    if "--engine" in flags:
        assert "sources up to 12 frames" in out and "[serve] paged KV" in out
        assert delta[4]["plain"] > 0  # paged attention's plain version
    else:
        assert "over 12 source frames" in out
    assert all(d.get("launches", 0) == 0 for d in delta)
