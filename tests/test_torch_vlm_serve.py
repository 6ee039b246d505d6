"""Port parity, paligemma-3b (the vlm family), serving and training
entry points: reduced (2 layers, d_model 64, 4 query heads of 16 over 1
KV head, vocab 211, a tied readout, a prefix of 8 image embeddings)
under the config's 4-bit pow2 LUT-Q, against the JAX package on the
same numpy-seeded inputs (``tests/torch_port_helpers.py``'s vlm
helpers; ``tests/test_torch_vlm.py`` holds the model's numerics).

Held exactly: the int8, packed4 (the tied table packed at an even
vocab) and calibrated ``serving_pow2`` views and their manifests; the
audit's integer dots against the reference's; the slot engine's tokens
and its speculative twin's, request by request, against the JAX engine
on ``synthetic_requests(seed=0)`` with text-only requests mixed in
(act_bits 32: dynamic 8-bit scales span a batch, ROADMAP queue 3);
``synthetic_requests`` against the reference's; the engine's length
check and refusals; the serve CLI in every view and mode; the train
CLI's prefixed batches, its checkpoint and the serve CLI's
``--ckpt-dir`` giving the in-memory model's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (VLM, VLM_PFX, assert_trees_equal,
                                jax_prefixed_loop, one_thread, to_np,
                                vlm_batch, vlm_cfgs, vlm_trees, vlm_views)

from repro.core.policy import serve_view as j_serve_view
from repro.kernels import audit as jaudit
from repro.models import api as japi
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_synthetic
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.kernels import audit, ops
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine, synthetic_requests

B, T, STEPS, PFX, D = 2, 10, 4, VLM_PFX, 64
DECODE = 7  # ops.COUNTS: the decode backend's calls


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vlm():
    return vlm_trees()


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# serve views, manifests, the audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_views_and_manifests_equal(vlm, view):
    """Each serve view byte for byte (the calibrated pow2 planes and the
    frozen pairs from a prefixed calibration batch among them) and its
    manifest; under serving_pow2 the tied table stays float."""
    jcfg, tcfg, js, model = vlm_views(vlm, view)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    src = vlm["jcal"] if view == "pow2" else vlm["jq"]
    _, tm = t_serve_view(interop.from_jax(to_np(src), tcfg),
                         pack4=view == "packed4",
                         policy=tapi.resolved_policy(tcfg),
                         with_manifest=True)
    _, jm = j_serve_view(src, pack4=view == "packed4",
                         policy=japi.resolved_policy(jcfg),
                         with_manifest=True)
    assert tm == jm
    assert ("embed/table" in tm) == (view != "pow2")
    if view == "pow2":
        assert model.embed.table.dtype == torch.float32
        assert all(m["encoding"] == "pow2" for m in tm.values())


def test_serving_pow2_audit_equals_the_reference(vlm):
    """The calibrated serving_pow2 view's prefill (B x (8 + 10) = 36
    rows: no activation has a quantized leaf's 64 or 96 rows) and one
    decode step pass the multiply audit with the reference's integer
    dots (its audit of its own prefill on the oracle backend); the tied
    readout is the one float product on a weight."""
    jcfg, tcfg, js, model = vlm_views(vlm, "pow2")
    batch = vlm_batch(11)
    tb = {k: _t(v) for k, v in batch.items()}
    jcfg_d = jcfg.replace(kernel_backend="decode")
    want = jaudit.audit_multiplierless(
        lambda p, b: japi.prefill(p, jcfg_d, b)[0], js,
        jax.tree.map(jnp.asarray, batch), params=js)
    with torch.no_grad():
        _, cache = tapi.prefill(model, tcfg, tb)
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, PFX + T + 2)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    # the reference scans its layers: its report holds the body once
    leaves = len(t_serve_view(interop.from_jax(to_np(vlm["jcal"]), tcfg),
                              policy=tapi.resolved_policy(tcfg),
                              with_manifest=True)[1])
    assert leaves == len(want["int_dots"]) > 0
    n = leaves * tcfg.n_layers
    for name, fn in (("prefill", lambda: tapi.prefill(model, tcfg, tb)),
                     ("decode", lambda: tapi.decode_step(model, tcfg, tok,
                                                         cache))):
        with torch.no_grad():
            rep = audit.audit_multiplierless(fn, params=model)
        assert len(rep["int_dots"]) == n, name
        heads = [d for d in rep["fp_dots"] if d["rhs"][-2:] in (
            (211, D), (D, 211))]
        assert len(heads) == 1, name



def test_packed_tied_head_at_an_even_vocab():
    """At an even vocab (212 here, 257216 at full width) the pack4 view
    packs the tied table, as the reference's; its transposed readout
    resolves to the decode backend, one call a forward; the view and
    manifest equal the reference's and the greedy tokens its loop's."""
    jcfg, tcfg = vlm_cfgs(vocab=212)
    params, axes = japi.init(jax.random.PRNGKey(2), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    pol_j, pol_t = japi.resolved_policy(jcfg), tapi.resolved_policy(tcfg)
    js, jm = j_serve_view(jq, pack4=True, policy=pol_j, with_manifest=True)
    model, tm = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=True,
                             policy=pol_t, with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    assert tm == jm and tm["embed/table"]["backend"] == "packed4"
    assert model.embed.table.a.dtype == torch.uint8
    batch = vlm_batch(7, vocab=212)
    _, want = jax_prefixed_loop(jcfg.replace(kernel_backend="decode"), js, batch,
                        STEPS)
    before = ops.read_counts()
    with torch.no_grad():
        got = tserving.generate(model, tcfg,
                                {k: _t(v) for k, v in batch.items()},
                                steps=STEPS, device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    assert delta[1]["plain"] == 7 * tcfg.n_layers * STEPS
    assert delta[DECODE]["decode"] == STEPS and delta[0]["plain"] == 0




# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _queue(cfg):
    """synthetic_requests(seed=0): 6 requests, prompts up to 12 tokens,
    up to 6 new; requests 1 and 4 lose their prefix (text-only)."""
    reqs = synthetic_requests(cfg, 6, max_prompt=12, max_new=6, seed=0)
    for i in (1, 4):
        del reqs[i]["prefix_embeds"]
    for r in reqs:
        del r["arrival_s"]
    return reqs


def test_synthetic_requests_equal_reference():
    """The reference's rng sequence: prompts, budgets and each request's
    (P, D) prefix, drawn after its tokens, equal for the same seed."""
    jcfg, tcfg = vlm_cfgs()
    a = synthetic_requests(tcfg, 5, max_prompt=16, max_new=8, seed=3)
    b = j_synthetic(jcfg, 5, max_prompt=16, max_new=8, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["prefix_embeds"], y["prefix_embeds"])
        assert x["max_new"] == y["max_new"]
        assert x["prefix_embeds"].shape == (PFX, D)


@pytest.mark.parametrize("speculative", [0, 2])
def test_slot_engine_matches_jax_engine(vlm, speculative):
    """synthetic_requests(seed=0) with two text-only requests mixed in,
    through the slot pool (2 slots, act_bits 32): every request's tokens
    equal the JAX engine's; the speculative twin (k = 2, 2-bit draft)
    gives the same tokens; prefixed and text-only requests never share a
    prefill; ``kv_pages`` keeps a vlm engine on its slot pool."""
    jcfg, tcfg, js, model = vlm_views(vlm, "int8", act_bits=32)
    reqs = _queue(tcfg)
    kw = dict(capacity=2, max_len=12 + 6 + 2)
    jeng = JEngine(js, jcfg.replace(kernel_backend="decode"), **kw)
    eng = Engine(model, tcfg, device="cpu", kv_pages=16, page_size=8,
                 speculative=speculative, draft_bits=2, **kw)
    assert not eng.paged and eng.max_len == kw["max_len"] + PFX
    groups = []
    admit = eng._admit_group

    def spy(slots, group):
        groups.append({r.prefix_embeds is not None for r in group})
        return admit(slots, group)

    eng._admit_group = spy
    for r in reqs:
        jeng.submit(**r)
        eng.submit(**r)
    with torch.no_grad():
        got = eng.run()
    for want, res in zip(jeng.run(), got):
        np.testing.assert_array_equal(res["tokens"], want["tokens"],
                                      err_msg=f"request {res['rid']}")
    assert all(len(g) == 1 for g in groups) and len(groups) >= 2
    st = eng.stats()
    assert st["paged"] is False and st["completed"] == len(reqs)
    if speculative:
        assert st["spec_rounds"] > 0
    jax.clear_caches()


def test_speculative_generate_equals_plain(vlm):
    """speculative=2 (draft_bits 2) over a prefixed ragged batch gives
    plain decoding's tokens at act_bits 32."""
    _, tcfg, _, model = vlm_views(vlm, "int8", act_bits=32)
    batch = {k: _t(v) for k, v in vlm_batch(5).items()}
    lengths = torch.tensor([T, 6])
    with torch.no_grad():
        base = tserving.generate(model, tcfg, batch, steps=8,
                                 lengths=lengths, device="cpu")
        spec, stats = tserving.generate(model, tcfg, batch, steps=8,
                                        lengths=lengths, speculative=2,
                                        draft_bits=2, return_stats=True,
                                        device="cpu")
    assert torch.equal(base, spec)
    assert stats["spec_rounds"] > 0


def test_engine_length_check_and_refusals(vlm):
    """A vlm request's length check counts the prefix's slots, even for
    a text-only request (as the reference's); a prefix of another width
    is refused; a slot's ``len`` after admission counts the prefix only
    where the request brought one."""
    _, tcfg, _, model = vlm_views(vlm, "int8", act_bits=32)
    eng = Engine(model, tcfg, capacity=2, max_len=12, device="cpu")
    assert eng.max_len == 12 + PFX
    with pytest.raises(ValueError, match="exceeds engine max_len 12"):
        eng.submit(np.arange(8), max_new=5)
    with pytest.raises(ValueError, match=r"expected \(8, 64\)"):
        eng.submit(np.arange(4), max_new=2,
                   prefix_embeds=np.zeros((PFX - 1, D)))
    eng.submit(np.arange(7), max_new=5, prefix_embeds=np.zeros((PFX, D)))
    eng.submit(np.arange(5), max_new=5)
    with torch.no_grad():
        eng.step()
    # admitted and one decode step taken
    np.testing.assert_array_equal(eng.cache["len"].numpy(),
                                  [7 + PFX + 1, 5 + 1])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"],
                                   ["--act-bits", "32", "--speculative", "2",
                                    "--draft-bits", "2"]])
def test_cli_serves_on_cpu(capsys, flags):
    """The serve CLI on reduced paligemma in each view, the engine
    (through its slot pool) and speculative decoding: prefixed batches,
    plain versions, no launch."""
    from repro_torch.launch import serve as t_serve_cli

    before = ops.read_counts()
    assert t_serve_cli.main(["--arch", VLM, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "3", "--device",
                             "cpu"] + flags) == 0
    out = capsys.readouterr().out
    delta = ops.count_delta(before)
    assert f"[serve] {VLM}:" in out and "device cpu" in out
    assert any(d.get("plain", 0) > 0 for d in delta)
    assert all(d.get("launches", 0) == 0 for d in delta)
    if "--engine" in flags:
        assert "3/3 requests" in out and "[serve] paged KV" not in out
    else:
        assert f"after a {PFX}-token image prefix" in out


def test_train_cli_checkpoint_serves_the_in_memory_tokens(tmp_path, capsys):
    """Two reduced training steps of the train CLI's prefixed batches
    (the loss over the text only), run in memory and through the CLI into
    a checkpoint: the same trained leaves; the serve CLI's ``--ckpt-dir``
    generate prints the tokens that the in-memory model's serve view
    gives on the CLI's batch."""
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli
    from repro_torch.runtime.loop import TrainLoop

    d = str(tmp_path / "ckpt")
    flags = ["--arch", VLM, "--reduced", "--steps", "2", "--batch", "2",
             "--seq", "12", "--vocab", "64", "--device", "cpu"]
    args = t_train_cli.parser().parse_args(flags)
    args.device = torch.device("cpu")
    cfg, state, step_fn = t_train_cli.build(args)
    make_batch = t_train_cli.batch_fn(MarkovLM(cfg.vocab, seed=0), args,
                                      args.device, cfg)
    b0 = make_batch(0)
    assert b0["prefix_embeds"].shape == (2, PFX, D)
    assert torch.equal(b0["prefix_embeds"], make_batch(0)["prefix_embeds"])
    assert not torch.equal(b0["prefix_embeds"],
                           make_batch(1)["prefix_embeds"])
    loop = TrainLoop(step_fn, make_batch, log_every=10,
                     quant_policy=tapi.resolved_policy(cfg))
    state, _ = loop.run(state, 2, handle_signals=False)
    assert t_train_cli.main(flags + ["--ckpt-dir", d]) == 0
    capsys.readouterr()
    params, step = tckpt.restore_params(d)
    assert step == 2
    t_serve_cli.check_ckpt_shapes(cfg, params["trainable"])
    mem = dict(interop.walk(interop.train_state_to_numpy(state)[
        "trainable"]))
    for path, leaf in interop.walk(params["trainable"]):
        np.testing.assert_array_equal(np.asarray(leaf), mem[path],
                                      err_msg="/".join(path))
    assert t_serve_cli.main(["--arch", VLM, "--reduced", "--vocab", "64",
                             "--batch", "2", "--prompt-len", "8", "--gen",
                             "5", "--device", "cpu", "--ckpt-dir", d]) == 0
    out = capsys.readouterr().out
    assert f"restored train checkpoint step 2 from {d}" in out
    # the CLI's batch: tokens from --seed + 1, the prefix from --seed + 3
    scfg = cfg.replace(act_bits=8, kernel_backend="auto")
    toks = torch.randint(0, 64, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    pe = torch.randn((2, PFX, D), generator=torch.Generator().manual_seed(3))
    sview = t_serve_view(state.model, policy=tapi.resolved_policy(cfg))
    with torch.no_grad():
        want = tserving.generate(sview, scfg, {"tokens": toks,
                                               "prefix_embeds": pe},
                                 steps=5, device="cpu")
    assert f"sample: {want[0, :8].tolist()}" in out
