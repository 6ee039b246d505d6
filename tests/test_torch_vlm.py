"""Port parity, paligemma-3b (the vlm family): reduced (2 layers, d_model
64, 4 query heads of 16 over 1 KV head, vocab 211, a tied readout, a
prefix of 8 image embeddings) under the config's 4-bit pow2 LUT-Q,
against the JAX package on the same numpy-seeded inputs.

The prefix is a batch's ``prefix_embeds`` (B, 8, 64), float32 from a
numpy seed, cast to the working dtype by both packages; prefix and text
share positions 0 .. 8 + T - 1, and the prefix attends itself both
ways.

Held exactly: the serve views and manifests; greedy tokens of
``generate`` against the reference's prefill / decode loop at the
config's act_bits 8 (a float ulp may move an 8-bit activation level, so
logits are held at act_bits 32, as the other families' tests do); the
prefix-positions oracle (teacher-forced full prefills) for prefixed and
text-only requests; the engines' tokens against the JAX engine's;
``synthetic_requests`` against the reference's; the audit's integer
dots.

Tolerances: ``flash_attention(prefix=)`` within 1e-6 of the largest
output in float32 (float32 sums in another order); prefill and decode
logits within 1e-4 of the largest logit in float32 and 2^-9 (half a
bf16 ulp) in bfloat16, as ``test_torch_dense_families.py``; prefill K/V
within 1e-5 (float32) and 2^-8 (bfloat16) of their largest entry; the
loss within 1e-5 relative and every gradient within 1e-4 of its largest
element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, assert_trees_equal,
                                jax_prefixed_loop, one_thread, to_np,
                                vlm_batch, vlm_cfgs, vlm_trees, vlm_views)

from repro.core import policy as jpolicy
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.kernels import audit as jaudit
from repro.models import api as japi
from repro.nn import attention as jattn
from repro.runtime import serving as jserving
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.kernels import audit, ops
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.runtime import serving as tserving

ARCH = "paligemma-3b"
B, T, STEPS, PFX, D = 2, 10, 4, 8, 64
RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}
KV_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
#: count_dicts() index of each view's plain product
PLAIN = {"int8": 0, "packed4": 1, "pow2": 2}
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


def _port_forced(tcfg, model, batch, ref_tokens, lengths=None):
    """The port's logits along the reference's tokens: prefill (with the
    prefix), adapt, one decode step a reference token."""
    n, width = batch["tokens"].shape
    pfx = PFX if "prefix_embeds" in batch else 0
    steps = ref_tokens.shape[1]
    with torch.inference_mode():
        logits, cache = tapi.prefill(
            model, tcfg, {k: _t(v) for k, v in batch.items()},
            lengths=None if lengths is None else _t(lengths))
        cache = tserving.adapt_prefill_cache(tcfg, cache, n,
                                             width + steps + pfx)
        outs = [logits[:, -1].float().numpy()]
        for t in range(1, steps):
            tok = _t(ref_tokens[:, t - 1:t])
            logits, cache = tapi.decode_step(model, tcfg, tok, cache)
            outs.append(logits[:, -1].float().numpy())
    return outs

# ---------------------------------------------------------------------------
# the configuration and what the port admits
# ---------------------------------------------------------------------------

def test_full_width_config_is_the_reference():
    """Field for field the reference's config; the port's entry points
    admit it; it stays off the paged path and speculation is open at
    act_bits 32, as in the reference."""
    from repro.configs import get_config as jget

    cfg, ref = tconfigs.get_config(ARCH), jget(ARCH)
    assert ARCH in tconfigs.list_archs()
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "head_dim", "resolved_head_dim",
              "rope_theta", "window", "qkv_bias", "tie_embeddings",
              "n_prefix_tokens", "act_bits", "quant", "quantize_embed"):
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    tapi._ported(cfg)
    tlm._check_family(cfg)
    assert not tapi.paged_supported(cfg) and not japi.paged_supported(ref)
    assert tapi.speculative_supported(cfg.replace(act_bits=32)) == (True, "")
    assert not tapi.speculative_supported(cfg)[0]
    _, tcfg = vlm_cfgs()
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.resolved_head_dim,
            tcfg.n_prefix_tokens, tcfg.vocab) == (4, 1, 16, PFX, 211)


def test_interop_round_trip_and_logical_paths(vlm):
    """from_jax -> to_numpy gives the quantized tree back bit for bit,
    the tied table included (no lm_head), and the port's logical paths
    are the reference's (``embed/table``, ``layers/attn/q/kernel``)."""
    _, tcfg = vlm_cfgs()
    model = interop.from_jax(to_np(vlm["jq"]), tcfg)
    assert not hasattr(model, "lm_head")
    assert_trees_equal(to_np(vlm["jq"]), interop.to_numpy(model))
    shapes = interop.trainable_shapes(tcfg)
    assert shapes[("embed", "table")] == (211, D)
    assert not any(p[0] == "lm_head" for p in shapes)


# ---------------------------------------------------------------------------
# attention, forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,prefix", [(22, 8), (16, 16), (37, 5)])
def test_flash_attention_prefix_equals_reference(S, prefix):
    """``flash_attention(prefix=)`` (q/kv blocks of 16, a padded last
    block where S is not a multiple) against the reference's
    ``dense_attention(prefix=)`` oracle and its ``flash_attention``, MQA
    (4 query heads over 1 KV head); the prefix changes the output; the
    packed overrides refuse a prefix."""
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, S, 1, 16).astype(np.float32) for _ in "kv")
    want = np.asarray(jattn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), prefix=prefix))
    jflash = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), prefix=prefix,
        q_block=16, kv_block=16))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), prefix=prefix,
                                q_block=16, kv_block=16).numpy()
    tol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jflash, rtol=0, atol=tol)
    causal = tattn.flash_attention(_t(q), _t(k), _t(v), q_block=16,
                                   kv_block=16).numpy()
    assert np.abs(causal[:, :prefix - 1] - got[:, :prefix - 1]).max() > 1e-3
    np.testing.assert_array_equal(causal[:, prefix:], got[:, prefix:])
    pos = torch.arange(S)
    with pytest.raises(ValueError, match="prefix with the packed"):
        tattn.flash_attention(_t(q), _t(k), _t(v), prefix=prefix,
                              q_positions=pos, kv_positions=pos,
                              q_segments=pos * 0, kv_segments=pos * 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_logits_and_caches(vlm, dtype):
    """The int8 view at act_bits 32: ``lm_forward`` over a prefixed batch
    (logits at every prefix and text position); ``lm_prefill`` with
    ragged text lengths (10 and 6) after the prefix: its last logits, its
    K/V at every position and ``len`` = 8 + lengths; a text-only prefill
    on the vlm config has ``len`` = lengths; the adapted cache crosses
    ``interop``'s cache converters both ways."""
    jcfg, tcfg, js, model = vlm_views(vlm, "int8", dtype, act_bits=32)
    batch = vlm_batch(3)
    lengths = np.array([T, 6], np.int32)
    jb = jax.tree.map(jnp.asarray, batch)
    fwd = jax.jit(lambda p, b: japi.m_lm.lm_forward(
        p, jcfg, b["tokens"], prefix_embeds=b["prefix_embeds"])[0],
        compiler_options=STRICT)
    pre = jax.jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n),
                  compiler_options=STRICT)
    want_f = np.asarray(fwd(js, jb).astype(jnp.float32))
    want_l, want_c = pre(js, jb, jnp.asarray(lengths))
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.inference_mode():
        got_f = tlm.lm_forward(model, tcfg, tb["tokens"],
                               prefix_embeds=tb["prefix_embeds"])[0]
        got_l, got_c = tapi.prefill(model, tcfg, tb, lengths=_t(lengths))
        _, text_c = tapi.prefill(model, tcfg, {"tokens": tb["tokens"]},
                                 lengths=_t(lengths))
    assert got_f.shape == (B, PFX + T, tcfg.vocab)
    np.testing.assert_allclose(
        got_f.float().numpy(), want_f, rtol=0,
        atol=RTOL[dtype] * float(np.abs(want_f).max()))
    wl = np.asarray(want_l.astype(jnp.float32))
    np.testing.assert_allclose(got_l.float().numpy(), wl, rtol=0,
                               atol=RTOL[dtype] * float(np.abs(wl).max()))
    np.testing.assert_array_equal(got_c["len"].numpy(), lengths + PFX)
    np.testing.assert_array_equal(np.asarray(want_c["len"]), lengths + PFX)
    np.testing.assert_array_equal(text_c["len"].numpy(), lengths)
    # the adapted (decode-width) cache crosses to the reference's layout
    # and back bit for bit
    adapted = tserving.adapt_prefill_cache(tcfg, got_c, B, PFX + T + 4)
    ref = interop.cache_to_numpy(adapted, tcfg)
    assert ref["layers"]["k"].shape == (tcfg.n_layers, B, PFX + T + 4, 1, 16)
    back = interop.cache_from_jax(ref, tcfg)
    assert torch.equal(back["len"], adapted["len"])
    for c, a in zip(back["layers"], adapted["layers"]):
        assert all(torch.equal(c[k], a[k]) for k in ("k", "v"))
    for i, layer in enumerate(got_c["layers"]):
        for key in ("k", "v"):
            w = np.asarray(want_c["layers"][key][i].astype(jnp.float32))
            g = layer[key].float().numpy()
            assert g.shape == (B, PFX + T, 1, 16)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=KV_TOL[dtype] * float(np.abs(w).max()),
                err_msg=f"layer {i} {key}")
    jax.clear_caches()


def test_decode_logits_along_the_jax_tokens(vlm):
    """The int8 view at act_bits 32 in float32: the port's logits along
    the reference loop's tokens, prefill and each decode step, over a
    prefixed batch with ragged text and over a text-only batch."""
    jcfg, tcfg, js, model = vlm_views(vlm, "int8", act_bits=32)
    for batch, lengths in ((vlm_batch(4), np.array([7, T], np.int32)),
                           (vlm_batch(5, prefix=False), None)):
        want, ref_tokens = jax_prefixed_loop(jcfg, js, batch, STEPS, lengths)
        got = _port_forced(tcfg, model, batch, ref_tokens, lengths)
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=RTOL["float32"] * float(np.abs(w).max()),
                err_msg=f"step {t}, prefix {'prefix_embeds' in batch}")


@pytest.mark.parametrize("view", ["train", "int8", "packed4", "pow2"])
def test_generate_tokens_identical(vlm, view):
    """Greedy tokens through ``generate`` (act_bits 8) equal the JAX
    prefill / decode loop's over a prefixed batch, in the train form and
    each serve view (serving_pow2: against JAX's integer decode oracle),
    through the plain products a forward should run: 7 a layer (5 under
    serving_pow2, whose min_size leaves k and v float), and the tied head (int8: one fused product; packed4 at the odd vocab: the
    table stays int8, fused; serving_pow2: a float product)."""
    jcfg, tcfg, js, model = vlm_views(vlm, view)
    batch = vlm_batch(6)
    _, want = jax_prefixed_loop(jcfg.replace(kernel_backend="decode"), js, batch,
                        STEPS)
    before = ops.read_counts()
    with torch.no_grad():
        got = tserving.generate(model, tcfg,
                                {k: _t(v) for k, v in batch.items()},
                                steps=STEPS, device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    if view == "train":
        return
    # serving_pow2's min_size (4096) leaves the reduced k and v float
    body = (5 if view == "pow2" else 7) * tcfg.n_layers * STEPS
    head = 0 if view == "pow2" else STEPS
    assert delta[PLAIN[view]]["plain"] == body + (head if view == "int8"
                                                  else 0)
    assert sum(delta[i]["plain"] for i in (0, 1, 2)) == body + head
    assert delta[DECODE]["decode"] == 0
    assert all(d.get("launches", 0) == 0 for d in delta)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_lm_loss_and_gradients_equal_jax_grad(vlm):
    """The loss of a prefixed batch (the prefix's logits dropped, labels
    over the text) and its gradient through the STE: equal to
    ``jax.value_and_grad`` of the reference's over its trainable split,
    the tied table's gradient (lookup and readout) among them."""
    jcfg, tcfg = vlm_cfgs()
    batch = vlm_batch(12, t=16)
    toks = batch["tokens"]
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)],
                            axis=1)
    trainable, static = jpolicy.split_trainable(vlm["jq"])
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "prefix_embeds": jnp.asarray(batch["prefix_embeds"])}

    def jloss(tr):
        return japi.loss_fn(jpolicy.merge_trainable(tr, static), jcfg,
                            jb)[0]

    jl, jg = jax.value_and_grad(jloss)(trainable)
    model = interop.from_jax(to_np(vlm["jq"]), tcfg)
    loss, metrics = tapi.loss_fn(model, tcfg, {k: _t(np.asarray(v))
                                               for k, v in jb.items()})
    loss.backward()
    assert float(metrics["ntok"]) == B * 15
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    wants = dict(interop.walk(to_np(jg)))
    checked = 0
    for name, p in model.named_parameters():
        # a quantized leaf's master is its kernel's ``w``
        path = tuple((name[:-2] if name.endswith(".w") else name).split("."))
        if path[0] == "layers":
            i, path = int(path[1]), ("layers",) + path[2:]
        else:
            i = None
        want = np.asarray(wants[path])
        want = want if i is None else want[i]
        assert p.grad is not None and np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
        checked += 1
    assert checked == len(list(model.parameters())) > 7 * tcfg.n_layers


# ---------------------------------------------------------------------------
# the prefix-positions oracle (the reference's test_engine.py)
# ---------------------------------------------------------------------------

def test_engine_vlm_prefix_positions_vs_oracle(vlm):
    """The reference's ``test_engine_vlm_prefix_positions_vs_oracle`` on
    the port (the float model, act_bits 32): a prefix occupies cache
    slots, so ``generate`` and the engine must count prefix + text in
    the cache's length or decode overwrites live K/V; pinned against the
    teacher-forced full-prefill oracle (one prefill a token), for
    prefixed and text-only requests (which occupy no prefix slot); the
    oracle's tokens are also the reference's ``generate``'s."""
    from repro.runtime.serving import generate as j_generate
    from repro_torch.runtime.engine import Engine

    jcfg, tcfg = vlm_cfgs(act_bits=32)
    jcfg, tcfg = jcfg.replace(quant=None), tcfg.replace(quant=None)
    model = interop.from_jax(to_np(vlm["params"]), tcfg)
    G, P = 4, 6
    batch = vlm_batch(13, t=P)
    for prefixed in (True, False):
        b = batch if prefixed else {"tokens": batch["tokens"]}
        tb = {k: _t(v) for k, v in b.items()}
        cur, want = tb["tokens"], []
        with torch.no_grad():
            for _ in range(G):
                lg, _ = tapi.prefill(model, tcfg, {**tb, "tokens": cur})
                nxt = torch.argmax(lg[:, -1].float(), -1)[:, None].to(
                    torch.int32)
                want.append(nxt)
                cur = torch.cat([cur, nxt], 1)
            want = torch.cat(want, 1).numpy()
            got = tserving.generate(model, tcfg, tb, steps=G, max_len=P + G,
                                    device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        jgot = j_generate(vlm["params"], jcfg,
                          jax.tree.map(jnp.asarray, b), steps=G,
                          max_len=P + G)
        np.testing.assert_array_equal(np.asarray(jgot), want)
        eng = Engine(model, tcfg, capacity=2, max_len=P + G, device="cpu")
        for i in range(B):
            eng.submit(b["tokens"][i], max_new=G,
                       prefix_embeds=(b["prefix_embeds"][i] if prefixed
                                      else None))
        with torch.no_grad():
            for i, r in enumerate(eng.run()):
                np.testing.assert_array_equal(r["tokens"], want[i])
        assert eng.stats()["max_len"] == P + G + PFX
    jax.clear_caches()
