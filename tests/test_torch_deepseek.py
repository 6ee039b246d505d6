"""Port parity, deepseek-v2-lite-16b: reduced (3 layers, the first a
dense prefix layer, d_model 64, 4 heads, MLA with kv_lora 24, q/k heads
of 16 + 8 rope, v heads of 16; 4 routed experts top-2 plus 1 shared of
96, capacity factor 4, vocab 211) against the JAX package on the same
numpy-seeded inputs.

The reduced MLA leaves are small (uk 24 x 64 = 1536 elements), under the
presets' 4096-element floor, so every policy here has ``min_size=0``: all
five MLA leaves of every layer are quantized and the absorbed decode
reads LUT-Q ``uk`` / ``uv`` leaves.

Held bit for bit: assignments, dictionaries and rule ids after
``quantize``; ``from_jax`` / ``to_numpy`` of the ``prefix_layers``; the
trainable shapes; greedy tokens through ``generate`` (int8, packed4,
calibrated ``serving_pow2``) and the slot ``Engine`` against lone
``generate``s.

Tolerances:

* ``mla_forward`` / ``mla_decode`` outputs: 1e-5 of max|out| in float32
  (the same float32 ops, summed in another order); in bfloat16 2^-7 of
  max|out| (one bf16 ulp of the largest output: the port's bf16 einsums
  and attention round where XLA's do, each product accumulated in
  another order).
* prefill caches: 1e-5 of max|c_kv| (float32).
* ``lm_forward`` logits, as ``test_torch_moe.py``: 1e-4 of max|logit| in
  float32, 2^-9 in bfloat16; aux within 1e-5.
* prefill and decode logits along the reference's tokens: 1e-4 of
  max|logit| at act_bits 32. At 8 bits a float ulp moves an activation
  to another int8 level and the logits by percents (ROADMAP queue 3), so
  there the greedy tokens are compared, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_reference, one_thread,
                                port_teacher_forced, to_np, tokens)

from repro.configs import get_config as jget
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import QuantPolicy as JPolicy
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.core.spec import QuantSpec as JSpec
from repro.models import api as japi
from repro.models import lm as jlm
from repro.models.reduce import reduced as jreduced
from repro.nn import mla as jmla
from repro.runtime import serving as jserving
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_archs
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.core.rules import with_size_floor
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels import audit, ops
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models.reduce import reduced as treduced
from repro_torch.nn import mla as tmla
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

ARCH = "deepseek-v2-lite-16b"
B, P, STEPS = 2, 12, 4
RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}
MLA_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CALIB = np.random.RandomState(1).randint(0, 211, (2, 12)).astype(np.int32)
#: kernel_report's module index of each view's plain product and stack
PLAIN = {"int8": (0, 8), "packed4": (1, 9), "pow2": (2, 10)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _j_floor0(policy):
    """The reference's ``policy`` with every quantizing rule's floor at 0
    (the port's ``with_size_floor``)."""
    return JPolicy(rules=tuple(r if r.spec is None
                               else dataclasses.replace(r, min_size=0)
                               for r in policy.rules), name=policy.name)


def _cfgs(dtype="float32", **kw):
    """Reduced deepseek, the config's 4-bit pow2 LUT-Q at floor 0, both
    sides (``quant=None``: float)."""
    fp = "quant" in kw and kw.pop("quant") is None
    jcfg, tcfg = cfg_pair(dtype, arch=ARCH, constraint="pow2", remat=False,
                          **kw)
    if fp:
        return jcfg.replace(quant=None), tcfg.replace(quant=None)
    spec = dict(bits=4, constraint="pow2", min_size=0)
    return (jcfg.replace(quant=JSpec(**spec)),
            tcfg.replace(quant=TSpec(**spec)))


def _pow2_cfgs(**kw):
    jcfg, tcfg = _cfgs(quant=None, **kw)
    return (jcfg.replace(quant=_j_floor0(j_serving_pow2())),
            tcfg.replace(quant=with_size_floor(t_serving_pow2(), 0)))


@pytest.fixture(scope="module")
def ds():
    """The JAX float params, their quantized tree and the calibrated
    serving_pow2 tree."""
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    pcfg, _ = _pow2_cfgs()
    pq = japi.quantize(params, pcfg, axes)
    jcal = japi.calibrate(pq, pcfg, {"tokens": jnp.asarray(CALIB)})
    return dict(params=params, axes=axes, jq=jq, jcal=jcal)


def _views(ds, view, **kw):
    """(JAX config, port config, JAX serve tree, port serve model) of a
    view: int8 (fused), packed4, or the calibrated serving_pow2."""
    if view == "pow2":
        jcfg, tcfg = _pow2_cfgs(**kw)
        src = ds["jcal"]
    else:
        jcfg, tcfg = _cfgs(**kw)
        src = ds["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


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
    ``only`` the paths containing that key."""
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


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "head_dim", "rope_theta", "tie_embeddings", "use_mla",
          "kv_lora", "qk_nope", "qk_rope", "v_head", "n_experts", "top_k",
          "n_shared_experts", "d_ff_shared", "first_dense",
          "capacity_factor", "act_bits", "quant", "window", "qkv_bias")


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_equals_reference(reduce):
    """Every field of the config (and of its reduced form: 3 layers, the
    first dense, 4 experts top-2, 1 shared of 96, kv_lora 24, heads of
    16 + 8 and 16) equals the reference's; the port admits MLA and the
    prefix layer, and keeps both off the paged path."""
    ref, cfg = jget(ARCH), tget(ARCH)
    assert ARCH in list_archs()
    if reduce:
        ref, cfg = jreduced(ref), treduced(cfg)
        assert (cfg.n_layers, cfg.first_dense, cfg.n_experts, cfg.top_k,
                cfg.n_shared_experts, cfg.d_ff_shared, cfg.kv_lora,
                cfg.qk_nope, cfg.qk_rope, cfg.v_head) == (
                    3, 1, 4, 2, 1, 96, 24, 16, 8, 16)
    for f in FIELDS:
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    tlm._check_family(cfg)
    tapi._ported(cfg)
    assert not tapi.paged_supported(cfg) and not japi.paged_supported(ref)
    assert tlm.n_stacked(cfg) == cfg.n_layers - 1


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def _mla_pair(ds, leaf, dtype):
    """The prefix layer's attention in both packages (float, int8,
    packed4 or serving_pow2 leaves), their configs, backends."""
    if leaf == "float":
        jcfg, tcfg = _cfgs(dtype, quant=None)
        jp = ds["params"]["prefix_layers"]["0"]["attn"]
        model = interop.from_jax(to_np(ds["params"]), tcfg)
    else:
        jcfg, tcfg, js, model = _views(ds, leaf, dtype=dtype)
        jp = js["prefix_layers"]["0"]["attn"]
    return jcfg, tcfg, jp, model.prefix_layers["0"].attn


def _dims(cfg):
    return dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
                qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope, v_head=cfg.v_head)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leaf", ["float", "int8", "packed4", "pow2"])
def test_mla_forward_and_decode_match(ds, leaf, dtype):
    """The expanded prefill (out, c_kv, k_rope) and two absorbed decode
    steps against a cache with a free column past the prompt: outputs
    within MLA_TOL, the caches written in place where the reference
    writes, the decode reading the LUT-Q uk / uv leaves decoded."""
    jcfg, tcfg, jp, tp = _mla_pair(ds, leaf, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    S = 9
    x = np.random.RandomState(20).randn(B, S, 64).astype(np.float32)
    xn = np.random.RandomState(21).randn(2, B, 1, 64).astype(np.float32)
    kw = dict(_dims(tcfg), act_bits=8 if leaf == "pow2" else 32)
    pos = np.arange(S)[None, :]
    jout, jc = jmla.mla_forward(jp, jnp.asarray(x, jdt), jnp.asarray(pos),
                                backend="decode", **kw)
    with torch.no_grad():
        tout, tc = tmla.mla_forward(tp, _t(x).to(tdt), _t(pos), **kw)
    assert tout.dtype == tdt and tc["c_kv"].shape == (B, S, 24)
    _close(tout.float().numpy(), jout, MLA_TOL[dtype])
    _close(tc["c_kv"].float().numpy(), jc["c_kv"], MLA_TOL[dtype])
    _close(tc["k_rope"].float().numpy(), jc["k_rope"], MLA_TOL[dtype])
    # a cache of S + 2 columns holding the reference's prefill latents
    pad = lambda a: np.pad(np.asarray(a.astype(jnp.float32)),  # noqa: E731
                           ((0, 0), (0, 2), (0, 0)))
    jcache = {k: jnp.asarray(pad(jc[k]), jdt) for k in ("c_kv", "k_rope")}
    tcache = {k: _t(pad(jc[k])).to(tdt) for k in ("c_kv", "k_rope")}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for step in range(2):
        n = S + step
        jo, jcache = jmla.mla_decode(jp, jnp.asarray(xn[step], jdt), jcache,
                                     jnp.full((B,), n, jnp.int32),
                                     backend="decode", **kw)
        with torch.no_grad():
            to = tmla.mla_decode(tp, _t(xn[step]).to(tdt), tcache,
                                 torch.full((B, 1), n, dtype=torch.int32),
                                 **kw)
        _close(to.float().numpy(), jo, MLA_TOL[dtype])
        for k in ("c_kv", "k_rope"):
            assert tcache[k].data_ptr() == ptrs[k]
            _close(tcache[k].float().numpy(), jcache[k], MLA_TOL[dtype])


def test_mla_decode_write_clamps_to_the_last_column():
    """At a length past the cache, the write lands on the last column,
    as ``dynamic_update_slice`` clamps it, and every column attends."""
    _, tcfg = _cfgs(quant=None)
    tp = tmla.mla_init(torch.Generator().manual_seed(0), 64, 4,
                       **{k: v for k, v in _dims(tcfg).items()
                          if k != "n_heads"})
    jp = {k: {"kernel": jnp.asarray(getattr(tp, k).kernel.detach().numpy())}
          for k in ("q", "dkv", "uk", "uv", "o")}
    rng = np.random.RandomState(3)
    x = rng.randn(B, 1, 64).astype(np.float32)
    cache = {"c_kv": rng.randn(B, 5, 24).astype(np.float32),
             "k_rope": rng.randn(B, 5, 8).astype(np.float32)}
    jo, jc = jmla.mla_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                              cache),
                             jnp.asarray([4, 7], jnp.int32), **_dims(tcfg))
    tc = {k: _t(v) for k, v in cache.items()}
    with torch.no_grad():
        to = tmla.mla_decode(tp, _t(x), tc, _t([[4], [7]]).int(),
                             **_dims(tcfg))
    _close(to.numpy(), jo, MLA_TOL["float32"])
    for k in tc:
        _close(tc[k].numpy(), jc[k], MLA_TOL["float32"])
        assert not np.array_equal(tc[k][1, -1].numpy(), cache[k][1, -1])


# ---------------------------------------------------------------------------
# the tree: interop, trainable shapes, quantize
# ---------------------------------------------------------------------------

def test_interop_round_trip_with_prefix_layers(ds):
    """from_jax / to_numpy carry prefix_layers (unstacked) and the
    2-layer stack both ways, bit for bit; state-dict keys are the
    reference's paths."""
    _, tcfg = _cfgs()
    model = interop.from_jax(to_np(ds["jq"]), tcfg)
    assert len(model.layers) == 2 and list(model.prefix_layers) == ["0"]
    assert hasattr(model.prefix_layers["0"], "mlp")
    assert all(hasattr(layer, "moe") for layer in model.layers)
    keys = set(model.state_dict())
    assert {"prefix_layers.0.attn.q.kernel.w", "prefix_layers.0.attn.uk."
            "kernel.a", "layers.1.attn.dkv.kernel.d",
            "prefix_layers.0.mlp.wi.kernel.a"} <= keys
    assert_trees_equal(to_np(ds["jq"]), interop.to_numpy(model))
    fp = interop.from_jax(to_np(ds["params"]), _cfgs(quant=None)[1])
    assert_trees_equal(to_np(ds["params"]), interop.to_numpy(fp))


def test_trainable_shapes_equal_the_reference_tree(ds):
    from repro.core.policy import split_trainable

    _, tcfg = _cfgs()
    trainable, _ = split_trainable(ds["jq"])
    want = {path: np.shape(v) for path, v in _leaves(trainable)
            if v is not None}
    got = interop.trainable_shapes(tcfg)
    assert got == want
    assert got[("layers", "attn", "dkv", "kernel")] == (2, 64, 32)
    assert got[("prefix_layers", "0", "attn", "uk", "kernel")] == (24, 64)


def test_quantize_bit_exact(ds):
    """quantize on the same float params: every leaf's master,
    assignments, dictionaries and rule ids byte for byte, the five MLA
    leaves of the prefix layer and of the stack among them."""
    _, tcfg = _cfgs()
    model = tapi.quantize(interop.from_jax(to_np(ds["params"]), tcfg), tcfg)
    got = interop.to_numpy(model)
    for k in ("w", "d", "a", "sid"):
        assert_trees_equal(to_np(ds["jq"]), got, only=k)
    for scope in (got["prefix_layers"]["0"]["attn"], got["layers"]["attn"]):
        assert all(hasattr(scope[k]["kernel"], "d")
                   for k in ("q", "dkv", "uk", "uv", "o"))


def test_serving_pow2_views_equal(ds):
    """The calibrated serving_pow2 view: sign+exponent planes, frozen
    pairs and the manifest equal the reference's; every body leaf, the
    MLA leaves included, is pow2-encoded."""
    jcfg, tcfg, js, model = _views(ds, "pow2")
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    _, tm = t_serve_view(interop.from_jax(to_np(ds["jcal"]), tcfg),
                         policy=tapi.resolved_policy(tcfg),
                         with_manifest=True)
    _, jm = j_serve_view(ds["jcal"], policy=japi.resolved_policy(jcfg),
                         with_manifest=True)
    assert tm == jm
    for k in ("q", "dkv", "uk", "uv", "o"):
        assert tm[f"prefix_layers/0/attn/{k}/kernel"]["encoding"] == "pow2"
        assert tm[f"layers/attn/{k}/kernel"]["encoding"] == "pow2"


# ---------------------------------------------------------------------------
# the model: logits, caches, generate, engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_logits_and_aux(ds, dtype):
    jcfg, tcfg = _cfgs(dtype)
    toks = tokens(jcfg, B, P, seed=7)
    jl, jaux = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, t),
                       compiler_options={"xla_allow_excess_precision":
                                         False})(ds["jq"], jnp.asarray(toks))
    model = interop.from_jax(to_np(ds["jq"]), tcfg)
    with torch.no_grad():
        tl, taux = tlm.lm_forward(model, tcfg, _t(toks))
    want = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())
    assert abs(float(taux) - float(jaux)) <= 1e-5


def test_prefill_cache_and_adapt(ds):
    """The prefill cache in the reference's layout (prefix layer apart,
    the stack restacked) holds its latents; the decode cache's layout
    equals ``init_cache``'s; ``kv_cache_bits=8`` leaves the latents as
    they are, in both packages."""
    jcfg, tcfg, js, model = _views(ds, "int8", act_bits=32)
    toks = tokens(jcfg, B, P, seed=12)
    _, jcache = japi.prefill(js, jcfg.replace(kernel_backend="decode"),
                             {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        _, tcache = tapi.prefill(model, tcfg, {"tokens": _t(toks)})
    got, want = interop.cache_to_numpy(tcache, tcfg), to_np(jcache)
    assert sorted(got) == sorted(want) == ["layers", "len", "prefix_layers"]
    for path, w in _leaves(want):
        g = dict(_leaves(got))[path]
        assert g.shape == w.shape, path
        _close(g, w, 1e-5)
    back = interop.cache_from_jax(want, tcfg)
    assert [sorted(c) for c in back["layers"]] == [["c_kv", "k_rope"]] * 3
    init = tapi.init_cache(tcfg, B, P + 4, device="cpu")
    for q in (16, 8):
        jc = jcfg.replace(kv_cache_bits=q)
        tc = tcfg.replace(kv_cache_bits=q)
        jad = jserving.adapt_prefill_cache(jc, jcache, B, P + 4)
        tad = tserving.adapt_prefill_cache(tc, tcache, B, P + 4)
        for c, i in zip(tad["layers"], init["layers"]):
            assert {k: (v.shape, v.dtype) for k, v in c.items()} == {
                k: (v.shape, v.dtype) for k, v in i.items()}
        for c, p in zip(tad["layers"], tcache["layers"]):
            for k in ("c_kv", "k_rope"):
                assert torch.equal(c[k][:, :P], p[k])
                assert not c[k][:, P:].any()
        assert sorted(jad["layers"]) == ["c_kv", "k_rope"]
        np.testing.assert_array_equal(
            np.asarray(jad["layers"]["c_kv"][:, :, :P]),
            np.asarray(jcache["layers"]["c_kv"]))


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_generate_tokens_and_decode_logits(ds, view):
    """Each serve view: the port's generate gives the JAX prefill /
    decode loop's greedy tokens at act_bits 8, with the plain products a
    forward should run (the prefill's 5 MLA products a layer, the
    absorbed decode's 3; the dense MLP, the shared experts and the head
    (not under serving_pow2); the 3 stacked expert products of each MoE
    layer); along the reference's tokens at act_bits 32 the port's
    prefill and decode logits are held within 1e-4 of max|logit|."""
    jcfg, tcfg, js, model = _views(ds, view)
    toks = tokens(jcfg, B, P, seed=5)
    _, want = jax_reference(jcfg.replace(kernel_backend="decode"), js, toks,
                            STEPS)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=STEPS,
                            device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    plain, stacked = PLAIN[view]
    head = 0 if view == "pow2" else 1
    n_moe = tcfg.n_layers - tcfg.first_dense
    prefill = 5 * tcfg.n_layers + 3 * tcfg.n_layers + head
    decode = 3 * tcfg.n_layers + 3 * tcfg.n_layers + head
    assert delta[plain]["plain"] == prefill + (STEPS - 1) * decode
    assert sum(delta[i]["plain"] for i in (0, 1, 2)) == (
        prefill + (STEPS - 1) * decode)
    assert delta[stacked]["plain"] == STEPS * 3 * n_moe
    assert all(d.get("launches", 0) == 0 for d in delta)
    jcfg, tcfg = jcfg.replace(act_bits=32), tcfg.replace(act_bits=32)
    want_logits, want = jax_reference(jcfg.replace(kernel_backend="decode"),
                                      js, toks, STEPS)
    with torch.no_grad():
        logits = port_teacher_forced(tcfg, model, toks, want)
    for t, (g, w) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(
            w).max(), err_msg=f"step {t}")


def _ragged():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 211, n).astype(np.int32) for n in (12, 7, 9, 12)]


def test_engine_equals_lone_generates_and_refusals(ds):
    """The slot Engine (one slot: a request's experts and scales are its
    own) gives each request the tokens of its lone generate; a Engine
    given kv pages keeps the slot path; speculation is refused with the
    reference's reason; a decode window and the paged cache raise."""
    _, tcfg, _, model = _views(ds, "int8")
    reqs = _ragged()
    lone = [tserving.generate(model, tcfg, {"tokens": _t(r[None])},
                              steps=3, max_len=16, device="cpu")[0].numpy()
            for r in reqs]
    for kw in ({}, dict(kv_pages=16, page_size=8)):
        eng = Engine(model, tcfg, capacity=1, max_len=16, device="cpu",
                     **kw)
        for r in reqs:
            eng.submit(r, max_new=3)
        for res, want in zip(eng.run(), lone):
            np.testing.assert_array_equal(res["tokens"], want)
        assert eng.stats()["paged"] is False
    jcfg = _cfgs()[0]
    for ab in (8, 32):
        ok, why = tapi.speculative_supported(tcfg.replace(act_bits=ab))
        assert (ok, why) == japi.speculative_supported(
            jcfg.replace(act_bits=ab)) and not ok
    assert "MoE" in tapi.speculative_supported(tcfg.replace(act_bits=32))[1]
    with pytest.raises(ValueError):
        Engine(model, tcfg.replace(act_bits=32), capacity=1, max_len=16,
               speculative=2, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        tapi.init_paged_cache(tcfg, 2, 16, 8, 3, device="cpu")
    cache = tapi.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="dense configs only"):
        tapi.decode_window(model, tcfg, _t(np.zeros((2, 3), np.int32)),
                           cache)


def test_serving_pow2_audit_and_float_latent_products(ds):
    """The calibrated serving_pow2 view's prefill and decode step pass
    the multiply audit: the integer dots are the quantized products (8
    a layer in the prefill, 6 in the decode: uk and uv leave it) plus
    the experts' (here the plain stack's one product an expert, 3 an
    expert a MoE layer); the float dots on weights are the routers' (one
    a MoE layer) and, in the decode, the absorbed form's two products on
    the decoded uk / uv a layer (trailing dims (qk_nope, kv_lora) and
    (kv_lora, v_head))."""
    _, tcfg, _, model = _views(ds, "pow2")
    n_moe = tcfg.n_layers - tcfg.first_dense
    # the audit rules by shape: B x 10 = 20 rows keeps the routers' float
    # input (rows, 64) off uk's (24, 64)
    toks = _t(tokens(tcfg, B, 10, seed=11))
    with torch.no_grad():
        _, cache = tapi.prefill(model, tcfg, {"tokens": toks})
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, 12)
    step_tok = torch.zeros((B, 1), dtype=torch.int32)
    runs = {"prefill": (lambda: tapi.prefill(model, tcfg, {"tokens": toks}),
                        8),
            "decode": (lambda: tapi.decode_step(model, tcfg, step_tok,
                                                cache), 6)}
    for name, (fn, per_layer) in runs.items():
        with torch.no_grad():
            rep = audit.audit_multiplierless(fn, params=model)
        assert len(rep["int_dots"]) == (per_layer * tcfg.n_layers
                                        + 3 * tcfg.n_experts * n_moe), name
        routers = [d for d in rep["fp_dots"] if d["rhs"][-2:] == (64, 4)]
        assert len(routers) == n_moe
        latent = [d for d in rep["fp_dots"] if d["rhs"][-2:] in (
            (tcfg.qk_nope, tcfg.kv_lora), (tcfg.kv_lora, tcfg.v_head))]
        assert len(latent) == (2 * tcfg.n_layers if name == "decode" else 0)


@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"]])
def test_cli_serves_deepseek_on_cpu(capsys, flags):
    """The serve CLI on reduced deepseek under each policy and the
    engine (given kv pages: the slot path): the MoE layers' expert
    stacks through their plain versions, no launch."""
    from repro_torch.launch import serve as t_serve_cli

    before = ops.read_counts()
    assert t_serve_cli.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "3", "--device",
                             "cpu"] + flags) == 0
    out = capsys.readouterr().out
    delta = ops.count_delta(before)
    assert "lutq_matmul_experts 0, lutq_gemv_packed_experts 0, " \
        "lutq_shift_experts 0" in out
    stacked = {"--pack4": 9, "--quant-policy": 10}.get(
        flags[0] if flags else "", 8)
    assert delta[stacked]["plain"] > 0
    assert all(d.get("launches", 0) == 0 for d in delta)


def test_serve_edge_runs_deepseek_on_cpu(capsys):
    """serve_edge at floor 0 (all five MLA leaves quantized) and a
    20-token audit: the audit passes and shift-add equals the oracle."""
    from repro_torch.launch import serve_edge

    assert serve_edge.main(["--arch", ARCH, "--min-size", "0",
                            "--calib-len", "20", "--gen", "4",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "token-identical" in out
    assert "prefix_layers/0/attn/uk/kernel" in out
