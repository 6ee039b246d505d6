"""Port parity, rwkv6-1.6b (the ssm family): reduced (2 RWKV6 layers,
d_model 64 = 4 WKV heads of 16, d_ff 128, the decay LoRA 64 wide; vocab
211, a tied readout) against the JAX package on the same numpy-seeded
inputs.

Held against the reference, in float32 and in bfloat16 (the working
dtype; the residual stream stays f32 in both packages, so the dtype of
every output and cache leaf is checked against the reference's): the
WKV scan at lengths 1, 5, 8 and 13 at chunk 8 (under, at and over one
chunk, the last padded by identity steps), with and without an initial
state; the token shift; the time-mix, the channel-mix and
``rwkv6_layer`` on the reduced model's first layer, with and without a
state; the prefill's logits and cache, ragged lengths included; a
decode step's logits and every cache leaf, the step writing its state
into the given tensors; quantization under the config's 4-bit pow2 spec:
the same set of quantized leaves (the bare decay-LoRA leaves ``w1`` and
``w2`` among them) and the assignments bit for bit, the size floor
checked against the stacked size as the reference's; the int8, packed4
and calibrated ``serving_pow2`` serve views byte for byte, their
manifests and their logits; the parameter and cache round trips.
Tolerances: TOL for one block or one step from the same inputs,
PREFILL_TOL for a whole prefill, as tests/test_torch_zamba.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import STRICT, assert_trees_equal, cfg_pair, one_thread, to_np

from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.core.spec import QuantSpec as JSpec
from repro.models import api as japi
from repro.nn import rwkv6 as jr
from repro.runtime import serving as jserving
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core.policy import quantize_tree
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv
from repro_torch.nn import rwkv6 as tr
from repro_torch.nn.tree import layer_split, logical_path
from repro_torch.runtime import serving as tserving

ARCH = "rwkv6-1.6b"
B, T = 2, 13
V, D, H, DH = 211, 64, 4, 16
DTYPES = ["float32", "bfloat16"]
#: max |port - reference| over the reference's largest entry, for one
#: block or one decode step from the same inputs (bfloat16: half a bf16
#: ulp; the body runs in f32 in both packages)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -9}
#: the same for a whole prefill (bfloat16: one bf16 rounding that lands
#: the other way is carried through the later layers)
PREFILL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CALIB = {"tokens": np.random.RandomState(1).randint(
    0, V, (2, 12)).astype(np.int32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(view="int8", **kw):
    """(JAX config, port config) of reduced rwkv at act_bits 32 unless
    given: the config's 4-bit pow2 LUT-Q (``min_size`` 4096: every
    reduced leaf's stacked size is 8192 or more), or under
    ``view="pow2"`` the serving_pow2 policy."""
    kw.setdefault("act_bits", 32)
    min_size = kw.pop("min_size", 4096)
    jcfg, tcfg = cfg_pair(arch=ARCH, remat=False, **kw)
    if view == "pow2":
        return (jcfg.replace(quant=j_serving_pow2()),
                tcfg.replace(quant=t_serving_pow2()))
    spec = dict(bits=4, constraint="pow2", min_size=min_size)
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def rw():
    """The JAX float params (seed 0), their axes, the 4-bit pow2 tree and
    the calibrated serving_pow2 tree."""
    jcfg, _ = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    pcfg, _ = _cfgs("pow2")
    pq = japi.quantize(params, pcfg, axes)
    jcal = japi.calibrate(pq, pcfg, jax.tree.map(jnp.asarray, CALIB))
    return dict(params=params, axes=axes,
                jq=japi.quantize(params, jcfg, axes), jcal=jcal)


def _rel(a, b):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    a, b = np.asarray(a).astype(np.float64), np.asarray(b).astype(np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(x, dtype=None):
    """A torch copy of ``x``, cast to ``dtype`` (a name) if given."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _j(x, dtype=None):
    """A jnp copy of ``x``, cast to ``dtype`` (a name) if given."""
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(getattr(jnp, dtype))


def _dt(x) -> str:
    """The dtype's name, either package's array or a numpy one."""
    return str(x.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# config, paths, interop
# ---------------------------------------------------------------------------

def test_full_width_config_is_the_reference():
    """rwkv6-1.6b is registered with the reference's fields (24 layers,
    d_model 2048 = 32 WKV heads of 64, d_ff 7168, vocab 65536 tied,
    4-bit pow2, act_bits 8); the api serves it, the decoder-only entry
    points refuse it and point at models/rwkv."""
    from repro.configs import get_config as jget

    cfg, ref = tconfigs.get_config(ARCH), jget(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "ssm_head_dim", "tie_embeddings", "act_bits",
              "quant", "ssm_chunk", "subquadratic"):
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    assert cfg.d_model // cfg.ssm_head_dim == 32
    assert "ssm" in tapi.FAMILIES
    tapi._ported(cfg)
    with pytest.raises(ValueError, match="models/rwkv"):
        tlm._check_family(cfg)


def test_paths_and_round_trips(rw):
    """``layers.<i>.mix.w1`` maps to the reference's stacked path
    ``layers/mix/w1`` (one stack axis), as a kernel under a Linear does;
    the float, quantized and calibrated trees cross to the port and back
    byte for byte, and the model's leaves are the reference's."""
    assert layer_split(("layers", "1", "mix", "w1")) == (
        ("layers", "mix", "w1"), (1,))
    assert logical_path(("layers", "0", "mix", "w2")) == (
        ("layers", "mix", "w2"), 1)
    assert logical_path(("layers", "1", "mix", "cm_v", "kernel")) == (
        ("layers", "mix", "cm_v", "kernel"), 1)
    _, tcfg = _cfgs()
    for key in ("params", "jq", "jcal"):
        model = interop.from_jax(to_np(rw[key]), tcfg)
        assert len(model.layers) == 2
        assert_trees_equal(to_np(rw[key]), interop.to_numpy(model))
    mine = interop.to_numpy(tapi.init(tcfg, seed=0, device="cpu"))
    jax.tree.map(lambda a, b: np.testing.assert_equal(
        (a.shape, a.dtype), (np.asarray(b).shape, np.asarray(b).dtype)),
        mine, to_np(rw["params"]))


def test_trainable_shapes_are_the_reference_tree(rw):
    """``interop.trainable_shapes``: every float leaf of the reference's
    tree at its stacked shape (w1 and w2 at (2, 64, 64))."""
    _, tcfg = _cfgs()
    want = {p: tuple(np.asarray(x).shape)
            for p, x in interop.walk(to_np(rw["params"]))}
    got = interop.trainable_shapes(tcfg)
    assert got == want
    assert got[("layers", "mix", "w1")] == (2, D, 64)
    assert got[("layers", "mix", "w2")] == (2, 64, D)


# ---------------------------------------------------------------------------
# the RWKV6 block
# ---------------------------------------------------------------------------

def _scan_inputs(S, seed):
    rng = np.random.RandomState(seed)
    Bn, Hn, dk = 2, 3, 4
    return dict(r=rng.randn(Bn, S, Hn, dk).astype(np.float32),
                k=rng.randn(Bn, S, Hn, dk).astype(np.float32),
                v=rng.randn(Bn, S, Hn, dk + 1).astype(np.float32),
                w=np.exp(-np.exp(rng.randn(Bn, S, Hn, dk))).astype(
                    np.float32),
                u=rng.randn(Hn, dk).astype(np.float32) * 0.1,
                s0=rng.randn(Bn, Hn, dk, dk + 1).astype(np.float32))


@pytest.mark.parametrize("S", [1, 5, 8, 13])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_scan_equals_reference(S, with_s0):
    """The exact recurrence, a step a token, against the reference's
    two-level scan at chunk 8 (under one chunk, one, and two with the
    second padded by identity steps; dk 4 != dv 5): y and the final
    state within TOL of their largest entry, both f32."""
    a = _scan_inputs(S, seed=S + 10 * with_s0)
    s0 = a["s0"] if with_s0 else np.zeros_like(a["s0"])
    fn = jax.jit(lambda r, k, v, w, u, s: jr._wkv_scan(r, k, v, w, u, s,
                                                       chunk=8),
                 compiler_options=STRICT)
    jy, js = fn(*(jnp.asarray(a[n]) for n in "rkvwu"), jnp.asarray(s0))
    ty, ts = tr.wkv_scan(*(_t(a[n]) for n in "rkvwu"), _t(s0))
    assert ty.shape == jy.shape and ts.shape == js.shape
    assert (_dt(ty), _dt(ts)) == (_dt(jy), _dt(js)) == ("float32",) * 2
    assert _rel(ty, jy) <= TOL["float32"] and _rel(ts, js) <= TOL["float32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_prev", [False, True])
def test_shift_equals_reference(dtype, with_prev):
    """The token shift with a zero or a given f32 row (the cache's): the
    shifted sequence (promoted to f32 where the row is) and the new last
    token equal the reference's, in its dtypes."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 6).astype(np.float32)
    prev = rng.randn(2, 1, 6).astype(np.float32) if with_prev else None
    js, jn = jr._shift(_j(x, dtype), None if prev is None else _j(prev))
    ts, tn = tr._shift(_t(x, dtype), None if prev is None else _t(prev))
    assert (_dt(ts), _dt(tn)) == (_dt(js), _dt(jn))
    assert _rel(ts, js) == 0 and _rel(tn, jn) == 0


def _first_layer(rw, tcfg):
    model = interop.from_jax(to_np(rw["params"]), tcfg)
    jp = jax.tree.map(lambda t: t[0], rw["params"]["layers"]["mix"])
    return model.layers[0].mix, jp


def _state(seed):
    rng = np.random.RandomState(seed)
    return {"shift_t": rng.randn(B, 1, D).astype(np.float32),
            "shift_c": rng.randn(B, 1, D).astype(np.float32),
            "wkv": rng.randn(B, H, DH, DH).astype(np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("part", ["time_mix", "layer", "channel_mix"])
def test_mixes_equal_reference(rw, part, with_state, dtype):
    """The time-mix (r, k, v, g, the decay LoRA through w1 and w2, the
    clipped exp(-exp) decay, the scan, the per-head ln_x norm and the
    silu gate, o), ``rwkv6_layer`` (the time-mix alone, as the
    reference's) and the channel-mix (relu squared, sigmoid(cm_r) x
    cm_v) of the reduced model's first layer on x in ``dtype`` over 5
    tokens, with no state or an f32 one (which promotes a bf16 x): the
    output and every state leaf within TOL of the reference's and in its
    dtypes."""
    _, tcfg = _cfgs()
    tp, jp = _first_layer(rw, tcfg)
    x = np.random.RandomState(4).randn(B, 5, D).astype(np.float32)
    st = _state(5) if with_state else None
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: _t(v) for k, v in st.items()}
    kw = dict(head_dim=DH)
    jfn = {"time_mix": lambda p, x, s: jr.rwkv6_time_mix(p, x, s, **kw),
           "layer": lambda p, x, s: jr.rwkv6_layer(p, x, s, **kw),
           "channel_mix": lambda p, x, s: jr.rwkv6_channel_mix(p, x, s)}
    tfn = {"time_mix": lambda p, x, s: tr.rwkv6_time_mix(p, x, s, **kw),
           "layer": lambda p, x, s: tr.rwkv6_layer(p, x, s, **kw),
           "channel_mix": lambda p, x, s: tr.rwkv6_channel_mix(p, x, s)}
    jout, jnew = jax.jit(jfn[part], compiler_options=STRICT)(
        jp, _j(x, dtype), jst)
    with torch.no_grad():
        tout, tnew = tfn[part](tp, _t(x, dtype), tst)
    # an f32 state row lifts a bf16 x's token shift, and all after it,
    # to f32 in both packages
    assert _dt(tout) == _dt(jout) == (dtype if st is None else "float32")
    assert _rel(tout, jout) <= TOL[dtype]
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        assert tnew[k].shape == jnew[k].shape, k
        assert _dt(tnew[k]) == _dt(jnew[k]), k
        assert _rel(tnew[k], jnew[k]) <= TOL[dtype], k


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_decode_writes_state_in_place(rw, dtype):
    """``rwkv6_decode``, one token of a whole pre-norm layer from an f32
    residual row: its output equals ``rwkv6_block``'s on a copy of the
    state, and the given state tensors (the same storage) then hold the
    block's new state bit for bit."""
    _, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(rw["params"]), tcfg)
    lp = model.layers[1]
    h = _t(np.random.RandomState(6).randn(B, 1, D).astype(np.float32))
    state = {k: _t(v) for k, v in _state(7).items()}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    with torch.no_grad():
        want, new = tr.rwkv6_block(lp.mix, lp.ln1, lp.ln2, h,
                                   {k: v.clone() for k, v in state.items()},
                                   head_dim=DH)
        got = tr.rwkv6_decode(lp.mix, lp.ln1, lp.ln2, h, state, head_dim=DH)
    assert torch.equal(got, want) and got.dtype == torch.float32
    for k in state:
        assert state[k].data_ptr() == ptrs[k]
        assert torch.equal(state[k], new[k]), k


# ---------------------------------------------------------------------------
# the model: prefill, decode, cache
# ---------------------------------------------------------------------------

def _jax_prefill(jcfg, tree, toks, lengths):
    fn = jax.jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n),
                 compiler_options=STRICT)
    return fn(tree, {"tokens": jnp.asarray(toks)}, jnp.asarray(lengths))


def _cache_leaves_close(tc, tcfg, jc, tol):
    """Every leaf of the port's cache ``tc`` f32 (as the reference's:
    ``cfg.dtype`` does not reach the state), of the reference's shape and
    within ``tol`` of its largest entry; ``len`` equal."""
    for c in tc["layers"]:
        assert {k: _dt(v) for k, v in c.items()} == dict.fromkeys(
            ("shift_t", "wkv", "shift_c"), "float32")
    got, want = interop.cache_to_numpy(tc, tcfg), to_np(jc)
    np.testing.assert_array_equal(got["len"], want["len"])
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k in want["layers"]:
        assert got["layers"][k].shape == want["layers"][k].shape, k
        assert got["layers"][k].dtype == want["layers"][k].dtype, k
        assert _rel(got["layers"][k], want["layers"][k]) <= tol, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", [None, (13, 9)])
def test_prefill_logits_and_cache(rw, lengths, dtype):
    """The prefill's last-token logits (in the working dtype) and its
    cache (every layer's token-shift rows and WKV state, len) against
    the reference's, full and ragged lengths, within PREFILL_TOL."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(rw["params"]), tcfg)
    toks = np.random.RandomState(5).randint(0, V, (B, T)).astype(np.int32)
    lens = np.array(lengths or (T, T), np.int32)
    jl, jc = _jax_prefill(jcfg, rw["params"], toks, lens)
    with torch.no_grad():
        tl, tc = tapi.prefill(model, tcfg, {"tokens": _t(toks)},
                              lengths=None if lengths is None else _t(lens))
    assert tl.shape == (B, 1, V) and _dt(tl) == _dt(jl) == dtype
    assert _rel(tl, jl) <= PREFILL_TOL[dtype]
    assert len(tc["layers"]) == 2
    _cache_leaves_close(tc, tcfg, jc, PREFILL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_logits_and_cache_in_place(rw, dtype):
    """A decode step after a 13-token prefill: its logits and every
    cache leaf against the reference's step on the same (crossed) cache,
    within TOL and in the reference's dtypes; the port writes every leaf
    into the same tensor objects."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(rw["params"]), tcfg)
    toks = np.random.RandomState(6).randint(0, V, (B, T)).astype(np.int32)
    _, jc = _jax_prefill(jcfg, rw["params"], toks, np.array([T, T]))
    jc = jserving.adapt_prefill_cache(jcfg, jc, B, 20)
    tc = interop.cache_from_jax(to_np(jc), tcfg)
    tok = np.array([[3], [7]], np.int32)
    jl, jc2 = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                      compiler_options=STRICT)(rw["params"],
                                               jnp.asarray(tok), jc)
    objs = [dict(c) for c in tc["layers"]]
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in tc["layers"]]
    with torch.no_grad():
        tl, tc2 = tapi.decode_step(model, tcfg, _t(tok), tc)
    assert _dt(tl) == _dt(jl) == dtype and _rel(tl, jl) <= TOL[dtype]
    assert all(c[k] is o[k] for c, o in zip(tc2["layers"], objs) for k in o)
    assert [{k: v.data_ptr() for k, v in c.items()}
            for c in tc2["layers"]] == ptrs
    _cache_leaves_close(tc2, tcfg, jc2, TOL[dtype])


def test_cache_layout_round_trip_and_refusals():
    """init_cache: one dict a layer (shift rows and WKV state f32, of a
    size ``max_len`` does not change); it crosses to the reference's
    stacked layout, equal to ``init_rwkv_state``'s, and back. A W > 1
    decode window raises; the family is never paged; adapt_prefill_cache
    keeps the state as it is."""
    from repro.models.rwkv import init_rwkv_state

    jcfg, tcfg = _cfgs()
    cache = tapi.init_cache(tcfg, 3, 10, device="cpu")
    assert [sorted(c) for c in cache["layers"]] == [
        ["shift_c", "shift_t", "wkv"]] * 2
    assert cache["layers"][0]["wkv"].shape == (3, H, DH, DH)
    assert cache["layers"][1]["shift_c"].shape == (3, 1, D)
    assert tapi.init_cache(tcfg, 3, 99, device="cpu")["layers"][0][
        "wkv"].shape == (3, H, DH, DH)
    assert_trees_equal(to_np(init_rwkv_state(jcfg, 3)),
                       interop.cache_to_numpy(cache, tcfg))
    for c in cache["layers"]:
        for t in c.values():
            t.normal_()
    back = interop.cache_from_jax(interop.cache_to_numpy(cache, tcfg), tcfg)
    for c, d in zip(cache["layers"], back["layers"]):
        assert sorted(c) == sorted(d)
        assert all(torch.equal(c[k], d[k]) for k in c)
    grown = tserving.adapt_prefill_cache(tcfg, cache, 3, 40)
    for c, d in zip(cache["layers"], grown["layers"]):
        assert all(torch.equal(c[k], d[k]) for k in c)
    model = tapi.init(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="decode window"):
        tapi.decode_window(model, tcfg, torch.zeros((3, 2), dtype=torch.int32),
                           cache)
    assert not tapi.paged_supported(tcfg)
    assert tapi.exact_length_prefill(tcfg)
    with pytest.raises(ValueError, match="paged KV unsupported"):
        tapi.init_paged_cache(tcfg, 1, 4, 8, 2, device="cpu")


# ---------------------------------------------------------------------------
# quantization and the serve views
# ---------------------------------------------------------------------------

def _state_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_paths(v, prefix + (k,))
    elif hasattr(tree, "_fields") and tree._fields[:3] == ("w", "d", "a"):
        yield prefix


@pytest.mark.parametrize("min_size", [4096, 6000, 9000])
def test_quantize_leaf_set_and_assignments(rw, min_size):
    """Under the config's 4-bit pow2 spec the port quantizes the
    reference's leaves, dictionaries and assignments bit for bit: the
    eight products' kernels, the bare w1 and w2 (one dictionary each
    over both layers) and the tied table; never w0, u, ln_x or the
    lerps. The floor counts a leaf's stacked size, as the reference's:
    at 6000 every 64 x 64 leaf (4096 a layer, 8192 stacked) stays
    quantized, at 9000 only the 64 x 128 pair and the table remain."""
    jcfg, tcfg = _cfgs(min_size=min_size)
    want = to_np(japi.quantize(rw["params"], jcfg, rw["axes"]))
    model = quantize_tree(interop.from_jax(to_np(rw["params"]), tcfg),
                          tcfg.quant)
    got = interop.to_numpy(model)
    paths = sorted("/".join(p) for p in _state_paths(want))
    assert sorted("/".join(p) for p in _state_paths(got)) == paths
    mix = {p.split("/")[2] for p in paths if p.startswith("layers/mix/")}
    if min_size < 8192:
        assert mix == {"r", "k", "v", "g", "o", "w1", "w2", "cm_k", "cm_v",
                       "cm_r"}
        assert model.layers[1].mix.w1.state.d.shape == (16,)
        assert model.layers[0].mix.w2.state.a.shape == (64, D)
    else:
        assert mix == {"cm_k", "cm_v"}
    assert "embed/table" in paths
    assert_trees_equal(want, got)


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_views_and_manifests_equal(rw, view):
    """Each serve view byte for byte and its manifest: under packed4 w1
    and w2 (Kin 64) pack along their reduction axis as every body leaf
    does (the odd reduced vocab leaves the tied table int8: fused);
    under serving_pow2 every body leaf, w1 and w2 included, is
    pow2-encoded with frozen activation pairs and the table stays float."""
    jcfg, tcfg = _cfgs(view)
    src = rw["jcal"] if view == "pow2" else rw["jq"]
    pack4 = view == "packed4"
    js, jman = j_serve_view(src, pack4=pack4,
                            policy=japi.resolved_policy(jcfg),
                            with_manifest=True)
    model, tman = t_serve_view(interop.from_jax(to_np(src), tcfg),
                               pack4=pack4, policy=tapi.resolved_policy(tcfg),
                               with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    assert tman == jman
    want = {"int8": "fused", "packed4": "packed4", "pow2": "pow2"}[view]
    for leaf in ("w1", "w2", "r/kernel", "cm_v/kernel"):
        assert tman[f"layers/mix/{leaf}"]["backend"] == want, leaf
        assert tman[f"layers/mix/{leaf}"]["stack"] == 1, leaf
    w2 = model.layers[0].mix.w2.state
    if view == "packed4":
        assert w2.a.dtype == torch.uint8 and w2.a.shape == (32, D)
        assert tman["embed/table"]["backend"] == "fused"
    if view == "pow2":
        assert w2.d.dtype == torch.int8 and w2.act is not None
        assert "embed/table" not in tman


def test_even_vocab_packs_the_table_and_decodes_the_head():
    """At an even vocab (212 here, 65536 at full width) the packed4 view
    packs the tied table too, as the reference's (manifest and bytes
    equal), and its transposed readout runs the decode backend, one call
    a forward, beside 20 packed body products: the full-width phase's
    launch counts, against the reference's tokens."""
    from torch_port_helpers import jax_reference

    jcfg, tcfg = _cfgs(vocab=212)
    params, axes = japi.init(jax.random.PRNGKey(2), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    js, jman = j_serve_view(jq, pack4=True, policy=japi.resolved_policy(jcfg),
                            with_manifest=True)
    model, tman = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=True,
                               policy=tapi.resolved_policy(tcfg),
                               with_manifest=True)
    assert tman == jman and tman["embed/table"]["backend"] == "packed4"
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    toks = np.random.RandomState(3).randint(0, 212, (B, 9)).astype(np.int32)
    _, want = jax_reference(jcfg.replace(kernel_backend="decode"), js, toks,
                            4)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=4,
                            device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    assert delta[1]["plain"] == 4 * 20 and delta[0]["plain"] == 0
    assert delta[7]["decode"] == 4


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_view_prefill_and_step_logits(rw, view):
    """Each serve view's prefill and one decode step at act_bits 32
    (serving_pow2 at its frozen scales) against the reference's on the
    same tree: logits within 1e-5 of the largest (pow2 within 1e-4: an
    8-bit level at a frozen scale lands on the same integer, the rest is
    the float head)."""
    jcfg, tcfg = _cfgs(view)
    src = rw["jcal"] if view == "pow2" else rw["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    jcfg = jcfg.replace(kernel_backend="decode")
    toks = np.random.RandomState(8).randint(0, V, (B, 11)).astype(np.int32)
    jl, jc = _jax_prefill(jcfg, js, toks, np.array([11, 11]))
    with torch.no_grad():
        tl, tc = tapi.prefill(model, tcfg, {"tokens": _t(toks)})
    tol = 1e-4 if view == "pow2" else TOL["float32"]
    assert _rel(tl, jl) <= tol
    jc = jserving.adapt_prefill_cache(jcfg, jc, B, 14)
    tc = tserving.adapt_prefill_cache(tcfg, tc, B, 14)
    tok = np.array([[4], [9]], np.int32)
    jl2, _ = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)(js, jnp.asarray(tok), jc)
    with torch.no_grad():
        tl2, _ = tapi.decode_step(model, tcfg, _t(tok), tc)
    assert _rel(tl2, jl2) <= tol


def test_model_init_is_seeded_and_on_the_asked_device():
    """``api.init`` builds the ssm model on the asked device from its
    seed (the same seed the same weights; CUDA where there is none
    raises), every leaf f32 and of the reference tree's shape."""
    _, tcfg = _cfgs()
    a = tapi.init(tcfg, seed=3, device="cpu")
    b = tapi.init(tcfg, seed=3, device="cpu")
    assert isinstance(a, trwkv.RWKV)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert all(p.dtype == torch.float32 for p in a.parameters())
    assert a.layers[0].mix.w0.detach()[0].item() == pytest.approx(-0.6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tapi.init(tcfg, seed=3)
