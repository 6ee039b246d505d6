"""Port parity, zamba2-2.7b (the hybrid family): reduced (4 Mamba2
layers in 2 super-blocks of 2, d_model 64, d_inner 128 = 8 SSM heads of
16, ssm_state 16, chunk 8; a shared attention block of 4 heads of 16
applied after each super-block; vocab 211, a tied readout) against the
JAX package on the same numpy-seeded inputs.

Held against the reference, in float32 and in bfloat16 (the served
working dtype, where JAX's promotion decides which parts run in f32:
the dtype of every output and cache leaf is the reference's): the SSD
scan, the causal conv and the Mamba2 decode step on random inputs at
lengths 5, 8 and 13 (under, at and over one chunk, the last one
padded), with and without an initial state, within TOL of the largest
output; the prefill's logits and cache (each leaf within PREFILL_TOL of
its largest entry), ragged lengths included; a decode step's logits
and every cache leaf (within TOL), the step writing its state in
place;
quantization under ``QuantSpec(bits=4, constraint="pow2",
min_size=1024)``: the same set of quantized leaves (``conv_w`` among
them: 640 weights a layer, 2560 stacked) and the assignments bit for
bit; the int8, packed4 and calibrated ``serving_pow2`` serve views byte
for byte and their manifests; the parameter and cache round trips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (STRICT, assert_trees_equal, cfg_pair,
                                one_thread, pow2_floor, to_np)

from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.core.spec import QuantSpec as JSpec
from repro.models import api as japi
from repro.nn import mamba2 as jm
from repro.runtime import serving as jserving
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core.lutq import LutqState
from repro_torch.core.policy import quantize_tree
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models import zamba as tzamba
from repro_torch.nn import mamba2 as tm
from repro_torch.nn.tree import layer_split, logical_path
from repro_torch.runtime import serving as tserving

ARCH = "zamba2-2.7b"
B, T = 2, 13
DTYPES = ["float32", "bfloat16"]
#: max |port - reference| over the reference's largest entry, for one
#: block or one decode step from the same inputs: in bfloat16 half a
#: bf16 ulp (measured: 0, the same bits, bar f32 SSM states at 1e-7)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -9}
#: the same for a whole prefill: in bfloat16 one bf16 rounding that
#: lands the other way (f32 sums in another order put a value on the
#: other side of a bf16 tie) is carried through the later layers (an
#: ulp and a half of the logits' scale measured at 13 tokens: logits
#: 5.7e-3, conv windows 4.6e-3, SSM states 3.0e-3; 0 at 5 tokens)
PREFILL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CALIB = {"tokens": np.random.RandomState(1).randint(
    0, 211, (2, 12)).astype(np.int32)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(view="int8", **kw):
    """(JAX config, port config) of reduced zamba at act_bits 32 unless
    given: 4-bit pow2 LUT-Q at min_size 1024, or under ``view="pow2"``
    the serving_pow2 policy with its body floor at 1024 too (its 4096
    would leave the reduced conv_w float; at full width it is 1.1 M)."""
    kw.setdefault("act_bits", 32)
    jcfg, tcfg = cfg_pair(arch=ARCH, remat=False, **kw)
    if view == "pow2":
        return (jcfg.replace(quant=pow2_floor(j_serving_pow2(), 1024)),
                tcfg.replace(quant=pow2_floor(t_serving_pow2(), 1024)))
    spec = dict(bits=4, constraint="pow2", min_size=1024)
    return jcfg.replace(quant=JSpec(**spec)), tcfg.replace(quant=TSpec(**spec))


@pytest.fixture(scope="module")
def zb():
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
    """zamba2-2.7b is registered with the reference's fields (54 layers,
    d_inner 5120 = 80 SSM heads of 64, the shared block every 6 layers);
    the decoder-only entry points refuse it and point at models/zamba."""
    from repro.configs import get_config as jget

    cfg, ref = tconfigs.get_config(ARCH), jget(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "ssm_state", "ssm_head_dim", "attn_every",
              "resolved_d_inner", "resolved_head_dim", "tie_embeddings",
              "act_bits", "quant", "ssm_chunk"):
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    assert tzamba.n_super(cfg) == 9 and cfg.resolved_d_inner == 5120
    tapi._ported(cfg)
    with pytest.raises(ValueError, match="models/zamba"):
        tlm._check_family(cfg)


def test_two_axis_paths_and_round_trips(zb):
    """``mamba_layers.<s>.<i>`` paths map to the reference's stacked path
    with two stack axes; the shared block has none. The float, quantized
    and calibrated trees cross to the port and back byte for byte."""
    assert layer_split(("mamba_layers", "1", "0", "mamba", "conv_w")) == (
        ("mamba_layers", "mamba", "conv_w"), (1, 0))
    assert logical_path(("mamba_layers", "1", "1", "mamba", "in_proj",
                         "kernel")) == (
        ("mamba_layers", "mamba", "in_proj", "kernel"), 2)
    assert logical_path(("shared", "attn", "q", "kernel")) == (
        ("shared", "attn", "q", "kernel"), 0)
    assert logical_path(("layers", "3", "attn", "q", "kernel")) == (
        ("layers", "attn", "q", "kernel"), 1)
    _, tcfg = _cfgs()
    for key in ("params", "jq", "jcal"):
        model = interop.from_jax(to_np(zb[key]), tcfg)
        assert len(model.mamba_layers) == 2 and len(model.mamba_layers[0]) == 2
        assert_trees_equal(to_np(zb[key]), interop.to_numpy(model))


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _ssd_inputs(S, seed):
    rng = np.random.RandomState(seed)
    Bn, H, P, N = 2, 3, 4, 5
    return dict(x=rng.randn(Bn, S, H, P).astype(np.float32),
                dt=np.log1p(np.exp(rng.randn(Bn, S, H))).astype(np.float32),
                A=np.exp(rng.randn(H) * 0.5).astype(np.float32),
                Bm=rng.randn(Bn, S, N).astype(np.float32),
                Cm=rng.randn(Bn, S, N).astype(np.float32),
                h0=rng.randn(Bn, H, N, P).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [5, 8, 13])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_equals_reference(S, with_h0, dtype):
    """The chunked scan at chunk 8: under one chunk, exactly one, and two
    with the second padded by identity steps; x, B and C in ``dtype``
    (dt, A and the state f32: in bfloat16 ``C.B`` stays bf16 and the
    rest promotes to f32, y returning to bf16); y and the final state
    within TOL of their largest entry, in the reference's dtypes."""
    a = _ssd_inputs(S, seed=S + 10 * with_h0)
    low = {k: dtype if k in ("x", "Bm", "Cm") else None for k in a}
    h0 = a["h0"] if with_h0 else None
    fn = jax.jit(lambda x, dt, A, Bm, Cm, h: jm.ssd_chunked(
        x, dt, A, Bm, Cm, chunk=8, h0=h), compiler_options=STRICT)
    jy, jh = fn(*(_j(a[k], low[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
                None if h0 is None else jnp.asarray(h0))
    ty, th = tm.ssd_chunked(*(_t(a[k], low[k]) for k in ("x", "dt", "A",
                                                         "Bm", "Cm")),
                            chunk=8, h0=None if h0 is None else _t(h0))
    assert ty.shape == jy.shape and th.shape == jh.shape
    assert (_dt(ty), _dt(th)) == (_dt(jy), _dt(jh)) == (dtype, "float32")
    assert _rel(ty, jy) <= TOL[dtype] and _rel(th, jh) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 5, 8, 13])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_reference(S, with_state, dtype):
    """The depthwise causal conv (4 taps) with a zero or a given window,
    x and the window in ``dtype``, the weight and bias f32 (as the
    model's): output within TOL of its largest entry and the new window
    equal (a copy of inputs), each in the reference's dtype (in bfloat16
    the taps sum in bf16 and the f32 bias lifts the output to f32)."""
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, 12).astype(np.float32)
    w = (rng.randn(4, 12) * 0.2).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    jy, jst = jax.jit(jm._causal_conv, compiler_options=STRICT)(
        _j(x, dtype), jnp.asarray(w), jnp.asarray(b),
        None if st is None else _j(st, dtype))
    ty, tst = tm._causal_conv(_t(x, dtype), _t(w), _t(b),
                              None if st is None else _t(st, dtype))
    assert (_dt(ty), _dt(tst)) == (_dt(jy), _dt(jst)) == ("float32", dtype)
    assert _rel(ty, jy) <= TOL[dtype]
    assert _rel(tst, jst) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_equals_reference_in_place(zb, dtype):
    """One Mamba2 decode step of the reduced model's first layer, u and
    the conv window in ``dtype``, the SSM state f32 (the cache's
    layout): the output within TOL of the reference's and in its dtype
    (the gated y returns to u's dtype before out_proj), the new SSM
    state and conv window within TOL of its returned ones, in their
    dtypes, written into the given tensors (same storage)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(zb["params"]), tcfg)
    mp = zb["params"]["mamba_layers"]["mamba"]
    jp = jax.tree.map(lambda t: t[0, 0], mp)
    rng = np.random.RandomState(3)
    u = rng.randn(2, 1, 64).astype(np.float32)
    ssm = rng.randn(2, 8, 16, 16).astype(np.float32)
    conv = rng.randn(2, 3, 160).astype(np.float32)
    dims = dict(d_inner=128, n_state=16, head_dim=16)
    jout, jst = jax.jit(lambda p, u, s: jm.mamba2_decode(p, u, s, **dims),
                        compiler_options=STRICT)(
        jp, _j(u, dtype), {"ssm": jnp.asarray(ssm), "conv":
                           _j(conv, dtype)})
    state = {"ssm": _t(ssm), "conv": _t(conv, dtype)}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    with torch.no_grad():
        tout = tm.mamba2_decode(model.mamba_layers[0][0].mamba,
                                _t(u, dtype), state, **dims)
    assert _dt(tout) == _dt(jout) == dtype
    assert _rel(tout, jout) <= TOL[dtype]
    for k in ("ssm", "conv"):
        assert state[k].data_ptr() == ptrs[k]
        assert _dt(state[k]) == _dt(jst[k]), k
        assert _rel(state[k], jst[k]) <= TOL[dtype], k


def test_softplus_is_jax_logaddexp():
    """``softplus`` is jax.nn.softplus (no threshold switch) to an f32
    ulp, NaN kept."""
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [np.nan, 1e4, -1e4]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tm.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# the model: prefill, decode, cache
# ---------------------------------------------------------------------------

def _jax_prefill(jcfg, tree, toks, lengths):
    fn = jax.jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n),
                 compiler_options=STRICT)
    return fn(tree, {"tokens": jnp.asarray(toks)}, jnp.asarray(lengths))


def _cache_leaves_close(tc, tcfg, jc, tol):
    """Every leaf of the port's cache ``tc`` in the dtype of the
    reference's ``jc`` (f32 SSM states, the working dtype's conv windows
    and K/V), of its shape and within ``tol`` of its largest entry;
    ``len`` equal."""
    dt = _dt(tcfg)
    for c in tc["layers"]:
        want = ({"ssm": "float32", "conv": dt} if "ssm" in c
                else {"k": dt, "v": dt})
        assert {k: _dt(v) for k, v in c.items()} == want
    got, want = interop.cache_to_numpy(tc, tcfg), to_np(jc)
    np.testing.assert_array_equal(got["len"], want["len"])
    for grp in ("mamba", "attn"):
        for k in want[grp]:
            assert got[grp][k].shape == want[grp][k].shape, (grp, k)
            assert got[grp][k].dtype == want[grp][k].dtype, (grp, k)
            assert _rel(got[grp][k], want[grp][k]) <= tol, (grp, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", [None, (13, 9)])
def test_prefill_logits_and_cache(zb, lengths, dtype):
    """The prefill's last-token logits (in the working dtype) and its
    cache (every Mamba layer's SSM state and conv window, each
    shared-block application's K/V, len) against the reference's, full
    and ragged lengths, within PREFILL_TOL, in the reference's
    dtypes."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(zb["params"]), tcfg)
    toks = np.random.RandomState(5).randint(0, 211, (B, T)).astype(np.int32)
    lens = np.array(lengths or (T, T), np.int32)
    jl, jc = _jax_prefill(jcfg, zb["params"], toks, lens)
    with torch.no_grad():
        tl, tc = tapi.prefill(model, tcfg, {"tokens": _t(toks)},
                              lengths=None if lengths is None else _t(lens))
    assert tl.shape == (B, 1, 211) and _dt(tl) == _dt(jl) == dtype
    assert _rel(tl, jl) <= PREFILL_TOL[dtype]
    assert len(tc["layers"]) == 2 * (2 + 1)
    _cache_leaves_close(tc, tcfg, jc, PREFILL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_logits_and_cache_in_place(zb, dtype):
    """A decode step after a 13-token prefill grown to 20 columns: its
    logits and every cache leaf against the reference's step on the
    same (crossed) cache, within TOL and in the reference's dtypes; the
    port writes every leaf in place."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    model = interop.from_jax(to_np(zb["params"]), tcfg)
    toks = np.random.RandomState(6).randint(0, 211, (B, T)).astype(np.int32)
    _, jc = _jax_prefill(jcfg, zb["params"], toks, np.array([T, T]))
    jc = jserving.adapt_prefill_cache(jcfg, jc, B, 20)
    tc = interop.cache_from_jax(to_np(jc), tcfg)
    tok = np.array([[3], [7]], np.int32)
    jl, jc2 = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                      compiler_options=STRICT)(zb["params"],
                                               jnp.asarray(tok), jc)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in tc["layers"]]
    with torch.no_grad():
        tl, tc2 = tapi.decode_step(model, tcfg, _t(tok), tc)
    assert _dt(tl) == _dt(jl) == dtype and _rel(tl, jl) <= TOL[dtype]
    assert [{k: v.data_ptr() for k, v in c.items()}
            for c in tc2["layers"]] == ptrs
    _cache_leaves_close(tc2, tcfg, jc2, TOL[dtype])


def test_cache_layout_and_refusals():
    """init_cache: a super-block's Mamba entries (ssm f32, conv in the
    working dtype) then its K/V; the cache crosses to the reference's
    layout and back. kv_cache_bits=8, a window and a W > 1 decode window
    raise; the family is never paged."""
    _, tcfg = _cfgs()
    cache = tapi.init_cache(tcfg, 3, 10, device="cpu")
    assert [sorted(c) for c in cache["layers"]] == (
        [["conv", "ssm"]] * 2 + [["k", "v"]]) * 2
    assert cache["layers"][0]["ssm"].shape == (3, 8, 16, 16)
    assert cache["layers"][0]["conv"].shape == (3, 3, 160)
    assert cache["layers"][2]["k"].shape == (3, 10, 4, 16)
    for c in cache["layers"]:
        for t in c.values():
            t.normal_()
    back = interop.cache_from_jax(interop.cache_to_numpy(cache, tcfg), tcfg)
    for c, d in zip(cache["layers"], back["layers"]):
        assert all(torch.equal(c[k], d[k]) for k in c)
    with pytest.raises(ValueError, match="kv_cache_bits=8"):
        tapi.init_cache(tcfg.replace(kv_cache_bits=8), 1, 8, device="cpu")
    with pytest.raises(ValueError, match="window"):
        tapi.init_cache(tcfg.replace(window=4), 1, 8, device="cpu")
    model = tapi.init(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="decode window"):
        tapi.decode_window(model, tcfg, torch.zeros((3, 2), dtype=torch.int32),
                           cache)
    assert not tapi.paged_supported(tcfg)
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


def test_quantize_leaf_set_and_assignments(zb):
    """Under QuantSpec(bits=4, constraint="pow2", min_size=1024) the
    port quantizes the reference's leaves: every Mamba projection, conv_w
    (640 weights a layer: the floor is checked against the 2 x 2 stack's
    2560), the shared block's seven products once (one dictionary each)
    and the tied table; dictionaries and assignments bit for bit."""
    _, tcfg = _cfgs()
    model = quantize_tree(interop.from_jax(to_np(zb["params"]), tcfg),
                          tcfg.quant)
    got = interop.to_numpy(model)
    want = to_np(zb["jq"])
    paths = sorted("/".join(p) for p in _state_paths(want))
    assert sorted("/".join(p) for p in _state_paths(got)) == paths
    assert "mamba_layers/mamba/conv_w" in paths
    assert "shared/attn/q/kernel" in paths and "embed/table" in paths
    assert len(paths) == 3 + 7 + 1
    conv = model.mamba_layers[1][0].mamba.conv_w.state
    assert conv.d.shape == (16,) and conv.a.shape == (4, 160)
    assert model.shared.mlp.wi.kernel.state.d.shape == (16,)
    assert_trees_equal(want, got)


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_views_and_manifests_equal(zb, view):
    """Each serve view byte for byte (conv_w packed along its 4 taps in
    packed4, pow2-encoded with int8 assignments under serving_pow2) and
    its manifest, two stack axes recorded for the Mamba leaves."""
    jcfg, tcfg = _cfgs(view)
    src = zb["jcal"] if view == "pow2" else zb["jq"]
    pack4 = view == "packed4"
    js, jman = j_serve_view(src, pack4=pack4,
                            policy=japi.resolved_policy(jcfg),
                            with_manifest=True)
    model, tman = t_serve_view(interop.from_jax(to_np(src), tcfg),
                               pack4=pack4, policy=tapi.resolved_policy(tcfg),
                               with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    assert tman == jman
    conv = tman["mamba_layers/mamba/conv_w"]
    assert conv["stack"] == 2 and tman["shared/attn/q/kernel"]["stack"] == 0
    st = model.mamba_layers[0][1].mamba.conv_w.state
    if view == "packed4":
        assert conv["packed"] and st.a.dtype == torch.uint8
    if view == "pow2":
        assert conv["encoding"] == "pow2" and st.d.dtype == torch.int8
        assert "embed/table" not in tman


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_materialize_decodes_conv_w_as_reference(zb, view):
    """``materialize`` of each serve form of conv_w (int8, packed,
    pow2-encoded) gives the reference's decoded weight bit for bit."""
    from repro.nn.linear import materialize as j_materialize
    from repro_torch.nn.linear import materialize as t_materialize

    jcfg, tcfg = _cfgs(view)
    src = zb["jcal"] if view == "pow2" else zb["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    jw = js["mamba_layers"]["mamba"]["conv_w"]
    for s in range(2):
        for i in range(2):
            want = j_materialize(jax.tree.map(lambda t: t[s, i], jw),
                                 jnp.float32)
            st = model.mamba_layers[s][i].mamba.conv_w.state
            assert isinstance(st, LutqState) and st.w is None
            np.testing.assert_array_equal(
                t_materialize(st, torch.float32).numpy(), np.asarray(want))


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_view_prefill_and_step_logits(zb, view):
    """Each serve view's prefill and one decode step at act_bits 32
    (serving_pow2 at its frozen scales) against the reference's on the
    same tree: logits within 1e-5 of the largest (pow2 within 1e-4: an
    8-bit activation level at a frozen scale, summed in another order,
    lands on the same integer, and the rest is the float head)."""
    jcfg, tcfg = _cfgs(view)
    src = zb["jcal"] if view == "pow2" else zb["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    jcfg = jcfg.replace(kernel_backend="decode")
    toks = np.random.RandomState(8).randint(0, 211, (B, 11)).astype(np.int32)
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
