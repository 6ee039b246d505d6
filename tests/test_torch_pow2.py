"""Port parity, the multiplier-less pow2 serving path: sign+exponent
planes, the shift-add dictionary, int8 activations, the per-logical-leaf
overflow guard, calibration, and reduced danube served under
``serving_pow2``, against the JAX package.

Integer results (codes, shifted dictionaries, int8 activations, int32
accumulators, assignments) are held bit-exact. Float tolerances:

* decoded entries and epilogue scales are exact powers of two in the
  port; they equal JAX's wherever JAX's ``exp2`` is exact (on some CPUs
  XLA's ``exp2`` misses 2^-13, 2^13 and 2^15 by a few ulps: ROADMAP
  queue 3), and those are the only places they may differ;
* calibrated act pairs: within 1e-5 relative (the maxima of float
  activations summed in another order);
* ``lutq_dot`` on the same inputs: bit-exact where JAX's epilogue
  scale is exact, else within 2^-20 of the largest output (the int32
  sums are equal; only an inexact JAX scale moves it);
* prefill and decode logits of reduced danube, as in
  ``test_torch_slice.py``: within 1e-4 of the largest logit in float32
  (the float activations entering each int8 quantization differ in
  their last bits, which may move one of them to the neighbouring
  level), 2^-9 in bfloat16 (half a bf16 ulp of the largest logit);
* greedy tokens, and the engine's tokens: identical.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from torch_port_helpers import (ARCH, jax_reference, one_thread,
                                port_teacher_forced, to_np)

from repro.core import lutq as jl
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lutq_shift import lutq_shift as j_lutq_shift_kernel
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core import lutq as tl
from repro_torch.core.policy import pow2_guard_bits
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.kernels import lutq_shift, ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as t_serve_cli
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    from repro.configs import get_config as jget
    from repro.models.reduce import reduced as jred
    from repro_torch.configs import get_config as tget
    from repro_torch.models.reduce import reduced as tred

    jcfg = jred(jget(ARCH)).replace(quant=j_serving_pow2(), act_bits=8,
                                    remat=False, **kw)
    tcfg = tred(tget(ARCH)).replace(quant=t_serving_pow2(), act_bits=8,
                                    remat=False, **kw)
    return jcfg, tcfg


CALIB = np.random.RandomState(1).randint(0, 211, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def pow2():
    """JAX reduced danube under serving_pow2: quantized (train form),
    calibrated, and its serve view with manifest."""
    jcfg, tcfg = _cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    jcal = japi.calibrate(jq, jcfg, {"tokens": jnp.asarray(CALIB)})
    js, jm = j_serve_view(jcal, policy=japi.resolved_policy(jcfg),
                          with_manifest=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jq=jq, jcal=jcal, js=js, jm=jm)


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
    """Same structure, dtypes and bytes (None fields must match)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        if la[k] is None or lb[k] is None:
            assert la[k] is None and lb[k] is None, k
            continue
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8),
                                      err_msg="/".join(k))


def _port(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# encoding and the shifted dictionary
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_exp2_inexact():
    """Integer exponents whose 2^e JAX's exp2 misses on this machine."""
    e = np.arange(tl.POW2_MIN_EXP, tl.POW2_MAX_EXP + 1)
    got = np.asarray(jnp.exp2(jnp.asarray(e, jnp.float32)))
    return set(e[got != np.ldexp(np.float32(1), e)].tolist())


@functools.lru_cache(maxsize=None)
def _pow2_dicts():
    """Stacked pow2-constrained dictionaries by K: JAX's constraint on
    sorted random dictionaries at several scales (one K=16 slice with a
    pruned zero, one all zero), and one-entry ones."""
    from repro.core.spec import QuantSpec as JSpec

    rng = np.random.RandomState(0)

    def stack(bits, scales, prune=0.0):
        spec = JSpec(bits=bits, constraint="pow2", prune_frac=prune)
        return [np.asarray(jl.apply_constraint(jnp.asarray(np.sort(
            rng.randn(1 << bits).astype(np.float32) * s)), spec))
            for s in scales]

    k16 = (stack(4, (0.02, 0.3, 5.0, 3e-4)) + stack(4, (0.05, 2.0), 0.2)
           + [np.zeros(16, np.float32)])
    return {"K16": np.stack(k16), "K2": np.stack(stack(1, (0.01, 1.0))),
            "K256": np.stack(stack(8, (0.1, 1e-3, 40.0))),
            "K1": np.array([[0.25], [-8.0], [0.0]], np.float32)}


@pytest.mark.parametrize("K", ["K16", "K2", "K256", "K1"])
def test_pow2_codes_and_shift_dictionary_match_jax(K):
    d = _pow2_dicts()[K]
    jcode = jl.pow2_encode(jnp.asarray(d))
    tcode = tl.pow2_encode(_port(d))
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(
        tref.pow2_shift_weights(tcode).numpy(),
        np.asarray(jref.pow2_shift_weights(jcode)))
    # decode and epilogue scale: exact powers of two, JAX's bits wherever
    # its exp2 is exact
    bad = _jax_exp2_inexact()
    code = np.asarray(jcode).astype(np.int32)
    exp = np.abs(code) - 1 + tl.POW2_MIN_EXP
    exact = np.where(code != 0, np.sign(code) * np.ldexp(np.float32(1), exp),
                     0).astype(np.float32)
    tdec = tl.pow2_decode(tcode).numpy()
    jdec = np.asarray(jl.pow2_decode(jcode))
    np.testing.assert_array_equal(tdec, exact)
    np.testing.assert_array_equal(tdec == jdec,
                                  (code == 0) | ~np.isin(exp, list(bad)))
    ok = (code != 0) & ~np.isin(exp, list(bad))
    np.testing.assert_array_equal(tdec[ok], d[ok])
    mag = np.abs(code)
    minm = np.where((mag > 0).any(-1), np.where(mag > 0, mag, 99).min(-1), 1)
    tsc = tref.pow2_shift_scale(tcode).numpy()
    np.testing.assert_array_equal(tsc, np.ldexp(np.float32(1),
                                                minm - 1 + tl.POW2_MIN_EXP))
    jsc = np.asarray(jref.pow2_shift_scale(jcode))
    np.testing.assert_array_equal(tsc == jsc, ~np.isin(
        minm - 1 + tl.POW2_MIN_EXP, list(bad)))


def test_pow2_encode_arbitrary_floats_away_from_midpoints():
    x = (np.random.RandomState(3).randn(4096) *
         np.exp2(np.random.RandomState(4).uniform(-16, 17, 4096))
         ).astype(np.float32)
    x[:5] = 0.0
    frac = np.abs(np.log2(np.maximum(np.abs(x), 1e-30)))
    away = np.abs(frac - np.floor(frac) - 0.5) > 1e-3
    jc = np.asarray(jl.pow2_encode(jnp.asarray(x)))
    tc = tl.pow2_encode(_port(x)).numpy()
    assert away.sum() > 4000
    np.testing.assert_array_equal(tc[away], jc[away])


# ---------------------------------------------------------------------------
# the shift-add plain version and int8 activations
# ---------------------------------------------------------------------------

def _shift_case(M, Kin, N, K, seed):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (M, Kin)).astype(np.int8)
    a = rng.randint(0, K, (Kin, N)).astype(np.uint8).view(np.int8)
    code = rng.randint(-9, 10, K).astype(np.int8)
    wsh = np.asarray(jref.pow2_shift_weights(jnp.asarray(code)))
    return xq, a, wsh


@pytest.mark.parametrize("M,Kin,N,K", [(1, 34, 50, 16), (5, 96, 72, 16),
                                       (33, 130, 57, 2), (8, 64, 211, 16),
                                       (3, 40, 24, 256)])
def test_lutq_shift_plain_matches_jax(M, Kin, N, K):
    xq, a, wsh = _shift_case(M, Kin, N, K, seed=M)
    got = lutq_shift.lutq_shift(_port(xq), _port(a), _port(wsh))
    assert got.dtype == torch.int32
    want = np.asarray(jref.lutq_shift_ref(jnp.asarray(xq), jnp.asarray(a),
                                          jnp.asarray(wsh)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the Pallas kernel in one block; its default one-hot decode matches
    # no int8 index < 0, so a K=256 dictionary's entries 128..255 read 0
    # there (ROADMAP queue 3): for K=256 its take decode is the oracle
    kern = j_lutq_shift_kernel(jnp.asarray(xq), jnp.asarray(a),
                               jnp.asarray(wsh), bm=M, bn=N, bk=Kin,
                               decode_onehot=K <= 128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    assert (a < 0).any() == (K > 128)


@pytest.mark.parametrize("M,N,Kin", [(4, 2560, 2560), (4, 640, 2560),
                                     (1, 2560, 6912), (8, 6912, 2560),
                                     (3, 700, 2000), (512, 6912, 2560),
                                     (130, 640, 2560), (2, 24, 20)])
def test_lutq_shift_plan_covers_the_reduction(M, N, Kin):
    """The card kernel's plan: the tile SHIFT_TILES gives M, splits of
    whole 128-row steps that cover Kin exactly once, at most the tile's
    most splits, and a workspace of one ticket a tile and every split's
    whole int32 tile when it splits."""
    plan = lutq_shift.plan_splits(M, N, Kin, sms=132)
    splits, kchunk = plan["splits"], plan["kchunk"]
    assert (splits - 1) * kchunk < Kin <= splits * kchunk
    assert kchunk % lutq_shift.BK == 0
    _, bm, bn, _, most = next(t for t in lutq_shift.SHIFT_TILES
                              if t[0] is None or M <= t[0])
    assert (plan["bm"], plan["bn"]) == (bm, bn) and (bm <= 16) == (M <= 16)
    assert plan["grid"] == (-(-M // bm), -(-N // bn), splits)
    assert 1 <= splits <= most
    tiles = plan["grid"][0] * plan["grid"][1]
    assert plan["tickets"] == (tiles if splits > 1 else 0)
    assert plan["partials"] == (tiles * splits * bm * bn if splits > 1
                                else 0)
    assert lutq_shift.plan_splits(M, N, Kin, sms=132) == plan


@settings(max_examples=40, deadline=None)
@given(span=st.integers(0, 23), K=st.sampled_from([2, 16, 256]),
       seed=st.integers(0, 2**16), extreme=st.booleans())
def test_lutq_shift_digit_planes_give_the_plain_bits(span, K, seed, extreme):
    """The kernel's arithmetic, emulated in plain torch: base-2^7 digit
    planes of the shifted dictionary (span // 7 + 1 of them), one s8 x s8
    -> s32 product a plane, combined by Horner modulo 2^32, give the
    plain version's int32 bits (and JAX's) for every dictionary the
    serve-time guard admits, up to its limit (``extreme``: every term at
    its largest)."""
    rng = np.random.RandomState(seed)
    Kin = min(int(rng.randint(1, 97)), 2 ** (24 - span))  # guard <= 31
    M, N = int(rng.randint(1, 6)), int(rng.randint(1, 40))
    mag = rng.randint(1, span + 2, K)
    mag[0], mag[-1] = 1, span + 1
    code = (mag * rng.choice([-1, 1], K)).astype(np.int8)
    if K > 2:
        code[1] = 0
    wsh = tref.pow2_shift_weights(_port(code))
    if extreme:
        a = np.full((Kin, N), K - 1, np.uint8).view(np.int8)
        xq = np.full((M, Kin), 127 if wsh[K - 1] > 0 else -127, np.int8)
    else:
        a = rng.randint(0, K, (Kin, N)).astype(np.uint8).view(np.int8)
        xq = rng.randint(-127, 128, (M, Kin)).astype(np.int8)
    assert pow2_guard_bits(_port(code), Kin) <= 31
    planes = tref.shift_planes(wsh)
    assert planes == span // 7 + 1
    digits = tref.shift_digits(wsh, planes)
    assert digits.dtype == torch.int8 and int(digits.abs().max()) <= 64
    assert torch.equal((digits.long() << (7 * torch.arange(planes)[:, None])
                        ).sum(0), wsh.long())
    want = tref.lutq_shift_ref(_port(xq), _port(a), wsh)
    got = tref.lutq_shift_planes_ref(_port(xq), _port(a), wsh, planes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.lutq_shift_ref(
        jnp.asarray(xq), jnp.asarray(a), jnp.asarray(wsh.numpy()))))
    if extreme:
        assert int(want.abs().min()) == 127 * 2 ** span * Kin


def test_pow2_dot_passes_the_leafs_derived_planes(monkeypatch):
    """The serving path derives a leaf's digit planes once (with its
    shifted dictionary) and hands them to the kernel wrapper; no call
    derives them again."""
    seen = []

    def spy(xq, a, wsh, planes=None):
        seen.append(planes)
        return tref.lutq_shift_ref(xq, a, wsh)

    monkeypatch.setattr(ops._lutq_shift, "lutq_shift", spy)
    rng = np.random.RandomState(2)
    code = _port(np.array([1, -3, 0, 16, -9, 2], np.int8))  # span 15
    a = _port(rng.randint(0, 6, (40, 12)).astype(np.int8))
    x = _port(rng.randn(3, 40).astype(np.float32))
    calls = []
    monkeypatch.setattr(ops, "shift_planes",
                        lambda w: calls.append(1) or tref.shift_planes(w))
    for _ in range(3):
        ops._pow2_dot_acc(x, code, a, None)
    assert seen == [3, 3, 3] and len(calls) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frozen", [True, False])
def test_pow2_act_quant_bit_exact_with_ties(frozen, dtype):
    rng = np.random.RandomState(5)
    # multiples of 1/4 against s = 1/2 (frozen) or a max of 127 (dynamic,
    # s = 1): many x / s land exactly on .5
    x = rng.randint(-508, 509, (6, 40)).astype(np.float32) * 0.25
    x[0, 0] = 127.0
    x[1, :4] = [2.5, -2.5, 3.5, -0.5] if not frozen else [1.25, -1.25,
                                                          0.75, -0.25]
    act = np.array([0.5, 127.0], np.float32) if frozen else None
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _port(x).to(getattr(torch, dtype))
    jxq, js = jops._pow2_act_quant(jx, None if act is None
                                   else jnp.asarray(act))
    txq, ts = ops._pow2_act_quant(tx, None if act is None else _port(act))
    assert txq.dtype == torch.int8
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    # a frozen qmax above 127 clips at 127; a zero scale becomes 1
    big = np.array([0.5, 300.0], np.float32)
    jxq, _ = jops._pow2_act_quant(jx, jnp.asarray(big))
    txq, _ = ops._pow2_act_quant(tx, _port(big))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    zero = np.array([0.0, 127.0], np.float32)
    jxq, js = jops._pow2_act_quant(jx, jnp.asarray(zero))
    txq, ts = ops._pow2_act_quant(tx, _port(zero))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    assert float(ts) == float(js) == 1.0


# ---------------------------------------------------------------------------
# serve view: planes, guard, manifest
# ---------------------------------------------------------------------------

def test_serving_pow2_planes_and_manifest_equal_jax(pow2):
    model = interop.from_jax(to_np(pow2["jcal"]), pow2["tcfg"])
    ts, tm = t_serve_view(model, policy=tapi.resolved_policy(pow2["tcfg"]),
                          with_manifest=True)
    assert_trees_equal(interop.to_numpy(ts), to_np(pow2["js"]))
    jm = {k: v for k, v in pow2["jm"].items() if not k.startswith("__")}
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    body = [v for v in tm.values()]
    assert body and all(v["encoding"] == "pow2" and v["act_frozen"]
                        and v["backend"] == "pow2" for v in body)
    # the carried-across serve tree round-trips through interop
    back = interop.from_jax(to_np(pow2["js"]), pow2["tcfg"])
    assert_trees_equal(interop.to_numpy(back), to_np(pow2["js"]))


def test_overflow_guard_decided_per_logical_leaf(pow2):
    """One layer's dictionary spans 2^-14..2^15, so 7 + 29 + log2 Kin
    > 31 for that layer; the other layer fits on its own. Every layer of
    that logical leaf keeps its float dictionary (and resolves to fused),
    as the reference keeps the whole stacked leaf."""
    jq = pow2["jq"]
    st = jq["layers"]["mlp"]["wo"]["kernel"]
    d = np.array(st.d)
    wide = np.sort(np.array([2.0 ** -14, 2.0 ** -3, 2.0 ** 3, 2.0 ** 15]
                            + list(d[1, 4:]), np.float32))
    d[1] = wide
    jq = jax.tree.map(lambda x: x, jq)
    jq["layers"]["mlp"]["wo"]["kernel"] = st._replace(d=jnp.asarray(d))
    jpol = japi.resolved_policy(pow2["jcfg"])
    js, jm = j_serve_view(jq, policy=jpol, with_manifest=True)
    model = interop.from_jax(to_np(jq), pow2["tcfg"])
    ts, tm = t_serve_view(model, policy=tapi.resolved_policy(pow2["tcfg"]),
                          with_manifest=True)
    assert_trees_equal(interop.to_numpy(ts), to_np(js))
    assert tm["layers/mlp/wo/kernel"]["encoding"] == "float"
    assert tm["layers/mlp/wo/kernel"]["backend"] == "fused"
    assert tm["layers/mlp/wi/kernel"]["encoding"] == "pow2"
    assert all(ts.layers[i].mlp.wo.kernel.d.dtype == torch.float32
               for i in range(2))
    kin = np.asarray(st.a).shape[-2]
    code0 = tl.pow2_encode(torch.from_numpy(d[0]))
    assert pow2_guard_bits(code0, kin) <= 31  # layer 0 alone would fit
    assert pow2_guard_bits(tl.pow2_encode(torch.from_numpy(d)), kin) > 31
    assert json.dumps(tm, sort_keys=True) == json.dumps(
        {k: v for k, v in jm.items() if not k.startswith("__")},
        sort_keys=True)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibrate_act_pairs_match_jax(pow2):
    model = interop.from_jax(to_np(pow2["jq"]), pow2["tcfg"])
    out = tapi.calibrate(model, pow2["tcfg"], {"tokens": _port(CALIB)})
    assert out is model
    got, want = interop.to_numpy(model), to_np(pow2["jcal"])
    n = 0
    for (path, t), (_, j) in zip(_leaves(got), _leaves(want)):
        if path[-1] != "act":
            continue
        assert t is not None and j is not None, path
        assert t.shape == j.shape and t.dtype == j.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=str(path))
        np.testing.assert_array_equal(t[..., 1], 127.0)
        # one maximum per logical leaf: every layer holds the same pair
        assert (t == t[:1]).all(), path
        n += 1
    assert n == 5


def test_calibrated_act_pairs_round_trip_through_checkpoint(pow2, tmp_path):
    from repro.checkpoint import ckpt as jckpt
    from repro_torch.checkpoint import ckpt as tckpt
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.train_state import init_train_state

    tcfg = pow2["tcfg"]
    model = interop.from_jax(to_np(pow2["jq"]), tcfg)
    tapi.calibrate(model, tcfg, {"tokens": _port(CALIB)})
    state = init_train_state(model, adamw(1e-3))
    tckpt.save(state, str(tmp_path), 1, policy=tapi.resolved_policy(tcfg))
    flat = interop.train_state_to_numpy(state)
    tree, step = tckpt.restore(str(tmp_path))
    jtree, jstep = jckpt.restore(str(tmp_path))
    assert step == jstep == 1
    assert_trees_equal(to_np(jtree)["static"], flat["static"])
    wo = tree["static"]["layers"]["mlp"]["wo"]["kernel"]["__lutq_act"]
    assert np.asarray(wo).shape == (2, 2)
    # into an uncalibrated port state: the pairs are installed
    fresh = init_train_state(interop.from_jax(to_np(pow2["jq"]), tcfg),
                             adamw(1e-3))
    assert fresh.model.layers[0].mlp.wo.kernel.act is None
    interop.load_train_state(fresh, tree)
    assert_trees_equal(interop.train_state_to_numpy(fresh)["static"],
                       flat["static"])


# ---------------------------------------------------------------------------
# serving with JAX's calibrated serve tree
# ---------------------------------------------------------------------------

def test_lutq_dot_pow2_matches_jax(pow2):
    st = pow2["js"]["layers"]["mlp"]["wi"]["kernel"]
    j1 = jax.tree.map(lambda v: v[1], st)
    t1 = interop.from_jax(to_np(pow2["js"]), pow2["tcfg"]
                          ).layers[1].mlp.wi.kernel.state
    x = np.random.RandomState(6).randn(3, 5, j1.a.shape[0]).astype(np.float32)
    for act in (j1.act, None):
        js, ts = j1._replace(act=act), t1._replace(act=None if act is None
                                                   else t1.act)
        jacc, jscale = jops._pow2_dot_acc(jnp.asarray(x[0]), js.d, js.a,
                                          js.act, interpret=True)
        tacc, tscale = ops._pow2_dot_acc(_port(x[0]), ts.d, ts.a, ts.act)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        exact = float(tscale) == float(jscale)  # JAX's exp2 exact here
        want = np.asarray(jops.lutq_dot(jnp.asarray(x), js, backend="pow2"))
        for be in ("auto", "pow2", "decode"):
            got = ops.lutq_dot(_port(x), ts, backend=be).numpy()
            assert got.shape == want.shape == (3, 5, j1.a.shape[1])
            if exact:  # the epilogue's float ops, in the reference's order
                np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.0 ** -20 * np.abs(want).max())
        np.testing.assert_array_equal(
            ops.lutq_dot(_port(x), ts, backend="decode").numpy(),
            ops.lutq_dot(_port(x), ts).numpy())
    # transposed use stays on the shift path
    xt = np.random.RandomState(7).randn(4, j1.a.shape[1]).astype(np.float32)
    want = np.asarray(jops.lutq_dot(jnp.asarray(xt), j1, backend="pow2",
                                    transpose_rhs=True))
    got = ops.lutq_dot(_port(xt), t1, transpose_rhs=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -20 * np.abs(want).max())


P, STEPS = 14, 4
#: logits, of the largest |logit|: as in test_torch_slice.py
RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_greedy_tokens_match_jax(pow2, dtype):
    jcfg = pow2["jcfg"].replace(kernel_backend="decode",
                                dtype=getattr(jnp, dtype))
    tcfg = pow2["tcfg"].replace(dtype=getattr(torch, dtype))
    toks = np.random.RandomState(8).randint(0, 211, (2, P)).astype(np.int32)
    want, jtoks = jax_reference(jcfg, pow2["js"], toks, STEPS)
    model = interop.from_jax(to_np(pow2["js"]), tcfg)
    before = dict(lutq_shift.COUNTS)
    with torch.inference_mode():
        logits = {be: tapi.prefill(model, tcfg.replace(kernel_backend=be),
                                   {"tokens": _port(toks)})[0][:, -1]
                  for be in ("decode", "auto")}
        assert lutq_shift.COUNTS["plain"] == before["plain"] + 10
        got = port_teacher_forced(tcfg, model, toks, jtoks)
    assert torch.equal(logits["decode"], logits["auto"])
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL[dtype] * np.abs(
            w).max(), err_msg=f"step {t}")
    got = tserving.generate(model, tcfg, {"tokens": _port(toks)},
                            steps=STEPS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jtoks)
    oracle = tserving.generate(model, tcfg.replace(kernel_backend="decode"),
                               {"tokens": _port(toks)}, steps=STEPS,
                               device="cpu")
    np.testing.assert_array_equal(oracle.numpy(), jtoks)


def test_ragged_engine_matches_jax_per_request(pow2):
    """Three ragged requests through a 2-slot engine: each request's
    tokens equal the JAX decode oracle's plain prefill/decode loop on
    that request alone. Frozen scales make every row of a pow2 matmul
    independent of the others in its batch. Reduced danube's k and v
    sit below the rule's size floor and stay float, and a float leaf
    under 8-bit activations takes one scale per call over all rows (in
    both packages), so here the model runs with act_bits=32: the pow2
    leaves quantize with their frozen pairs all the same."""
    jcfg = pow2["jcfg"].replace(kernel_backend="decode", act_bits=32)
    tcfg = pow2["tcfg"].replace(act_bits=32)
    toks = np.random.RandomState(9).randint(0, 211, (3, 10)).astype(np.int32)
    model = interop.from_jax(to_np(pow2["js"]), tcfg)
    eng = Engine(model, tcfg, capacity=2, max_len=20, device="cpu")
    lens = np.array([10, 6, 8], np.int32)
    for i, L in enumerate(lens):
        eng.submit(toks[i, :L], max_new=4)
    got = eng.run()
    np.testing.assert_array_equal(np.stack([r["tokens"] for r in got]),
                                  _jax_ragged_greedy(jcfg, pow2["js"], toks,
                                                     lens, 4))
    jax.clear_caches()


def test_engine_with_per_call_scales_matches_jax_engine(pow2):
    """Without calibration each pow2 matmul takes max|x| over every row
    it is given, idle slots and prompt padding included, so a request's
    tokens depend on what shares its batch (the reference's own
    engine-vs-solo tests are red for this reason, ROADMAP queue 3). The
    port's engine must present the reference engine's rows: on the same
    ragged queue, 2 slots, integer decode oracle in both, the two
    engines give the same tokens."""
    from repro.runtime.engine import Engine as JEngine

    jcfg = pow2["jcfg"].replace(kernel_backend="decode")
    tcfg = pow2["tcfg"].replace(kernel_backend="decode")
    js = j_serve_view(pow2["jq"], policy=japi.resolved_policy(jcfg))
    model = interop.from_jax(to_np(js), tcfg)
    assert all(layer.mlp.wi.kernel.act is None for layer in model.layers)
    toks = np.random.RandomState(9).randint(0, 211, (3, 10)).astype(np.int32)
    lens = (10, 6, 8)
    jeng = JEngine(js, jcfg, capacity=2, max_len=20)
    eng = Engine(model, tcfg, capacity=2, max_len=20, device="cpu")
    for e in (jeng, eng):
        for i, L in enumerate(lens):
            e.submit(toks[i, :L], max_new=6)
    for want, got in zip(jeng.run(), eng.run()):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    jax.clear_caches()


def _jax_ragged_greedy(jcfg, serve, toks, lens, steps):
    """The JAX plain loop over right-padded prompts (``lengths``), every
    request in its own row: prefill, then greedy decode steps."""
    from repro.runtime import serving as jserving
    from torch_port_helpers import STRICT

    max_len = toks.shape[1] + steps
    prefill = jax.jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)
    n = jnp.asarray(lens)
    logits, cache = prefill(serve, {"tokens": jnp.asarray(toks)}, n)
    cache = jserving.adapt_prefill_cache(jcfg, cache, toks.shape[0], max_len,
                                         lengths=n)
    out = []
    for t in range(steps):
        if t:
            logits, cache = decode(serve, tok, cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
        tok = tok.astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def test_cli_serves_serving_pow2_on_cpu(capsys):
    before = dict(lutq_shift.COUNTS)
    assert t_serve_cli.main([
        "--arch", "h2o-danube-1.8b", "--reduced", "--quant-policy",
        "serving_pow2", "--batch", "2", "--prompt-len", "12", "--gen", "3",
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pow2: 5 leaves" in out
    assert "pow2-encoded leaves: 10 of 10" in out
    assert "lutq_shift 0," in out and "device cpu" in out
    assert lutq_shift.COUNTS["launches"] == before["launches"]
    assert lutq_shift.COUNTS["plain"] == before["plain"] + 3 * 10
