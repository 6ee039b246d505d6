"""Port parity, the MoE family: reduced qwen3-moe-235b-a22b (2 layers,
d_model 64, 4 heads of 16 over 1 KV head, qk-norm, 4 experts top-2,
capacity factor 4, vocab 211) against the JAX package on the same
numpy-seeded inputs; the parity cases also at ``head_dim=32``, where
``n_heads * head_dim`` (128) is not ``d_model``, as at full width.

Held bit for bit: routed expert ids; expert-stacked assignments,
dictionaries and rule ids after ``quantize``; the serve views' int8
assignments, packed bytes and pow2 sign+exponent planes (the overflow
guard decided over layers x experts), manifests; the pow2 path's int32
accumulators per expert (dynamic per-expert scales, frozen pairs, an
empty expert); interop round trips; greedy tokens through ``generate``
(int8 / fused, packed4, calibrated ``serving_pow2``) and the slot-pool
``Engine``.

Tolerances:

* ``moe_apply`` outputs and aux: 1e-5 of max|out| (1e-5 absolute for
  aux): the same float32 ops, summed in another order (the router
  product, the softmax, the k-way combine).
* expert-stacked fused / packed4 products: 1e-5 of max|out| (float32
  products in another order); pow2: the int32 sums bit for bit, the
  scaled output within 2^-20 of max|out| (JAX's exp2 may miss a power
  of two by an ulp, ROADMAP queue 3).
* ``lm_forward`` logits, as ``test_torch_slice.py``: 1e-4 of max|logit|
  in float32, 2^-9 (half a bf16 ulp) in bfloat16.

Tokens are compared exactly. The engine is compared to the JAX engine
under the same batch composition at ``act_bits=32``: dynamic 8-bit
activation scales span the whole batch (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_reference, one_thread,
                                port_teacher_forced, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import (mixed_paper as j_mixed_paper,
                              serving_aggressive as j_serving_aggressive,
                              serving_pow2 as j_serving_pow2)
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.runtime.engine import Engine as JEngine
from repro_torch import interop
from repro_torch.core.policy import pow2_guard_bits
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.rules import (mixed_paper as t_mixed_paper,
                                    serving_aggressive as t_serving_aggressive,
                                    serving_pow2 as t_serving_pow2)
from repro_torch.kernels import audit, lutq_shift, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.nn.tree import logical_path
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

ARCH = "qwen3-moe-235b-a22b"
B, P, STEPS = 2, 12, 4
RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}
CALIB = np.random.RandomState(1).randint(0, 211, (2, 12)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", head_dim=16, **kw):
    """Reduced qwen3-moe, 4-bit pow2 LUT-Q on every leaf, both sides
    (``quant=None``: float)."""
    fp = "quant" in kw and kw.pop("quant") is None
    jcfg, tcfg = cfg_pair(dtype, arch=ARCH, constraint="pow2",
                          head_dim=head_dim, remat=False, **kw)
    if fp:
        return jcfg.replace(quant=None), tcfg.replace(quant=None)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[16, 32], ids=["hd16", "hd32"])
def moe(request):
    """The JAX float params and their quantized (train-form) tree."""
    jcfg, tcfg = _cfgs(head_dim=request.param)
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    return dict(hd=request.param, params=params, axes=axes, jq=jq)


@pytest.fixture(scope="module")
def pow2():
    """Reduced qwen3-moe under serving_pow2: quantized, calibrated."""
    jcfg, tcfg = _cfgs(quant=None)
    jcfg = jcfg.replace(quant=j_serving_pow2())
    tcfg = tcfg.replace(quant=t_serving_pow2())
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    jq = japi.quantize(params, jcfg, axes)
    jcal = japi.calibrate(jq, jcfg, {"tokens": jnp.asarray(CALIB)})
    return dict(jcfg=jcfg, tcfg=tcfg, jq=jq, jcal=jcal)


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


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer(E=8, n_shared=0, seed=0):
    """A float MoE layer (D 64, F 96) in both packages and x (2, 16, 64)."""
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), 64, 96, E,
                         n_shared=n_shared, d_ff_shared=96 if n_shared
                         else None)
    x = np.random.RandomState(seed + 1).randn(2, 16, 64).astype(np.float32)
    tp = tmoe.MoE(**{k: _t(v) for k, v in to_np(p).items()})
    return p, tp, x


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_matches_reference(cf, n_shared):
    """Routed expert ids equal, outputs and aux within 1e-5; at cf 1.25
    routes drop (the port drops the same slots: the outputs agree)."""
    p, tp, x = _layer(n_shared=n_shared)
    jout, jaux = jmoe.moe_apply(p, jnp.asarray(x), top_k=2,
                                capacity_factor=cf)
    xt = jnp.asarray(x).reshape(-1, 64)
    jprobs = jax.nn.softmax(xt @ p["router"], axis=-1)
    _, jids = jax.lax.top_k(jprobs, 2)
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tp, _t(x), top_k=2, capacity_factor=cf)
        _, _, ids = tmoe.route(tp.router, _t(x).reshape(-1, 64), 2)
        C = tmoe.capacity(32, 2, 8, cf)
        _, keep, _ = tmoe.dispatch(ids, torch.ones(ids.shape), C, 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (int(keep.sum()) < keep.numel()) == (cf == 1.25)
    _close(out.numpy(), jout)
    assert abs(float(aux) - float(jaux)) <= 1e-5


def test_moe_apply_without_drops_equals_dense_oracle():
    p, tp, x = _layer()
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tp, _t(x), top_k=2, capacity_factor=4.0)
        dense, daux = tmoe.moe_apply_dense(tp, _t(x), top_k=2)
    jdense, jdaux = jmoe.moe_apply_dense(p, jnp.asarray(x), top_k=2)
    _close(out.numpy(), dense.numpy())
    _close(dense.numpy(), jdense)
    assert abs(float(aux) - float(daux)) <= 1e-6
    assert abs(float(daux) - float(jdaux)) <= 1e-5


def test_shared_experts_through_lm_forward():
    """The deepseek shape of a MoE layer (one shared expert of 96) on
    reduced qwen3-moe's float params: logits and aux."""
    jcfg, tcfg = _cfgs(quant=None, n_shared_experts=1, d_ff_shared=96)
    params, _ = japi.init(jax.random.PRNGKey(2), jcfg)
    assert "shared_wi" in params["layers"]["moe"]
    toks = tokens(jcfg, B, P, seed=3)
    jl, jaux = jlm.lm_forward(params, jcfg, jnp.asarray(toks))
    model = interop.from_jax(to_np(params), tcfg)
    with torch.no_grad():
        tl, taux = tlm.lm_forward(model, tcfg, _t(toks))
    _close(tl.numpy(), jl, RTOL["float32"])
    assert abs(float(taux) - float(jaux)) <= 1e-5


# ---------------------------------------------------------------------------
# expert-stacked LUT-Q state
# ---------------------------------------------------------------------------

def test_quantize_expert_leaves_bit_exact(moe):
    """quantize on the same float params: every leaf's assignments,
    dictionaries and rule ids byte for byte; an expert leaf's d is (E,
    K) a layer and its logical path counts two stack axes."""
    _, tcfg = _cfgs(head_dim=moe["hd"])
    model = tapi.quantize(interop.from_jax(to_np(moe["params"]), tcfg), tcfg)
    got = interop.to_numpy(model)
    for k in ("w", "d", "a", "sid"):
        assert_trees_equal(to_np(moe["jq"]), got, only=k)
    wi = model.layers[0].moe.wi.kernel if hasattr(
        model.layers[0].moe.wi, "kernel") else model.layers[0].moe.wi
    assert wi.d.shape == (4, 16) and wi.a.shape == (4, 64, 96)
    assert logical_path(("layers", "1", "moe", "wo")) == (
        ("layers", "moe", "wo"), 2)
    assert logical_path(("layers", "1", "moe", "shared_wo")) == (
        ("layers", "moe", "shared_wo"), 1)


@pytest.mark.parametrize("preset", ["serving_aggressive", "mixed_paper"])
def test_moe_rules_of_the_presets(moe, preset):
    """``*/moe/*`` rules (moe-2bit-pow2, moe-ternary) claim the expert
    stacks: the same expert assignments and rule ids as JAX, the same
    pow2 dictionaries, and ternary scales (means of |w|, summed in
    another order) within 1e-6."""
    from repro.core.policy import quantize_tree as j_quantize_tree

    jpol = {"serving_aggressive": j_serving_aggressive,
            "mixed_paper": j_mixed_paper}[preset]()
    tpol = {"serving_aggressive": t_serving_aggressive,
            "mixed_paper": t_mixed_paper}[preset]()
    moe_only = {"layers": {"moe": moe["params"]["layers"]["moe"]}}
    axes = {"layers": {"moe": moe["axes"]["layers"]["moe"]}}
    jq = j_quantize_tree(moe_only, jpol, axes=axes)
    _, tcfg = _cfgs(head_dim=moe["hd"])
    tcfg = tcfg.replace(quant=tpol)
    model = tapi.quantize(interop.from_jax(to_np(moe["params"]), tcfg), tcfg)
    got = interop.to_numpy(model)["layers"]["moe"]
    want = to_np(jq)["layers"]["moe"]
    rule = {"serving_aggressive": "moe-2bit-pow2",
            "mixed_paper": "moe-ternary"}[preset]
    assert tpol.rules[int(got["wi"].sid.flat[0])].rule_name == rule
    for name in ("wi", "wg", "wo"):
        for f in ("a", "sid"):
            np.testing.assert_array_equal(getattr(got[name], f),
                                          getattr(want[name], f),
                                          err_msg=f"{name}.{f}")
        if preset == "serving_aggressive":
            np.testing.assert_array_equal(got[name].d, want[name].d)
        else:  # a scaled ternary entry is a float mean: a few ulps apart
            np.testing.assert_allclose(got[name].d, want[name].d, rtol=1e-6)
    assert got["router"].dtype == np.float32  # the router stays float


@pytest.mark.parametrize("pack4", [False, True])
def test_serve_view_expert_leaves_bit_exact(moe, pack4):
    jcfg, tcfg = _cfgs(head_dim=moe["hd"])
    js, jm = j_serve_view(moe["jq"], pack4=pack4,
                          policy=japi.resolved_policy(jcfg),
                          with_manifest=True)
    model, tm = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                             pack4=pack4, policy=tapi.resolved_policy(tcfg),
                             with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(model))
    assert tm == jm
    assert tm["layers/moe/wi"]["stack"] == 2
    assert tm["layers/moe/wi"]["backend"] == ("packed4" if pack4
                                              else "fused")


def test_serving_pow2_planes_act_pairs_and_manifest(pow2):
    """serving_pow2 after calibration: the expert leaves' sign+exponent
    planes, int8 assignments and frozen (E, 2) pairs per layer equal the
    reference's slices."""
    jcfg, tcfg = pow2["jcfg"], pow2["tcfg"]
    js, jm = j_serve_view(pow2["jcal"], policy=japi.resolved_policy(jcfg),
                          with_manifest=True)
    model = interop.from_jax(to_np(pow2["jq"]), tcfg)
    tapi.calibrate(model, tcfg, {"tokens": _t(CALIB)})
    acts = interop.to_numpy(model)["layers"]["moe"]["wi"].act
    want = to_np(pow2["jcal"])["layers"]["moe"]["wi"].act
    assert acts.shape == want.shape == (2, 4, 2)
    np.testing.assert_allclose(acts, want, rtol=1e-5)
    # serve the reference's calibrated tree: bytes and manifest equal
    served, tm = t_serve_view(interop.from_jax(to_np(pow2["jcal"]), tcfg),
                              policy=tapi.resolved_policy(tcfg),
                              with_manifest=True)
    assert_trees_equal(to_np(js), interop.to_numpy(served))
    assert tm == jm
    assert tm["layers/moe/wo"]["encoding"] == "pow2"
    assert tm["layers/moe/wo"]["backend"] == "pow2"


def test_pow2_guard_decided_over_layers_and_experts(pow2):
    """One expert of one layer with a wide exponent spread keeps the
    whole logical leaf (every layer, every expert) on float
    dictionaries, in both packages; the other leaves stay encoded."""
    from repro.core.lutq import LutqState as JState
    from repro.core.policy import _pow2_encodable as j_encodable

    jcfg, tcfg = pow2["jcfg"], pow2["tcfg"]
    tree = jax.tree.map(lambda x: x, pow2["jcal"],
                        is_leaf=lambda x: isinstance(x, JState))
    wo = tree["layers"]["moe"]["wo"]
    d = np.array(wo.d)
    d[1, 2, 0], d[1, 2, -1] = -2.0 ** 15, 2.0 ** 15
    d[1, 2, 1] = 2.0 ** -14
    tree["layers"]["moe"]["wo"] = wo._replace(d=jnp.asarray(d))
    code, fits = j_encodable(jnp.asarray(d), 96)
    assert not fits
    assert pow2_guard_bits(_t(np.asarray(code)), 96) > 31
    js, jm = j_serve_view(tree, policy=japi.resolved_policy(jcfg),
                          with_manifest=True)
    served, tm = t_serve_view(interop.from_jax(to_np(tree), tcfg),
                              policy=tapi.resolved_policy(tcfg),
                              with_manifest=True)
    assert tm == jm
    assert tm["layers/moe/wo"]["encoding"] == "float"
    assert tm["layers/moe/wi"]["encoding"] == "pow2"
    assert_trees_equal(to_np(js), interop.to_numpy(served))
    # the float expert stack keeps its frozen (E, 2) pairs: each slab is
    # fake-quantized with its expert's pair (all equal), then fused
    from repro_torch.core.actquant import fake_quant_frozen

    st = served.layers[1].moe.wo.state
    assert st.d.dtype == torch.float32 and st.act.shape == (4, 2)
    x = _t(np.random.RandomState(12).randn(4, 3, 96).astype(np.float32))
    with torch.no_grad():
        got = tmoe._expert_dot(x, st, torch.float32, act_bits=8)
        want = torch.stack([ops.lutq_dot(fake_quant_frozen(x[e], st.act[e]),
                                         st._replace(d=st.d[e], a=st.a[e],
                                                     act=None, sid=None))
                            for e in range(4)])
    _close(got.numpy(), want.numpy())


def test_interop_round_trip(moe):
    _, tcfg = _cfgs(head_dim=moe["hd"])
    model = interop.from_jax(to_np(moe["jq"]), tcfg)
    assert hasattr(model.layers[0].attn, "q_norm")
    assert_trees_equal(to_np(moe["jq"]), interop.to_numpy(model))


# ---------------------------------------------------------------------------
# the expert-stacked dot, per backend
# ---------------------------------------------------------------------------

def _buf(E=4, C=6, D=64, empty=1, seed=4):
    x = np.random.RandomState(seed).randn(E, C, D).astype(np.float32)
    x[empty] = 0.0
    return x


@pytest.mark.parametrize("pack4", [False, True])
def test_expert_dot_float_backends(moe, pack4):
    """fused / packed4: one stacked product (one plain call here, one
    launch on the card) equals the reference's vmap of lutq_dot; the
    dynamic 8-bit fake-quant spans the whole buffer; an empty expert
    gives zeros."""
    jcfg, tcfg = _cfgs(head_dim=moe["hd"])
    js = j_serve_view(moe["jq"], pack4=pack4,
                      policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                         pack4=pack4, policy=tapi.resolved_policy(tcfg))
    x = _buf()
    jleaf = jax.tree.map(lambda t: t[0], js["layers"]["moe"]["wi"])
    want = jmoe._expert_dot(jnp.asarray(x), jleaf, jnp.float32, act_bits=8)
    before = ops.read_counts()
    with torch.no_grad():
        got = tmoe._expert_dot(_t(x), model.layers[0].moe.wi.state,
                               torch.float32, act_bits=8)
    delta = ops.count_delta(before)
    assert delta[9 if pack4 else 8] == {"launches": 0, "plain": 1}
    _close(got.numpy(), want)
    assert not got[1].any()


@pytest.mark.parametrize("frozen", [False, True])
def test_expert_dot_pow2_accumulators_bit_exact(pow2, frozen):
    """pow2: int8 activations per expert slab (its own dynamic amax or
    its own frozen pair), int32 accumulators equal the reference's per
    expert bit for bit, the empty expert's are zero and its output 0."""
    jcfg = pow2["jcfg"]
    src = pow2["jcal"] if frozen else pow2["jq"]
    js = j_serve_view(src, policy=japi.resolved_policy(jcfg))
    served = t_serve_view(interop.from_jax(to_np(src), pow2["tcfg"]),
                          policy=tapi.resolved_policy(pow2["tcfg"]))
    st = served.layers[1].moe.wg.state
    assert st.d.dtype == torch.int8 and (st.act is not None) == frozen
    x = _buf(C=5, seed=6)
    x[2] *= 8.0  # a slab whose own amax differs
    jleaf = jax.tree.map(lambda t: t[1], js["layers"]["moe"]["wg"])
    for e in range(4):
        jacc, jscale = jops._pow2_dot_acc(
            jnp.asarray(x[e]), jleaf.d[e], jleaf.a[e],
            None if jleaf.act is None else jleaf.act[e], use_kernel=False)
        xq, s = ops._pow2_act_quant(_t(x), st.act, experts=True)
        wsh = tref.pow2_shift_weights(st.d)
        acc = tref.lutq_shift_experts_ref(xq, st.a, wsh)
        np.testing.assert_array_equal(acc[e].numpy(), np.asarray(jacc))
        assert float(s[e] * tref.pow2_shift_scale(st.d)[e]) == \
            pytest.approx(float(jscale), rel=2.0 ** -20)
    before = lutq_shift.EXPERT_COUNTS["plain"]
    with torch.no_grad():
        got = ops.lutq_dot_experts(_t(x), st, out_dtype=torch.float32)
    assert lutq_shift.EXPERT_COUNTS["plain"] == before + 1
    want = jmoe._expert_dot(jnp.asarray(x), jleaf, jnp.float32,
                            backend="decode", act_bits=8)
    _close(got.numpy(), want, 2.0 ** -20)
    assert not got[1].any() and bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# the model: logits, generate, engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_logits_and_aux(moe, dtype):
    jcfg, tcfg = _cfgs(dtype, head_dim=moe["hd"])
    toks = tokens(jcfg, B, P, seed=7)
    jl, jaux = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, t),
                       compiler_options={"xla_allow_excess_precision":
                                         False})(moe["jq"], jnp.asarray(toks))
    model = interop.from_jax(to_np(moe["jq"]), tcfg)
    with torch.no_grad():
        tl, taux = tlm.lm_forward(model, tcfg, _t(toks))
    want = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=RTOL[dtype] * np.abs(want).max())
    assert abs(float(taux) - float(jaux)) <= 1e-5


@pytest.mark.parametrize("view", ["int8", "packed4"])
def test_generate_tokens_identical(moe, view):
    """int8 (fused) and packed4 serve views, 8-bit activations: the
    port's generate gives the JAX prefill/decode loop's greedy tokens
    and runs the three stacked expert products a layer (their plain
    versions here) in each forward. Its decode logits (teacher-forced)
    are held within the slice's tolerance at act_bits=32: at 8 bits the
    reference's compiled layer scan rounds some activations to another
    int8 level than its own op-by-op layers do (5e-2 of the largest
    logit at head_dim 32, step 2, where the port equals the op-by-op
    layers to 1.4e-6)."""
    pack4 = view == "packed4"
    jcfg, tcfg = _cfgs(head_dim=moe["hd"])
    js = j_serve_view(moe["jq"], pack4=pack4,
                      policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                         pack4=pack4, policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, B, P, seed=5)
    _, want = jax_reference(jcfg.replace(kernel_backend="decode"), js, toks,
                            STEPS)
    before = ops.read_counts()
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=STEPS,
                            device="cpu")
    delta = ops.count_delta(before)
    np.testing.assert_array_equal(got.numpy(), want)
    experts = delta[9 if pack4 else 8]["plain"]
    assert experts == STEPS * 3 * tcfg.n_layers
    jcfg, tcfg = jcfg.replace(act_bits=32), tcfg.replace(act_bits=32)
    want_logits, want = jax_reference(jcfg.replace(kernel_backend="decode"),
                                      js, toks, STEPS)
    with torch.no_grad():
        logits = port_teacher_forced(tcfg, model, toks, want)
    for t, (g, w) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(
            w).max(), err_msg=f"step {t}")


def test_generate_serving_pow2_tokens_identical(pow2):
    """The calibrated serving_pow2 view: the experts through the stacked
    shift-add path (plain version here), tokens equal JAX's integer
    decode oracle loop; the port's decode oracle gives the same."""
    jcfg, tcfg = pow2["jcfg"], pow2["tcfg"]
    js = j_serve_view(pow2["jcal"], policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(pow2["jcal"]), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, B, P, seed=8)
    _, want = jax_reference(jcfg.replace(kernel_backend="decode"), js, toks,
                            STEPS)
    before = lutq_shift.EXPERT_COUNTS["plain"]
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=STEPS,
                            device="cpu")
    assert lutq_shift.EXPERT_COUNTS["plain"] == before + (
        STEPS * 3 * tcfg.n_layers)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = tserving.generate(model, tcfg.replace(kernel_backend="decode"),
                               {"tokens": _t(toks)}, steps=STEPS,
                               device="cpu")
    np.testing.assert_array_equal(oracle.numpy(), want)


def _ragged():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 211, n).astype(np.int32) for n in (12, 7, 9, 12,
                                                              5)]


def test_engine_matches_jax_engine_same_batch_composition(moe):
    """A 5-request ragged queue on 2 slots at act_bits=32 (int8 view):
    equal lengths are admitted together, others apart, and each
    request's tokens equal the JAX engine's."""
    jcfg, tcfg = _cfgs(head_dim=moe["hd"], act_bits=32)
    js = j_serve_view(moe["jq"], policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    jeng = JEngine(js, jcfg.replace(kernel_backend="decode"), capacity=2,
                   max_len=24)
    eng = Engine(model, tcfg, capacity=2, max_len=24, device="cpu")
    for e in (jeng, eng):
        for i, pr in enumerate(_ragged()):
            e.submit(pr, max_new=3 + i % 3)
    for want, got in zip(jeng.run(), eng.run()):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_generate_ragged_lengths_prefill_each_stream_alone(moe):
    """Right-padded MoE prompts: each stream is prefilled at its exact
    length (the padding would take expert capacity), as the reference's
    generate does: tokens equal JAX's generate and a lone generate."""
    from repro.runtime import serving as jserving

    jcfg, tcfg = _cfgs(head_dim=moe["hd"], act_bits=32)
    js = j_serve_view(moe["jq"], policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, 3, P, seed=10)
    lens = np.array([P, 6, 9], np.int32)
    want = jserving.generate(js, jcfg.replace(kernel_backend="decode"),
                             {"tokens": jnp.asarray(toks)}, steps=3,
                             lengths=lens)
    got = tserving.generate(model, tcfg, {"tokens": _t(toks)}, steps=3,
                            lengths=_t(lens), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    alone = tserving.generate(model, tcfg, {"tokens": _t(toks[1:2, :6])},
                              steps=3, device="cpu")
    np.testing.assert_array_equal(got[1].numpy(), alone[0].numpy())


def test_paged_engine_keeps_the_slot_path_and_speculative_is_refused(moe):
    jcfg, tcfg = _cfgs(head_dim=moe["hd"], act_bits=32)
    model = t_serve_view(interop.from_jax(to_np(moe["jq"]), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    assert not tapi.paged_supported(tcfg) and not japi.paged_supported(jcfg)
    paged = Engine(model, tcfg, capacity=2, max_len=24, kv_pages=16,
                   page_size=8, device="cpu")
    slot = Engine(model, tcfg, capacity=2, max_len=24, device="cpu")
    for e in (paged, slot):
        for pr in _ragged()[:3]:
            e.submit(pr, max_new=3)
    for a, b in zip(paged.run(), slot.run()):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert paged.stats()["paged"] is False
    ok, why = tapi.speculative_supported(tcfg)
    assert (ok, why) == japi.speculative_supported(jcfg) and not ok
    with pytest.raises(ValueError, match="MoE"):
        Engine(model, tcfg, capacity=2, max_len=24, speculative=2,
               device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        tapi.init_paged_cache(tcfg, 2, 16, 8, 3, device="cpu")
    cache = tapi.init_cache(tcfg, 2, 24, device="cpu")
    with pytest.raises(ValueError, match="dense configs only"):
        tapi.decode_window(model, tcfg, _t(np.zeros((2, 3), np.int32)),
                           cache)


@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"]])
def test_cli_serves_qwen3_moe_on_cpu(capsys, flags):
    """The serve CLI on reduced qwen3-moe under each policy, and the
    engine (given kv pages: the slot path): expert stacks through their
    plain versions, no launch."""
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


def test_serving_pow2_moe_forward_is_multiplierless(pow2):
    """The calibrated serving_pow2 view's prefill passes the multiply
    audit: the experts' (Din, Dout) are among the quantized shapes, no
    float dot touches them, and the integer dots are there; the router's
    float product (not quantized) is allowed."""
    tcfg = pow2["tcfg"]
    served = t_serve_view(interop.from_jax(to_np(pow2["jcal"]), tcfg),
                          policy=tapi.resolved_policy(tcfg))
    shapes = audit.quantized_weight_dims(served)
    assert {(64, 96), (96, 64)} <= shapes
    toks = {"tokens": _t(tokens(tcfg, B, P, seed=11))}
    rep = audit.audit_multiplierless(tapi.prefill, served, tcfg, toks,
                                     params=served)
    routers = [d for d in rep["fp_dots"] if d["rhs"] == (64, 4)]
    assert len(routers) == tcfg.n_layers
    assert len(rep["int_dots"]) >= 7 * tcfg.n_layers
