"""Port parity, the multiply audit of multiplier-less serving
(``repro_torch.kernels.audit``, ``repro_torch.launch.serve_edge``)
against the reference's StableHLO audit (``repro.kernels.audit``,
``examples/serve_edge.py``).

The reference lowers a jitted forward and parses its StableHLO; the port
records every aten op and kernel launch of an eager run. Both apply the
same three rules, so the same functions pass or fail both. The
reference's prefill runs its layers under ``lax.scan``, so its module
holds the layer body's dots once: the port's integer dots are the
reference's distinct shapes, ``n_layers`` times as many. fp multiplies
are printed, not compared (aten and StableHLO break elementwise work up
differently). No tolerance is involved: these are shape, count and
integer-bit comparisons.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from torch_port_helpers import ARCH, one_thread, to_np

from repro.core import memory as jmemory
from repro.core.lutq import LutqState as JState
from repro.core.lutq import init_state as j_init_state
from repro.core.lutq import pow2_encode as j_pow2_encode
from repro.core.policy import lutq_weight_count as j_weight_count
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.core.spec import QuantSpec as JSpec
from repro.kernels import audit as jaudit
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.nn.tree import tree_paths as j_tree_paths
from repro_torch import interop
from repro_torch.core.lutq import LutqState, decode_any
from repro_torch.kernels import audit, lutq_shift, ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_edge
from repro_torch.models import api as tapi
from repro_torch.runtime import engine as tengine


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


CALIB = np.random.RandomState(1).randint(0, 211, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def pow2():
    """Reduced danube under serving_pow2, calibrated: the JAX serve tree
    and the port's model built from it."""
    from repro.configs import get_config as jget
    from repro.models.reduce import reduced as jred
    from repro_torch.configs import get_config as tget
    from repro_torch.core.rules import serving_pow2 as t_serving_pow2
    from repro_torch.models.reduce import reduced as tred

    jcfg = jred(jget(ARCH)).replace(quant=j_serving_pow2(), act_bits=8,
                                    remat=False)
    tcfg = tred(tget(ARCH)).replace(quant=t_serving_pow2(), act_bits=8,
                                    remat=False)
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    jq = japi.calibrate(japi.quantize(params, jcfg, axes), jcfg,
                        {"tokens": jnp.asarray(CALIB)})
    js = j_serve_view(jq, policy=japi.resolved_policy(jcfg))
    return dict(jcfg=jcfg, tcfg=tcfg, js=js,
                model=interop.from_jax(to_np(js), tcfg))


def _dot_shapes(dots):
    return [(tuple(d["lhs"]), tuple(d["rhs"]), tuple(d["out"]))
            for d in dots]


# ---------------------------------------------------------------------------
# the reference's TestMultiplyAudit, mirrored
# ---------------------------------------------------------------------------

def _pow2_states(Kin, N, seed=0):
    """The reference test's pow2 leaf (JAX) and the same leaf in the
    port."""
    w = jax.random.normal(jax.random.PRNGKey(seed), (Kin, N))
    st_ = j_init_state(w, JSpec(bits=4, constraint="pow2", min_size=1))
    js = JState(w=None, d=j_pow2_encode(st_.d), a=st_.a)
    ts = LutqState(w=None, d=torch.from_numpy(np.asarray(js.d)),
                   a=torch.from_numpy(np.asarray(js.a)))
    return js, ts


def _x(M, Kin, seed=1):
    x = jax.random.normal(jax.random.PRNGKey(seed), (M, Kin))
    return x, torch.from_numpy(np.array(x))


def test_oracle_lowering_is_integer():
    """Zero fp dots in the quantized matmul path of the integer decode
    oracle; its int32 product is present, with the reference's shape; fp
    multiplies only at the boundary: quant (M, Kin) / epilogue (M, N)."""
    js, ts = _pow2_states(64, 48)
    jx, tx = _x(8, 64)
    rep = audit.audit_multiplierless(
        lambda x, s: ops.lutq_dot(x, s, backend="decode"), tx, ts,
        weight_shapes=[(64, 48)])
    assert not rep["fp_dots"]
    assert rep["int_dots"]
    for m in rep["fp_multiplies"]:
        assert m["elems"] <= 8 * 64, m
    want = jaudit.audit_multiplierless(
        lambda x, s: jops.lutq_dot(x, s, backend="decode"), jx, js,
        weight_shapes=[(64, 48)])
    assert _dot_shapes(rep["int_dots"]) == _dot_shapes(want["int_dots"])


def test_kernel_lowering_is_integer():
    _, ts = _pow2_states(64, 48)
    _, tx = _x(8, 64)
    before = dict(lutq_shift.COUNTS)
    rep = audit.audit_multiplierless(
        lambda x, s: ops.lutq_dot(x, s, backend="pow2"), tx, ts,
        weight_shapes=[(64, 48)])
    assert rep["int_dots"]
    assert lutq_shift.COUNTS["plain"] == before["plain"] + 1


def test_float_decode_fails_audit():
    w = jax.random.normal(jax.random.PRNGKey(0), (64, 48))
    st_ = j_init_state(w, JSpec(bits=4, min_size=1))
    serve = LutqState(w=None, d=torch.from_numpy(np.asarray(st_.d)),
                      a=torch.from_numpy(np.asarray(st_.a)))
    _, tx = _x(8, 64)
    with pytest.raises(AssertionError, match="decoded-weight matmul"):
        audit.audit_multiplierless(
            lambda x, s: ops.lutq_dot(x, s, backend="decode"), tx, serve,
            weight_shapes=[(64, 48)])


def test_weight_dims_collected_from_params():
    _, ts = _pow2_states(64, 48)
    dims = audit.quantized_weight_dims({"a": {"kernel": ts}})
    assert (64, 48) in dims and (48, 64) in dims
    # a packed plane holds two rows a byte: its Kin is twice its rows
    packed = ts._replace(a=torch.zeros((32, 48), dtype=torch.uint8))
    assert audit.quantized_weight_dims([packed]) == {(64, 48), (48, 64)}


# ---------------------------------------------------------------------------
# reduced danube under serving_pow2
# ---------------------------------------------------------------------------

def test_quantized_weight_dims_equal_reference(pow2):
    assert audit.quantized_weight_dims(pow2["model"]) == \
        jaudit.quantized_weight_dims(pow2["js"])


def _port_prefill_report(pow2, backend):
    tcfg = pow2["tcfg"].replace(kernel_backend=backend)
    with torch.inference_mode():
        return audit.audit_multiplierless(
            lambda p, t: tapi.prefill(p, tcfg, {"tokens": t})[0],
            pow2["model"], torch.from_numpy(CALIB), params=pow2["model"])


@pytest.fixture(scope="module")
def reference_report(pow2):
    """The reference's audit of its prefill on the oracle backend (pure
    XLA, as its own forward-audit test runs it)."""
    jcfg = pow2["jcfg"].replace(kernel_backend="decode")
    return jaudit.audit_multiplierless(
        lambda p, t: japi.prefill(p, jcfg, {"tokens": t})[0],
        pow2["js"], jnp.asarray(CALIB), params=pow2["js"])


@pytest.mark.parametrize("backend", ["decode", "auto"])
def test_forward_audit_no_fp_multiply_on_quantized_path(pow2, backend):
    """The serve forward's quantized matmuls are integer, on the integer
    decode oracle and on the kernel backend (its plain version here)."""
    assert _port_prefill_report(pow2, backend)["int_dots"]


@pytest.mark.parametrize("backend", ["decode", "auto"])
def test_int_dot_shapes_equal_reference(pow2, reference_report, backend):
    """The distinct int-dot (lhs, rhs, out) shapes of a prefill equal the
    reference's; the count is the reference's x n_layers (its layer
    scan holds the body's dots once)."""
    rep = _port_prefill_report(pow2, backend)
    got, want = _dot_shapes(rep["int_dots"]), _dot_shapes(
        reference_report["int_dots"])
    assert set(got) == set(want)
    assert len(got) == len(want) * pow2["tcfg"].n_layers
    print(f"fp multiplies: port {len(rep['fp_multiplies'])} ops, "
          f"{audit.count_ops(rep)['fp_multiply_elems']} elems; reference "
          f"{len(reference_report['fp_multiplies'])} ops, "
          f"{sum(m['elems'] for m in reference_report['fp_multiplies'])} "
          f"elems")


# ---------------------------------------------------------------------------
# the plain shift-add product: int32 on the CPU
# ---------------------------------------------------------------------------

def _shift_operands(rng, M, Kin, N, K, span, extreme, sign):
    """xq, a (int8, indices >= 128 stored negative), wsh of a pow2
    dictionary of ``span`` with both signs; ``extreme``: every term at
    its largest, all of one ``sign``."""
    mag = rng.randint(1, span + 2, K)
    mag[0], mag[-1] = 1, span + 1
    code = (mag * rng.choice([-1, 1], K)).astype(np.int8)
    if K > 2:
        code[1] = 0
    wsh = tref.pow2_shift_weights(torch.from_numpy(code))
    if extreme:
        a = np.full((Kin, N), K - 1, np.uint8).view(np.int8)
        big = 127 * sign * (1 if int(wsh[K - 1]) > 0 else -1)
        xq = np.full((M, Kin), big, np.int8)
    else:
        a = rng.randint(0, K, (Kin, N)).astype(np.uint8).view(np.int8)
        xq = rng.randint(-127, 128, (M, Kin)).astype(np.int8)
    return torch.from_numpy(xq), torch.from_numpy(a), wsh


def _check_shift_ref(xq, a, wsh):
    """int32 product == the float64 product == JAX's, bit for bit; the
    audit sees one int dot and no fp dot."""
    got, stream = audit.record(tref.lutq_shift_ref, xq, a, wsh)
    assert got.dtype == torch.int32
    f64 = torch.matmul(xq.to(torch.float64),
                       wsh[a.view(torch.uint8).long()].to(torch.float64))
    assert torch.equal(got, f64.to(torch.int32))
    want = np.asarray(jref.lutq_shift_ref(jnp.asarray(xq.numpy()),
                                          jnp.asarray(a.numpy()),
                                          jnp.asarray(wsh.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    rep = audit.multiply_report(stream)
    assert len(rep["int_dots"]) == 1 and not rep["fp_dots"]
    return got


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("K", [2, 16, 256])
@pytest.mark.parametrize("span,Kin", [(16, 256), (3, 2 ** 21)])
def test_lutq_shift_ref_int32_at_the_guards_limit(K, span, Kin, sign):
    """7 + span + ceil(log2 Kin) = 31, every term at its largest."""
    assert 7 + span + int(np.ceil(np.log2(Kin))) == 31
    rng = np.random.RandomState(K)
    xq, a, wsh = _shift_operands(rng, 2, Kin, 3, K, span, True, sign)
    got = _check_shift_ref(xq, a, wsh)
    assert torch.equal(got, torch.full_like(got, sign * 127 * 2 ** span * Kin))
    assert (a < 0).all() == (K > 128)


@settings(max_examples=30, deadline=None)
@given(span=st.integers(0, 23), K=st.sampled_from([2, 16, 256]),
       seed=st.integers(0, 2 ** 16), extreme=st.booleans(),
       sign=st.sampled_from([1, -1]))
def test_lutq_shift_ref_int32_equals_float64_and_jax(span, K, seed, extreme,
                                                      sign):
    rng = np.random.RandomState(seed)
    Kin = min(int(rng.randint(1, 300)), 2 ** (24 - span))  # guard <= 31
    M, N = int(rng.randint(1, 6)), int(rng.randint(1, 40))
    _check_shift_ref(*_shift_operands(rng, M, Kin, N, K, span, extreme,
                                      sign))


# ---------------------------------------------------------------------------
# the audit's edges
# ---------------------------------------------------------------------------

def test_weight_shaped_fp_multiply_fails_audit():
    """Scaling a decoded weight is a decoded-weight multiply."""
    _, ts = _pow2_states(64, 48)
    d = torch.linspace(-1.0, 1.0, 16)
    with pytest.raises(AssertionError, match="decoded-weight scaling"):
        audit.audit_multiplierless(lambda: decode_any(d, ts.a) * 0.5,
                                   weight_shapes=[(64, 48)])


def test_launch_without_a_note_fails():
    """Counts that grew with no note (a replayed graph's) raise."""
    def bump():
        lutq_shift.COUNTS["launches"] += 1
    before = ops.read_counts()
    try:
        with pytest.raises(RuntimeError, match="did not see"):
            audit.record(bump)
    finally:
        ops.set_counts(before)
    assert audit.RECORDER is None


def test_audit_refuses_a_capturing_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capturing"):
        audit.record(lambda: torch.ones(2) * 2)
    assert audit.RECORDER is None


def test_engine_refuses_a_graph_step_inside_an_audit(pow2, monkeypatch):
    """Where the engine would capture or replay its decode step, an
    audit raises; the same step under disable_graphs() passes."""
    eng = tengine.Engine(pow2["model"], pow2["tcfg"], capacity=1,
                         max_len=16, device="cpu")
    eng.submit(CALIB[0, :6], max_new=8)
    eng.step()
    monkeypatch.setattr(tengine.Engine, "_graphs_on",
                        lambda self: not tengine._GRAPHS_OFF)
    with pytest.raises(RuntimeError, match="disable_graphs"):
        audit.record(eng.step)
    assert audit.RECORDER is None
    with tengine.disable_graphs():
        rep = audit.audit_multiplierless(eng.step, params=pow2["model"])
    assert len(rep["int_dots"]) == 5 * pow2["tcfg"].n_layers


# ---------------------------------------------------------------------------
# serve_edge
# ---------------------------------------------------------------------------

def _reference_example_numbers(js):
    """The reference example's storage and op-budget totals, from
    ``repro.core.memory`` over the JAX serve tree, as it computes them."""
    dense_bits = q_bits = 0
    tot = {"adds": 0, "shifts": 0, "fp_mults": 0}
    dense_mults = 0
    for _, leaf in j_tree_paths(js):
        if not isinstance(leaf, JState):
            continue
        n = j_weight_count(leaf)
        K = int(leaf.d.shape[-1])
        dense_bits += jmemory.dense_layer_bits(n)
        q_bits += jmemory.pow2_layer_bits(n, K,
                                          act_pair=leaf.act is not None)
        if leaf.a.ndim < 2:
            continue
        kin, nout = int(leaf.a.shape[-2]), int(leaf.a.shape[-1])
        if leaf.a.dtype == np.uint8:
            kin *= 2
        stack = int(np.prod(leaf.a.shape[:-2], dtype=np.int64))
        o = jmemory.affine_shift_ops(nout, kin, K)
        for k in tot:
            tot[k] += o[k] * stack
        dense_mults += kin * nout * stack
    return q_bits, dense_bits, tot, dense_mults


def test_serve_edge_totals_equal_reference_example(pow2):
    q_bits, dense_bits, tot, dense_mults = _reference_example_numbers(
        pow2["js"])
    assert q_bits and tot["fp_mults"]
    assert serve_edge.storage_bits(pow2["model"]) == (q_bits, dense_bits)
    _, got_tot, got_dense = serve_edge.op_budget(pow2["model"])
    assert (got_tot, got_dense) == (tot, dense_mults)


def test_serve_edge_cli_on_cpu(pow2, capsys):
    assert serve_edge.main(["--device", "cpu", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "token-identical" in out
    # the CLI serves its own weights; its totals depend on the shapes only
    _, _, tot, _ = _reference_example_numbers(pow2["js"])
    total = [ln for ln in out.splitlines() if "(total)" in ln]
    assert total == [f"  {'(total)':42s} adds={tot['adds']:>10d} "
                     f"shifts={tot['shifts']:>7d} "
                     f"fp_mults={tot['fp_mults']:>7d}"]
