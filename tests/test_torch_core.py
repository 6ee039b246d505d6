"""Port parity, core: spec/policy JSON, interop, assignment and
dictionary init, activation fake-quant, 4-bit packing, serve views."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import cfg_pair, jax_quantized, one_thread, to_np

from repro.core import lutq as jl
from repro.core import rules as jrules
from repro.core.actquant import fake_quant as j_fake_quant
from repro.core.policy import (backend_manifest as j_manifest,
                               effective_bits as j_effective_bits,
                               quantized_fraction as j_quantized_fraction,
                               rule_breakdown as j_rule_breakdown,
                               serve_view as j_serve_view)
from repro.core.spec import QuantSpec as JSpec
from repro.kernels.ref import pack4_kin as j_pack4_kin
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core import lutq as tl
from repro_torch.core import rules as trules
from repro_torch.core.actquant import fake_quant as t_fake_quant
from repro_torch.core.policy import (backend_manifest as t_manifest,
                                     effective_bits as t_effective_bits,
                                     quantized_fraction as t_quantized_fraction,
                                     rule_breakdown as t_rule_breakdown,
                                     serve_view as t_serve_view)
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.kernels.ref import pack4_kin as t_pack4_kin
from repro_torch.kernels.ref import unpack4_kin as t_unpack4_kin
from repro_torch.models import api as tapi


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quantized():
    """(JAX config, port config, JAX quantized reduced danube)."""
    jcfg, tcfg = cfg_pair()
    return jcfg, tcfg, jax_quantized(jcfg)


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


# ---------------------------------------------------------------------------
# spec / rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jrules.PRESETS) + ["uniform:3:pow2"])
def test_policy_json_roundtrips_between_packages(name):
    jp = jrules.get_policy(name)
    tp = trules.QuantPolicy.from_json(jp.to_json())
    assert json.loads(tp.to_json()) == json.loads(jp.to_json())
    assert trules.get_policy(name).to_json() == jp.to_json()
    back = jrules.QuantPolicy.from_json(tp.to_json())
    assert back == jp


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_interop_roundtrip_unchanged(quantized):
    _, tcfg, jq = quantized
    tree = to_np(jq)
    model = interop.from_jax(tree, tcfg)
    assert "layers.1.attn.q.kernel.d" in model.state_dict()
    assert model.layers[1].attn.q.kernel.d.shape == (16,)
    assert_trees_equal(interop.to_numpy(model), tree)


def test_interop_fp_tree_roundtrip():
    jcfg, tcfg = cfg_pair()
    params, _ = japi.init(jax.random.PRNGKey(3), jcfg)
    tree = to_np(params)
    assert_trees_equal(interop.to_numpy(interop.from_jax(tree, tcfg)), tree)


# ---------------------------------------------------------------------------
# assignment and dictionary init
# ---------------------------------------------------------------------------

def test_assign_bit_exact_with_ties():
    rs = np.random.RandomState(0)
    d = np.sort(rs.randn(16).astype(np.float32))
    mid = (d[:-1] + d[1:]) * np.float32(0.5)
    w = np.concatenate([rs.randn(5000).astype(np.float32), mid, d])
    want = np.asarray(jl.assign(jnp.asarray(w), jnp.asarray(d)))
    got = tl.assign(torch.from_numpy(w), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


INIT_CASES = [
    ("dense", (64, 96), TSpec(bits=4), JSpec(bits=4)),
    ("segsum", (300, 256), TSpec(bits=4), JSpec(bits=4)),
    ("pow2", (64, 96), TSpec(bits=4, constraint="pow2"),
     JSpec(bits=4, constraint="pow2")),
    ("pow2-segsum", (300, 256), TSpec(bits=3, constraint="pow2"),
     JSpec(bits=3, constraint="pow2")),
    ("k256", (128, 96), TSpec(bits=8), JSpec(bits=8)),
    ("prune", (64, 96), TSpec(bits=4, prune_frac=0.3),
     JSpec(bits=4, prune_frac=0.3)),
]


@pytest.mark.parametrize("name,shape,tspec,jspec", INIT_CASES,
                         ids=[c[0] for c in INIT_CASES])
def test_init_state_matches_reference(name, shape, tspec, jspec):
    rs = np.random.RandomState(1)
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    js = jl.init_state(jnp.asarray(w), jspec)
    ts = tl.init_state(torch.from_numpy(w), tspec)
    # dictionaries: f32 sums in another order, 1e-6 relative
    np.testing.assert_allclose(ts.d.numpy(), np.asarray(js.d), rtol=1e-6,
                               atol=1e-6 * float(np.abs(js.d).max()))
    # assignments: bit-exact
    assert ts.a.dtype == torch.int8
    np.testing.assert_array_equal(ts.a.numpy(), np.asarray(js.a))


def test_quantile_matches_reference():
    rs = np.random.RandomState(2)
    flat = rs.randn(10001).astype(np.float32)
    qs = (np.arange(16, dtype=np.float32) + 0.5) / 16
    want = np.asarray(jnp.quantile(jnp.asarray(flat), jnp.asarray(qs)))
    got = tl.quantile_linear(torch.from_numpy(flat), torch.from_numpy(qs))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_matches_reference(bits, dtype):
    """Bit for bit in the working dtype: amax, / qmax, round, clip and
    the x + (q - x) form each round to it."""
    x = (np.random.RandomState(3).randn(7, 64) * 3).astype(np.float32)
    want = j_fake_quant(jnp.asarray(x, getattr(jnp, dtype)), bits)
    got = t_fake_quant(torch.from_numpy(x).to(getattr(torch, dtype)), bits)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# packing and serve views
# ---------------------------------------------------------------------------

def test_pack4_bytes_equal():
    a = np.random.RandomState(4).randint(0, 16, (3, 10, 7)).astype(np.int8)
    want = np.asarray(j_pack4_kin(jnp.asarray(a)))
    got = t_pack4_kin(torch.from_numpy(a))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_unpack4_kin(got).numpy(), a)


@pytest.mark.parametrize("pack4", [False, True])
def test_serve_view_byte_for_byte(quantized, pack4):
    jcfg, tcfg, jq = quantized
    jpol, tpol = japi.resolved_policy(jcfg), tapi.resolved_policy(tcfg)
    js, jm = j_serve_view(jq, pack4=pack4, policy=jpol, with_manifest=True)
    model = interop.from_jax(to_np(jq), tcfg)
    ts, tm = t_serve_view(model, pack4=pack4, policy=tpol,
                          with_manifest=True)
    assert_trees_equal(interop.to_numpy(ts), to_np(js))
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    for override in (None, "fused", "decode"):
        assert (json.dumps(t_manifest(ts, tpol, override=override),
                           sort_keys=True)
                == json.dumps(j_manifest(js, jpol, override=override),
                              sort_keys=True))
    # the quantized tree keeps its masters: the view shares, not moves
    assert model.layers[0].mlp.wi.kernel.w is not None
    assert t_quantized_fraction(ts) == pytest.approx(
        j_quantized_fraction(js))
    assert t_effective_bits(ts) == j_effective_bits(js)
    assert t_rule_breakdown(ts, tpol) == j_rule_breakdown(js, jpol)


def test_pow2_rule_raises_not_implemented(quantized):
    _, tcfg, jq = quantized
    model = interop.from_jax(to_np(jq), tcfg)
    pol = trules.uniform(TSpec(bits=4, constraint="pow2", backend="pow2"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        t_serve_view(model, policy=pol)
