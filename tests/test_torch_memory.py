"""Port parity, the analytic accounting: ``core/memory.py`` and the
ResNet inventories of ``models/resnet.py`` against the JAX package, as
exact integers (footprints as the same float from the same integers),
and the memory formulas of ``tests/test_policy_serving.py`` and
``benchmarks/table2_memory.py`` on the port."""
import numpy as np
import pytest
import torch

from repro.core import memory as jm
from repro.core import rules as jrules
from repro.core.spec import LUTQ_2BIT_POW2 as J2, LUTQ_4BIT_POW2 as J4
from repro.models import resnet as jr
from repro_torch.core import memory as tm
from repro_torch.core import rules as trules
from repro_torch.core.policy import quantize_tree, serve_view
from repro_torch.core.spec import LUTQ_2BIT_POW2 as T2, LUTQ_4BIT_POW2 as T4
from repro_torch.core.spec import QuantSpec
from repro_torch.models import resnet as tr

DEPTHS = (18, 34, 50)


@pytest.mark.parametrize("depth", DEPTHS)
def test_resnet_inventories_equal(depth):
    assert tr.resnet_layer_sizes(depth) == jr.resnet_layer_sizes(depth)
    for res in (224, 32):
        assert (tr.resnet_activation_elems(depth, res)
                == jr.resnet_activation_elems(depth, res))
        assert tr._conv_inventory(depth, res) == jr._conv_inventory(depth, res)


@pytest.mark.parametrize("K", [None, 4, 16])
@pytest.mark.parametrize("depth", DEPTHS)
def test_resnet_mults_equal(depth, K):
    got = tr.resnet_mults(depth, K=K)
    assert isinstance(got, int) and got == jr.resnet_mults(depth, K=K)


@pytest.mark.parametrize("K,act_elems,act_bits,quantize_all", [
    (None, 0, 32, True), (4, 0, 32, True), (16, 802816, 8, True),
    (4, 802816, 8, False), (32, 1000, 32, True)])
def test_footprint_mb_equal(K, act_elems, act_bits, quantize_all):
    for depth in DEPTHS:
        sizes = tr.resnet_layer_sizes(depth)
        kw = dict(weight_bits=None, K=K, act_elems=act_elems,
                  act_bits=act_bits, quantize_all=quantize_all)
        assert tm.footprint_mb(sizes, **kw) == jm.footprint_mb(sizes, **kw)


def _mixed(rules, spec4, spec2):
    """benchmarks/table2_memory.py's RESNET_MIXED policy in one package."""
    return rules.QuantPolicy(
        rules=(rules.QuantRule("stem", None, name="first-layer-fp"),
               rules.QuantRule("fc", None, name="last-layer-fp"),
               rules.QuantRule("s[01]*", spec4, min_size=0,
                               name="early-4bit-pow2"),
               rules.QuantRule("*", spec2, min_size=0,
                               name="late-2bit-pow2")),
        name="resnet_mixed")


@pytest.mark.parametrize("policy", ["resnet_mixed", "paper_default",
                                    "serving_pow2", "uniform:3:pow2"])
def test_policy_footprint_equal(policy):
    if policy == "resnet_mixed":
        tp, jp = _mixed(trules, T4, T2), _mixed(jrules, J4, J2)
    else:
        tp, jp = trules.get_policy(policy), jrules.get_policy(policy)
    for depth in DEPTHS:
        sizes = tr.resnet_layer_sizes(depth)
        assert tm.policy_footprint(sizes, tp) == jm.policy_footprint(sizes, jp)


@pytest.mark.parametrize("K", [None, 2, 16, 256])
def test_shift_op_counts_equal(K):
    for o, i in ((10, 1000), (1000, 2048), (8, 64)):
        assert tm.affine_shift_ops(o, i, K) == jm.affine_shift_ops(o, i, K)
        assert tm.affine_mults(o, i, K) == jm.affine_mults(o, i, K)
    for ci, co, k, hw in jr._conv_inventory(50)[0]:
        args = (co, ci, k, k, hw, hw, K)
        assert tm.conv_shift_ops(*args) == jm.conv_shift_ops(*args)
        assert tm.conv_mults(*args) == jm.conv_mults(*args)


@pytest.mark.parametrize("bits", range(1, 9))
def test_layer_bits_equal(bits):
    K = 2 ** bits
    for n in (1, 1000, 36864, 10_000_000):
        assert tm.lutq_layer_bits(n, K) == jm.lutq_layer_bits(n, K)
        assert tm.lutq_layer_bits(n, K) == K * 32 + n * bits
        assert tm.dense_layer_bits(n) == jm.dense_layer_bits(n)
        for pair in (True, False):
            assert (tm.pow2_layer_bits(n, K, act_pair=pair)
                    == jm.pow2_layer_bits(n, K, act_pair=pair))
        if n > K * 32:
            assert tm.lutq_layer_bits(n, K) < tm.dense_layer_bits(n)


def test_affine_mults():
    assert tm.affine_mults(10, 1000) == 10_000
    assert tm.affine_mults(10, 1000, K=16) == 160


def test_serve_bytes_match_paper_formula():
    """A packed serve leaf stores exactly ``lutq_layer_bits`` (the
    reference's test on its serve view, on the port's)."""
    lin = torch.nn.Module()
    lin.layer = torch.nn.Module()
    w = np.random.RandomState(0).randn(128, 96).astype(np.float32) * 0.05
    lin.layer.kernel = torch.nn.Parameter(torch.from_numpy(w))
    quantize_tree(lin, QuantSpec(bits=4, min_size=1024))
    st = serve_view(lin, pack4=True).layer.kernel.state
    n = st.a.numel() * 2  # packed
    got = st.a.numel() * st.a.element_size() * 8 + st.d.numel() * 32
    assert got == tm.lutq_layer_bits(n, K=16, b_float=32)


def test_table2_claims():
    """benchmarks/table2_memory.py's headline claims on the port."""
    fp50 = tm.footprint_mb(tr.resnet_layer_sizes(50), weight_bits=None,
                           K=None, act_elems=0)
    q50 = tm.footprint_mb(tr.resnet_layer_sizes(50), weight_bits=2, K=4,
                          act_elems=tr.resnet_activation_elems(50),
                          act_bits=8)
    assert abs(fp50 - 97.5) < 6.0
    assert abs(q50 - 7.4) < 0.6
    assert tr.resnet_mults(50) / tr.resnet_mults(50, K=4) > 50
    rows = tm.policy_footprint(tr.resnet_layer_sizes(50),
                               _mixed(trules, T4, T2))
    assert rows["(total)"]["mib"] < fp50 / 4
