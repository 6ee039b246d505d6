"""Port parity, the vision slice: ML-BN, the post-ReLU and learned-clip
activation quantizers, the NHWC conv, ResNet-20, its LUT-Q serve views,
the CIFAR-table train step and the shapes dataset, against the JAX
package on the same numpy inputs (ResNet widths (8, 16), one block a
stage, 8x8 images).

Tolerances (float32 on both sides):
- values that take the same ops in the same order (the fake-quantizers,
  the shift-add fold, the datasets, assignments): equal bit for bit,
  and their gradients equal (a zero's sign aside);
- batch norm and ResNet logits and running statistics: 1e-5 of the
  largest magnitude. The BN scale's root differs by about an ulp (the
  port's is correctly rounded, XLA's CPU ``rsqrt`` is not) and sums run
  in another order; ML-BN's pow2 scales may differ only where the raw
  scale lies within 1e-6 (relative) of a rounding boundary, and such
  flips are counted;
- two train steps: the tolerances of ``tests/test_torch_train.py``
  (loss 1e-5 relative; masters, BN parameters and statistics 1e-5 of
  each leaf's largest magnitude; dictionaries 1e-6; assignments equal
  except for weights within 1e-6 of a midpoint, counted).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_helpers import one_thread, to_np

from repro.core import actquant as jaq
from repro.core import mlbn as jbn
from repro.core import rules as jrules
from repro.core.policy import kmeans_tree as j_kmeans_tree
from repro.core.policy import merge_trainable as j_merge
from repro.core.policy import quantize_tree as j_quantize
from repro.core.policy import serve_view as j_serve_view
from repro.core.policy import split_trainable as j_split
from repro.core.spec import QuantSpec as JSpec
from repro.data import synthetic as jsyn
from repro.models import resnet as jr
from repro.nn.conv import conv_apply as j_conv_apply
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch.core import actquant as taq
from repro_torch.core import mlbn as tbn
from repro_torch.core import rules as trules
from repro_torch.core.lutq import LutqState
from repro_torch.core.policy import quantize_tree as t_quantize
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.core.policy import split_trainable as t_split
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.launch import cifar_table as ct
from repro_torch.models import resnet as tr
from repro_torch.nn import conv as tconv
from repro_torch.nn.tree import tree_paths
from repro_torch.optim import optimizers as topt

W, BLOCKS, RES, B, N_CLASSES = (8, 16), 1, 8, 8, 8
GEO = dict(widths=W, blocks=BLOCKS)


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=1e-5):
    got, want = n(got), n(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def bits_equal(got, want):
    got, want = n(got), n(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


def equal(got, want):
    """Equal values (a gradient's zeros may differ in sign: a masked
    zero here, zero times a negative cotangent in JAX)."""
    got, want = n(got), n(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pow2_flips(raw, got, want):
    """Count pow2 scales that differ; every one must sit where the raw
    scale is within 1e-6 (relative) of a rounding boundary."""
    raw, got, want = n(raw), n(got), n(want)
    diff = got != want
    lg = np.log2(np.abs(raw[diff]).astype(np.float64))
    assert np.all(np.abs(np.abs(lg - np.floor(lg) - 0.5)) < 1e-6 / np.log(2))
    return int(diff.sum())


def is_pow2(a, tol=1e-6):
    a = np.abs(n(a))
    a = a[a > 0]
    e = np.log2(a)
    return np.allclose(e, np.round(e), atol=tol)


def rnd(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def bn_pair(p, s):
    """(JAX BNParams, BNStats) from numpy (gamma, beta), (mean, var)."""
    return (jbn.BNParams(jnp.asarray(p[0]), jnp.asarray(p[1])),
            jbn.BNStats(jnp.asarray(s[0]), jnp.asarray(s[1])),
            tbn.BNParams(t(p[0]), t(p[1])), tbn.BNStats(t(s[0]), t(s[1])))


def unit_bn(c):
    one, zero = np.ones(c, np.float32), np.zeros(c, np.float32)
    return bn_pair((one, zero), (zero, one))


# ---------------------------------------------------------------------------
# tests/test_mlbn.py, each as a JAX-against-port case
# ---------------------------------------------------------------------------

def test_mlbn_training_normalizes():
    jp, js, tp, ts = unit_bn(16)
    x = rnd(0, 128, 16, scale=5, shift=3)
    jy, _ = jbn.batch_norm(jnp.asarray(x), jp, js, training=True)
    ty, _ = tbn.batch_norm(t(x), tp, ts, training=True)
    np.testing.assert_allclose(n(ty.mean(0)), 0, atol=1e-4)
    np.testing.assert_allclose(n(ty.std(0, unbiased=False)), 1, atol=1e-2)
    close(ty, jy)


def test_mlbn_inference_scale_is_pow2():
    jp, js, tp, ts = unit_bn(16)
    x = rnd(1, 256, 16, scale=2, shift=1)
    _, js2 = jbn.batch_norm(jnp.asarray(x), jp, js, training=True,
                            multiplier_less=True, momentum=0.0)
    _, ts2 = tbn.batch_norm(t(x), tp, ts, training=True,
                            multiplier_less=True, momentum=0.0)
    close(ts2.var, js2.var)
    ja, jb = jbn.inference_scale_offset(jp, js2, multiplier_less=True)
    ta, tb = tbn.inference_scale_offset(tp, ts2, multiplier_less=True)
    assert is_pow2(ta)
    raw, _ = tbn.inference_scale_offset(tp, ts2)
    assert pow2_flips(raw, ta, ja) == 0
    close(tb, jb)


def test_mlbn_close_to_bn():
    jp, js, tp, ts = unit_bn(8)
    x = rnd(2, 512, 8, scale=1.7, shift=-0.4)
    y_bn, _ = tbn.batch_norm(t(x), tp, ts, training=True)
    y_ml, _ = tbn.batch_norm(t(x), tp, ts, training=True,
                             multiplier_less=True)
    ratio = n(y_ml.std(0) / y_bn.std(0))
    assert np.all(ratio <= np.sqrt(2) + 1e-3)
    assert np.all(ratio >= 1 / np.sqrt(2) - 1e-3)
    jy, _ = jbn.batch_norm(jnp.asarray(x), jp, js, training=True,
                           multiplier_less=True)
    close(y_ml, jy)


def test_mlbn_gamma_receives_gradient_through_ste():
    jp, js, tp, ts = unit_bn(4)
    x = rnd(3, 64, 4)

    def jloss(gamma):
        y, _ = jbn.batch_norm(jnp.asarray(x), jp._replace(gamma=gamma), js,
                              training=True, multiplier_less=True)
        return jnp.sum(y ** 2)

    jg = jax.grad(jloss)(jp.gamma)
    gamma = tp.gamma.clone().requires_grad_(True)
    y, _ = tbn.batch_norm(t(x), tp._replace(gamma=gamma), ts, training=True,
                          multiplier_less=True)
    (y ** 2).sum().backward()
    assert np.all(np.isfinite(n(gamma.grad))) and np.any(n(gamma.grad) != 0)
    close(gamma.grad, jg)


def test_mlbn_inference_matches_folded_form():
    jp, js, tp, ts = unit_bn(8)
    x = rnd(4, 32, 8, scale=2)
    _, js2 = jbn.batch_norm(jnp.asarray(x), jp, js, training=True,
                            momentum=0.0)
    _, ts2 = tbn.batch_norm(t(x), tp, ts, training=True, momentum=0.0)
    y_inf, _ = tbn.batch_norm(t(x), tp, ts2, training=False,
                              multiplier_less=True)
    a, b = tbn.inference_scale_offset(tp, ts2, multiplier_less=True)
    np.testing.assert_allclose(n(y_inf), n(a * t(x) + b), rtol=1e-4,
                               atol=1e-5)
    jy, _ = jbn.batch_norm(jnp.asarray(x), jp, js2, training=False,
                           multiplier_less=True)
    close(y_inf, jy)


def test_mlbn_shift_add_apply_bitwise_equals_multiply():
    gamma = np.linspace(0.3, 4.0, 8).astype(np.float32)
    beta = rnd(5, 8)
    x = rnd(6, 32, 8, scale=2)
    jp, js, tp, ts = bn_pair((gamma, beta), (np.zeros(8, np.float32),
                                             np.ones(8, np.float32)))
    _, js2 = jbn.batch_norm(jnp.asarray(x), jp, js, training=True,
                            momentum=0.0)
    ja, jb = jbn.inference_scale_offset(jp, js2, multiplier_less=True)
    # the port's shift-add on the reference's folded (a, b)
    got = tbn.apply_scale_offset_shift(t(x), t(ja), t(jb))
    bits_equal(got, jbn.apply_scale_offset_shift(jnp.asarray(x), ja, jb))
    bits_equal(got, t(ja) * t(x) + t(jb))
    # and on its own fold
    _, ts2 = tbn.batch_norm(t(x), tp, ts, training=True, momentum=0.0)
    a, b = tbn.inference_scale_offset(tp, ts2, multiplier_less=True)
    bits_equal(tbn.apply_scale_offset_shift(t(x), a, b), a * t(x) + b)


def test_mlbn_shift_add_zero_scale():
    a, b = np.array([0.0, 2.0], np.float32), np.array([1.0, -1.0], np.float32)
    x = np.ones((3, 2), np.float32)
    got = tbn.apply_scale_offset_shift(t(x), t(a), t(b))
    bits_equal(got, t(a) * t(x) + t(b))
    bits_equal(got, jbn.apply_scale_offset_shift(jnp.asarray(x),
                                                 jnp.asarray(a),
                                                 jnp.asarray(b)))


def _nontrivial_stats(stats):
    return {k: type(v)(v.mean + 0.3, v.var * 2.5) for k, v in stats.items()}


def test_mlbn_resnet_serve_path_matches_trained_mlbn_forward(net,
                                                             monkeypatch):
    """The port's multiplier-less inference (shift-add fold) is bit for
    bit the multiply form it replaces, and close to the reference's."""
    jparams, jstats, _ = net
    model, stats = interop.resnet_from_jax(to_np(jparams), to_np(jstats))
    x = rnd(7, 2, 8, 8, 3)
    kw = dict(GEO, training=False, multiplier_less=True)
    with torch.no_grad():
        y_fold, _ = tr.resnet20_apply(model, stats, t(x), **kw)
        monkeypatch.setattr(tr, "apply_scale_offset_shift",
                            lambda h, a, b, **_: a * h + b)
        y_mul, _ = tr.resnet20_apply(model, stats, t(x), **kw)
    bits_equal(y_fold, y_mul)
    jy, _ = jr.resnet20_apply(jparams, jstats, jnp.asarray(x), **kw)
    close(y_fold, jy)


def test_actquant_fake_quant_levels():
    x = np.linspace(-1, 1, 1001).astype(np.float32)
    q = taq.fake_quant(t(x), bits=8)
    assert len(np.unique(n(q))) <= 256
    bits_equal(q, jaq.fake_quant(jnp.asarray(x), bits=8))


def test_actquant_fake_quant_identity_gradient():
    x = t(np.linspace(-1, 1, 101).astype(np.float32)).requires_grad_(True)
    (taq.fake_quant(x, 8) ** 2).sum().backward()
    np.testing.assert_allclose(n(x.grad), n(2 * taq.fake_quant(x, 8)),
                               atol=1e-6)
    jg = jax.grad(lambda v: jnp.sum(jaq.fake_quant(v, 8) ** 2))(
        jnp.asarray(n(x)))
    equal(x.grad, jg)


def test_actquant_error_bound():
    x = rnd(8, 1000)
    q = taq.fake_quant(t(x), bits=8)
    scale = float(np.abs(x).max()) / 127.0
    assert float(np.abs(n(q) - x).max()) <= scale * 0.5 + 1e-7
    bits_equal(q, jaq.fake_quant(jnp.asarray(x), bits=8))


def test_actquant_relu_variant_nonnegative():
    x = rnd(9, 1000)
    q = taq.relu_fake_quant(t(x), bits=8)
    assert float(q.min()) >= 0.0
    bits_equal(q, jaq.relu_fake_quant(jnp.asarray(x), bits=8))


def test_actquant_bits32_is_identity():
    x = rnd(10, 100)
    bits_equal(taq.fake_quant(t(x), 32), x)
    bits_equal(taq.learned_clip_fake_quant(t(x), torch.tensor(1.0), 32), x)
    bits_equal(taq.relu_fake_quant(t(x), 32),
               jaq.relu_fake_quant(jnp.asarray(x), 32))


def test_actquant_learned_clip_levels_and_range():
    x = np.linspace(-3, 3, 1001).astype(np.float32)
    q = taq.learned_clip_fake_quant(t(x), torch.tensor(1.0), bits=4)
    assert len(np.unique(n(q))) <= 16
    assert float(q.abs().max()) <= 1.0 + 1e-5
    bits_equal(q, jaq.learned_clip_fake_quant(jnp.asarray(x),
                                              jnp.float32(1.0), bits=4))


def test_actquant_learned_clip_alpha_receives_gradient():
    x = np.array([-0.2, 0.3, 4.0, 5.0], np.float32)
    alpha = torch.tensor(1.0, requires_grad=True)
    taq.learned_clip_fake_quant(t(x), alpha, bits=8).sum().backward()
    np.testing.assert_allclose(float(alpha.grad), 2.0, atol=1e-5)
    jg = jax.grad(lambda a: jnp.sum(jaq.learned_clip_fake_quant(
        jnp.asarray(x), a, bits=8)))(jnp.float32(1.0))
    assert float(alpha.grad) == float(jg)


def test_actquant_learned_clip_identity_gradient_inside_range():
    x = t(np.linspace(-0.5, 0.5, 11).astype(np.float32)).requires_grad_(True)
    taq.learned_clip_fake_quant(x, torch.tensor(1.0), bits=8).sum().backward()
    np.testing.assert_allclose(n(x.grad), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# quantizers, batch norm and the fold against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, 32])
def test_relu_fake_quant_values_and_gradients(bits):
    x = rnd(11, 4, 33, scale=2)
    g = rnd(12, 4, 33)
    xt = t(x).requires_grad_(True)
    q = taq.relu_fake_quant(xt, bits)
    (q * t(g)).sum().backward()
    jq, jvjp = jax.vjp(lambda v: jaq.relu_fake_quant(v, bits), jnp.asarray(x))
    bits_equal(q, jq)
    equal(xt.grad, jvjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("bits", [8, 4])
def test_learned_clip_values_and_gradients(bits):
    alpha = np.float32(0.75)
    a = np.float32(np.abs(alpha) + np.float32(1e-6))
    # values inside, beyond and exactly on the clip (ties split the
    # gradient between x and alpha in both packages)
    x = np.concatenate([rnd(13, 61), [a, -a, 3 * a]]).astype(np.float32)
    g = rnd(14, x.size)
    xt = t(x).requires_grad_(True)
    at = torch.tensor(alpha, requires_grad=True)
    q = taq.learned_clip_fake_quant(xt, at, bits)
    (q * t(g)).sum().backward()
    jq, jvjp = jax.vjp(lambda v, al: jaq.learned_clip_fake_quant(v, al, bits),
                       jnp.asarray(x), jnp.float32(alpha))
    gx, ga = jvjp(jnp.asarray(g))
    bits_equal(q, jq)
    equal(xt.grad, gx)
    np.testing.assert_allclose(float(at.grad), float(ga), rtol=1e-6)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("ml", [False, True])
def test_batch_norm_matches_reference(training, ml):
    c = 12
    p = (rnd(15, c, scale=0.5, shift=1.0), rnd(16, c))
    s = (rnd(17, c), np.abs(rnd(18, c)) + 0.5)
    jp, js, tp, ts = bn_pair(p, s)
    x = rnd(19, 4, 5, 5, c, scale=3, shift=0.5)
    jy, jns = jbn.batch_norm(jnp.asarray(x), jp, js, training=training,
                             multiplier_less=ml)
    ty, tns = tbn.batch_norm(t(x), tp, ts, training=training,
                             multiplier_less=ml)
    close(ty, jy)
    close(tns.mean, jns.mean)
    close(tns.var, jns.var)
    # the folded inference form
    ja, jb = jbn.inference_scale_offset(jp, jns, multiplier_less=ml)
    ta, tb = tbn.inference_scale_offset(tp, tns, multiplier_less=ml)
    if ml:
        raw, _ = tbn.inference_scale_offset(tp, tns)
        assert pow2_flips(raw, ta, ja) == 0
        bits_equal(tbn.apply_scale_offset_shift(t(x), ta, tb),
                   ta * t(x) + tb)
    close(ta, ja)
    close(tb, jb)


def test_shift_add_bits_at_every_exponent():
    """Exact pow2 scales of both signs over the exponent window, zeros,
    and x with zeros and both signs: equal to ``a*x + b`` and to the
    reference's ldexp form, bit for bit."""
    rs = np.random.RandomState(20)
    e = np.arange(-14, 16)
    a = (np.where(rs.rand(e.size) < 0.5, -1.0, 1.0) * 2.0 ** e).astype(
        np.float32)
    a[[3, 17]] = 0.0
    b = rs.randn(a.size).astype(np.float32)
    x = (rs.randn(64, a.size) * 10.0 ** rs.randint(-3, 4, (64, 1))).astype(
        np.float32)
    x[::7] = 0.0
    got = tbn.apply_scale_offset_shift(t(x), t(a), t(b))
    bits_equal(got, t(a) * t(x) + t(b))
    bits_equal(got, jbn.apply_scale_offset_shift(jnp.asarray(x),
                                                 jnp.asarray(a),
                                                 jnp.asarray(b)))
    # NCHW-style feature axis
    xc = np.ascontiguousarray(x.T[None])
    bits_equal(tbn.apply_scale_offset_shift(t(xc), t(a), t(b), axis=1),
               t(a)[None, :, None] * t(xc) + t(b)[None, :, None])


# ---------------------------------------------------------------------------
# conv: XLA's SAME padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,k,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2),
                                         (8, 3, 1), (5, 3, 3)])
def test_conv_same_padding_values(hw, k, stride):
    x = rnd(21, 2, hw, hw, 4)
    w = rnd(22, k, k, 4, 6, scale=0.3)
    jy = j_conv_apply({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                      stride=stride)
    with torch.no_grad():
        ty = tconv.conv_apply(tconv.Conv(t(w)), t(x), stride=stride)
    close(ty, jy, 1e-6)
    before, after = tconv.same_pads(hw, k, stride)
    if before != after:
        # torch's symmetric padding: the same shape, other values
        sym = F.conv2d(t(x).permute(0, 3, 1, 2), t(w).permute(3, 2, 0, 1),
                       stride=stride, padding=(k - 1) // 2).permute(0, 2, 3, 1)
        assert sym.shape == ty.shape
        assert float((sym - ty).abs().max()) > 1e-2 * float(ty.abs().max())


def test_conv_gradients_match_reference():
    x = rnd(23, 2, 8, 8, 4)
    w = rnd(24, 3, 3, 4, 6, scale=0.3)
    g = rnd(25, 2, 4, 4, 6)
    jy, vjp = jax.vjp(lambda xx, ww: j_conv_apply({"kernel": ww}, xx,
                                                  stride=2),
                      jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    conv = tconv.Conv(t(w))
    (tconv.conv_apply(conv, xt, stride=2) * t(g)).sum().backward()
    close(xt.grad, jgx, 1e-6)
    close(conv.kernel.grad, jgw, 1e-6)


# ---------------------------------------------------------------------------
# ResNet-20
# ---------------------------------------------------------------------------

def jax_tree(model, stats):
    """The reference's (params, stats) trees of a port ResNet: nested
    dicts of jnp arrays, each ``{gamma, beta}`` level a BNParams."""
    params = {}
    for path, v in tree_paths(model):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(n(v))

    def bn(node):
        if not isinstance(node, dict):
            return node
        if sorted(node) == ["beta", "gamma"]:
            return jbn.BNParams(node["gamma"], node["beta"])
        return {k: bn(v) for k, v in node.items()}

    return bn(params), {k: jbn.BNStats(jnp.asarray(n(v.mean)),
                                       jnp.asarray(n(v.var)))
                        for k, v in stats.items()}


@pytest.fixture(scope="module")
def net():
    """(JAX params, JAX stats with non-trivial running values, input):
    the port's init from a seed, in the reference's layout."""
    model, stats = tr.init_resnet20(torch.Generator().manual_seed(0),
                                    widths=W, blocks=BLOCKS,
                                    n_classes=N_CLASSES, device="cpu")
    params, stats = jax_tree(model, stats)
    return params, _nontrivial_stats(stats), rnd(26, B, RES, RES, 3,
                                                 scale=0.3, shift=0.5)


def _stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k].mean, want[k].mean)
        close(got[k].var, want[k].var)


@pytest.mark.parametrize("act_bits", [32, 8])
@pytest.mark.parametrize("training,ml", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_resnet_forward_matches_reference(net, training, ml, act_bits):
    params, stats, x = net
    kw = dict(GEO, training=training, multiplier_less=ml, act_bits=act_bits)
    jl, jns = jr.resnet20_apply(params, stats, jnp.asarray(x), **kw)
    model, tstats = interop.resnet_from_jax(to_np(params), to_np(stats))
    tl, tns = tr.resnet20_apply(model, tstats, t(x), **kw)
    close(tl, jl)
    _stats_close(tns, jns)


def test_resnet_init_structure():
    model, stats = tr.init_resnet20(torch.Generator().manual_seed(0),
                                    widths=(16, 32, 64), blocks=3,
                                    n_classes=8, device="cpu")
    jparams, jstats = jax.eval_shape(lambda k: jr.init_resnet20(
        k, widths=(16, 32, 64), blocks=3, n_classes=8), jax.random.PRNGKey(0))
    kernels = [p for p, v in tree_paths(model) if p[-1] == "kernel"]
    assert len(kernels) == 22  # 19 convs + 2 downsamples + fc: ResNet-20
    assert sorted(stats) == sorted(jstats)
    jshapes = {tuple(str(k.key) if hasattr(k, "key") else k.name
                     for k in path): v.shape
               for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tshapes = {p: tuple(v.shape) for p, v in tree_paths(model)}
    assert tshapes == jshapes
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.init_resnet20(None, widths=W, blocks=1)  # the default is cuda


@pytest.fixture(scope="module")
def jax_quantized(net):
    """{prune_frac: the reference's 4-bit pow2 tree at min_size 64}."""
    def quantize(params, prune):
        return j_quantize(params, JSpec(bits=4, constraint="pow2",
                                        min_size=64, prune_frac=prune))
    return {prune: jax.jit(quantize, static_argnums=1)(net[0], prune)
            for prune in (0.0, 0.7)}


@pytest.mark.parametrize("prune", [0.0, 0.7])
def test_quantize_tree_assignments_equal(net, jax_quantized, prune):
    params, stats, _ = net
    tspec = TSpec(bits=4, constraint="pow2", min_size=64, prune_frac=prune)
    jq = to_np(jax_quantized[prune])
    model, _ = interop.resnet_from_jax(to_np(params), to_np(stats))
    t_quantize(model, tspec)
    leaves = {p: v for p, v in tree_paths(model) if isinstance(v, LutqState)}
    assert len(leaves) == 7  # every conv and the fc at min_size 64
    for path, st in leaves.items():
        j = jq
        for k in path:
            j = j[k]
        bits_equal(st.d, j.d)
        bits_equal(st.a, j.a)
        bits_equal(st.sid, j.sid)
        if prune:
            assert (n(st.d) == 0).sum() == 1


VIEWS = {"int8": (dict(), dict(), "fused"),
         "pack4": (dict(pack4=True), dict(pack4=True), "packed4"),
         "serving_pow2": (dict(policy=jrules.serving_pow2()),
                          dict(policy=trules.serving_pow2()), "pow2")}


@pytest.fixture(scope="module")
def quantized(net, jax_quantized):
    """(the reference's quantized tree, the port's model holding it and
    its statistics)."""
    jq = jax_quantized[0.0]
    model, tstats = interop.resnet_from_jax(to_np(jq), to_np(net[1]))
    return jq, model, tstats


@pytest.mark.parametrize("view", list(VIEWS))
def test_serve_views_match_reference(net, quantized, view):
    _, stats, x = net
    jq, model, tstats = quantized
    jkw, tkw, fc_backend = VIEWS[view]
    jv, jman = j_serve_view(jq, with_manifest=True, **jkw)
    tv, tman = t_serve_view(model, with_manifest=True, **tkw)
    assert tman == jman
    assert tman["fc/kernel"]["backend"] == fc_backend
    assert all(r["backend"] == "decode" for k, r in tman.items()
               if k != "fc/kernel")
    kw = dict(GEO, training=False, multiplier_less=True, act_bits=8)
    jl, _ = jr.resnet20_apply(jv, stats, jnp.asarray(x), **kw)
    # the port's own view and the reference's view converted
    conv, cstats = interop.resnet_from_jax(to_np(jv), to_np(stats))
    for m, s in ((tv, tstats), (conv, cstats)):
        before = ops.read_counts()
        with torch.no_grad():
            tl, _ = tr.resnet20_apply(m, s, t(x), **kw)
        delta = ops.count_delta(before)
        plain = {"fused": delta[0], "packed4": delta[1],
                 "pow2": delta[2]}
        assert plain[fc_backend] == {"launches": 0, "plain": 1}
        assert sum(d["plain"] for d in delta[:3]) == 1
        close(tl, jl)


def test_resnet_from_jax_missing_leaf_raises(net):
    params, stats, _ = net
    tree, st = to_np(params), to_np(stats)
    del tree["s1b0"]["down"]
    with pytest.raises(KeyError, match="s1b0.down.kernel"):
        interop.resnet_from_jax(tree, st)
    tree, st = to_np(params), to_np(stats)
    del st["s1b0_bn2"]
    with pytest.raises(KeyError, match="s1b0_bn2"):
        interop.resnet_from_jax(tree, st)


# ---------------------------------------------------------------------------
# the CIFAR-table train step against the reference's
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_B = 2, 16


def _jax_steps(params, stats, spec, kw, batches):
    """benchmarks/cifar_table.py's step (its lines 60-76), jitted."""
    opt = jopt.adamw(jopt.cosine_schedule(2e-3, 20, ct.STEPS))
    if spec is not None:
        params = j_quantize(params, spec)
    trainable, static = j_split(params)
    opt_state = opt.init(trainable)

    @jax.jit
    def step(trainable, static, stats, opt_state, n, batch):
        def loss_fn(tr_):
            return jr.classify_loss(j_merge(tr_, static), stats, batch, **kw)

        (loss, (new_stats, acc)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(trainable)
        trainable, opt_state = opt.update(g, opt_state, trainable, n)
        if spec is not None:
            _, static = j_split(j_kmeans_tree(j_merge(trainable, static),
                                              spec))
        return trainable, static, {**stats, **new_stats}, opt_state, loss

    losses = []
    for i, b in enumerate(batches):
        trainable, static, stats, opt_state, loss = step(
            trainable, static, stats, opt_state, jnp.asarray(i),
            {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return params, j_merge(trainable, static), stats, losses


def _near_midpoint(w, d, tol=1e-6):
    mid = (d[:-1] + d[1:]) * np.float32(0.5)
    return np.abs(w.reshape(-1)[:, None] - mid[None, :]).min(1) <= tol


@pytest.mark.parametrize("label", ["LUT-Q 4-bit pow2 (quasi ML)",
                                   "LUT-Q 4-bit pow2 (fully ML)"])
def test_train_steps_match_reference(net, label):
    params, stats, _ = net
    _, spec, ml, act_bits = ct.config(label)
    tspec = ct.table_spec(spec)
    jspec = JSpec(**{f.name: getattr(tspec, f.name)
                     for f in dataclasses.fields(tspec)})
    xs, ys = tsyn.shapes_dataset(64, seed=1, res=RES)
    it = tsyn.class_batches(xs, ys, TRAIN_B, seed=3)
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    kw = dict(GEO, multiplier_less=ml, act_bits=act_bits)
    jq, jparams, jstats, jlosses = _jax_steps(params, stats, jspec, kw,
                                              batches)

    model, tstats = interop.resnet_from_jax(to_np(jq), to_np(stats))
    opt = topt.adamw(topt.cosine_schedule(2e-3, 20, ct.STEPS))
    opt_state = opt.init(t_split(model)[0])
    tlosses = []
    for i, b in enumerate(batches):
        tstats, loss, _ = ct.train_step(model, tstats, opt, opt_state, i,
                                        ct.to_device(b, "cpu"), spec=tspec,
                                        **kw)
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _stats_close(tstats, jstats)

    jtree = to_np(jparams)
    near = quantized = 0
    for path, leaf in tree_paths(model):
        j = jtree
        for k in path:
            j = getattr(j, k) if k in ("gamma", "beta") else j[k]
        if not isinstance(leaf, LutqState):
            close(leaf, j)
            continue
        quantized += 1
        close(leaf.w, j.w)
        np.testing.assert_allclose(n(leaf.d), j.d, rtol=1e-6, atol=1e-6)
        diff = n(leaf.a) != j.a
        assert _near_midpoint(j.w[diff], j.d).all(), path
        near += int(diff.sum())
    assert quantized == 4  # the stem, down and fc are under min_size 256
    print(f"{label}: assignments that differ, all within 1e-6 of a "
          f"midpoint: {near}")


def test_cifar_table_cli_needs_a_card_or_cpu(capsys):
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.train_one(None, steps=1)
    assert ct.main(["--device", "cpu", "--steps", "1", "--widths", "4", "8",
                    "8", "--res", "8", "--batch", "8"]) == 0
    out = capsys.readouterr().out
    assert all(label in out for label, *_ in ct.CONFIGS)
    assert "ordering check" in out


# ---------------------------------------------------------------------------
# the shapes dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_img,seed,res,n_classes", [(64, 0, 16, 8),
                                                      (40, 3, 8, 8),
                                                      (24, 1, 32, 4)])
def test_shapes_dataset_bytes_equal(n_img, seed, res, n_classes):
    txs, tys = tsyn.shapes_dataset(n_img, seed=seed, res=res,
                                   n_classes=n_classes)
    jxs, jys = jsyn.shapes_dataset(n_img, seed=seed, res=res,
                                   n_classes=n_classes)
    bits_equal(txs, jxs)
    bits_equal(tys, jys)


def test_class_batches_bytes_equal():
    xs, ys = tsyn.shapes_dataset(40, seed=1, res=8)
    ti = tsyn.class_batches(xs, ys, 16, seed=3)
    ji = jsyn.class_batches(xs, ys, 16, seed=3)
    for _ in range(5):  # two epochs of two batches, and one more
        tb, jb = next(ti), next(ji)
        assert sorted(tb) == sorted(jb) == ["x", "y"]
        bits_equal(tb["x"], jb["x"])
        bits_equal(tb["y"], jb["y"])
