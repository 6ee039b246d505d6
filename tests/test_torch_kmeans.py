"""Port parity, training step 4 and its pieces: the ``kmeans_stats``
plain version, ``kmeans_update_stats`` / ``update_state``, the STE, the
activation STE, the optimizers and schedule, and the MarkovLM data.

Tolerances: assignments and counts equal; sums 1e-6 relative (f32 sums
in another order); dictionaries 1e-6 (pow2 ones equal); optimizer
results 1e-6 (float32 ops in the same order, transcendental functions
from another library).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_thread

from repro.core import lutq as jl
from repro.core.actquant import fake_quant as j_fake_quant
from repro.core.spec import QuantSpec as JSpec
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.kernels import ops as jops
from repro.kernels.ref import kmeans_stats_ref as j_kmeans_stats_ref
from repro.optim import optimizers as jopt
from repro_torch.core import lutq as tl
from repro_torch.core.actquant import fake_quant as t_fake_quant
from repro_torch.core.spec import QuantSpec as TSpec
from repro_torch.data.synthetic import MarkovLM as TMarkovLM
from repro_torch.kernels import kmeans_stats as tks
from repro_torch.kernels import ops as tops
from repro_torch.optim import optimizers as topt


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _case(N, K, ties, seed):
    """(w, sorted d) as numpy f32; with ``ties`` the dictionary's
    midpoints are exactly weights."""
    r = np.random.RandomState(seed)
    if ties:
        d = (np.arange(K) - (K - 1) / 2.0).astype(np.float32)
        w = ((r.randint(0, 2 * K, N) - K) * 0.5).astype(np.float32)
        w[: K - 1] = (d[:-1] + d[1:]) * np.float32(0.5)
    else:
        w = (r.randn(N) * 0.05).astype(np.float32)
        d = np.sort(r.randn(K) * 0.05).astype(np.float32)
    return w, d


@pytest.fixture(scope="module")
def jax_stats():
    """JAX's kmeans_stats (Pallas, interpret mode) and its reference on
    every case, computed once."""
    out = {}
    for case in STATS_CASES:
        w, d = _case(*case)
        jk = jops.kmeans_stats(jnp.asarray(w), jnp.asarray(d), bn=4096,
                               interpret=True)
        jr = j_kmeans_stats_ref(jnp.asarray(w), jnp.asarray(d))
        out[case] = (w, d, [tuple(np.asarray(x) for x in r)
                            for r in (jk, jr)])
    return out


STATS_CASES = [(12_288, 16, False, 0), (10_007, 16, False, 1),
               (12_288, 256, False, 2), (5_003, 256, True, 3),
               (4_099, 16, True, 4)]


@pytest.mark.parametrize("case", STATS_CASES, ids=lambda c: f"N{c[0]}-K{c[1]}"
                         f"{'-ties' if c[2] else ''}")
def test_kmeans_stats_plain_matches_jax(jax_stats, case):
    w, d, refs = jax_stats[case]
    before = dict(tks.COUNTS)
    a, sums, counts = tops.kmeans_stats(torch.from_numpy(w),
                                        torch.from_numpy(d))
    assert tks.COUNTS["plain"] == before["plain"] + 1
    assert tks.COUNTS["launches"] == before["launches"]
    assert a.dtype == torch.int8 and a.shape == w.shape
    for ja, js, jc in refs:
        np.testing.assert_array_equal(a.numpy(), ja)
        np.testing.assert_array_equal(counts.numpy(), jc)
        np.testing.assert_allclose(sums.numpy(), js, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).sum())
    if case[1] == 256:  # entries >= 128 stored as negative int8
        assert (a < 0).any()


def test_kmeans_step_fused_matches_jax():
    w, d = _case(9_001, 16, False, 5)
    ja, jd = jops.kmeans_step_fused(jnp.asarray(w), jnp.asarray(d),
                                    interpret=True)
    ta, td = tops.kmeans_step_fused(torch.from_numpy(w), torch.from_numpy(d))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-8)


SPECS = {
    "none": dict(bits=4, constraint="none", kmeans_iters=2),
    "pow2": dict(bits=4, constraint="pow2", kmeans_iters=1),
    "ternary": dict(bits=2, constraint="ternary", fixed_scale=True),
    "prune": dict(bits=3, constraint="none", prune_frac=0.25),
}


@pytest.mark.parametrize("impl", ["dense", "segsum", "stats", None])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_update_state_matches_reference(spec_name, impl):
    kw = SPECS[spec_name]
    js, ts = JSpec(min_size=1, **kw), TSpec(min_size=1, **kw)
    r = np.random.RandomState(7)
    w = (r.randn(96, 80) * 0.05).astype(np.float32)
    d0 = np.array(jl.init_dictionary(jnp.asarray(w), js))
    # the masters moved after the dictionary was fit, as in a train step
    w2 = w + (r.randn(*w.shape) * 0.01).astype(np.float32)
    a0 = np.array(jl.assign(jnp.asarray(w), jnp.asarray(d0)))
    jst = jl.update_state(jl.LutqState(jnp.asarray(w2), jnp.asarray(d0),
                                       jnp.asarray(a0)), js, impl=impl)
    tst = tl.update_state(tl.LutqState(torch.from_numpy(w2),
                                       torch.from_numpy(d0),
                                       torch.from_numpy(a0)), ts, impl=impl)
    np.testing.assert_array_equal(tst.a.numpy(), np.asarray(jst.a))
    if spec_name == "pow2":
        np.testing.assert_array_equal(tst.d.numpy(), np.asarray(jst.d))
    else:
        np.testing.assert_allclose(tst.d.numpy(), np.asarray(jst.d),
                                   rtol=1e-6, atol=1e-6)


def test_kmeans_update_stats_runs_the_kernel_path():
    """impl="stats" on a CPU tensor: kmeans_iters + 1 passes of the plain
    version (on the card the same calls launch the kernel)."""
    w, _ = _case(70_000, 16, False, 8)
    spec = TSpec(bits=4, kmeans_iters=3)
    d = tl.init_dictionary(torch.from_numpy(w), spec)
    before = tks.COUNTS["plain"]
    tl.kmeans_update_stats(torch.from_numpy(w), d, spec)
    assert tks.COUNTS["plain"] - before == spec.kmeans_iters + 1


#: danube's quantized leaf sizes (q/o, k/v, wi/wg and wo, embed/head)
TRAIN_LEAF_SIZES = [2560 * 2560, 2560 * 640, 2560 * 6912, 32000 * 2560]


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4099, 1_000_003]
                         + TRAIN_LEAF_SIZES)
def test_kmeans_plan_covers_every_element_and_row_once(n):
    """The CUDA kernel's plan, from shapes and the SM count only: the
    scalar head ends on a 16-byte boundary, the block ranges tile the
    float4 vectors with no gap, overlap or empty block, one partial row a
    block, and (up to 1e6 weights, element by element) every weight is
    taken by exactly one thread."""
    from repro_torch.kernels.ref import kmeans_thread_elements

    for K in (1, 2, 16, 17, 256):
        for sms in (1, 132):
            for off in range(4):
                p = tks.plan(n, K, sms, off)
                T = p["threads"]
                assert p == tks.plan(n, K, sms, off)
                assert p["head"] + 4 * p["nvec"] + p["tail"] == n
                assert p["head"] < 4 and p["tail"] < 4
                assert p["head"] == n or (off + p["head"]) % 4 == 0
                assert p["head"] + p["tail"] <= T
                assert T == tks.threads_for(K) and T * K * 8 <= 64 * 1024
                assert p["chunk"] % 32 == 0
                ranges = tks.block_ranges(p)
                assert len(ranges) == p["blocks"] == p["rows"]
                assert p["blocks"] <= sms * tks.blocks_per_sm(K)
                assert ranges[0][0] == 0 and ranges[-1][1] == p["nvec"]
                assert all(e == b for (_, e), (b, _) in zip(ranges,
                                                            ranges[1:]))
                assert p["nvec"] == 0 or all(b < e for b, e in ranges)
                for key in ("lanes", "slices"):
                    x = p[key]
                    assert x & (x - 1) == 0 and 1 <= x <= tks.MAX_LANES
                    assert K * x <= T or x == 1
                assert p["slices"] * K <= 256
                if n <= 1_000_003 and (K == 16 or n < 5000):
                    E = kmeans_thread_elements(p)
                    assert E.shape[:2] == (p["blocks"], T)
                    c = torch.bincount(E[E >= 0], minlength=n)
                    assert c.numel() == n and bool((c == 1).all())


@pytest.mark.parametrize("case", STATS_CASES, ids=lambda c: f"N{c[0]}-K{c[1]}"
                         f"{'-ties' if c[2] else ''}")
def test_kmeans_kernel_order_matches_jax(jax_stats, case):
    """A plain-torch f32 emulation of the CUDA kernel's summation order
    (per-thread sequential, fixed fold, block-ordered merge), under the
    plans of 1 and 132 SMs and every misalignment of w, against the
    Pallas kernel (interpret mode) and the JAX reference: assignments
    and counts equal, each entry's sum within the card's tolerance of
    1e-5 of sum|w| over the entry."""
    from repro_torch.kernels.ref import kmeans_stats_order_ref

    w, d, refs = jax_stats[case]
    K = d.shape[0]
    for sms in (1, 132):
        for off in range(4):
            a, sums, counts = kmeans_stats_order_ref(
                torch.from_numpy(w), torch.from_numpy(d),
                tks.plan(w.size, K, sms, off))
            for ja, js, jc in refs:
                np.testing.assert_array_equal(a.numpy(), ja)
                np.testing.assert_array_equal(counts.numpy(), jc)
                mag = np.zeros(K, np.float64)
                np.add.at(mag, ja.view(np.uint8), np.abs(w))
                assert (np.abs(sums.numpy() - js) <= 1e-5 * mag).all()


def test_kmeans_kernel_order_many_blocks_matches_plain():
    """The emulated order over a grid of more blocks than merge slices
    (several rows a slice) and a ragged head, against the plain
    version."""
    from repro_torch.kernels.ref import (kmeans_stats_order_ref,
                                         kmeans_stats_ref)

    w, d = _case(4_000_037, 16, False, 9)
    w, d = torch.from_numpy(w), torch.from_numpy(d)
    p = tks.plan(w.numel(), 16, 132, 1)
    assert p["blocks"] > 2 * p["slices"] and p["head"] == 3
    a0, s0, c0 = kmeans_stats_ref(w, d)
    a, sums, counts = kmeans_stats_order_ref(w, d, p)
    assert torch.equal(a, a0) and torch.equal(counts, c0)
    mag = torch.zeros(16).index_add_(0, a0.long(), w.abs())
    assert bool(((sums - s0).abs() <= 1e-5 * mag).all())


def test_kmeans_stats_without_assignments():
    """write_a=False: no assignments (None), the same sums and counts,
    one plain call counted as with them."""
    w, d = _case(10_007, 16, False, 10)
    w, d = torch.from_numpy(w), torch.from_numpy(d)
    a0, s0, c0 = tops.kmeans_stats(w, d)
    before = dict(tks.COUNTS)
    a, sums, counts = tops.kmeans_stats(w, d, write_a=False)
    assert a is None and torch.equal(sums, s0) and torch.equal(counts, c0)
    assert tks.COUNTS["plain"] == before["plain"] + 1
    assert tks.COUNTS["launches"] == before["launches"]


@pytest.mark.parametrize("spec_name", ["none", "pow2", "prune"])
def test_kmeans_update_stats_skips_only_unread_assignments(monkeypatch,
                                                           spec_name):
    """An iteration pass writes no assignments unless the prune
    correction reads them; (d, a) equal those with every pass writing,
    kmeans_iters + 1 passes either way, and the JAX update_state's."""
    kw = dict(SPECS[spec_name], kmeans_iters=3)
    ts, js = TSpec(min_size=1, **kw), JSpec(min_size=1, **kw)
    r = np.random.RandomState(11)
    w = (r.randn(96, 80) * 0.05).astype(np.float32)
    d0 = np.array(jl.init_dictionary(jnp.asarray(w), js))
    w2 = w + (r.randn(*w.shape) * 0.01).astype(np.float32)
    seen = []
    real = tops.kmeans_stats

    def spy(flat, d, write_a=True):
        seen.append(write_a)
        return real(flat, d, write_a)

    def always(flat, d, write_a=True):
        seen.append(True)
        return real(flat, d, True)

    out = {}
    for name, fn in (("skip", spy), ("always", always)):
        monkeypatch.setattr(tops, "kmeans_stats", fn)
        seen.clear()
        out[name] = tl.kmeans_update_stats(torch.from_numpy(w2),
                                           torch.from_numpy(d0), ts)
        out[name + "_writes"] = list(seen)
    keep = spec_name == "prune"
    assert out["skip_writes"] == [keep] * ts.kmeans_iters + [True]
    assert len(out["always_writes"]) == ts.kmeans_iters + 1
    for x, y in zip(out["skip"], out["always"]):
        assert torch.equal(x, y)
    a0 = np.array(jl.assign(jnp.asarray(w), jnp.asarray(d0)))
    jst = jl.update_state(jl.LutqState(jnp.asarray(w2), jnp.asarray(d0),
                                       jnp.asarray(a0)), js, impl="stats")
    np.testing.assert_array_equal(out["skip"][1].numpy(), np.asarray(jst.a))
    np.testing.assert_allclose(out["skip"][0].numpy(), np.asarray(jst.d),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,device,want", [
    (1000, "cpu", "dense"), (1 << 16, "cpu", "segsum"),
    (1 << 16, "cuda", "stats"), (1000, "cuda", "dense")])
def test_resolve_kmeans_impl_is_structural(n, device, want):
    assert jl.resolve_kmeans_impl(n) == ("dense" if n < (1 << 16)
                                         else "segsum")
    assert tl.resolve_kmeans_impl(n, device=device) == want
    assert tl.resolve_kmeans_impl(n, "stats", device="cpu") == "stats"
    with pytest.raises(ValueError):
        tl.resolve_kmeans_impl(n, "nope")


@pytest.mark.parametrize("K", [16, 256])
def test_ste_forward_is_exact_and_gradient_is_identity(K):
    r = np.random.RandomState(K)
    w = torch.from_numpy((r.randn(40, 24) * 0.05).astype(np.float32))
    w.requires_grad_(True)
    d = torch.sort(torch.from_numpy(r.randn(K).astype(np.float32))).values
    a = torch.from_numpy(r.randint(0, K, (40, 24)).astype(np.uint8)
                         ).view(torch.int8)
    q = tl.quantize_ste(w, d, a)
    want = np.asarray(jl.quantize_ste(jnp.asarray(w.detach().numpy()),
                                      jnp.asarray(d.numpy()),
                                      jnp.asarray(a.numpy())))
    np.testing.assert_array_equal(q.detach().numpy(), want)
    np.testing.assert_array_equal(q.detach().numpy(),
                                  d.numpy()[a.numpy().view(np.uint8)])
    g = torch.from_numpy(r.randn(40, 24).astype(np.float32))
    q.backward(g)
    assert torch.equal(w.grad, g)
    assert tl.quantize_ste_any(w, d, a).dtype == w.dtype


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_gradient_is_identity(bits):
    r = np.random.RandomState(bits)
    x = torch.from_numpy(r.randn(6, 33).astype(np.float32))
    x.requires_grad_(True)
    y = t_fake_quant(x, bits)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(j_fake_quant(jnp.asarray(
            x.detach().numpy()), bits)))
    g = torch.from_numpy(r.randn(6, 33).astype(np.float32))
    y.backward(g)
    assert torch.equal(x.grad, g)


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"a": r.randn(7, 5).astype(np.float32),
            "b": r.randn(11).astype(np.float32),
            "c": (r.randn(3, 4, 2) * 1e-3).astype(np.float32)}


def _jtree(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _ttree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


@pytest.mark.parametrize("make", [
    lambda o, lr: o.adamw(lr, weight_decay=0.01),
    lambda o, lr: o.adamw(lr),
    lambda o, lr: o.sgd(lr),
    lambda o, lr: o.sgd(lr, momentum=0.0, weight_decay=0.1),
    lambda o, lr: o.sgd(lr, nesterov=True, weight_decay=0.01),
], ids=["adamw-wd", "adamw", "sgd", "sgd-plain-wd", "sgd-nesterov"])
def test_optimizer_matches_reference(make):
    jsched = jopt.cosine_schedule(3e-2, 2, 5)
    tsched = topt.cosine_schedule(3e-2, 2, 5)
    jo, to = make(jopt, jsched), make(topt, tsched)
    p0 = _tree(0)
    jp, tp = _jtree(p0), _ttree(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _tree(10 + step)
        jp, js = jo.update(_jtree(g), js, jp, jnp.asarray(step, jnp.int32))
        to.update(_ttree(g), ts, tp, step)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    for name in js:
        for k in p0:
            np.testing.assert_allclose(ts[name][k].numpy(),
                                       np.asarray(js[name][k]),
                                       rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    jg, jn = jopt.clip_by_global_norm(_jtree(g), max_norm)
    tg, tn = topt.clip_by_global_norm(_ttree(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-9)


def test_cosine_schedule_matches_reference():
    js, ts = jopt.cosine_schedule(1e-3, 10, 100), topt.cosine_schedule(
        1e-3, 10, 100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_markov_batches_equal_reference():
    jl_, tl_ = JMarkovLM(211, seed=3), TMarkovLM(211, seed=3)
    np.testing.assert_array_equal(jl_.succ, tl_.succ)
    for step in (0, 7):
        jb, tb = jl_.batch(1, step, 4, 33), tl_.batch(1, step, 4, 33)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    assert jl_.entropy_floor() == tl_.entropy_floor()
