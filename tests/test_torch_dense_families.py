"""Port parity, the remaining dense LM families: mistral-large-123b (96
query heads over 8 KV heads, a group of 12) and qwen1.5-110b (a bias on
q, k and v), at reduced size against the JAX package.

``reduced()`` shrinks both to 4 query heads over 1 KV head, a group of
4, so mistral-large runs here at ``n_heads=12, n_kv_heads=1`` (its group
of 12) and at ``n_heads=16`` (the paged kernel's largest group), in both
packages. qwen1.5's q, k and v biases are zero at init in both packages,
so a parity test at init proves nothing about them: every case here sets
the JAX tree's biases to nonzero numpy values from a seed before
quantizing (a float tree for the loss). Every case is 2 layers, d_model
64, head dim 16, vocab 211, 4-bit pow2 LUT-Q at ``min_size`` 512.

Held exactly: greedy tokens through ``generate`` in the train form and
the int8, packed4 and calibrated ``serving_pow2`` views; the paged
engine's tokens request by request against the JAX engine (act_bits 32:
dynamic 8-bit scales span the batch, ROADMAP queue 3); a speculative
paged engine against plain decoding; the biases through ``interop``, the
serve and draft views and a checkpoint; the pow2 overflow guard at the
full-width reductions (Kin 28672, 49152) against the reference's.

Tolerances: teacher-forced prefill and decode logits within 1e-4 of the
largest logit in float32 and 2^-9 (half a bf16 ulp) in bfloat16, as
``test_torch_slice.py``; the loss within 1e-5 relative and every
gradient within 1e-4 of its largest element (float32 sums in another
order).
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_reference, one_thread,
                                port_teacher_forced, to_np, tokens)

from repro.core import policy as jpolicy
from repro.core.policy import serve_view as j_serve_view
from repro.core.rules import serving_pow2 as j_serving_pow2
from repro.models import api as japi
from repro.runtime.engine import Engine as JEngine
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import policy as tpolicy
from repro_torch.core.lutq import LutqState
from repro_torch.core.rules import serving_pow2 as t_serving_pow2
from repro_torch.kernels import audit, ops, paged_attn
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.nn.tree import tree_paths
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

LARGE, QWEN = "mistral-large-123b", "qwen1.5-110b"
B, P, STEPS = 2, 14, 4
RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}
#: the reduced cases: arch and the fields that give each its group
CASES = {"large-g12": dict(arch=LARGE, n_heads=12, n_kv_heads=1),
         "large-g16": dict(arch=LARGE, n_heads=16, n_kv_heads=1),
         "qwen-bias": dict(arch=QWEN)}
CALIB = np.random.RandomState(1).randint(0, 211, (2, 12)).astype(np.int32)
CSRC = Path(tlm.__file__).resolve().parents[1] / "kernels" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(case, dtype="float32", **kw):
    return cfg_pair(dtype, constraint="pow2", remat=False,
                    **CASES[case], **kw)


def _with_biases(params, seed=4):
    """The tree with every q/k/v bias set to nonzero numpy values."""
    attn = params["layers"]["attn"]
    if "bias" not in attn["q"]:
        return params
    rng = np.random.RandomState(seed)
    for k in "qkv":
        b = attn[k]["bias"]
        attn[k]["bias"] = jnp.asarray(
            (rng.randn(*b.shape) * 0.5).astype(np.float32))
    return params


@functools.lru_cache(maxsize=None)
def _family(case):
    """One case: its float params (nonzero biases), their quantized
    train-form tree and the calibrated serving_pow2 tree."""
    jcfg, tcfg = _cfgs(case)
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    params = _with_biases(params)
    jq = japi.quantize(params, jcfg, axes)
    pcfg = jcfg.replace(quant=j_serving_pow2())
    jpow2 = japi.calibrate(japi.quantize(params, pcfg, axes), pcfg,
                           {"tokens": jnp.asarray(CALIB)})
    return dict(case=case, params=params, axes=axes, jq=jq, jpow2=jpow2)


@pytest.fixture(scope="module", params=list(CASES))
def fam(request):
    return _family(request.param)


def _views(fam, jcfg, tcfg, view):
    """(JAX tree, port model) of ``view``: the train form, int8, packed4
    or the calibrated serving_pow2 view."""
    if view == "train":
        return fam["jq"], interop.from_jax(to_np(fam["jq"]), tcfg)
    tree = fam["jpow2"] if view == "pow2" else fam["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(tree, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = tpolicy.serve_view(interop.from_jax(to_np(tree), tcfg),
                               pack4=pack4,
                               policy=tapi.resolved_policy(tcfg))
    return js, model


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [LARGE, QWEN])
def test_full_width_config_is_the_reference(arch):
    from repro.configs import get_config as jget

    cfg, ref = tconfigs.get_config(arch), jget(arch)
    assert arch in tconfigs.list_archs()
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "head_dim", "resolved_head_dim",
              "rope_theta", "window", "qkv_bias", "tie_embeddings",
              "act_bits", "quant"):
        assert repr(getattr(cfg, f)) == repr(getattr(ref, f)), f
    tapi._ported(cfg)
    tlm._check_family(cfg)
    assert tapi.paged_supported(cfg)
    assert cfg.n_heads // cfg.n_kv_heads == {LARGE: 12, QWEN: 8}[arch]
    assert cfg.n_heads // cfg.n_kv_heads <= paged_attn._MAX_GROUP


def test_check_family_still_refuses_what_remains():
    """The decoder-only entry points refuse an ssm config and point it at
    models/rwkv.py (tests/test_torch_rwkv.py), a hybrid one at
    models/zamba.py (tests/test_torch_zamba.py), and an unknown family
    outright; a vlm config's modality prefix is admitted
    (tests/test_torch_vlm.py), as are MLA and leading dense layers
    (tests/test_torch_deepseek.py)."""
    cfg = tconfigs.get_config(LARGE)
    with pytest.raises(ValueError, match="models/rwkv"):
        tlm._check_family(cfg.replace(family="ssm"))
    with pytest.raises(ValueError, match="models/zamba"):
        tlm._check_family(cfg.replace(family="hybrid"))
    with pytest.raises(ValueError, match="unknown model family"):
        tlm._check_family(cfg.replace(family="retnet"))
    tlm._check_family(cfg.replace(family="vlm", n_prefix_tokens=4))
    tlm._check_family(tconfigs.get_config("paligemma-3b"))


# ---------------------------------------------------------------------------
# logits and greedy tokens against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits(fam, dtype):
    """The int8 view: the port's logits along the JAX token sequence,
    prefill and each decode step, at act_bits 32. At 8 bits a float32 or
    bf16 ulp that two summation orders give apart moves an activation to
    another int8 level (reduced mistral-large at G = 16 in bf16: one ulp
    of the prefill attention's output, 1.2e-2 of the top logit; qwen1.5
    in float32: the reference's compiled decode step against its own
    op-by-op run, 2.4e-2, which the port matches to 6e-7): tokens are
    held there, logits here."""
    jcfg, tcfg = _cfgs(fam["case"], dtype, act_bits=32)
    js, model = _views(fam, jcfg, tcfg, "int8")
    toks = tokens(jcfg, B, P, seed=3)
    want, ref_tokens = jax_reference(jcfg, js, toks, STEPS)
    with torch.inference_mode():
        got = port_teacher_forced(tcfg, model, toks, ref_tokens)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=RTOL[dtype] * float(np.abs(w).max()),
                                   err_msg=f"step {t}")
    jax.clear_caches()


@pytest.mark.parametrize("view", ["train", "int8", "packed4", "pow2"])
def test_generate_tokens_identical(fam, view):
    """Greedy tokens through ``generate`` (8-bit activations) equal the
    JAX prefill/decode loop's, in the train form and each serve view
    (serving_pow2: against JAX's integer decode oracle, and the port's
    oracle gives the same)."""
    jcfg, tcfg = _cfgs(fam["case"])
    if view == "pow2":
        jcfg = jcfg.replace(quant=j_serving_pow2())
        tcfg = tcfg.replace(quant=t_serving_pow2())
    js, model = _views(fam, jcfg, tcfg, view)
    toks = tokens(jcfg, B, P, seed=5)
    _, want = jax_reference(jcfg.replace(kernel_backend="decode"), js, toks,
                            STEPS)
    with torch.no_grad():
        got = tserving.generate(model, tcfg, {"tokens": _t(toks)},
                                steps=STEPS, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        if view == "pow2":
            oracle = tserving.generate(
                model, tcfg.replace(kernel_backend="decode"),
                {"tokens": _t(toks)}, steps=STEPS, device="cpu")
            np.testing.assert_array_equal(oracle.numpy(), want)
    jax.clear_caches()


def _ragged(vocab, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, n).astype(np.int32), g)
            for n, g in ((9, 4), (17, 3), (5, 5), (12, 4))]


def test_paged_engine_matches_jax_engine(fam):
    """Ragged requests (more than the slots) through the paged engine,
    page 8, int8 KV, act_bits 32, chunked prefill: each request's tokens
    equal the JAX paged engine's."""
    jcfg, tcfg = _cfgs(fam["case"], act_bits=32, kv_cache_bits=8)
    js, model = _views(fam, jcfg, tcfg, "int8")
    kw = dict(capacity=2, max_len=32, kv_pages=16, page_size=8,
              prefill_pack=False)
    jeng = JEngine(js, jcfg.replace(kernel_backend="decode"), warmup=False,
                   **kw)
    eng = Engine(model, tcfg, device="cpu", **kw)
    assert eng.paged
    before = paged_attn.COUNTS["plain"]
    for p, g in _ragged(tcfg.vocab):
        jeng.submit(p, max_new=g)
        eng.submit(p, max_new=g)
    with torch.no_grad():
        for want, got in zip(jeng.run(), eng.run()):
            np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                          err_msg=f"request {got['rid']}")
    # one plain paged attention a layer a decode step
    assert paged_attn.COUNTS["plain"] - before == (
        tcfg.n_layers * eng.stats()["decode_steps"])
    jax.clear_caches()


def test_packed_and_speculative_paged_engines_equal_plain_decoding(fam):
    """The paged engine with packed prefill, and a speculative paged
    engine (k = 2 over a 2-bit draft view that keeps the biases), give
    every request the tokens of its lone ``generate``."""
    jcfg, tcfg = _cfgs(fam["case"], act_bits=32)
    _, model = _views(fam, jcfg, tcfg, "packed4")
    reqs = _ragged(tcfg.vocab, seed=6)
    kw = dict(capacity=2, max_len=40, kv_pages=24, page_size=8)
    with torch.no_grad():
        lone = [tserving.generate(model, tcfg, {"tokens": _t(p[None])},
                                  steps=g, device="cpu")[0].numpy()
                for p, g in reqs]
        for extra in (dict(prefill_pack=True),
                      dict(prefill_pack=False, speculative=2, draft_bits=2)):
            eng = Engine(model, tcfg, device="cpu", **kw, **extra)
            for p, g in reqs:
                eng.submit(p, max_new=g)
            for res, want in zip(eng.run(), lone):
                np.testing.assert_array_equal(res["tokens"], want,
                                              err_msg=str(extra))
            st = eng.stats()
            if "speculative" in extra:
                assert st["spec_rounds"] > 0
            else:
                assert st["packed_groups"] > 0
    draft = tapi.draft_view(model, draft_bits=2)
    for i, layer in enumerate(model.layers):
        for k in "qkv":
            got = getattr(draft.layers[i].attn, k)
            want = getattr(layer.attn, k)
            assert hasattr(got, "bias") == (fam["case"] == "qwen-bias")
            if hasattr(want, "bias"):
                assert got.bias is want.bias


# ---------------------------------------------------------------------------
# the qkv bias
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs("qwen-bias")
    return dict(_family("qwen-bias"), jcfg=jcfg, tcfg=tcfg)


def _bias_arrays(tree):
    return {k: np.asarray(tree["layers"]["attn"][k]["bias"]) for k in "qkv"}


def test_interop_round_trip_keeps_the_biases(qwen):
    """from_jax -> to_numpy gives the JAX tree's biases back bit for bit,
    one (L, N) stack a projection, and the port's modules hold them per
    layer as float parameters."""
    want = _bias_arrays(qwen["jq"])
    assert all(np.abs(b).min() > 0 for b in want.values())
    model = interop.from_jax(to_np(qwen["jq"]), qwen["tcfg"])
    for i, layer in enumerate(model.layers):
        for k in "qkv":
            b = getattr(layer.attn, k).bias
            assert isinstance(b, torch.nn.Parameter)
            np.testing.assert_array_equal(b.detach().numpy(), want[k][i])
        assert not hasattr(layer.attn.o, "bias")
    back = _bias_arrays(interop.to_numpy(model))
    for k in "qkv":
        assert back[k].dtype == want[k].dtype
        np.testing.assert_array_equal(back[k], want[k])


@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_serve_view_leaves_the_biases_unquantized(qwen, view):
    """Each serve view keeps the biases as float leaves, shared with the
    quantized tree, and its manifest (JSON-equal to the reference's)
    names no bias."""
    jcfg, tcfg = qwen["jcfg"], qwen["tcfg"]
    jq = qwen["jq"]
    if view == "pow2":
        jcfg = jcfg.replace(quant=j_serving_pow2())
        tcfg = tcfg.replace(quant=t_serving_pow2())
        jq = japi.quantize(qwen["params"], jcfg, qwen["axes"])
    pack4 = view == "packed4"
    model = interop.from_jax(to_np(jq), tcfg)
    served, man = tpolicy.serve_view(model, pack4=pack4,
                                     policy=tapi.resolved_policy(tcfg),
                                     with_manifest=True)
    _, jman = j_serve_view(jq, pack4=pack4,
                           policy=japi.resolved_policy(jcfg),
                           with_manifest=True)
    assert man == jman
    assert not any("bias" in k for k in man)
    # serving_pow2's min_size (4096) leaves the reduced k and v float
    assert {"layers/attn/q/kernel", "layers/mlp/wo/kernel"} <= set(man)
    assert ("layers/attn/k/kernel" in man) == (view != "pow2")
    for a, b in zip(model.layers, served.layers):
        for k in "qkv":
            assert getattr(b.attn, k).bias is getattr(a.attn, k).bias
            assert getattr(b.attn, k).bias.dtype == torch.float32
    if view == "pow2":
        assert {m["encoding"] for m in man.values()} == {"pow2"}


def test_lm_loss_and_gradient_with_trainable_biases(qwen):
    """One reduced training loss and its gradient, the biases trainable:
    equal to JAX's value_and_grad over the reference's trainable split
    (the masters and every float leaf)."""
    jcfg, tcfg = qwen["jcfg"], qwen["tcfg"]
    rng = np.random.RandomState(12)
    toks = rng.randint(0, tcfg.vocab, (2, 16)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    trainable, static = jpolicy.split_trainable(qwen["jq"])

    def jloss(tr):
        return japi.loss_fn(jpolicy.merge_trainable(tr, static), jcfg,
                            {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})[0]

    jl, jg = jax.value_and_grad(jloss)(trainable)
    model = interop.from_jax(to_np(qwen["jq"]), tcfg)
    loss, _ = tlm.lm_loss(model, tcfg, {"tokens": _t(toks),
                                        "labels": _t(labels)})
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    checked = 0
    for i, layer in enumerate(model.layers):
        for k in "qkv":
            want = np.asarray(jg["layers"]["attn"][k]["bias"])[i]
            got = getattr(layer.attn, k).bias.grad.numpy()
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
            w = getattr(layer.attn, k).kernel.w.grad.numpy()
            wj = np.asarray(jg["layers"]["attn"][k]["kernel"])[i]
            np.testing.assert_allclose(w, wj, rtol=0,
                                       atol=1e-4 * np.abs(wj).max())
            checked += 2
    assert checked == 6 * tcfg.n_layers


def test_serving_pow2_forward_is_multiplierless(fam):
    """The calibrated serving_pow2 view's prefill and one decode step
    pass the multiply audit: one integer dot a quantized leaf, no float
    dot or
    weight-shaped multiply on a quantized shape; a bias add is no
    multiply."""
    _, tcfg = _cfgs(fam["case"])
    tcfg = tcfg.replace(quant=t_serving_pow2())
    model = tpolicy.serve_view(interop.from_jax(to_np(fam["jpow2"]), tcfg),
                               policy=tapi.resolved_policy(tcfg))
    toks = {"tokens": _t(tokens(tcfg, B, P, seed=11))}
    with torch.no_grad():
        rep = audit.audit_multiplierless(tapi.prefill, model, tcfg, toks,
                                         params=model)
        _, cache = tapi.prefill(model, tcfg, toks)
        cache = tserving.adapt_prefill_cache(tcfg, cache, B, P + 2)
        step = audit.audit_multiplierless(
            tapi.decode_step, model, tcfg,
            torch.zeros((B, 1), dtype=torch.int32), cache, params=model)
    # one integer dot a quantized leaf: at serving_pow2's min_size (4096)
    # q, o and the MLP's three, not the reduced k and v (64 x 16)
    n_q = sum(isinstance(leaf, LutqState) for _, leaf in tree_paths(model))
    assert n_q == 5 * tcfg.n_layers
    for r in (rep, step):
        assert audit.count_ops(r)["n_int_dots"] == n_q
    dh = tcfg.resolved_head_dim
    assert {(tcfg.d_model, tcfg.n_heads * dh),
            (tcfg.d_ff, tcfg.d_model)} <= audit.quantized_weight_dims(model)


@pytest.mark.parametrize("flags", [[], ["--pack4"],
                                   ["--quant-policy", "serving_pow2"],
                                   ["--engine", "--kv-pages", "16",
                                    "--page-size", "8", "--max-batch", "2",
                                    "--queue", "3"],
                                   ["--act-bits", "32", "--speculative", "2",
                                    "--draft-bits", "2"]])
@pytest.mark.parametrize("arch", [LARGE, QWEN])
def test_cli_serves_on_cpu(capsys, arch, flags):
    """The serve CLI on each reduced family under each view, the paged
    engine and speculative decoding: plain versions, no launch."""
    from repro_torch.launch import serve as t_serve_cli

    before = ops.read_counts()
    assert t_serve_cli.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "3", "--device",
                             "cpu"] + flags) == 0
    out = capsys.readouterr().out
    delta = ops.count_delta(before)
    assert f"[serve] {arch}:" in out
    assert any(d.get("plain", 0) > 0 for d in delta)
    assert all(d.get("launches", 0) == 0 for d in delta)
    if flags[:1] == ["--engine"]:
        assert "3/3 requests" in out


@pytest.mark.parametrize("arch", [LARGE, QWEN])
def test_checkpoint_round_trip_through_ckpt_dir(tmp_path, capsys, arch):
    """The training CLI writes a checkpoint (qwen1.5: the biases among
    its trainable leaves); ``check_ckpt_shapes`` accepts it, the serve
    CLI restores it, and the served model holds the trained biases bit
    for bit."""
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli
    from repro_torch.models.reduce import reduced

    d = str(tmp_path / "ckpt")
    assert t_train_cli.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--vocab",
                             "64", "--device", "cpu", "--ckpt-dir",
                             d]) == 0
    capsys.readouterr()
    assert t_serve_cli.main(["--arch", arch, "--reduced", "--vocab", "64",
                             "--batch", "2", "--prompt-len", "8", "--gen",
                             "3", "--device", "cpu", "--ckpt-dir", d]) == 0
    out = capsys.readouterr().out
    assert f"restored train checkpoint step 2 from {d}" in out
    params, _ = tckpt.restore_params(d)
    tcfg = reduced(tconfigs.get_config(arch)).replace(
        vocab=64, quant=tckpt.load_policy(d))
    t_serve_cli.check_ckpt_shapes(tcfg, params["trainable"])
    biased = "bias" in params["trainable"]["layers"]["attn"]["q"]
    assert biased == (arch == QWEN)
    model = interop.from_train_params(params, tcfg, device="cpu")
    if biased:
        for k in "qkv":
            want = np.asarray(params["trainable"]["layers"]["attn"][k]["bias"])
            assert np.abs(want).max() > 0  # trained away from zero
            for i, layer in enumerate(model.layers):
                np.testing.assert_array_equal(
                    getattr(layer.attn, k).bias.detach().numpy(), want[i])
    bad = dict(params["trainable"])
    bad["layers"] = {**bad["layers"], "attn": {
        **bad["layers"]["attn"], "q": {"kernel": bad["layers"]["attn"]["q"][
            "kernel"]}}}
    if biased:
        with pytest.raises(SystemExit, match="layers/attn/q/bias"):
            t_serve_cli.check_ckpt_shapes(tcfg, bad)


# ---------------------------------------------------------------------------
# the pow2 overflow guard and the paged kernel's plan at full width
# ---------------------------------------------------------------------------

def _pow2_dicts(top, spans, K=16):
    """(L, K) pow2 dictionaries, layer l spanning exponents [top -
    spans[l], top], both signs."""
    rows = []
    for s in spans:
        e = np.linspace(top - s, top, K // 2).round()
        e[0], e[-1] = top - s, top
        mags = 2.0 ** e
        rows.append(np.sort(np.concatenate([-mags, mags])))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("side", ["at", "past"])
@pytest.mark.parametrize("kin,limit", [(28672, 9), (49152, 8)])
def test_pow2_guard_equals_reference_at_full_width(kin, limit, side):
    """mistral-large's down projection (Kin 28672: span <= 9, 15 bits)
    and qwen1.5's (Kin 49152: span <= 8, 16 bits): the port's
    ``_pow2_encodable`` gives the reference's plane and decision, over
    all layers of a leaf at once, on dictionaries whose largest span sits
    at the limit or one past it."""
    span = limit + (side == "past")
    d = _pow2_dicts(-3, [3, span, limit - 2])
    jcode, jfits = jpolicy._pow2_encodable(jnp.asarray(d), kin)
    tcode, tfits = tpolicy._pow2_encodable(torch.from_numpy(d), kin)
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
    assert tfits == jfits == (side == "at")
    assert tpolicy.pow2_guard_bits(tcode, kin) == 31 + (side == "past")


def _cu_constants():
    src = (CSRC / "paged_attn.cuh").read_text()
    get = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kThreads", "kMaxGroup", "kTile", "kStages",
                     "kMaxSplits", "kMaxParts", "kMaxSmem")}
    return get, (CSRC / "paged_attn.cu").read_text()


def test_paged_plan_constants_equal_the_kernel():
    """The Python reckoning of the kernel's block (smem_plan) uses the
    .cu's own constants, so the plan and the kernel's Smem agree."""
    c, src = _cu_constants()
    assert c["kThreads"] // 32 == paged_attn._WARPS
    assert c["kMaxGroup"] == paged_attn._MAX_GROUP == 16
    assert (c["kTile"], c["kStages"], c["kMaxSplits"]) == (
        paged_attn.TILE, paged_attn.STAGES, paged_attn.MAX_SPLITS)
    assert c["kMaxParts"] == paged_attn._MAX_PARTS
    assert c["kMaxSmem"] == paged_attn.MAX_SMEM
    # the compile-time shapes of qwen1.5-110b and mistral-large-123b,
    # each in its own source
    for g, dh in ((8, 128), (12, 128)):
        assert f"if (G == {g} && dh == {dh}) return launch_g{g}_dh{dh}(" in src
        assert f"launch_dtypes<{g}, {dh}, {g}>" in (
            CSRC / f"paged_attn_g{g}.cu").read_text()


@pytest.mark.parametrize("G", [12, 16])
def test_paged_launch_plan_at_wide_groups(G):
    """At dh 128 and groups of 12 and 16 (132 SMs): run (a)'s decode
    batch (8 rows, 9 pages of 64) and one long row split across blocks
    keep their scores in shared memory in every pool dtype; the block
    grows with the group (the reduction slots at the kernel's 16 heads);
    a batch whose rows get one split each turns multipass once its score
    row outgrows the budget, and a zero budget forces it."""
    plans = {}
    for it in (1, 2, 4):
        for B, NB, w in ((8, 9, None), (1, 69, 4096), (8, 69, None)):
            p = paged_attn.launch_plan(B, 8, NB, 64, 128, G, window=w,
                                       itemsize=it, sms=132)
            assert not p["multipass"], (it, B, NB, w)
            assert p["smem_bytes"] <= paged_attn.MAX_SMEM
            assert p["nsplit"] * p["chunk"] >= p["span"]
            narrow = paged_attn.launch_plan(B, 8, NB, 64, 128, 4, window=w,
                                            itemsize=it, sms=132)
            assert p["smem_bytes"] > narrow["smem_bytes"]
            plans[it, B, NB] = p
        forced = paged_attn.launch_plan(8, 8, 9, 64, 128, G, itemsize=it,
                                        sms=132, budget_bytes=0)
        assert forced["multipass"] and forced["ws_bytes"] == (
            8 * 8 * 4 * G * forced["span"])
    # 64 sequences x 8 KV heads over 132 SMs: one split a row, whose
    # 4416-position score row of G heads (G x 17.25 KiB) leaves no room
    one = paged_attn.launch_plan(64, 8, 69, 64, 128, G, itemsize=2, sms=132)
    assert one["nsplit"] == 1 and one["multipass"]
    assert one["score_bytes"] == 4 * G * 69 * 64
    assert plans[2, 8, 9]["nsplit"] == 5 and plans[2, 8, 9]["chunk"] == 128
