"""Shared setup for the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and the port. JAX runs
on the CPU with its Pallas kernels in interpret mode; the port runs on
``device="cpu"``, where the kernel wrappers take their plain versions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

ARCH = "h2o-danube-1.8b"
#: every leaf of reduced danube is above this floor, so all quantize
MIN_SIZE = 512


def to_np(tree):
    """A JAX tree (dicts, LutqState) as numpy leaves; None fields stay."""
    return jax.tree.map(np.asarray, tree)


def cfg_pair(dtype: str = "float32", arch: str = ARCH, **kw):
    """(JAX config, port config) of reduced ``arch`` (danube unless
    named) with the same fields, 4-bit LUT-Q at MIN_SIZE unless
    ``quant_bits``/``constraint`` say otherwise. ``dtype`` names the
    working dtype of both sides."""
    from repro.configs import get_config as jget
    from repro.core.spec import QuantSpec as JSpec
    from repro.models.reduce import reduced as jred
    from repro_torch.configs import get_config as tget
    from repro_torch.core.spec import QuantSpec as TSpec
    from repro_torch.models.reduce import reduced as tred

    spec = dict(bits=kw.pop("quant_bits", 4),
                constraint=kw.pop("constraint", "none"), min_size=MIN_SIZE)
    jcfg = jred(jget(arch)).replace(quant=JSpec(**spec),
                                    dtype=getattr(jnp, dtype), **kw)
    tcfg = tred(tget(arch)).replace(quant=TSpec(**spec),
                                    dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def jax_quantized(jcfg, seed=0):
    """JAX init -> quantize of a reduced config (the slow step: share
    it)."""
    from repro.models import api as japi

    params, axes = japi.init(jax.random.PRNGKey(seed), jcfg)
    return japi.quantize(params, jcfg, axes)


def tokens(cfg, B, P, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (B, P)).astype(
        np.int32)


#: XLA's CPU compiler otherwise keeps a fused chain of bf16 elementwise
#: ops in f32 and rounds once at its end; with this off every op rounds
#: to its dtype, as the JAX program says op by op and as the port does
STRICT = {"xla_allow_excess_precision": False}


def jax_reference(jcfg, serve, toks, steps):
    """prefill -> adapt_prefill_cache -> argmax -> decode_step loop, each
    step compiled with ``STRICT``; returns (per-step logits (B, V) as
    float32 numpy, tokens (B, steps))."""
    from repro.models import api as japi
    from repro.runtime import serving as jserving

    max_len = toks.shape[1] + steps
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b, max_len=max_len),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)
    logits, cache = prefill(serve, {"tokens": jnp.asarray(toks)})
    cache = jserving.adapt_prefill_cache(jcfg, cache, toks.shape[0], max_len)
    outs, toks_out = [], []
    for t in range(steps):
        if t:
            logits, cache = decode(serve, tok, cache)
        outs.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
        tok = tok.astype(jnp.int32)
        toks_out.append(np.asarray(tok))
    return outs, np.concatenate(toks_out, axis=1)


def pow2_floor(policy, min_size):
    """``policy`` (either package's QuantPolicy) with its last rule's
    size floor at ``min_size``."""
    import dataclasses

    last = policy.rules[-1]
    last = dataclasses.replace(last, spec=dataclasses.replace(
        last.spec, min_size=min_size))
    return dataclasses.replace(policy, rules=policy.rules[:-1] + (last,))


def one_thread():
    """Keep each xdist worker's torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


def port_teacher_forced(tcfg, model, toks, ref_tokens):
    """The port's logits along the JAX token sequence: prefill, then one
    decode step per reference token; per-step logits (B, V) as float32
    numpy, as :func:`jax_reference` returns them."""
    from repro_torch.models import api as tapi
    from repro_torch.runtime import serving as tserving

    steps = ref_tokens.shape[1]
    max_len = toks.shape[1] + steps
    logits, cache = tapi.prefill(model, tcfg,
                                 {"tokens": torch.from_numpy(toks)})
    cache = tserving.adapt_prefill_cache(tcfg, cache, toks.shape[0], max_len)
    outs = [logits[:, -1].float().numpy()]
    for t in range(1, steps):
        tok = torch.from_numpy(ref_tokens[:, t - 1:t].copy())
        logits, cache = tapi.decode_step(model, tcfg, tok, cache)
        outs.append(logits[:, -1].float().numpy())
    return outs


# ---------------------------------------------------------------------------
# paligemma-3b (the vlm family): tests/test_torch_vlm*.py
# ---------------------------------------------------------------------------

VLM = "paligemma-3b"
#: reduced paligemma's prefix (``reduce.reduced``) and d_model
VLM_PFX, VLM_D = 8, 64
VLM_CALIB = {"tokens": np.random.RandomState(1).randint(
    0, 211, (2, 12)).astype(np.int32),
    "prefix_embeds": np.random.RandomState(2).randn(
        2, VLM_PFX, VLM_D).astype(np.float32)}


def vlm_cfgs(view="int8", dtype="float32", **kw):
    """(JAX config, port config) of reduced paligemma (the config's
    act_bits 8 unless given): 4-bit pow2 LUT-Q, or under ``view="pow2"``
    the serving_pow2 policy."""
    from repro.core.rules import serving_pow2 as j_serving_pow2
    from repro_torch.core.rules import serving_pow2 as t_serving_pow2

    jcfg, tcfg = cfg_pair(dtype, arch=VLM, constraint="pow2", remat=False,
                          **kw)
    if view == "pow2":
        return (jcfg.replace(quant=j_serving_pow2()),
                tcfg.replace(quant=t_serving_pow2()))
    return jcfg, tcfg


def vlm_trees():
    """The JAX float params of reduced paligemma (seed 0), their axes,
    the quantized tree and the calibrated serving_pow2 tree (calibrated
    on a prefixed batch)."""
    from repro.models import api as japi

    jcfg, _ = vlm_cfgs()
    params, axes = japi.init(jax.random.PRNGKey(0), jcfg)
    pcfg, _ = vlm_cfgs("pow2")
    pq = japi.quantize(params, pcfg, axes)
    jcal = japi.calibrate(pq, pcfg, jax.tree.map(jnp.asarray, VLM_CALIB))
    return dict(params=params, axes=axes,
                jq=japi.quantize(params, jcfg, axes), jcal=jcal)


def vlm_views(trees, view, dtype="float32", **kw):
    """(JAX config, port config, JAX tree, port model) of ``view``: the
    train form, int8, packed4 or the calibrated serving_pow2 view."""
    from repro.core.policy import serve_view as j_serve_view
    from repro.models import api as japi
    from repro_torch import interop
    from repro_torch.core.policy import serve_view as t_serve_view
    from repro_torch.models import api as tapi

    jcfg, tcfg = vlm_cfgs(view, dtype, **kw)
    if view == "train":
        return jcfg, tcfg, trees["jq"], interop.from_jax(to_np(trees["jq"]),
                                                         tcfg)
    src = trees["jcal"] if view == "pow2" else trees["jq"]
    pack4 = view == "packed4"
    js = j_serve_view(src, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(src), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    return jcfg, tcfg, js, model


def vlm_batch(seed, b=2, t=10, vocab=211, prefix=True):
    """{"tokens": (b, t)[, "prefix_embeds": (b, 8, 64) float32]}, numpy
    from ``seed``."""
    out = {"tokens": np.random.RandomState(seed).randint(
        0, vocab, (b, t)).astype(np.int32)}
    if prefix:
        out["prefix_embeds"] = np.random.RandomState(seed + 100).randn(
            b, VLM_PFX, VLM_D).astype(np.float32)
    return out


def jax_prefixed_loop(jcfg, tree, batch, steps, lengths=None):
    """The reference's prefill (a batch with or without
    ``prefix_embeds``) -> adapt_prefill_cache -> argmax -> decode loop,
    each step jitted with ``STRICT``: per-step logits (B, V) as float32
    numpy and the greedy tokens (B, steps)."""
    from repro.models import api as japi
    from repro.runtime import serving as jserving

    prefill = jax.jit(lambda p, b, n: japi.prefill(p, jcfg, b, lengths=n),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c),
                     compiler_options=STRICT)
    n, width = batch["tokens"].shape
    pfx = jcfg.n_prefix_tokens if "prefix_embeds" in batch else 0
    lens = np.full(n, width, np.int32) if lengths is None else lengths
    logits, cache = prefill(tree, jax.tree.map(jnp.asarray, batch),
                            jnp.asarray(lens))
    cache = jserving.adapt_prefill_cache(jcfg, cache, n,
                                         width + steps + pfx)
    outs, toks = [], []
    for t in range(steps):
        if t:
            logits, cache = decode(tree, tok, cache)
        lg = logits[:, -1].astype(jnp.float32)
        outs.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    jax.clear_caches()
    return outs, np.concatenate(toks, axis=1)


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
    """Two numpy trees (dicts, namedtuples) with the same paths, dtypes,
    shapes and bytes."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
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


# ---------------------------------------------------------------------------
# training parity of a family: tests/test_torch_*_train.py
# ---------------------------------------------------------------------------

def port_grads(model):
    """{(reference path, stack indices): the gradient} of every
    parameter of a port model after a backward (a quantized leaf's
    master at its kernel's path, as the reference's trainable tree)."""
    from repro_torch import interop

    keys = interop._ref_keys(model)
    out = {}
    for name, p in model.named_parameters():
        _, path, i = keys[name]
        assert p.grad is not None, name
        out[path, i] = p.grad
    return out


def jax_loss_and_grads(jcfg, jtree, batch):
    """(loss, {(reference path, stack indices): numpy gradient}) of
    ``jax.value_and_grad`` of the reference's ``loss_fn`` over the
    trainable split of ``jtree`` on the numpy ``batch``; the indices
    left None, each leaf whole (slice it with :func:`grad_slice`)."""
    from repro.core import policy as jpolicy
    from repro.models import api as japi
    from repro_torch import interop

    trainable, static = jpolicy.split_trainable(jtree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(tr):
        return japi.loss_fn(jpolicy.merge_trainable(tr, static), jcfg, jb)[0]

    jl, jg = jax.value_and_grad(jloss)(trainable)
    out = dict(interop.walk(to_np(jg)))
    jax.clear_caches()
    return float(jl), out


def grad_slice(grads, path, i):
    arr = np.asarray(grads[path], np.float32)
    return arr if i is None else arr[i]


def assert_grads_close(tgrads, jgrads, tol):
    """Each port gradient within ``tol`` of its reference leaf's (slice's)
    largest magnitude; every reference leaf is reached. Returns the
    count of leaves (per-layer slices) held."""
    seen = set()
    for (path, i), g in tgrads.items():
        want = grad_slice(jgrads, path, i)
        got = g.float().numpy()
        assert got.shape == want.shape, path
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg="/".join(path) + f" {i}")
        seen.add(path)
    assert seen == {p for p, g in jgrads.items() if g is not None}
    return len(tgrads)


def port_loss_backward(model, tcfg, batch):
    """``api.loss_fn`` of the numpy ``batch`` and its backward: the
    loss."""
    from repro_torch.models import api as tapi

    loss, _ = tapi.loss_fn(model, tcfg, {k: torch.from_numpy(np.asarray(v))
                                         for k, v in batch.items()})
    loss.backward()
    return loss


def assert_remat_same_bits(cfg_of, jtree, batch):
    """The loss and every gradient are the same bits with ``cfg.remat``
    on and off (``cfg_of(remat)`` gives the port config)."""
    from repro_torch import interop

    runs = []
    for remat in (False, True):
        tcfg = cfg_of(remat)
        model = interop.from_jax(to_np(jtree), tcfg)
        loss = port_loss_backward(model, tcfg, batch)
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def assert_kmeans_tree_reaches_every_leaf(tcfg, jtree, monkeypatch):
    """The port model's quantized leaves are the reference tree's (by
    logical path), and ``kmeans_tree`` runs step 4 on every one of
    them, once. Returns (the logical paths, the count of per-layer
    leaves)."""
    from repro_torch import interop
    from repro_torch.core import policy as tpolicy
    from repro_torch.models import api as tapi
    from repro_torch.nn.tree import QuantKernel, logical_path

    model = interop.from_jax(to_np(jtree), tcfg)
    kernels = [m for m in model.modules() if isinstance(m, QuantKernel)]
    got = {logical_path(tuple(n.split(".")))[0]
           for n, m in model.named_modules() if isinstance(m, QuantKernel)}
    assert got == {p for p, leaf in interop.walk(to_np(jtree))
                   if interop._is_state(leaf)}
    seen = []
    update = tpolicy.update_state

    def spy(state, spec, impl=None):
        seen.append(state.w.data_ptr())
        return update(state, spec, impl=impl)

    monkeypatch.setattr(tpolicy, "update_state", spy)
    tpolicy.kmeans_tree(model, tapi.resolved_policy(tcfg))
    assert sorted(seen) == sorted(m.w.data_ptr() for m in kernels)
    return got, len(kernels)


def near_midpoint(w, d, tol=1e-6):
    mid = (d[:-1] + d[1:]) * np.float32(0.5)
    return np.abs(w.reshape(-1)[:, None] - mid[None, :]).min(1) <= tol


def _stack_slices(x):
    """(index, slice) of each per-layer dictionary of a stacked leaf."""
    lead = x.shape[:-1] if x.ndim else ()
    return [(i, x[i]) for i in np.ndindex(*lead)] if lead else [((), x)]


def assert_train_states_match(jtree, ttree, master_tol=1e-5):
    """A JAX ``state_flat`` tree and a port ``train_state_to_numpy``
    tree after the same steps: the same leaves; dictionaries within
    1e-6; assignments equal wherever the dictionaries are, and where a
    weight's entry differs it lies within 1e-6 of a midpoint (summation
    order tips the nearest entry there); masters within ``master_tol``
    of each leaf's largest magnitude (the moments follow them and are
    not held); the step and the other static leaves bit for bit.
    Returns the count of differing assignments."""
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(jl) == sorted(tl)
    near = 0
    for k, x in jl.items():
        y = tl[k]
        if x is None:
            assert y is None, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k[-1] == "__lutq_a":
            w = np.asarray(jl[("trainable",) + k[1:-1]])
            d = np.asarray(jl[k[:-1] + ("__lutq_d",)])
            for i, di in _stack_slices(d):
                diff = x[i] != y[i]
                assert near_midpoint(w[i][diff], di).all(), (k, i)
                near += int(diff.sum())
        elif k[-1] == "__lutq_d":
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6,
                                       err_msg=str(k))
        elif k[0] == "trainable":
            np.testing.assert_allclose(y, x, rtol=0,
                                       atol=master_tol * np.abs(x).max(),
                                       err_msg=str(k))
        elif k[0] != "opt_state":
            np.testing.assert_array_equal(y, x, err_msg=str(k))
    return near


def jax_train_run(jcfg, jtree, batches, impl, lr):
    """The reference's jitted train step (AdamW + k-means at ``impl``)
    over numpy ``batches`` from ``jtree``: (numpy state_flat tree,
    [(loss, grad_norm)])."""
    from repro.models import api as japi
    from repro.optim import optimizers as jopt
    from repro.optim.train_state import init_train_state, make_train_step
    from repro.optim.train_state import state_flat

    opt = jopt.adamw(jopt.cosine_schedule(**lr))
    state = state_flat(init_train_state(jtree, opt))
    step = jax.jit(make_train_step(jcfg, japi.loss_fn, opt,
                                   kmeans_impl=impl))
    hist = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    out = to_np(state)
    jax.clear_caches()
    return out, hist


def port_train_run(tcfg, jtree, batches, impl, lr):
    """The port's train step over the same batches from
    ``interop.from_jax(jtree)``: (numpy state_flat tree, [(loss,
    grad_norm)], kmeans_stats counts {"launches", "plain"} of the run)."""
    from repro_torch import interop
    from repro_torch.kernels import kmeans_stats
    from repro_torch.models import api as tapi
    from repro_torch.optim import optimizers as topt
    from repro_torch.optim.train_state import (init_train_state,
                                               make_train_step)

    opt = topt.adamw(topt.cosine_schedule(**lr))
    state = init_train_state(interop.from_jax(to_np(jtree), tcfg), opt)
    step = make_train_step(tcfg, tapi.loss_fn, opt, kmeans_impl=impl)
    before = dict(kmeans_stats.COUNTS)
    hist = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.asarray(v))
                                for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    counts = {k: kmeans_stats.COUNTS[k] - before[k] for k in before}
    return interop.train_state_to_numpy(state), hist, counts


def assert_histories_match(thist, jhist, norm_rtol=1e-5):
    """[(loss, grad_norm)] of two runs: losses within 1e-5 relative,
    grad-norms within ``norm_rtol``."""
    t, j = np.array(thist), np.array(jhist)
    np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=1e-5)
    np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=norm_rtol)


#: the port's training CLI on a reduced config, as the handoff tests run it
HANDOFF_VOCAB, HANDOFF_STEPS = 64, 2


def train_cli_argv(arch, *flags):
    return ["--arch", arch, "--reduced", "--steps", str(HANDOFF_STEPS),
            "--batch", "2", "--seq", "8", "--vocab", str(HANDOFF_VOCAB),
            "--device", "cpu", *flags]


def train_in_memory(arch):
    """The port's training CLI's run (:func:`train_cli_argv`) in memory:
    ``launch/train.build`` and a ``TrainLoop`` over ``batch_fn``'s
    batches, no checkpoint. Returns (cfg, state)."""
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train as t_train_cli
    from repro_torch.models import api as tapi
    from repro_torch.runtime.loop import TrainLoop

    args = t_train_cli.parser().parse_args(train_cli_argv(arch))
    args.device = torch.device("cpu")
    cfg, state, step_fn = t_train_cli.build(args)
    make_batch = t_train_cli.batch_fn(MarkovLM(cfg.vocab,
                                               seed=args.data_seed),
                                      args, args.device, cfg)
    loop = TrainLoop(step_fn, make_batch, log_every=100,
                     log_fn=lambda m: None,
                     quant_policy=tapi.resolved_policy(cfg))
    state, _ = loop.run(state, args.steps, handle_signals=False)
    return cfg, state


def serve_cli_batch(cfg, batch=2, prompt_len=8, seed=0):
    """The prompt batch of ``launch/serve.py`` at these flags (its
    tokens, and an encdec config's frames)."""
    gen = torch.Generator().manual_seed(seed + 1)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                   generator=gen)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (batch, prompt_len, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 2)).to(cfg.dtype)
    return out


def port_checkpoint_handoff(arch, ckpt_dir, capsys):
    """The port's training CLI writes ``ckpt_dir``; its serve CLI's
    ``--ckpt-dir`` (the manifest's policy, int8 and packed4) prints the
    greedy tokens of the in-memory trained model's serve view, and
    ``restore_params -> from_train_params`` gives them on every row.
    Returns the training CLI's output."""
    from repro_torch import interop
    from repro_torch.checkpoint import ckpt as tckpt
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.launch import serve as t_serve_cli
    from repro_torch.launch import train as t_train_cli
    from repro_torch.models import api as tapi
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    capsys.readouterr()
    assert t_train_cli.main(train_cli_argv(arch, "--ckpt-dir", ckpt_dir)) == 0
    train_out = capsys.readouterr().out
    _, state = train_in_memory(arch)
    params, step = tckpt.restore_params(ckpt_dir)
    assert step == HANDOFF_STEPS
    policy = tckpt.load_policy(ckpt_dir)
    cfg = reduced(get_config(arch)).replace(vocab=HANDOFF_VOCAB, quant=policy,
                                            act_bits=8)
    t_serve_cli.check_ckpt_shapes(cfg, params["trainable"])
    pol = tapi.resolved_policy(cfg)
    batch = serve_cli_batch(cfg)
    for flags in ([], ["--pack4"]):
        pack4 = bool(flags)
        assert t_serve_cli.main(["--arch", arch, "--reduced", "--vocab",
                                 str(HANDOFF_VOCAB), "--batch", "2",
                                 "--prompt-len", "8", "--gen", "4",
                                 "--device", "cpu", "--ckpt-dir",
                                 ckpt_dir] + flags) == 0
        out = capsys.readouterr().out
        assert (f"restored train checkpoint step {HANDOFF_STEPS} from "
                f"{ckpt_dir} (policy from manifest)") in out
        with torch.no_grad():
            want = generate(serve_view(state.model, pack4=pack4, policy=pol),
                            cfg, batch, steps=4, device="cpu")
            restored = serve_view(interop.from_train_params(
                params, cfg, pack4=pack4, policy=pol, device="cpu"),
                pack4=pack4, policy=pol)
            got = generate(restored, cfg, batch, steps=4, device="cpu")
        assert f"sample: {want[0, :8].tolist()}" in out, (flags, out)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    return train_out
