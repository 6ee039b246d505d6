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
