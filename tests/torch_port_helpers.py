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


def cfg_pair(dtype: str = "float32", **kw):
    """(JAX config, port config) of reduced danube with the same fields,
    4-bit LUT-Q at MIN_SIZE unless ``quant_bits``/``constraint`` say
    otherwise. ``dtype`` names the working dtype of both sides."""
    from repro.configs import get_config as jget
    from repro.core.spec import QuantSpec as JSpec
    from repro.models.reduce import reduced as jred
    from repro_torch.configs import get_config as tget
    from repro_torch.core.spec import QuantSpec as TSpec
    from repro_torch.models.reduce import reduced as tred

    spec = dict(bits=kw.pop("quant_bits", 4),
                constraint=kw.pop("constraint", "none"), min_size=MIN_SIZE)
    jcfg = jred(jget(ARCH)).replace(quant=JSpec(**spec),
                                    dtype=getattr(jnp, dtype), **kw)
    tcfg = tred(tget(ARCH)).replace(quant=TSpec(**spec),
                                    dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def jax_quantized(jcfg, seed=0):
    """JAX init -> quantize of reduced danube (the slow step: share it)."""
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


def one_thread():
    """Keep each xdist worker's torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n
