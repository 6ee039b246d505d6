"""Port parity, the serving slice: prefill and decode logits of reduced
danube (2 layers, d_model 64, 1 KV head, window 24, vocab 211), every
leaf 4-bit LUT-Q, against the JAX package on the same converted tree.

The prompt (30) is longer than the window (24), so the SWA ring wraps
at adaptation and again while decoding. Decode steps feed both sides the
JAX tokens, so a logit compared at step t sees the same history on both.

Each case runs in the full-width model's working dtype (bfloat16) and
in float32. The JAX side is compiled with excess precision off, so each
of its bf16 ops rounds to bf16 as the port's eager ops do.

Tolerance, float32: |port - jax| <= 1e-4 * max|jax logits|. Both run
the same op order; what differs is the summation order of the matmuls
and reductions (~1e-6 relative observed). With 8-bit activations a
value within an ulp of a rounding boundary may land in the neighbouring
level, which moves a logit by far less than the bound.

Tolerance, bfloat16: |port - jax| <= 2^-9 * max|jax logits|, half a
bf16 ulp of the largest logit (the two sides agree bit for bit today).
Rounding one op at another point than the reference does (say silu
rounded once instead of after each of its steps, rmsnorm or rope in
bf16 instead of float32, fake-quant in float32, the decoded weight not
rounded to bf16) flips bf16 roundings that two layers amplify to
several ulps of the largest logit, and fails it.
"""
import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_quantized, jax_reference,
                                one_thread, port_teacher_forced, to_np,
                                tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro_torch import interop
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.models import api as tapi

B, P, STEPS = 2, 30, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(cfg_pair()[0])


RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -9}


@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("kv_cache_bits", [16, 8])
@pytest.mark.parametrize("act_bits", [32, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits(jq, dtype, act_bits, kv_cache_bits, pack4):
    jcfg, tcfg = cfg_pair(dtype, act_bits=act_bits,
                          kv_cache_bits=kv_cache_bits)
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, B, P)
    want, ref_tokens = jax_reference(jcfg, js, toks, STEPS)
    with torch.inference_mode():
        got = port_teacher_forced(tcfg, model, toks, ref_tokens)
    for t, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL[dtype] * scale,
                                   err_msg=f"step {t}")
    jax.clear_caches()
