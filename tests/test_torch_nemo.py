"""Port parity, mistral-nemo-12b: its only need beyond danube is a head
dim (128) other than d_model / n_heads (160). Reduced mistral-nemo at
``head_dim=32`` (4 query heads of 32 over 1 KV head, a group of 4, so
``n_heads * head_dim`` = 128 is not d_model = 64; no window; 4-bit
LUT-Q) against the JAX package: greedy tokens through ``generate``, and
through the paged engine request by request. Tokens are compared
exactly; the engine runs at act_bits=32, where a request's rows do not
depend on the rest of its batch (dynamic 8-bit scales span the batch,
ROADMAP queue 3).
"""
import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (cfg_pair, jax_quantized, jax_reference,
                                one_thread, to_np, tokens)

from repro.core.policy import serve_view as j_serve_view
from repro.models import api as japi
from repro.runtime.engine import Engine as JEngine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.policy import serve_view as t_serve_view
from repro_torch.models import api as tapi
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.engine import Engine

ARCH = "mistral-nemo-12b"


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return cfg_pair(arch=ARCH, head_dim=32, remat=False, **kw)


@pytest.fixture(scope="module")
def jq():
    return jax_quantized(_cfgs()[0])


def test_full_width_config_is_the_reference():
    from repro.configs import get_config as jget

    cfg, ref = get_config(ARCH), jget(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "head_dim", "rope_theta", "window",
              "tie_embeddings", "act_bits"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.n_heads * cfg.resolved_head_dim != cfg.d_model
    assert tapi.paged_supported(cfg)


@pytest.mark.parametrize("pack4", [False, True])
def test_generate_tokens_identical(jq, pack4):
    jcfg, tcfg = _cfgs()
    assert tcfg.n_heads * tcfg.resolved_head_dim == 128 != tcfg.d_model
    js = j_serve_view(jq, pack4=pack4, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg), pack4=pack4,
                         policy=tapi.resolved_policy(tcfg))
    toks = tokens(jcfg, 2, 14, seed=2)
    _, want = jax_reference(jcfg, js, toks, 4)
    got = tserving.generate(model, tcfg, {"tokens": torch.from_numpy(toks)},
                            steps=4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_engine_matches_jax_engine(jq):
    """Ragged requests (more than the slots) on the paged path, page 8,
    int8 KV: each request's tokens equal the JAX paged engine's."""
    jcfg, tcfg = _cfgs(act_bits=32, kv_cache_bits=8)
    js = j_serve_view(jq, policy=japi.resolved_policy(jcfg))
    model = t_serve_view(interop.from_jax(to_np(jq), tcfg),
                         policy=tapi.resolved_policy(tcfg))
    kw = dict(capacity=2, max_len=32, kv_pages=16, page_size=8,
              prefill_pack=False)
    jeng = JEngine(js, jcfg.replace(kernel_backend="decode"), warmup=False,
                   **kw)
    eng = Engine(model, tcfg, device="cpu", **kw)
    assert eng.paged
    rng = np.random.RandomState(3)
    for n, g in ((9, 4), (17, 3), (5, 5), (12, 4)):
        p = rng.randint(0, tcfg.vocab, n).astype(np.int32)
        jeng.submit(p, max_new=g)
        eng.submit(p, max_new=g)
    for want, got in zip(jeng.run(), eng.run()):
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"request {got['rid']}")
    jax.clear_caches()
