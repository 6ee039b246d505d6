"""Port parity, kernel 5: ``repro_torch.kernels.flash_attn.flash_attention``
on the CPU (its plain version, ``kernels.ref.flash_attention_ref``)
against the JAX package's Pallas ``flash_attention_tpu`` in interpret
mode, on the same numpy inputs. Mirrors tests/test_flash_kernel.py.

Tolerances: float32 at most 1e-5 absolute (unit-normal inputs, f32 sums
in another order); bfloat16 at most 2^-7 of each query row's max|ref|
(one bf16 ulp of the row: both sides round an f32 result to bf16).
The kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_thread

from repro.kernels.flash_attn import flash_attention_tpu
from repro.nn.attention import dense_attention
from repro_torch.kernels import flash_attn
from repro_torch.nn.attention import flash_attention as prefill_attention

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _mk(BH, S, D, seed=0, Skv=None):
    rng = np.random.RandomState(seed)
    Skv = S if Skv is None else Skv
    return (rng.randn(BH, S, D).astype(np.float32),
            rng.randn(BH, Skv, D).astype(np.float32),
            rng.randn(BH, Skv, D).astype(np.float32))


def _both(q, k, v, dtype="float32", **kw):
    """(JAX kernel in interpret mode, port) on the same numpy inputs, as
    float32 numpy."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = flash_attention_tpu(*(jnp.asarray(t, jd) for t in (q, k, v)),
                               interpret=True, **kw)
    got = flash_attn.flash_attention(
        *(torch.from_numpy(t).to(td) for t in (q, k, v)), **kw)
    assert got.dtype == td and tuple(got.shape) == q.shape
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("S,D,bq,bk", [(256, 64, 128, 128),
                                       (512, 128, 128, 128),
                                       (256, 64, 64, 128),
                                       (384, 32, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel(S, D, bq, bk, causal):
    want, got = _both(*_mk(3, S, D), causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_bf16():
    want, got = _both(*_mk(2, 256, 64, seed=1), dtype="bfloat16")
    err = np.abs(got - want).max(-1)
    assert (err <= BF16_TOL * np.abs(want).max(-1)).all()


def test_skv_longer_than_s_has_no_causal_offset():
    """Row r sees kv rows <= r whatever Skv is, as the reference's."""
    want, got = _both(*_mk(2, 128, 32, seed=2, Skv=256), bq=64, bk=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_causal_blocks_skipped():
    """NaN in the kv blocks strictly above the first q block's diagonal:
    neither side reads them, so rows [0, b) stay finite, and the port's
    keep the bits of a clean run."""
    S, D, b = 256, 32, 128
    q, k, v = _mk(1, S, D, seed=7)
    kp, vp = k.copy(), v.copy()
    kp[:, b:], vp[:, b:] = np.nan, np.nan
    want, got = _both(q, kp, vp, causal=True, bq=b, bk=b)
    assert np.isfinite(want[:, :b]).all() and np.isfinite(got[:, :b]).all()
    np.testing.assert_allclose(got[:, :b], want[:, :b], rtol=0, atol=F32_TOL)
    clean = flash_attn.flash_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), bq=b, bk=b)
    np.testing.assert_array_equal(got[:, :b], clean[:, :b].numpy())


def test_gqa_grouped_layout():
    """G query-head blocks against each repeated KV head: the port equals
    the JAX kernel and GQA dense attention."""
    B, S, Hkv, G, D = 2, 256, 2, 2, 32
    rng = np.random.RandomState(3)
    q = rng.randn(B, S, Hkv * G, D).astype(np.float32)
    k = rng.randn(B, S, Hkv, D).astype(np.float32)
    v = rng.randn(B, S, Hkv, D).astype(np.float32)
    dense = np.asarray(dense_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True))
    qf = q.reshape(B, S, Hkv, G, D).transpose(0, 2, 3, 1, 4).reshape(-1, S, D)
    kf = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, S, D)
    vf = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, S, D)
    want, got = _both(qf, kf, vf, causal=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    got = got.reshape(B, Hkv, G, S, D).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.reshape(B, S, -1, D), dense, rtol=2e-4,
                               atol=2e-4)


def test_equals_prefill_attention_f32():
    """In the GQA layout the kernel's function is the port's prefill
    attention (window wider than S) up to f32 rounding."""
    B, S, Hkv, G, D = 2, 128, 2, 2, 16
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(B, S, Hkv * G, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, Hkv, D).astype(np.float32))
    qf = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(-1, S, D)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(-1, S, D)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(-1, S, D)
    got = flash_attn.flash_attention(qf.contiguous(), kf.contiguous(),
                                     vf.contiguous(), bq=64, bk=32)
    got = got.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4)
    want = prefill_attention(q, k, v, window=4096, q_block=64, kv_block=32)
    np.testing.assert_allclose(got.reshape(B, S, -1, D).numpy(),
                               want.numpy(), rtol=0, atol=F32_TOL)


def test_cpu_runs_the_plain_version():
    before = dict(flash_attn.COUNTS)
    flash_attn.flash_attention(*(torch.from_numpy(t)
                                 for t in _mk(1, 64, 16)))
    assert flash_attn.COUNTS["plain"] == before["plain"] + 1
    assert flash_attn.COUNTS["launches"] == before["launches"]


@pytest.mark.parametrize("case,match", [
    (dict(S=192, bq=128), "multiple of bq"),
    (dict(Skv=96, bk=64), "multiple of bq=.* of bk"),
    (dict(D=8), "head dim"),
    (dict(D=72), "head dim"),
    (dict(D=144), "head dim"),
    (dict(bk=256, S=512), "kv block"),
    (dict(bk=24, S=48), "kv block"),
    (dict(bq=40, S=80), "q block"),
    (dict(k_dtype=torch.bfloat16), "share a float32 or bfloat16"),
    (dict(dtype=torch.float16), "share a float32 or bfloat16"),
    (dict(k_heads=3), "k and v must be"),
])
def test_raises_on_what_the_kernel_does_not_take(case, match):
    BH, D = 2, case.get("D", 32)
    S = case.get("S", 128)
    Skv = case.get("Skv", S)
    dtype = case.get("dtype", torch.float32)
    q = torch.zeros(BH, S, D, dtype=dtype)
    k = torch.zeros(case.get("k_heads", BH), Skv, D,
                    dtype=case.get("k_dtype", dtype))
    v = torch.zeros(BH, Skv, D, dtype=dtype)
    plain = flash_attn.COUNTS["plain"]
    with pytest.raises(ValueError, match=match):
        flash_attn.flash_attention(q, k, v, bq=case.get("bq", 128),
                                   bk=case.get("bk", 128))
    assert flash_attn.COUNTS["plain"] == plain
