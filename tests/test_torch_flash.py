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
from repro_torch.kernels.ref import flash_attention_exp2_ref
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


# ---------------------------------------------------------------------------
# the kernel plan (shapes only): which hand-written kernel a call launches
# ---------------------------------------------------------------------------

def _accepted(S, Skv, D, bq, bk):
    """The wrapper's (min(bq, S), min(bk, Skv)) for these shapes, or None
    where it raises (meta tensors: shapes only)."""
    q = torch.empty(1, S, D, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, Skv, D, device="meta", dtype=torch.bfloat16)
    try:
        return flash_attn._check_shapes(q, kv, kv, bq, bk)
    except ValueError:
        return None


def _plan_shapes():
    from test_torch_cuda import FLASH_CASES

    grid = [(S, Skv, D, bq, bk)
            for S in (16, 40, 48, 64, 96, 100, 128, 192, 256, 320, 384, 512)
            for Skv in (S, 2 * S, 48)
            for D in (16, 80, 128)
            for bq in (16, 32, 48, 64, 96, 128, 192, 256, 512)
            for bk in (16, 32, 48, 64, 96, 128)]
    cases = [(S, Skv, D, bq, bk) for _, S, Skv, D, bq, bk, _ in FLASH_CASES]
    geometries = [(512, 512, 80, 128, 128), (512, 512, 80, 256, 128),
                  (4096, 4096, 80, 128, 128)]
    return grid + cases + geometries


def test_plan_names_a_kernel_for_every_accepted_shape():
    """Every shape the wrapper accepts gets a kernel; flash_wgmma only
    where each 64-row warpgroup lies in one reference q block and its kv
    tile is compiled; flash_bf16's 16-row warps always do."""
    seen = set()
    for S, Skv, D, bq, bk in _plan_shapes():
        got = _accepted(S, Skv, D, bq, bk)
        if got is None:
            continue
        bq_eff, bk_eff = got
        assert flash_attn.plan(S, Skv, D, bq, bk, torch.float32) == "flash_f32"
        name = flash_attn.plan(S, Skv, D, bq, bk, torch.bfloat16)
        assert name in flash_attn.KERNEL_CODES and name != "flash_f32"
        seen.add(name)
        rows = flash_attn.WG_ROWS if name == "flash_wgmma" else 16
        for r0 in range(0, S, rows):
            blocks = {r // bq_eff for r in range(r0, min(r0 + rows, S))}
            assert len(blocks) == 1, (S, Skv, D, bq, bk, name, r0)
        if name == "flash_wgmma":
            assert bk_eff in flash_attn.WGMMA_BK
        elif bk_eff in flash_attn.WGMMA_BK:
            assert bq_eff % flash_attn.WG_ROWS and bq_eff != S
    assert seen == {"flash_wgmma", "flash_bf16"}


@pytest.mark.parametrize("S,Skv,D,bq,bk,want", [
    (512, 512, 80, 128, 128, "flash_wgmma"),    # danube's prefill geometry
    (4096, 4096, 80, 128, 128, "flash_wgmma"),  # the 4096-token row
    (512, 512, 80, 256, 128, "flash_wgmma"),    # its NaN check, bq = S / 2
    (40, 48, 16, 128, 16, "flash_wgmma"),       # bq = S < 64
    (100, 128, 80, 100, 64, "flash_wgmma"),     # bq = S, ragged
    (256, 256, 64, 64, 128, "flash_wgmma"),
    (256, 256, 64, 32, 128, "flash_bf16"),      # warpgroups span q blocks
    (384, 384, 32, 48, 128, "flash_bf16"),
    (384, 384, 80, 128, 96, "flash_bf16"),      # kv tile not compiled
    (384, 384, 80, 192, 128, "flash_wgmma"),    # three warpgroups a q block
])
def test_plan_picks(S, Skv, D, bq, bk, want):
    assert _accepted(S, Skv, D, bq, bk) is not None
    assert flash_attn.plan(S, Skv, D, bq, bk, torch.bfloat16) == want


@pytest.mark.parametrize("kernel,dtype,bk,match", [
    ("flash_mma", torch.bfloat16, 128, "no kernel"),
    ("flash_f32", torch.bfloat16, 128, "does not take"),
    ("flash_wgmma", torch.float32, 128, "does not take"),
    ("flash_wgmma", torch.bfloat16, 96, "bk in"),
    ("flash_wgmma", torch.bfloat16, 128, "expected the CUDA device"),
    ("flash_bf16", torch.bfloat16, 96, "expected the CUDA device"),
])
def test_launch_raises_on_what_the_named_kernel_does_not_take(kernel, dtype,
                                                              bk, match):
    """``launch`` never runs the plain version, and a CPU tensor is not
    the card's."""
    q = torch.zeros(2, 192, 32, dtype=dtype)
    before = dict(flash_attn.COUNTS)
    with pytest.raises(ValueError, match=match):
        flash_attn.launch(kernel, q, q, q, causal=True, scale=0.5, bk=bk)
    assert flash_attn.COUNTS == before


# ---------------------------------------------------------------------------
# flash_wgmma's base-2 softmax order (kernels.ref.flash_attention_exp2_ref)
# against the Pallas kernel: the bf16 bound of the card's checks
# ---------------------------------------------------------------------------

def _gqa_flat(B, S, Hkv, G, D, seed):
    """Danube's GQA layout at a reduced size: (B*Hkv*G, S, D) queries and
    each KV head repeated for its G query heads."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, Hkv * G, D).astype(np.float32)
    k = rng.randn(B, S, Hkv, D).astype(np.float32)
    v = rng.randn(B, S, Hkv, D).astype(np.float32)
    qf = q.reshape(B, S, Hkv, G, D).transpose(0, 2, 3, 1, 4).reshape(-1, S, D)
    kf = np.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, S, D)
    vf = np.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, S, D)
    return qf, kf, vf


@pytest.mark.parametrize("operands,kw", [
    (("mk", 3, 256, 64), dict(bq=128, bk=128)),
    (("mk", 3, 512, 128), dict(bq=128, bk=128, causal=False)),
    (("mk", 3, 256, 64), dict(bq=64, bk=128)),
    (("mk", 3, 384, 32), dict(bq=128, bk=128)),
    (("mk", 2, 128, 80), dict(bq=64, bk=32, causal=False)),
    (("gqa", 2, 256, 2, 4, 80), dict(bq=128, bk=128)),  # reduced danube
    (("gqa", 1, 512, 1, 4, 80), dict(bq=256, bk=128)),
], ids=["s256d64", "s512d128-full", "bq64", "s384d32", "d80-bk32-full",
        "danube-reduced", "danube-bq-half"])
def test_exp2_order_within_bf16_bound_of_jax_kernel(operands, kw):
    """The kernel's base-2 order (max over raw scores, the scale folded
    into the exponent's FMA) stays within one bf16 ulp of each row's max
    (2^-7, phase 2e's bound) of the Pallas kernel in interpret mode."""
    if operands[0] == "mk":
        q, k, v = _mk(*operands[1:], seed=5)
    else:
        q, k, v = _gqa_flat(*operands[1:], seed=6)
    want = flash_attention_tpu(*(jnp.asarray(t, jnp.bfloat16)
                                 for t in (q, k, v)), interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32))
    got = flash_attention_exp2_ref(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    err = np.abs(got - want).max(-1)
    assert (err <= BF16_TOL * np.abs(want).max(-1)).all()


def test_exp2_order_f32_close_to_the_plain_version():
    """In f32 the two orders differ only by the rounding of the exponent's
    argument: far inside the f32 bound of 1e-5."""
    q, k, v = (torch.from_numpy(t) for t in _mk(2, 256, 80, seed=7))
    for causal in (True, False):
        want = flash_attn.flash_attention(q, k, v, causal=causal, bq=64)
        got = flash_attention_exp2_ref(q, k, v, causal=causal, bq=64)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=F32_TOL)
