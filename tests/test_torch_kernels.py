"""Port parity, kernels: ``lutq_dot`` under fused / packed4 / decode
against the JAX package, through the kernels' plain versions (CPU
tensors). The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, on a card.

Tolerances, each against the JAX output:
  * float32 x: rtol 1e-5 (atol 1e-5 of the output's scale): both sides
    accumulate in f32, in another order;
  * bfloat16 x: rtol 2e-2: both round the output to bf16 (one bf16 ulp
    is 2**-8 relative), and the JAX decode backend rounds its bf16
    product where the kernels accumulate in f32 first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import one_thread

from repro.core import lutq as jl
from repro.core.lutq import LutqState as JState
from repro.core.lutq import init_state as j_init_state
from repro.core.spec import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels.ref import pack4_kin as j_pack4_kin
from repro_torch.core import lutq as tl
from repro_torch.core.lutq import LutqState as TState
from repro_torch.kernels import build, lutq_gemv_packed, lutq_matmul, ops
from repro_torch.kernels.ref import pack4_kin

TOL = {"float32": dict(rtol=1e-5, scale=1e-5),
       "bfloat16": dict(rtol=2e-2, scale=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _serve_leaf(Kin, N, bits=4, seed=0):
    """A JAX serve-form leaf (w=None) quantized from a seeded numpy w."""
    w = np.random.RandomState(seed).randn(Kin, N).astype(np.float32)
    st = j_init_state(jnp.asarray(w), JSpec(bits=bits, min_size=1))
    return JState(w=None, d=st.d, a=st.a)


def _to_port(st):
    return TState(w=None, d=torch.from_numpy(np.array(st.d)),
                  a=torch.from_numpy(np.array(st.a)))


def _x(M, Kin, dtype, seed=1):
    x = np.random.RandomState(seed).randn(M, Kin).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"],
        atol=tol["scale"] * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 3, 17])
@pytest.mark.parametrize("backend", ["fused", "packed4", "decode"])
def test_lutq_dot_matches_reference(backend, M, dtype):
    Kin, N = 96, 211  # odd N on purpose
    st = _serve_leaf(Kin, N)
    if backend == "packed4":
        st = st._replace(a=j_pack4_kin(st.a))
    xj, xt = _x(M, Kin, dtype)
    want = jops.lutq_dot(xj, st, backend=backend)
    got = ops.lutq_dot(xt, _to_port(st), backend=backend)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    _close(got, want, dtype)


@pytest.mark.parametrize("backend", ["fused", "decode"])
def test_lutq_dot_transposed(backend):
    st = _serve_leaf(96, 211)
    xj, xt = _x(7, 211, "float32", seed=2)
    want = jops.lutq_dot(xj, st, backend=backend, transpose_rhs=True)
    got = ops.lutq_dot(xt, _to_port(st), backend=backend, transpose_rhs=True)
    _close(got, want, "float32")


def test_lutq_dot_k256_negative_int8_indices():
    """K=256 stores indices >= 128 as negative int8, which must read entry
    a + 256, as the reference's ``take`` (its decode backend) does. The
    reference's Pallas fused kernel decodes them to 0 instead (its
    one-hot never matches a negative index; ROADMAP queue 3), so the
    JAX decode backend is the oracle here."""
    st = _serve_leaf(64, 80, bits=8)
    a = np.asarray(st.a)
    assert (a < 0).any()
    xj, xt = _x(5, 64, "float32", seed=3)
    want = jops.lutq_dot(xj, st, backend="decode")
    got = ops.lutq_dot(xt, _to_port(st), backend="fused")
    _close(got, want, "float32")


def test_lutq_dot_leading_dims_and_out_dtype():
    st = _serve_leaf(64, 48)
    x = np.random.RandomState(4).randn(2, 5, 64).astype(np.float32)
    want = jops.lutq_dot(jnp.asarray(x), st, backend="fused",
                         out_dtype=jnp.bfloat16)
    got = ops.lutq_dot(torch.from_numpy(x), _to_port(st), backend="fused",
                       out_dtype=torch.bfloat16)
    assert got.shape == (2, 5, 48) and got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def test_resolve_backend_ladder():
    st = _to_port(_serve_leaf(64, 48))
    packed = st._replace(a=pack4_kin(st.a))
    assert ops.resolve_backend(st) == "fused"
    assert ops.resolve_backend(st, "packed4") == "fused"
    assert ops.resolve_backend(packed) == "packed4"
    assert ops.resolve_backend(packed, transpose_rhs=True) == "decode"
    assert ops.resolve_backend(st, "decode") == "decode"
    assert ops.resolve_backend(st._replace(w=torch.zeros(64, 48))) == "decode"
    # the pow2 rung (the reference's TestResolution): an int8 sign+exponent
    # plane takes the shift-add path, transposed use included; packed
    # assignments or K > 256 fall to decode; a pow2 request on a float
    # dictionary degrades to fused
    enc = st._replace(d=tl.pow2_encode(tl.pow2_round(st.d)))
    jenc = JState(w=None, d=jl.pow2_encode(jl.pow2_round(jnp.asarray(
        st.d.numpy()))), a=jnp.asarray(st.a.numpy()))
    for kw in ({}, {"backend": "pow2"}, {"transpose_rhs": True},
               {"backend": "decode"}):
        assert ops.resolve_backend(enc, **kw) == jops.resolve_backend(
            jenc, **kw)
    assert ops.resolve_backend(enc) == "pow2"
    assert ops.resolve_backend(enc, transpose_rhs=True) == "pow2"
    assert ops.resolve_backend(enc, "decode") == "decode"
    assert ops.resolve_backend(enc._replace(a=packed.a)) == "decode"
    assert ops.resolve_backend(st, "pow2") == "fused"


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    st = _to_port(_serve_leaf(64, 48))
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    before = (dict(lutq_matmul.COUNTS), dict(lutq_gemv_packed.COUNTS))
    lutq_matmul.lutq_matmul(x, st.a, st.d)
    lutq_gemv_packed.lutq_gemv_packed(x, pack4_kin(st.a), st.d)
    assert lutq_matmul.COUNTS["launches"] == before[0]["launches"]
    assert lutq_gemv_packed.COUNTS["launches"] == before[1]["launches"]
    assert lutq_matmul.COUNTS["plain"] == before[0]["plain"] + 1
    assert lutq_gemv_packed.COUNTS["plain"] == before[1]["plain"] + 1


def test_wrappers_check_shapes():
    st = _to_port(_serve_leaf(64, 48))
    with pytest.raises(ValueError, match="Kin"):
        lutq_matmul.lutq_matmul(torch.zeros(2, 63), st.a, st.d)
    with pytest.raises(ValueError, match="Kin"):
        lutq_gemv_packed.lutq_gemv_packed(torch.zeros(2, 64), st.a, st.d)
    with pytest.raises(TypeError, match="uint8"):
        lutq_gemv_packed.lutq_gemv_packed(torch.zeros(2, 128), st.a, st.d)


#: danube's (Kin, N) products: q/o, k/v, wi/wg, wo and the head
DANUBE_PRODUCTS = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
                   (2560, 32000)]


def _cover(extent, starts, width):
    """How many times each of ``extent`` positions is covered by the
    intervals [s, min(extent, s + width))."""
    n = np.zeros(extent, dtype=np.int64)
    for s in starts:
        n[s:min(extent, s + width)] += 1
    return n


@pytest.mark.parametrize("M,N,Kin,sms", [(4, 2560, 2560, 132),
                                         (4, 32000, 2560, 132),
                                         (512, 640, 2560, 132),
                                         (3, 211, 96, 132),
                                         (1, 8, 6912, 132)]
                         + [(M, N, Kin, 132) for M in (1, 4, 8, 130, 256, 512)
                            for Kin, N in DANUBE_PRODUCTS]
                         + [(17, 257, 2002, 132), (129, 130, 130, 132),
                            (64, 640, 64, 132), (16, 32000, 6912, 114)])
def test_plan_splits_covers_the_reduction(M, N, Kin, sms):
    """Every output tile and every reduction row is covered exactly once,
    the split count is one the ticket merge takes, the tile is the one
    GEMM_TILES gives M, and the plan is a function of shapes only."""
    plan = build.plan_splits(M, N, Kin, sms)
    bm, bn, splits, kchunk = (plan["bm"], plan["bn"], plan["splits"],
                              plan["kchunk"])
    grid_m, grid_n, grid_z = plan["grid"]
    top, want_bm, want_bn, per_sm, most = next(
        t for t in build.GEMM_TILES if t[0] is None or M <= t[0])
    assert grid_z == splits and 1 <= splits <= most
    assert kchunk % build.BK == 0
    assert (splits - 1) * kchunk < Kin <= splits * kchunk
    assert (_cover(M, range(0, grid_m * bm, bm), bm) == 1).all()
    assert (_cover(N, range(0, grid_n * bn, bn), bn) == 1).all()
    assert (_cover(Kin, range(0, splits * kchunk, kchunk), kchunk) == 1).all()
    assert (bm, bn) == (want_bm, want_bn)
    # decode tiles for M <= 16, prefill tiles above
    assert (bm <= 16) == (M <= 16)
    tiles = grid_m * grid_n
    if M <= build.GEMM_STABLE_M:
        # the row-stable tiles split as an 8-row decode does
        want = build.plan_splits(8, N, Kin, sms)
        assert (splits, kchunk) == (want["splits"], want["kchunk"])
    elif splits > 1:
        # split only while the tiles leave SMs idle, and never below one
        # pipeline step a split
        assert tiles * splits <= per_sm * sms
        assert tiles < per_sm * sms
    assert build.plan_splits(M, N, Kin, sms) == plan


@pytest.mark.parametrize("M,N,Kin", [(4, 2560, 2560), (8, 640, 2560),
                                     (512, 2560, 6912), (512, 32000, 2560),
                                     (3, 211, 96)])
def test_gemm_workspace_matches_the_grid(M, N, Kin):
    """The wrapper's partial buffer holds splits x M x N f32 and its
    tickets one int32 a tile, zero; none without a split."""
    plan = build.plan_splits(M, N, Kin, 132)
    part, ticket = build.gemm_workspace(plan, torch.device("cpu"))
    grid_m, grid_n, splits = plan["grid"]
    if splits == 1:
        assert part is None and ticket is None
        assert plan["partials"] == plan["tickets"] == 0
        return
    assert part.dtype == torch.float32 and part.numel() == splits * M * N
    assert plan["partials"] == part.numel()
    assert plan["tickets"] == grid_m * grid_n
    assert ticket.dtype == torch.int32
    assert ticket.numel() >= grid_m * grid_n and not ticket.any()
