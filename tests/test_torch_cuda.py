"""The CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: skipped (from a fixture) where there is no card. This
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src:tests python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance of the GEMMs, relative to the output's scale: 1e-4 for f32 x
(f32 accumulation in another order), 1e-3 for bf16 x (tensor-core bf16
products accumulated in f32). ``kmeans_stats``: assignments equal byte
for byte and counts exactly equal; each entry's sum within 1e-5 of the
sum of |w| over that entry (f32 accumulation in another order); a second
call and CUDA-graph replays give the same bits.
Paged attention, relative to max|plain|: 1e-5 for f32 queries (f32
sums in another order), 2^-7 for bf16 queries (one bf16 ulp of the
largest output: the output rounds to bf16, and a bf16 score may round
the other way where the two f32 sums differ in their last bits).
``lutq_shift``: equal to its plain version bit for bit (int32 sums), and
the pow2 path's logits equal those of its integer decode oracle.
Flash attention, per (row, query) over that query row's max|plain|:
1e-5 for f32 (f32 sums in another order), 2^-7 for bf16 (one bf16 ulp
of the row: the output rounds to bf16 after f32 sums in another order).
The activation and KV quantizers, the optimizer's divides and a whole
AdamW step equal the CPU's bit for bit (the card divides where the
reference divides; the optimizer's roots are taken in float64 and
rounded once). Paged attention also gives the same bits on a second
call, with dead block entries on a page of NaN, and in a CUDA graph.
The vision family: ``conv_apply`` within 1e-4 of max|CPU| in both passes
(f32 sums in another order, TF32 off inside the call); the ML-BN
shift-add fold equal to the multiply form bit for bit; the fc's three
kernels at (M, 64) @ (64, 8) as above; one CIFAR-table train step
within 1e-2 (loss, 8-bit activations) and 2 lr (parameters) of the CPU's.
The multiply audit (``kernels/audit.py``) is held by counts and shapes,
with no tolerance: one int dot a ``lutq_shift`` launch, and refusals of
the float-dictionary kernels, the card's float64 decode oracle and a
replayed CUDA graph. The expert-stacked kernels (the MoE family): one
launch a stacked product, the GEMMs' tolerances against the plain
version (a loop over the experts), ``lutq_shift`` bit for bit, an empty
expert exactly 0, each expert's slab bit for bit against a one-expert
launch where the two plans split alike; reduced qwen3-moe served on the
card gives the CPU's greedy tokens. deepseek-v2-lite: kernels 1, 2 and
4 at its leaf shapes (dkv's N = 576, uk's Kin = 512) with the tolerances
above; the MLA decode step replayed from a CUDA graph equals the eager
step bit for bit (logits and latent cache); reduced deepseek on the card
gives the CPU's greedy tokens. seamless-m4t-medium: kernels 6 and 7 at
G = 1, dh 64 (bf16 q over bf16 pages) with the paged tolerances above,
two calls, NaN dead pages and a graph replay giving the same bits; the
encdec paged decode step replayed from a CUDA graph equals the eager
step bit for bit, and the paged engine (plain and speculative, graph
and eager) gives lone generates' tokens; reduced seamless on the card
gives the CPU's greedy tokens in each view. paligemma-3b:
``kmeans_stats`` over its 526.8 M-weight tied table (2.107 GB of f32,
byte offsets past 2^31) with the tolerances above; kernel 1 and
``lutq_shift`` on its transposed head (N = 257216); a vlm decode step
(the cache's length counting the prefix) replayed from a CUDA graph
equal to the eager step bit for bit; reduced paligemma on the card
gives the CPU's greedy tokens after its image prefix. zamba2-2.7b:
kernels 1, 2 and 4 at its product shapes (in_proj's N = 10448, not a
multiple of the 64-wide n tile; out_proj; the shared MLP) with the
tolerances above; the hybrid decode step, which overwrites its SSM
state and conv window in place, replayed from a CUDA graph three times
equals three eager steps bit for bit (logits, every state and K/V), each
replay advancing the state; reduced zamba on the card (graph-replayed
and eager) gives the CPU's greedy tokens in each view. rwkv6-1.6b:
kernels 1 and 2 on f32 x (1e-4) and ``lutq_shift`` (bit for bit) at its
product shapes (w1's N = 64, w2's Kin = 64, cm_k, cm_v); the ssm decode
step, which overwrites its WKV state and token-shift rows in place,
replayed from a CUDA graph three times equals three eager steps bit for
bit, each replay advancing the state, while the same step from a zeroed
state lands 1.25 x 1e-3 a layer of max |logit| away or more; reduced
rwkv on the card (graph-replayed and eager) gives the CPU's greedy
tokens in each view. Training of the encdec, hybrid and ssm families:
one step of each reduced config on the card equals the CPU's (the loss
within 1e-4 relative, dictionaries within 1e-5), every k-means pass a
``kmeans_stats`` launch.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core.actquant import fake_quant
from repro_torch.kernels import (build, flash_attn, kmeans_stats,
                                 lutq_gemv_packed, lutq_matmul, lutq_shift,
                                 paged_attn)
from repro_torch.kernels.ref import (flash_attention_ref, kmeans_stats_ref,
                                     lutq_gemv_packed_ref, lutq_matmul_ref,
                                     lutq_shift_ref, pack4_kin,
                                     paged_attention_ref, pow2_shift_weights)
from repro_torch.models.lm import _kv_quant
from repro_torch.device import scalar_like


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested against JAX "
                    "in tests/test_torch_kernels.py)")
    return torch.device("cuda")


#: (M, Kin, N, offset): decode (M <= 16: 8 x 256 and 16 x 256 tiles,
#: the reduction split) and prefill (64 x 128 and 128 x 256 tiles) at
#: each tile's edges, generate's M = 4 and 512 and the engine's M = 8 and
#: 256 at danube's k/v width, ragged N (unaligned assignment rows), a
#: ragged Kin (unaligned x rows) and assignments at an odd byte offset
CUDA_CASES = [(1, 96, 211, 0), (3, 2560, 640, 0), (17, 64, 130, 0),
              (96, 128, 257, 0), (4, 2560, 640, 0), (8, 2560, 640, 0),
              (9, 256, 384, 0), (16, 192, 256, 0), (64, 128, 256, 0),
              (65, 320, 136, 0), (128, 256, 128, 0), (129, 130, 130, 0),
              (130, 2002, 211, 0), (256, 2560, 640, 0), (512, 640, 384, 0),
              (4, 256, 640, 1), (129, 256, 640, 3)]


def _gemm_operands(kernel, M, Kin, N, dtype, device, offset=0, K=16,
                   seed=0):
    """x, the assignments on ``device`` (``offset`` bytes into a buffer)
    and d, with the matching wrapper and plain version."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, Kin, generator=g).to(dtype)
    a = torch.randint(0, K, (Kin, N), generator=g, dtype=torch.int8)
    d = torch.sort(torch.randn(K, generator=g)).values
    if kernel == "lutq_matmul":
        fn, plain, idx = lutq_matmul.lutq_matmul, lutq_matmul_ref, a
    else:
        fn, plain, idx = (lutq_gemv_packed.lutq_gemv_packed,
                          lutq_gemv_packed_ref, pack4_kin(a))
    buf = torch.zeros(idx.numel() + offset, dtype=idx.dtype, device=device)
    idx_card = buf[offset:].view(idx.shape)
    idx_card.copy_(idx)
    return fn, plain, (x, idx, d), (x.to(device), idx_card, d.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,Kin,N,offset", CUDA_CASES)
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_kernel_matches_plain(cuda_device, kernel, M, Kin, N, offset,
                                   dtype):
    fn, plain, cpu_args, card_args = _gemm_operands(
        kernel, M, Kin, N, getattr(torch, dtype), cuda_device, offset)
    assert card_args[1].data_ptr() % 16 == offset
    want = plain(*cpu_args)
    counts = (lutq_matmul.COUNTS if kernel == "lutq_matmul"
              else lutq_gemv_packed.COUNTS)
    before = dict(counts)
    got = fn(*card_args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 1e-3
    err = (got.cpu() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    assert counts["launches"] == before["launches"] + 1
    assert counts["plain"] == before["plain"]


#: (M, Kin, N): decode and prefill shapes whose plans split the reduction
GEMM_REPEAT_CASES = [(4, 2560, 2560), (8, 2560, 640), (512, 2560, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", GEMM_REPEAT_CASES)
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_gemm_is_deterministic(cuda_device, kernel, M, Kin, N):
    """Two calls give the same bits: the splits are merged in a fixed
    order by an integer ticket, with no float atomics."""
    assert build.plan_splits(M, N, Kin,
                             build.sm_count(cuda_device))["splits"] > 1
    fn, _, _, args = _gemm_operands(kernel, M, Kin, N, torch.bfloat16,
                                    cuda_device)
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not build._GEMM_TICKETS[str(args[0].device)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", GEMM_REPEAT_CASES)
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_gemm_replays_in_a_cuda_graph(cuda_device, kernel, M, Kin, N):
    """One call captured in a CUDA graph and replayed twice equals the
    eager call, and the merge tickets are left at zero for the next
    replay."""
    fn, _, _, args = _gemm_operands(kernel, M, Kin, N, torch.bfloat16,
                                    cuda_device, seed=1)
    eager = fn(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert not build._GEMM_TICKETS[str(args[0].device)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_gemm_raises_instead_of_falling_back(cuda_device, kernel,
                                                  monkeypatch):
    fn, _, _, (x, a, d) = _gemm_operands(kernel, 4, 256, 640,
                                         torch.bfloat16, cuda_device)
    counts = (lutq_matmul.COUNTS if kernel == "lutq_matmul"
              else lutq_gemv_packed.COUNTS)
    before = dict(counts)
    launcher = f"{kernel}_launch"

    class FailedLaunch:
        pass

    setattr(FailedLaunch, launcher, staticmethod(lambda *args: 1))

    def failed_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        fn(x, a, d)
    monkeypatch.setattr(build, "load_library", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(x, a, d)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fn(x, a.cpu(), d)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.t().contiguous().t(), a, d)
    assert counts == before


@pytest.mark.cuda
def test_cuda_fused_k256_reads_unsigned_bytes(cuda_device):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 256, generator=g)
    a = torch.randint(-128, 128, (256, 96), generator=g, dtype=torch.int8)
    d = torch.sort(torch.randn(256, generator=g)).values
    want = lutq_matmul_ref(x, a, d)
    got = lutq_matmul.lutq_matmul(x.to(cuda_device), a.to(cuda_device),
                                  d.to(cuda_device))
    torch.cuda.synchronize()
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max()


def _shift_operands(M, Kin, N, K, g, span=9, extreme=False):
    """xq, a and wsh of a pow2 dictionary of K codes with nonzero
    magnitudes 1..span+1, a zero code and both signs. ``extreme``: every
    xq at ±127 with the sign of its row's weights, the largest |acc| the
    guard allows."""
    code = torch.randint(1, span + 2, (K,), generator=g, dtype=torch.int32)
    code[0], code[-1] = 1, span + 1
    code = code * (torch.randint(0, 2, (K,), generator=g) * 2 - 1)
    if K > 2:
        code[1] = 0
    wsh = pow2_shift_weights(code.to(torch.int8))
    a = torch.randint(-128, 128, (Kin, N), generator=g, dtype=torch.int8)
    if K < 256:
        a = (a.view(torch.uint8) % K).view(torch.int8)
    if extreme:
        a = torch.full((Kin, N), K - 1, dtype=torch.uint8).view(torch.int8)
        xq = torch.where(wsh[K - 1] > 0, 127, -127) * torch.ones(
            (M, Kin), dtype=torch.int32)
        return xq.to(torch.int8), a, wsh
    xq = torch.randint(-127, 128, (M, Kin), generator=g, dtype=torch.int8)
    return xq, a, wsh


#: (M, Kin, N, K, offset): decode and prefill shapes, ragged N, M and
#: Kin, unaligned assignment rows (byte loads), K = 2, 16 and 256 (indices
#: >= 128 stored as negative int8); the tile edges M = 8 | 9, 16 | 17,
#: the engine's 8-slot step and 256-row chunk, and K = 16 and 256 at
#: generate's prefill M
SHIFT_CASES = [(1, 96, 211, 16, 0), (4, 2560, 640, 16, 0),
               (3, 2000, 700, 2, 0), (8, 64, 130, 256, 0),
               (4, 130, 96, 16, 1), (9, 128, 257, 16, 0),
               (130, 300, 97, 256, 0), (64, 512, 640, 16, 3),
               (8, 2560, 640, 16, 0), (9, 2560, 640, 16, 0),
               (16, 2560, 640, 16, 0), (17, 2560, 640, 16, 0),
               (64, 2560, 640, 16, 0), (256, 2560, 640, 16, 0),
               (512, 2560, 640, 16, 0), (512, 2560, 640, 256, 0),
               (17, 200, 33, 256, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N,K,offset", SHIFT_CASES)
def test_cuda_lutq_shift_matches_plain_bit_exact(cuda_device, M, Kin, N, K,
                                                 offset):
    g = torch.Generator().manual_seed(M * 7 + K)
    xq, a, wsh = _shift_operands(M, Kin, N, K, g)
    want = lutq_shift_ref(xq, a, wsh)
    # a at ``offset`` bytes into a buffer on the card: its rows are
    # unaligned unless offset and N allow wider loads
    buf = torch.zeros(Kin * N + offset, dtype=torch.int8, device=cuda_device)
    a_card = buf[offset:].view(Kin, N)
    a_card.copy_(a)
    assert a_card.data_ptr() % 4 == offset % 4
    before = dict(lutq_shift.COUNTS)
    got = lutq_shift.lutq_shift(xq.to(cuda_device), a_card,
                                wsh.to(cuda_device))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert lutq_shift.COUNTS["launches"] == before["launches"] + 1
    assert lutq_shift.COUNTS["plain"] == before["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", [(4, 2560, 640), (4, 6912, 256),
                                     (96, 2560, 128)])
def test_cuda_lutq_shift_at_the_guard_limit(cuda_device, M, Kin, N):
    """7 + span + ceil(log2 Kin) = 31 and every term at its largest: the
    int32 sums reach ~2^31 - 2^24 without overflowing."""
    import math

    span = 31 - 7 - math.ceil(math.log2(Kin))
    xq, a, wsh = _shift_operands(M, Kin, N, 16, torch.Generator(), span=span,
                                 extreme=True)
    want = lutq_shift_ref(xq, a, wsh)
    assert want.abs().min() == 127 * 2 ** span * Kin > 2 ** 30
    got = lutq_shift.lutq_shift(xq.to(cuda_device), a.to(cuda_device),
                                wsh.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


#: (span, Kin, K): dictionaries that take 2, 3 and 4 digit planes of base
#: 2^7 (span // 7 + 1), each at the guard's limit 7 + span + ceil(log2
#: Kin) = 31 (small Kin for the wide spans)
SHIFT_PLANE_CASES = [(12, 2560, 16), (11, 6912, 256), (17, 128, 16),
                     (14, 1024, 256), (20, 16, 16), (21, 8, 256), (23, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("M", [4, 130])
@pytest.mark.parametrize("span,Kin,K", SHIFT_PLANE_CASES)
def test_cuda_lutq_shift_digit_planes(cuda_device, span, Kin, K, M, extreme):
    """Wide dictionaries run as several s8 digit planes combined by
    Horner: the plain version's bits, random and with every term at its
    largest."""
    from repro_torch.kernels.ref import shift_planes

    g = torch.Generator().manual_seed(span * 31 + M)
    xq, a, wsh = _shift_operands(M, Kin, 96, K, g, span=span,
                                 extreme=extreme)
    assert shift_planes(wsh) == span // 7 + 1 >= 2
    want = lutq_shift_ref(xq, a, wsh)
    got = lutq_shift.lutq_shift(xq.to(cuda_device), a.to(cuda_device),
                                wsh.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if extreme:
        assert int(want.abs().min()) == 127 * 2 ** span * Kin


#: (M, Kin, N): decode and prefill shapes that split the reduction, and
#: one that does not
SHIFT_REPEAT_CASES = [(4, 2560, 2560), (8, 2560, 640), (512, 2560, 640),
                      (512, 2560, 6912)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", SHIFT_REPEAT_CASES)
def test_cuda_lutq_shift_repeats_and_replays(cuda_device, M, Kin, N):
    """A second call and two replays of one call captured in a CUDA graph
    give the first call's bits, each call one launch, and the merge
    tickets are back at zero."""
    from repro_torch.kernels.ref import shift_planes

    plan = lutq_shift.plan_splits(M, N, Kin, build.sm_count(cuda_device))
    assert (plan["splits"] > 1) == (N != 6912)
    xq, a, wsh = (t.to(cuda_device) for t in _shift_operands(
        M, Kin, N, 16, torch.Generator().manual_seed(M)))
    planes = shift_planes(wsh)  # derived before the capture: a host read
    launches = lutq_shift.COUNTS["launches"]
    first, second = (lutq_shift.lutq_shift(xq, a, wsh) for _ in range(2))
    assert lutq_shift.COUNTS["launches"] == launches + 2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        lutq_shift.lutq_shift(xq, a, wsh, planes)  # warm-up on that stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = lutq_shift.lutq_shift(xq, a, wsh, planes)
    assert torch.equal(first, second)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    tickets = build._GEMM_TICKETS.get(str(xq.device))
    assert tickets is None or not tickets.any()


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", [(4, 2560, 2560), (512, 2560, 640)])
def test_cuda_lutq_shift_one_launch_no_memset(cuda_device, M, Kin, N):
    """A split call is one kernel on the stream: the profiler lists the
    kernel once a call and no memset."""
    from torch.profiler import ProfilerActivity, profile

    xq, a, wsh = (t.to(cuda_device) for t in _shift_operands(
        M, Kin, N, 16, torch.Generator().manual_seed(1), span=5))
    want = lutq_shift.lutq_shift(xq, a, wsh, 1)  # tickets made before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = [lutq_shift.lutq_shift(xq, a, wsh, 1) for _ in range(3)]
        torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in got)
    assert torch.equal(want.cpu(), lutq_shift_ref(xq.cpu(), a.cpu(),
                                                  wsh.cpu()))
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {e.key: e.count for e in prof.key_averages()}
    assert not [n for n in names if "emset" in n], names
    shift = [n for n in names if "lutq_shift" in n]
    assert len(shift) == 1 and counts[shift[0]] == 3, names


@pytest.mark.cuda
def test_cuda_lutq_shift_raises_instead_of_falling_back(cuda_device,
                                                        monkeypatch):
    xq, a, wsh = _shift_operands(4, 64, 96, 16, torch.Generator())
    xq, a, wsh = xq.to(cuda_device), a.to(cuda_device), wsh.to(cuda_device)
    plain = lutq_shift.COUNTS["plain"]

    class FailedLaunch:
        @staticmethod
        def lutq_shift_launch(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        lutq_shift.lutq_shift(xq, a, wsh)
    with pytest.raises(ValueError, match="xq's CUDA device"):
        lutq_shift.lutq_shift(xq, a.cpu(), wsh)
    assert lutq_shift.COUNTS["plain"] == plain


@pytest.mark.cuda
@pytest.mark.parametrize("calibrated", [True, False])
def test_cuda_pow2_serving_oracle_equals_kernel(cuda_device, calibrated):
    """Reduced danube under serving_pow2 on the card, with scales frozen
    by calibration or taken per call: prefill logits through the
    shift-add kernel equal the integer decode oracle's bit for bit, and
    the greedy tokens are equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=serving_pow2(), act_bits=8)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(3))
    model = api.serve_state(cfg, seed=0, device="cuda", calib_batch={
        "tokens": toks.cuda()} if calibrated else None)
    out = {}
    for be in ("decode", "auto"):
        run = cfg.replace(kernel_backend=be)
        launches = lutq_shift.COUNTS["launches"]
        with torch.inference_mode():
            logits, _ = api.prefill(model, run, {"tokens": toks.cuda()})
        out[be] = (logits, generate(model, run, {"tokens": toks}, steps=6,
                                    device="cuda"))
        assert (lutq_shift.COUNTS["launches"] > launches) == (be == "auto")
    assert torch.equal(out["decode"][0], out["auto"][0])
    assert torch.equal(out["decode"][1], out["auto"][1])


def _kmeans_case(N, K, ties, g):
    w = torch.randn(N, generator=g) * 0.05
    if ties:  # a dictionary whose midpoints are exactly weights
        d = torch.arange(K, dtype=torch.float32) - (K - 1) / 2.0
        w = (torch.randint(0, 2 * K, (N,), generator=g) - K) * 0.5
        w[: K - 1] = (d[:-1] + d[1:]) * 0.5
    else:
        d = torch.sort(torch.randn(K, generator=g) * 0.05).values
    return w, d


#: danube's quantized leaf sizes (q/o, k/v, wi/wg and wo, embed/head)
TRAIN_LEAF_SIZES = [2560 * 2560, 2560 * 640, 2560 * 6912, 32000 * 2560]
#: (N, K, ties, offset): leaf shapes, K = 256 (indices >= 128), a ragged
#: N, midpoints that are weights, N below one vector with K = 1, 2 and 17,
#: and w at element offsets 1-3 into a larger buffer (a misaligned head)
KMEANS_CASES = ([(2560 * 6912, 256, False, 0), (1_000_003, 16, False, 0),
                 (4099, 16, True, 0), (70_001, 256, True, 0)]
                + [(N, 16, False, 0) for N in TRAIN_LEAF_SIZES]
                + [(N, K, False, 0) for N in (1, 3, 5) for K in (1, 2, 17)]
                + [(N, K, False, off) for off in (1, 2, 3)
                   for N, K in ((1_000_003, 16), (4099, 17), (5, 2))]
                + [(70_001, 256, True, 3)])


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,ties,offset", KMEANS_CASES)
def test_cuda_kmeans_stats_matches_plain(cuda_device, N, K, ties, offset):
    w, d = _kmeans_case(N, K, ties, torch.Generator().manual_seed(N + K))
    a0, s0, c0 = kmeans_stats_ref(w, d)
    buf = torch.zeros(N + offset, device=cuda_device)
    buf[offset:] = w.to(cuda_device)
    wc = buf[offset:]
    assert (wc.data_ptr() // 4) % 4 == offset
    a1, s1, c1 = kmeans_stats.kmeans_stats(wc, d.to(cuda_device))
    torch.cuda.synchronize()
    assert a1.dtype == torch.int8 and a1.shape == (N,)
    assert torch.equal(a1.cpu(), a0)
    assert torch.equal(c1.cpu(), c0)
    idx = a0.view(torch.uint8).long()
    mag = torch.zeros(K).index_add_(0, idx, w.abs())
    assert ((s1.cpu() - s0).abs() <= 1e-5 * mag).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(2560 * 640, 16), (1_000_003, 256), (5, 2)])
def test_cuda_kmeans_stats_repeats_and_replays(cuda_device, N, K):
    """A second call and two replays of one call captured in a CUDA graph
    give the first call's bits, one launch a call and no plain call, and
    the merge tickets are back at zero; write_a=False gives the same
    sums and counts and no assignments."""
    w, d = (t.to(cuda_device) for t in _kmeans_case(
        N, K, False, torch.Generator().manual_seed(K)))
    before = dict(kmeans_stats.COUNTS)
    first, second = (kmeans_stats.kmeans_stats(w, d) for _ in range(2))
    assert kmeans_stats.COUNTS["launches"] == before["launches"] + 2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        kmeans_stats.kmeans_stats(w, d)  # warm-up on that stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kmeans_stats.kmeans_stats(w, d)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    for _ in range(2):
        for x in captured:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(captured, first):
            assert torch.equal(x, y)
    assert not build.merge_tickets(1, w.device).any()
    a, sums, counts = kmeans_stats.kmeans_stats(w, d, write_a=False)
    assert a is None
    assert torch.equal(sums, first[1]) and torch.equal(counts, first[2])
    assert kmeans_stats.COUNTS["launches"] == before["launches"] + 5
    assert kmeans_stats.COUNTS["plain"] == before["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(2560 * 2560, 16), (70_001, 256)])
def test_cuda_kmeans_stats_one_launch_no_memset(cuda_device, N, K):
    """A call is one kernel on the stream: the profiler lists the kernel
    once a call and no memset."""
    from torch.profiler import ProfilerActivity, profile

    w, d = (t.to(cuda_device) for t in _kmeans_case(
        N, K, False, torch.Generator().manual_seed(2)))
    want = kmeans_stats.kmeans_stats(w, d)  # tickets made before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = [kmeans_stats.kmeans_stats(w, d) for _ in range(3)]
        torch.cuda.synchronize()
    assert all(torch.equal(x, y) for g in got for x, y in zip(g, want))
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {e.key: e.count for e in prof.key_averages()}
    assert not [n for n in names if "emset" in n], names
    assert len(names) == 1 and "kmeans_stats" in names[0], names
    assert counts[names[0]] == 3, counts


@pytest.mark.cuda
def test_cuda_kmeans_stats_raises_instead_of_falling_back(cuda_device,
                                                          monkeypatch):
    w, d = (t.to(cuda_device) for t in _kmeans_case(
        4099, 16, False, torch.Generator()))
    before = dict(kmeans_stats.COUNTS)

    class FailedLaunch:
        @staticmethod
        def kmeans_stats_launch(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        kmeans_stats.kmeans_stats(w, d)
    with pytest.raises(ValueError, match="w's CUDA device"):
        kmeans_stats.kmeans_stats(w, d.cpu())
    assert kmeans_stats.COUNTS == before


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

#: (B, Hkv, G, dh, page, NB, lengths, window): reduced danube's decode
#: shape, full-width danube's at capacity 8 with a 69-page row, the same
#: with lengths on the kernel's split edges (filled in from the card's
#: split plan by _paged_operands), a batch of empty rows, and head dim
#: 128 at the groups of qwen1.5-110b (8), mistral-large-123b (12) and
#: the kernel's limit (16), the last on the split edges
PAGED_SHAPES = {
    "reduced": (6, 1, 2, 16, 8, 4, [0, 1, 7, 8, 25, 32], 24),
    "full": (8, 8, 4, 80, 64, 69, [1, 63, 64, 65, 577, 2048, 4101, 4416],
             4096),
    "splits": (12, 8, 4, 80, 64, 69, None, 4096),
    "empty": (4, 8, 4, 80, 64, 69, [0, 0, 0, 0], 4096),
    "g8": (8, 8, 8, 128, 64, 69, [1, 63, 64, 65, 577, 2048, 4101, 4416],
           4096),
    "g12": (8, 8, 12, 128, 64, 69, [1, 63, 64, 65, 577, 2048, 4101, 4416],
            4096),
    "g16": (12, 8, 16, 128, 64, 69, None, 4096),
    # seamless-m4t-medium: 16 heads of 64 over 16 KV heads (G = 1)
    "g1": (8, 16, 1, 64, 64, 69, [1, 63, 64, 65, 577, 2048, 4101, 4416],
           4096),
    "g1_splits": (12, 16, 1, 64, 64, 69, None, 4096),
    "g1_engine": (4, 16, 1, 64, 64, 3, [0, 1, 64, 192], 4096),
}


def _split_edge_lengths(B, Hkv, NB, page, window, dev):
    """Lengths on the split edges of both plans (with and without the
    window) at this card's SM count: one position, a row shorter than
    one split, each first edge +- 1, window rows whose first valid
    position is on no page or split edge, the whole table."""
    sms = build.sm_count(dev)
    lens = [1]
    for w in (window, None):
        chunk = paged_attn.split_plan(B, Hkv, NB, page, w, sms=sms)["chunk"]
        lens += [chunk // 2, chunk - 1, chunk, chunk + 1, 2 * chunk + 1]
    lens += [window + 1, window + 3 * 64 // 2 + 1, NB * page]
    lens = sorted({min(x, NB * page) for x in lens})
    return (lens * B)[:B]
#: largest |kernel - plain| of each (sequence, query head) row over that
#: row's largest |plain|: one bf16 ulp (2^-7) of the row for bf16 q (bf16
#: output, bf16 scores that may round the other way where the f32 sums
#: differ in their last bits), 1e-5 for f32 q (f32 sums in another order)
PAGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _rows_within(got, want, tol):
    """Each (sequence, query head) row of got within tol of that row's
    own largest |want| (an all-zero row, cache_len 0, exactly)."""
    err = (got.float() - want.float()).abs().amax(-1)
    return bool((err <= tol * want.float().abs().amax(-1)).all())


def _paged_operands(shape, q_dtype, kv_dtype, dev, seed=0, poison=False):
    """q, pools with a zero trash page 0 and distinct live pages, the
    block table (dead entries on page 0, or with ``poison`` on a last
    page of NaN: NaN scales for int8 pools), lengths and the window."""
    B, Hkv, G, dh, page, NB, lens, window = PAGED_SHAPES[shape]
    if lens is None:
        lens = _split_edge_lengths(B, Hkv, NB, page, window, dev)
    g = torch.Generator().manual_seed(seed)
    P = 2 + B * NB
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, (P, page, Hkv, dh), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, page, Hkv, dh), generator=g,
                           dtype=torch.int8)
        ks = (torch.rand(P, page, Hkv, generator=g) * 0.05).to(torch.bfloat16)
        vs = (torch.rand(P, page, Hkv, generator=g) * 0.05).to(torch.bfloat16)
        ks[0] = 0
        vs[0] = 0
    else:
        kp = torch.randn(P, page, Hkv, dh, generator=g).to(kv_dtype)
        vp = torch.randn(P, page, Hkv, dh, generator=g).to(kv_dtype)
        ks = vs = None
    kp[0] = 0
    vp[0] = 0
    for t in (kp, vp) if ks is None else (ks, vs):
        t[P - 1] = float("nan")
    q = torch.randn(B, 1, Hkv * G, dh, generator=g).to(q_dtype)
    block = (1 + torch.randperm(B * NB, generator=g)).reshape(B, NB).int()
    for b, L in enumerate(lens):
        live = torch.arange(NB)
        first = max(0, (L - window) // page) if poison and window else 0
        dead = (live >= -(-L // page)) | (live < first)
        block[b, dead] = P - 1 if poison else 0
    cl = torch.tensor(lens, dtype=torch.int32)
    moved = [None if t is None else t.to(dev)
             for t in (q, kp, vp, block, cl, ks, vs)]
    return moved + [window]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("shape", ["reduced", "full", "splits", "empty",
                                   "g8", "g12", "g16"])
@pytest.mark.parametrize("budget", [None, 0], ids=["plan", "workspace"])
def test_cuda_paged_attention_matches_plain(cuda_device, budget, shape,
                                            q_dtype, kv_dtype):
    """Both variants (the default plan, and each split's scores forced
    into the workspace) against the plain version on the same card
    tensors, lengths on the split edges and all-empty rows included."""
    q, kp, vp, block, cl, ks, vs, window = _paged_operands(
        shape, q_dtype, kv_dtype, cuda_device)
    for w in (None, window):
        want = paged_attention_ref(q, kp, vp, block, cl, window=w,
                                   k_scale=ks, v_scale=vs)
        got = paged_attn.paged_attention(q, kp, vp, block, cl, window=w,
                                         k_scale=ks, v_scale=vs,
                                         smem_budget_bytes=budget)
        torch.cuda.synchronize()
        assert got.dtype == q_dtype and got.shape == q.shape
        assert _rows_within(got, want, PAGED_TOL[q_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.int8)])
@pytest.mark.parametrize("shape", ["reduced", "splits", "g12", "g16"])
@pytest.mark.parametrize("budget", [None, 0], ids=["plan", "workspace"])
def test_cuda_paged_attention_is_deterministic_and_skips_dead_pages(
        cuda_device, budget, shape, q_dtype, kv_dtype):
    """Two calls give the same bits (a fixed merge order, no float
    atomics), and pointing every dead or behind-window block entry at a
    page of NaN keeps them: no such page is read."""
    args = _paged_operands(shape, q_dtype, kv_dtype, cuda_device)
    q, kp, vp, block, cl, ks, vs, window = args
    poisoned = _paged_operands(shape, q_dtype, kv_dtype, cuda_device,
                               poison=True)[3]
    outs = [paged_attn.paged_attention(q, kp, vp, blk, cl, window=window,
                                       k_scale=ks, v_scale=vs,
                                       smem_budget_bytes=budget)
            for blk in (block, block, poisoned)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["splits", "g8", "g12", "g16"])
@pytest.mark.parametrize("budget", [None, 0], ids=["plan", "workspace"])
def test_cuda_paged_attention_replays_in_a_cuda_graph(cuda_device, budget,
                                                      shape):
    """One call captured in a CUDA graph and replayed twice equals the
    eager call: the launch reads nothing back from the card, and the
    merge tickets are left at zero for the next replay."""
    q, kp, vp, block, cl, ks, vs, window = _paged_operands(
        shape, torch.bfloat16, torch.int8, cuda_device)

    def call():
        return paged_attn.paged_attention(q, kp, vp, block, cl, window=window,
                                          k_scale=ks, v_scale=vs,
                                          smem_budget_bytes=budget)
    eager = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert not paged_attn._TICKETS[q.device.index].any()


@pytest.mark.cuda
def test_cuda_paged_attention_launches_and_never_runs_plain(cuda_device):
    q, kp, vp, block, cl, ks, vs, window = _paged_operands(
        "full", torch.bfloat16, torch.int8, cuda_device)
    before = dict(paged_attn.COUNTS)
    variants = dict(paged_attn.VARIANTS)
    paged_attn.paged_attention(q, kp, vp, block, cl, window=window,
                               k_scale=ks, v_scale=vs)
    paged_attn.paged_attention(q, kp, vp, block, cl, window=window,
                               k_scale=ks, v_scale=vs, smem_budget_bytes=0)
    torch.cuda.synchronize()
    assert paged_attn.COUNTS["plain"] == before["plain"]
    assert paged_attn.COUNTS["launches"] == before["launches"] + 2
    # a split's scores stay in shared memory within the default budget;
    # a zero budget forces the workspace
    assert (paged_attn.VARIANTS["paged_attention_multipass"]
            == variants["paged_attention_multipass"] + 1)
    assert (paged_attn.VARIANTS["paged_attention"]
            == variants["paged_attention"] + 1)


@pytest.mark.cuda
def test_cuda_paged_attention_raises_instead_of_falling_back(cuda_device,
                                                             monkeypatch):
    q, kp, vp, block, cl, ks, vs, window = _paged_operands(
        "reduced", torch.float32, torch.float32, cuda_device)
    plain = paged_attn.COUNTS["plain"]

    class FailedLaunch:
        @staticmethod
        def paged_attention_launch(*args):
            return 1  # cudaErrorInvalidValue

    def failed_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        paged_attn.paged_attention(q, kp, vp, block, cl)
    monkeypatch.setattr(build, "load_library", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        paged_attn.paged_attention(q, kp, vp, block, cl)
    # the kernel takes groups of up to 16: 2 x 9 = 18 query heads a KV head
    with pytest.raises(ValueError, match="query heads per KV head"):
        paged_attn.paged_attention(q.repeat(1, 1, 9, 1), kp, vp, block, cl)
    assert paged_attn.COUNTS["plain"] == plain


@pytest.mark.cuda
def test_cuda_paged_engine_matches_cpu(cuda_device):
    """Reduced danube through the paged engine (int8 pages): the card's
    tokens are the CPU's, and the card ran the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=QuantSpec(bits=4, min_size=512), act_bits=32, kv_cache_bits=8)
    model = serve_view(api.quantize(api.init(cfg, seed=0, device="cpu"), cfg),
                       pack4=True, policy=api.resolved_policy(cfg))
    reqs = synthetic_requests(cfg, 4, max_prompt=30, max_new=8, seed=1)
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(model.to(dev), cfg, capacity=2, max_len=38, kv_pages=16,
                     page_size=8, prefill_pack=False, device=dev)
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"])
        launches = paged_attn.COUNTS["launches"]
        toks[dev] = [r["tokens"] for r in eng.run()]
        assert (paged_attn.COUNTS["launches"] > launches) == (dev == "cuda")
    for a, b in zip(toks["cpu"], toks["cuda"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-large-123b", "qwen1.5-110b"])
def test_cuda_dense_family_engine_matches_cpu(cuda_device, arch):
    """Reduced mistral-large-123b at its group of 12 (12 query heads over
    1 KV head, head dim 16) and reduced qwen1.5-110b with nonzero q, k
    and v biases, through the paged engine (int8 pages, packed4): the
    card's tokens are the CPU's, and the card ran the paged kernel and
    the GEMM, no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import lutq_gemv_packed
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg = reduced(get_config(arch)).replace(
        quant=QuantSpec(bits=4, constraint="pow2", min_size=512),
        act_bits=32, kv_cache_bits=8)
    if arch == "mistral-large-123b":
        cfg = cfg.replace(n_heads=12, n_kv_heads=1)
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for layer in model.layers:
            for k in ("q", "k", "v"):
                lin = getattr(layer.attn, k)
                assert hasattr(lin, "bias") == cfg.qkv_bias
                if cfg.qkv_bias:
                    lin.bias.copy_(torch.randn(lin.bias.shape, generator=g))
    model = serve_view(model, pack4=True, policy=api.resolved_policy(cfg))
    reqs = synthetic_requests(cfg, 4, max_prompt=30, max_new=8, seed=1)
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(model.to(dev), cfg, capacity=2, max_len=38, kv_pages=16,
                     page_size=8, device=dev)
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"])
        before = (paged_attn.COUNTS["launches"],
                  lutq_gemv_packed.COUNTS["launches"], paged_attn.COUNTS[
                      "plain"], lutq_gemv_packed.COUNTS["plain"])
        with torch.no_grad():
            toks[dev] = [r["tokens"] for r in eng.run()]
        if dev == "cuda":
            assert paged_attn.COUNTS["launches"] > before[0]
            assert lutq_gemv_packed.COUNTS["launches"] > before[1]
            assert (paged_attn.COUNTS["plain"],
                    lutq_gemv_packed.COUNTS["plain"]) == before[2:]
    for a, b in zip(toks["cpu"], toks["cuda"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the engine's decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _reduced_model(case):
    """(config, serve model on the card) of reduced danube for one of
    GRAPH_CASES."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    base = reduced(get_config("h2o-danube-1.8b"))
    if case == "pow2":
        cfg = base.replace(quant=serving_pow2(), act_bits=8, kv_cache_bits=8)
        calib = torch.randint(0, cfg.vocab, (2, 24),
                              generator=torch.Generator().manual_seed(3))
        return cfg, api.serve_state(cfg, seed=0, device="cuda",
                                    calib_batch={"tokens": calib.cuda()})
    fused = case == "paged-fused-bf16"
    cfg = base.replace(quant=QuantSpec(bits=4, min_size=512), act_bits=32,
                       kv_cache_bits=16 if fused else 8,
                       dtype=torch.bfloat16 if fused else torch.float32,
                       kernel_backend="fused" if fused else "auto")
    model = serve_view(api.quantize(api.init(cfg, seed=0, device="cuda"),
                                    cfg), pack4=not fused,
                       policy=api.resolved_policy(cfg))
    return cfg, model


def _serve_queue(cfg, model, reqs, graphs=True, **kw):
    """(tokens per request, launch counts of the serve, the engine)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine, disable_graphs

    with contextlib.ExitStack() as stack:
        if not graphs:
            stack.enter_context(disable_graphs())
        eng = Engine(model, cfg, device="cuda", **kw)
        traces = eng.paged_trace_counts()
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"],
                       seed=r.get("seed"))
        before = ops.read_counts()
        toks = [r["tokens"] for r in eng.run()]
        torch.cuda.synchronize()
        counts = ops.count_delta(before)
    if kw.get("kv_pages") and graphs:
        assert traces == _paged_graphs(eng) == eng.paged_trace_counts()
    return toks, counts, eng


def _paged_graphs(eng, n=1):
    """The trace counts of a paged engine that captured its graphs (n =
    1) or runs eagerly (n = 0): the decode step, one chunk graph a
    bucket width, the hydrate and the splice, and one packed graph a
    bucket width where the engine packs."""
    out = {"decode": n, "chunk": n * len(eng.buckets), "hydrate": n,
           "splice": n}
    if eng.prefill_pack:
        out["packed"] = n * len(eng.buckets)
    return out


PAGED = dict(capacity=2, max_len=38, kv_pages=16, page_size=8,
             prefill_pack=False)
GRAPH_CASES = ["paged-packed4-int8", "paged-fused-bf16",
               "slot-packed4-generate", "pow2"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_cuda_graph_engine_equals_eager(cuda_device, case):
    """The engine that replays its captured decode step gives the tokens
    and the launch counts of the same engine stepping eagerly inside
    disable_graphs(); a paged engine captures at construction, reports
    its warmup, and a serve captures nothing more."""
    from repro_torch.runtime.engine import disable_graphs, synthetic_requests
    from repro_torch.runtime.serving import generate

    slot = case == "slot-packed4-generate"
    cfg, model = _reduced_model("paged-packed4-int8" if slot else case)
    if slot:
        from repro_torch.kernels import ops

        toks = torch.randint(0, cfg.vocab, (3, 20),
                             generator=torch.Generator().manual_seed(4))
        out = {}
        for graphs in (True, False):
            before = ops.read_counts()
            with contextlib.ExitStack() as stack:
                if not graphs:
                    stack.enter_context(disable_graphs())
                gen, stats = generate(model, cfg, {"tokens": toks}, steps=9,
                                      return_stats=True, device="cuda")
            out[graphs] = (gen.cpu(), ops.count_delta(before), stats)
        assert torch.equal(out[True][0], out[False][0])
        assert out[True][1] == out[False][1]
        assert out[True][1][1]["launches"] == 9 * (7 * cfg.n_layers + 1)
        assert out[True][2]["t_warmup_s"] > 0 == out[False][2]["t_warmup_s"]
        return
    reqs = synthetic_requests(cfg, 5, max_prompt=30, max_new=8, seed=1)
    got, counts, eng = _serve_queue(cfg, model, reqs, **PAGED)
    want, want_counts, _ = _serve_queue(cfg, model, reqs, graphs=False,
                                        **PAGED)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert counts == want_counts
    launches = {"paged-packed4-int8": 1, "paged-fused-bf16": 0, "pow2": 2}
    assert counts[launches[case]]["launches"] > 0
    assert counts[4]["launches"] == cfg.n_layers * eng.n_decode_steps
    assert eng.stats()["t_warmup_s"] > 0


@pytest.mark.cuda
def test_cuda_graph_engine_samples_as_eager(cuda_device):
    """A temperature queue: the graph replays the forward, the sampling
    stays eager on the same logits and generators, so the tokens under
    the same seeds equal the eager engine's."""
    from repro_torch.runtime.engine import synthetic_requests

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 4, max_prompt=30, max_new=8, seed=2)
    for i, r in enumerate(reqs):
        r["seed"] = 40 + i
    got, _, _ = _serve_queue(cfg, model, reqs, temperature=0.8, **PAGED)
    want, _, _ = _serve_queue(cfg, model, reqs, graphs=False,
                              temperature=0.8, **PAGED)
    greedy, _, _ = _serve_queue(cfg, model, reqs, **PAGED)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(got, greedy))


@pytest.mark.cuda
def test_cuda_engines_of_two_geometries_keep_their_graphs(cuda_device):
    """A paged engine and a slot-pool engine of other capacities, stepped
    in turns in one process: each replays its own graph and gives its
    eager tokens."""
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 5, max_prompt=30, max_new=8, seed=3)
    kws = (PAGED, dict(capacity=3, max_len=38))
    engines = [Engine(model, cfg, device="cuda", **kw) for kw in kws]
    for eng in engines:
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"])
    while not all(e.idle for e in engines):
        for eng in engines:
            if not eng.idle:
                eng.step()
    assert engines[0].paged_trace_counts() == _paged_graphs(engines[0])
    assert engines[1].paged_trace_counts() == {"decode": 1}
    assert engines[0]._graphs["decode"] is not engines[1]._graphs["decode"]
    for eng, kw in zip(engines, kws):
        want, _, _ = _serve_queue(cfg, model, reqs, graphs=False, **kw)
        for a, b in zip([eng.results[i]["tokens"] for i in range(5)], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_graph_survives_grown_ticket_buffers(cuda_device):
    """Ticket buffers grown after a capture are kept, so the graph's
    replay keeps its bits: the same queue served again by the same engine
    after the growth (and freed memory refilled with garbage) gives the
    same tokens."""
    from repro_torch.runtime.engine import synthetic_requests

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 4, max_prompt=30, max_new=8, seed=4)
    first, _, eng = _serve_queue(cfg, model, reqs, prefix_cache=False,
                                 **PAGED)
    dev = torch.device("cuda", torch.cuda.current_device())
    old = [t for t in (build._GEMM_TICKETS.get(str(dev)),
                       paged_attn._TICKETS.get(dev.index)) if t is not None]
    assert old
    n = max(t.numel() for t in old) * 4
    build.merge_tickets(n, dev)
    paged_attn._tickets(dev, n)
    assert all(any(t is o for t in build._OUTGROWN) for o in old)
    torch.cuda.empty_cache()
    junk = torch.full((1 << 24,), 7, dtype=torch.int32, device=dev)
    for r in reqs:
        eng.submit(r["tokens"], max_new=r["max_new"])
    again = [r["tokens"] for r in eng.run()[len(reqs):]]
    del junk
    assert eng.paged_trace_counts() == _paged_graphs(eng)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not any(o.any() for o in old)


@pytest.mark.cuda
def test_cuda_engine_in_a_calibration_block_steps_eagerly(cuda_device):
    """Inside capture_act_scales a graph engine steps eagerly: its decode
    forwards fold into the record exactly as the eager engine's do."""
    from repro_torch.core.actquant import capture_act_scales
    from repro_torch.runtime.engine import (Engine, disable_graphs,
                                            synthetic_requests)

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 3, max_prompt=30, max_new=8, seed=5)
    recs = []
    for graphs in (True, False):
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            eng = Engine(model, cfg, device="cuda", **PAGED)
            assert eng.paged_trace_counts() == _paged_graphs(eng, graphs)
            for r in reqs:
                eng.submit(r["tokens"], max_new=r["max_new"])
            with capture_act_scales(model) as rec:
                eng.run()
        assert eng.n_decode_steps > 0
        assert eng.paged_trace_counts() == _paged_graphs(eng, graphs)
        recs.append(rec)
    assert recs[0] and recs[0] == recs[1]


def _shared_prefix_queue(vocab, n=5):
    """A 16-token system prompt (two pages of 8) shared by ``n``
    requests, each with its own tail of 1-14 tokens and 3-8 new."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 16)
    return [{"tokens": np.concatenate([system, rng.integers(
                0, vocab, int(rng.integers(1, 15)))]).astype(np.int32),
             "max_new": int(rng.integers(3, 9))} for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paged-packed4-int8", "paged-fused-bf16"])
def test_cuda_graph_prefill_with_prefix_hits_equals_eager(cuda_device,
                                                          case):
    """A shared-prefix queue (hydrates from cached pages, splices past
    the hit) served with the prefill and decode graphs and eagerly: the
    same tokens and launch counts, one GEMM forward a chunk and a decode
    step, and the graphs of construction, no more, after the serve.
    Every trash entry but offset 0 (the dead slots' decode entry) holds
    one value: the splice's writes there agree, so their order on the
    card cannot matter (dead slots average the trash page, and under
    dynamic activation scales their rows reach the live rows')."""
    cfg, model = _reduced_model(case)
    reqs = _shared_prefix_queue(cfg.vocab)
    got, counts, eng = _serve_queue(cfg, model, reqs, **PAGED)
    want, want_counts, eager = _serve_queue(cfg, model, reqs, graphs=False,
                                            **PAGED)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert counts == want_counts
    st = eng.stats()
    assert st["prefix_hits"] > 0 and st["prefix_hits"] == \
        eager.stats()["prefix_hits"]
    assert eager.paged_trace_counts() == _paged_graphs(eager, 0)
    gemm = counts[0 if case == "paged-fused-bf16" else 1]["launches"]
    assert gemm == (7 * cfg.n_layers + 1) * (st["decode_steps"]
                                             + st["prefill_chunk_calls"])
    for e in (eng, eager):
        for pool in e.cache["pool"]:
            for key, t in pool.items():
                assert torch.unique(t[0, 1:]).numel() == 1, key


#: the packed-prefill geometry of tests/test_torch_packed.py: four
#: prompts of 5-8 tokens for 4 slots in one packed call
PACKED = dict(capacity=4, max_len=20, kv_pages=24, page_size=16)


def _packed_queue(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, L).astype(np.int32),
             "max_new": g} for L, g in zip((5, 7, 6, 8), (4, 3, 4, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paged-packed4-int8", "paged-fused-bf16"])
def test_cuda_packed_engine_graph_equals_eager(cuda_device, case):
    """A packing engine replaying its packed graph gives the tokens and
    launch counts of the same engine eagerly inside disable_graphs(),
    and of the unpacked engine; it holds one packed graph a bucket width
    from its warmup on (the serve captures none), and one GEMM forward
    of a packed call launches 168 body products and one head product."""
    cfg, model = _reduced_model(case)
    reqs = _packed_queue(cfg.vocab)
    got, counts, eng = _serve_queue(cfg, model, reqs, **PACKED)
    want, want_counts, eager = _serve_queue(cfg, model, reqs, graphs=False,
                                            **PACKED)
    plain, _, unpacked = _serve_queue(cfg, model, reqs, prefill_pack=False,
                                      **PACKED)
    assert eng.prefill_pack and eng.paged_trace_counts()["packed"] == \
        len(eng.buckets)
    assert eager.paged_trace_counts() == _paged_graphs(eager, 0)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert counts == want_counts
    st = eng.stats()
    assert st["packed_groups"] == eager.stats()["packed_groups"] == 1
    assert st["prefill_chunk_calls"] < unpacked.stats()["prefill_chunk_calls"]
    gemm = counts[0 if case == "paged-fused-bf16" else 1]["launches"]
    assert gemm == (7 * cfg.n_layers + 1) * (st["decode_steps"]
                                             + st["prefill_chunk_calls"])


@pytest.mark.cuda
def test_cuda_packed_engine_matches_cpu(cuda_device):
    """Reduced danube (packed4, int8 pages) through a packing engine: the
    card's tokens are the CPU's, with one packed call on each."""
    from repro_torch.runtime.engine import Engine

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = _packed_queue(cfg.vocab, seed=2)
    toks, stats = {}, {}
    for dev in ("cpu", "cuda"):
        eng = Engine(model.to(dev), cfg, device=dev, **PACKED)
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"])
        toks[dev] = [r["tokens"] for r in eng.run()]
        stats[dev] = eng.stats()
    model.to("cuda")
    assert stats["cpu"]["packed_groups"] == stats["cuda"]["packed_groups"] \
        == 1
    for a, b in zip(toks["cpu"], toks["cuda"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paged-packed4-int8", "paged-fused-bf16"])
def test_cuda_chunk_graph_replays_at_two_starts(cuda_device, case):
    """The captured 16-wide chunk replayed at start 0 (slab at 0) and at
    start 80 (a 64-position slab moved to 32, in a 128-position
    workspace) gives the logits and workspace of eager calls with int
    starts, bit for bit."""
    from repro_torch.models.lm import lm_paged_prefill_chunk
    from repro_torch.runtime.engine import Engine

    cfg, model = _reduced_model(case)
    eng = Engine(model, cfg, device="cuda", **PAGED)
    assert eng.wws == 128 and cfg.window == 24
    graph, _ = eng._graphs["chunk16"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for w in eng.ws:
        for t in w.values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    want_ws = [{k: t.clone() for k, t in w.items()} for w in eng.ws]
    for start, n_real in ((0, 16), (80, 11)):
        toks = torch.randint(0, cfg.vocab, (1, 16), generator=gen,
                             device="cuda", dtype=torch.int32)
        eng.chunk_tok[:, :16].copy_(toks)
        eng.chunk_start.fill_(start)
        eng.chunk_n_real.fill_(n_real)
        graph.replay()
        with torch.inference_mode():
            want, _ = lm_paged_prefill_chunk(model, cfg, toks, want_ws,
                                             start, n_real)
        torch.cuda.synchronize()
        assert torch.equal(eng.chunk_logits, want.float()), start
        for w, v in zip(eng.ws, want_ws):
            for key in ("k", "v"):
                assert torch.equal(w[key], v[key]), (start, key)


# ---------------------------------------------------------------------------
# flash attention (kernel 5)
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: (BH, S, Skv, D, bq, bk, causal): the JAX test's shapes, a ragged S of
#: one q block (S = bq = 40), Skv != S, danube's head dim, q blocks of 32
#: and 48 rows (flash_bf16: a 64-row warpgroup would span two), and a
#: ragged causal S at bq = 64 whose last block's second warpgroup lies
#: past S (flash_wgmma's 128-row blocks)
FLASH_CASES = [(3, 256, 256, 64, 128, 128, True),
               (3, 512, 512, 128, 128, 128, False),
               (3, 256, 256, 64, 64, 128, True),
               (3, 384, 384, 32, 128, 128, True),
               (2, 40, 48, 16, 128, 16, True),
               (2, 128, 256, 80, 64, 32, False),
               (4, 192, 192, 80, 64, 64, True),
               (3, 256, 256, 80, 32, 128, True),
               (2, 384, 384, 96, 48, 64, True),
               (2, 320, 320, 112, 64, 32, True)]


def _flash_operands(BH, S, Skv, D, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(BH, S, D, generator=g).to(dtype)
    k = torch.randn(BH, Skv, D, generator=g).to(dtype)
    v = torch.randn(BH, Skv, D, generator=g).to(dtype)
    return q.to(dev), k.to(dev), v.to(dev)


def _flash_within(got, want, tol):
    """Each query row of got within tol of that row's own max|want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return bool((err <= tol * want.float().abs().amax(-1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH,S,Skv,D,bq,bk,causal", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, BH, S, Skv, D, bq,
                                            bk, causal, dtype):
    q, k, v = _flash_operands(BH, S, Skv, D, dtype, cuda_device)
    want = flash_attention_ref(q, k, v, causal=causal, bq=bq, bk=bk)
    kernel = flash_attn.plan(S, Skv, D, bq, bk, dtype)
    before = dict(flash_attn.COUNTS)
    got = flash_attn.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _flash_within(got, want, FLASH_TOL[dtype])
    assert flash_attn.COUNTS["launches"] == before["launches"] + 1
    for name in flash_attn.KERNEL_CODES:  # exactly the kernel plan names
        assert flash_attn.COUNTS[name] == before[name] + (name == kernel)
    assert flash_attn.COUNTS["plain"] == before["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_never_reads_skipped_blocks(cuda_device, dtype):
    """K/V rows [S/2, S) hold NaN and bq = bk = S/2: the first q block
    never reads them, so its rows keep the bits of a clean run."""
    S, b = 256, 128
    q, k, v = _flash_operands(2, S, S, 80, dtype, cuda_device, seed=7)
    clean = flash_attn.flash_attention(q, k, v, bq=b, bk=b)
    k[:, b:], v[:, b:] = float("nan"), float("nan")
    poisoned = flash_attn.flash_attention(q, k, v, bq=b, bk=b)
    torch.cuda.synchronize()
    assert torch.equal(poisoned[:, :b], clean[:, :b])
    assert bool(torch.isnan(poisoned[:, b:]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_never_reads_skipped_blocks_at_bq64(cuda_device,
                                                                 dtype):
    """bq = bk = 64 (bf16: flash_wgmma, whose 128-row blocks hold two
    64-row warpgroups): K/V rows [64, S) hold NaN, and the first q block
    keeps the bits of a clean run."""
    S, b = 256, 64
    assert flash_attn.plan(S, S, 80, b, b, dtype) == (
        "flash_wgmma" if dtype == torch.bfloat16 else "flash_f32")
    q, k, v = _flash_operands(2, S, S, 80, dtype, cuda_device, seed=8)
    clean = flash_attn.flash_attention(q, k, v, bq=b, bk=b)
    k[:, b:], v[:, b:] = float("nan"), float("nan")
    poisoned = flash_attn.flash_attention(q, k, v, bq=b, bk=b)
    torch.cuda.synchronize()
    assert torch.equal(poisoned[:, :b], clean[:, :b])
    assert bool(torch.isnan(poisoned[:, b:]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bq", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 128)],
                         ids=["wgmma", "bf16", "f32"])
def test_cuda_flash_attention_same_bits_again_and_in_graph(cuda_device, dtype,
                                                           bq):
    """A second call and two replays of a call captured in a CUDA graph
    (the TMA maps travel in the captured launch) give the first call's
    bits."""
    q, k, v = _flash_operands(4, 256, 256, 80, dtype, cuda_device, seed=9)
    first = flash_attn.flash_attention(q, k, v, bq=bq, bk=64)
    again = flash_attn.flash_attention(q, k, v, bq=bq, bk=64)
    torch.cuda.synchronize()
    assert torch.equal(again, first)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        flash_attn.flash_attention(q, k, v, bq=bq, bk=64)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attn.flash_attention(q, k, v, bq=bq, bk=64)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.cuda
def test_cuda_flash_attention_raises_instead_of_falling_back(cuda_device,
                                                             monkeypatch):
    q, k, v = _flash_operands(2, 128, 128, 64, torch.bfloat16, cuda_device)
    plain = flash_attn.COUNTS["plain"]

    class FailedLaunch:
        @staticmethod
        def flash_attention_launch(*args):
            return 1  # cudaErrorInvalidValue

    def failed_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        flash_attn.flash_attention(q, k, v)
    monkeypatch.setattr(build, "load_library", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flash_attn.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), bq=64, bk=64)
    assert flash_attn.COUNTS["plain"] == plain


# ---------------------------------------------------------------------------
# the card divides where the reference divides
# ---------------------------------------------------------------------------

#: float32 maxima where ``amax * f32(1/127) != amax / 127``: a card that
#: multiplied by the reciprocal would miss these scales by an ulp
#: (found with numpy; tests/test_torch_core.py pins the same values to
#: the JAX reference on the CPU)
RECIPROCAL_MISSES = [float.fromhex(h) for h in (
    "0x1.7166ecp+2", "0x1.499822p+1", "0x1.968e02p+0", "0x1.d6c39ap-1",
    "0x1.69f1eep-11", "0x1.4bc9bap+7")]


def _with_amax(shape, amax, g):
    """Uniform values in (-amax, amax) with |x| = amax at one place of
    each last-axis row (amax broadcast over the leading axes)."""
    x = (torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1) * 0.99
    x = x * amax[..., None]
    x[..., 0] = -amax
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_fake_quant_equals_cpu_bits(cuda_device, dtype, bits):
    g = torch.Generator().manual_seed(bits)
    for amax in RECIPROCAL_MISSES:
        x = _with_amax((8, 96), torch.full((8,), amax, dtype=torch.float64),
                       g).to(dtype)
        want = fake_quant(x, bits)
        got = fake_quant(x.to(cuda_device), bits)
        assert got.dtype == dtype and torch.equal(got.cpu(), want), amax


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kv_quant_equals_cpu_bits(cuda_device, dtype):
    g = torch.Generator().manual_seed(3)
    amax = torch.tensor(RECIPROCAL_MISSES, dtype=torch.float64)
    amax = amax.repeat(4 * 5)[:4 * 5 * 4].reshape(4, 5, 4)
    t = _with_amax((4, 5, 4, 80), amax, g).to(dtype)
    want_q, want_s = _kv_quant(t, 8)
    got_q, got_s = _kv_quant(t.to(cuda_device), 8)
    assert torch.equal(got_q.cpu(), want_q)
    assert got_s.dtype == torch.bfloat16 and torch.equal(got_s.cpu(), want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 1, 2])
def test_cuda_optimizer_divisors_equal_cpu_bits(cuda_device, step):
    """AdamW's bias corrections 1 - b^t and a microbatch count of 3 are
    no powers of two: the optimizer's divides by them (through
    ``scalar_like``) give the CPU's bits on the card."""
    b1, b2 = 0.9, 0.95
    t = np.float32(step) + np.float32(1.0)
    divisors = [float(np.float32(1.0) - np.float32(b) ** t) for b in (b1, b2)]
    g = torch.Generator().manual_seed(step)
    ts = [torch.randn(s, generator=g).abs() for s in ((64, 33), (33,))]
    for c in divisors + [3.0]:
        want = torch._foreach_div(ts, scalar_like(c, ts[0]))
        card = [x.to(cuda_device) for x in ts]
        got = torch._foreach_div(card, scalar_like(c, card[0]))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), c


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 4])
def test_cuda_adamw_step_equals_cpu_bits(cuda_device, step):
    """One whole AdamW step (weight decay on) over a few float32 leaves,
    1.26 M elements, from moments drawn from a seed: the card's
    parameters and moments equal the CPU's bit for bit (both roots
    correctly rounded)."""
    from repro_torch.optim.optimizers import adamw

    g = torch.Generator().manual_seed(step)
    shapes = {"w": (1024, 1152), "k": (512, 160), "b": (1152,)}
    state = {k: (torch.randn(s, generator=g),
                 torch.randn(s, generator=g) * 1e-2,
                 torch.randn(s, generator=g) * 1e-3,
                 torch.rand(s, generator=g) * 1e-5)
             for k, s in shapes.items()}
    opt = adamw(lambda s: 3e-4, weight_decay=0.1)
    runs = {}
    for dev in ("cpu", cuda_device):
        params = {k: t[0].clone().to(dev) for k, t in state.items()}
        grads = {k: t[1].to(dev) for k, t in state.items()}
        st = {"m": {k: t[2].clone().to(dev) for k, t in state.items()},
              "v": {k: t[3].clone().to(dev) for k, t in state.items()}}
        opt.update(grads, st, params, step)
        runs[str(dev)] = [params, st["m"], st["v"]]
    for want, got in zip(runs["cpu"], runs[str(cuda_device)]):
        for k in shapes:
            assert torch.equal(got[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# self-speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Kin,N", [(64, 211), (96, 64), (2560, 6912),
                                   (2560, 32000)])
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_window_rows_equal_decode_rows(cuda_device, kernel, Kin, N,
                                            dtype):
    """Each block of B rows of a B (k + 1)-row product (a speculative
    verify window) has the bits of those B rows alone (the decode step),
    for B = 1, 4, 8 and k = 1..4: the split plan of up to 64 rows is the
    8-row decode's."""
    fn, _, _, (x, a, d) = _gemm_operands(kernel, 40, Kin, N,
                                         getattr(torch, dtype), cuda_device)
    for B in (1, 4, 8):
        for k in (1, 2, 3, 4):
            full = fn(x[:B * (k + 1)], a, d)
            for j in range(k + 1):
                rows = slice(j * B, (j + 1) * B)
                assert torch.equal(fn(x[rows], a, d), full[rows]), (B, k, j)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k", [(13, 4), (16, 4), (72, 1)])
@pytest.mark.parametrize("Kin,N", [(64, 211), (2560, 6912)])
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_wide_window_rows_equal_decode_rows(cuda_device, kernel, Kin,
                                                 N, B, k):
    """A window of more than ROW_STABLE_M rows runs its products over
    whole positions at a time (``lm._rows``): 4 positions of 13 or 16
    slots, then the rest, and one position of 72 slots. Each position's
    B rows have the bits of those B rows alone (the decode step)."""
    from repro_torch.models.lm import _rows

    fn, _, _, (x, a, d) = _gemm_operands(kernel, B * (k + 1), Kin, N,
                                         torch.bfloat16, cuda_device)
    x = x.reshape(B, k + 1, Kin)

    def prod(t):  # as ops.lutq_dot hands its x to the kernel
        x2 = t.reshape(-1, Kin).contiguous()
        return fn(x2, a, d).reshape(*t.shape[:-1], -1)

    win = _rows(prod, x, build.ROW_STABLE_M)
    for j in range(k + 1):
        assert torch.equal(fn(x[:, j].contiguous(), a, d), win[:, j]), j


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_wide_speculative_engine_equals_plain(cuda_device, paged):
    """Reduced danube through a 14-slot engine at k = 4: 70 window rows,
    products over 4 positions (56 rows) and then 1 (14 rows). The
    replayed rounds give the plain engine's tokens."""
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 20, max_prompt=24, max_new=10, seed=2)
    kw = dict(capacity=14, max_len=40)
    if paged:
        kw.update(kv_pages=96, page_size=8, prefill_pack=False)
    runs = []
    for k in (0, 4):
        eng = Engine(model, cfg, speculative=k, draft_bits=2, device="cuda",
                     **kw)
        for r in reqs:
            eng.submit(r["tokens"], max_new=r["max_new"])
        runs.append([r["tokens"] for r in eng.run()])
    assert eng.stats()["spec_rounds"] > 0
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_speculative_engine_equals_plain_and_eager(cuda_device, paged):
    """Reduced danube (packed, int8 KV, act_bits=32) through a 2-slot
    speculative engine: the replayed rounds give the tokens of the plain
    engine and of the same rounds stepped eagerly, with the same launch
    counts; a paged engine captures its decode step and its round at
    construction and a serve captures nothing more."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import (Engine, disable_graphs,
                                            synthetic_requests)

    cfg, model = _reduced_model("paged-packed4-int8")
    reqs = synthetic_requests(cfg, 5, max_prompt=30, max_new=8, seed=1)
    kw = dict(PAGED, max_len=40) if paged else dict(capacity=2, max_len=40)
    runs = {}
    for name, k, graphs in (("plain", 0, True), ("graph", 2, True),
                            ("eager", 2, False)):
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            eng = Engine(model, cfg, speculative=k, draft_bits=2,
                         device="cuda", **kw)
            traces = eng.paged_trace_counts()
            for r in reqs:
                eng.submit(r["tokens"], max_new=r["max_new"])
            before = ops.read_counts()
            toks = [r["tokens"] for r in eng.run()]
            torch.cuda.synchronize()
            runs[name] = (toks, ops.count_delta(before), eng.stats())
        if name == "graph":
            want = {"decode": int(paged), "spec": int(paged)}
            if paged:
                want.update(_paged_graphs(eng))
            assert traces == want
            assert eng.paged_trace_counts() == dict(want, spec=1)
    for name in ("graph", "eager"):
        for a, b in zip(runs[name][0], runs["plain"][0]):
            np.testing.assert_array_equal(a, b)
    assert runs["graph"][1] == runs["eager"][1]
    st = runs["graph"][2]
    assert st["spec_rounds"] == st["decode_steps"] > 0
    # per round: k draft forwards and one window on the packed kernel
    n_fwd = 7 * cfg.n_layers + 1
    assert runs["graph"][1][1]["launches"] >= 3 * n_fwd * st["spec_rounds"]


def _blocks(model) -> int:
    """Device bytes the caching allocator gives the distinct tensors of
    ``model`` (each rounded up to its 512-byte block)."""
    from repro_torch.nn.tree import tree_paths

    seen, total = set(), 0
    for _, leaf in tree_paths(model):
        for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if t is not None and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += -(-t.numel() * t.element_size() // 512) * 512
    return total


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "serving_pow2"])
def test_cuda_train_checkpoint_serves_the_cpu_tokens(cuda_device, tmp_path,
                                                     policy):
    """Reduced danube trained 3 steps on the CPU by the training CLI into
    a checkpoint, served on the card and on the CPU through
    restore_params and from_train_params (packed4; under serving_pow2
    through lutq_shift): the same greedy tokens, no plain version on the
    card, and the load raises the card's allocated memory by no more
    than the serve view's blocks (no master, no moment)."""
    from repro_torch import interop
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.serving import generate

    flags = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "3",
             "--batch", "4", "--seq", "32", "--device", "cpu",
             "--ckpt-dir", str(tmp_path)]
    if policy:
        flags += ["--quant-policy", policy]
    assert train_cli.main(flags) == 0
    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        vocab=256, quant=ckpt.load_policy(str(tmp_path)), act_bits=8)
    pol = api.resolved_policy(cfg)
    params, _ = ckpt.restore_params(str(tmp_path))
    toks = torch.randint(0, cfg.vocab, (2, 30),
                         generator=torch.Generator().manual_seed(4))
    out, counts = {}, {}
    for dev in ("cpu", "cuda"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = interop.from_train_params(params, cfg, pack4=True,
                                          policy=pol, device=dev)
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - base
        sv = serve_view(model, pack4=True, policy=pol)
        if dev == "cuda":
            assert 0 < grew <= _blocks(sv), (grew, _blocks(sv))
        before = ops.read_counts()
        out[dev] = generate(sv, cfg, {"tokens": toks}, steps=8,
                            device=dev).cpu()
        counts[dev] = ops.count_delta(before)
    np.testing.assert_array_equal(out["cuda"].numpy(), out["cpu"].numpy())
    mm, gp, sh = counts["cuda"][:3]
    kernel = sh if policy else gp
    assert kernel["launches"] > 0
    assert sum(c.get("plain", 0) for c in counts["cuda"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_cuda_sequence_family_train_step_matches_cpu(cuda_device, arch):
    """One training step of the reduced encdec, hybrid or ssm config
    (the training CLI's build, kmeans_impl="stats", act_bits 32) on the
    card and on the CPU from one initial state and batch (seamless's
    with its frames): the loss within 1e-4 relative and every
    dictionary within 1e-5 of its largest entry; every k-means pass a
    kmeans_stats launch on the card (two a leaf), none a plain pass."""
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import train as train_cli
    from repro_torch.nn.tree import QuantKernel

    args = train_cli.parser().parse_args(
        ["--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
         "--seq", "16", "--act-bits", "32", "--device", "cpu"])
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, state, step_fn = train_cli.build(args, kmeans_impl="stats")
        state.model.to(dev)
        state.opt_state = {k: {n: t.to(dev) for n, t in v.items()}
                           for k, v in state.opt_state.items()}
        batch = train_cli.batch_fn(MarkovLM(cfg.vocab, seed=0), args,
                                   torch.device(dev), cfg)(0)
        before = dict(kmeans_stats.COUNTS)
        state, m = step_fn(state, batch)
        kernels = {n: k for n, k in state.model.named_modules()
                   if isinstance(k, QuantKernel)}
        out[dev] = (float(m["loss"]), {n: k.d.cpu() for n, k in
                                       kernels.items()},
                    {k: kmeans_stats.COUNTS[k] - before[k] for k in before})
    (lc, dc, cc), (lg, dg, cg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    for n in dc:
        err = float((dg[n] - dc[n]).abs().max() / dc[n].abs().max())
        assert err <= 1e-5, (n, err)
    assert cg == {"launches": 2 * len(dc), "plain": 0}, cg
    assert cc == {"launches": 0, "plain": 2 * len(dc)}, cc


# ---------------------------------------------------------------------------
# the vision family: conv, the ML-BN fold, the fc's kernels, a train step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_conv_apply_matches_cpu(cuda_device, stride):
    """conv_apply's output and both gradients on the card equal the
    CPU's within 1e-4 of max|CPU| (f32 sums in another order) with TF32
    switched on globally: the call runs both passes with TF32 off (TF32's
    10-bit mantissa would miss by ~1e-3)."""
    from repro_torch.nn.conv import Conv, conv_apply

    g = torch.Generator().manual_seed(30)
    x = torch.randn(8, 32, 32, 16, generator=g)
    w = torch.randn(3, 3, 16, 32, generator=g) * 0.1
    gy = torch.randn(8, 32 // stride, 32 // stride, 32, generator=g)
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in ("cpu", "cuda"):
            xt = x.to(dev, copy=True).requires_grad_(True)
            conv = Conv(w.to(dev, copy=True))
            y = conv_apply(conv, xt, stride=stride)
            (y * gy.to(dev)).sum().backward()
            out[dev] = [t.detach().cpu() for t in (y, xt.grad,
                                                    conv.kernel.grad)]
        assert torch.backends.cudnn.allow_tf32  # the switch was local
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.shape == want.shape
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err


def _pow2_fc(M, g, K=16, Kin=64, N=8):
    """Non-negative features (M, Kin) and a sorted 4-bit pow2 dictionary
    with its assignments (Kin, N): the ResNet fc's operands."""
    from repro_torch.core.lutq import pow2_round

    x = torch.rand(M, Kin, generator=g) * 3.0
    d = torch.sort(pow2_round(torch.randn(K, generator=g) * 0.3)).values
    a = torch.randint(0, K, (Kin, N), generator=g, dtype=torch.int8)
    return x, a, d


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 128, 512])
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed",
                                    "lutq_shift"])
def test_cuda_vision_fc_kernels_match_plain(cuda_device, kernel, M):
    """The three kernels at the ResNet fc's shape (Kin 64, N 8, below the
    vectorised N % 16 == 0 path): the GEMMs within 1e-4 of max|plain|,
    lutq_shift bit for bit (dynamic int8 activation scale)."""
    from repro_torch.core.lutq import pow2_encode
    from repro_torch.kernels import ops

    x, a, d = (t.to(cuda_device) for t in _pow2_fc(
        M, torch.Generator().manual_seed(31 + M)))
    before = ops.read_counts()
    if kernel == "lutq_shift":
        code = pow2_encode(d)
        got, _ = ops._pow2_dot_acc(x, code, a, None)
        want, _ = ops._pow2_dot_acc(x, code, a, None, use_kernel=False)
        assert torch.equal(got, want)
    else:
        fn, plain, idx = {
            "lutq_matmul": (lutq_matmul.lutq_matmul, lutq_matmul_ref, a),
            "lutq_gemv_packed": (lutq_gemv_packed.lutq_gemv_packed,
                                 lutq_gemv_packed_ref, pack4_kin(a))}[kernel]
        got, want = fn(x, idx, d), plain(x, idx, d)
        assert got.shape == (M, 8)
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    delta = dict(zip(("lutq_matmul", "lutq_gemv_packed", "lutq_shift"),
                     ops.count_delta(before)[:3]))
    assert delta[kernel] == {"launches": 1, "plain": 0}


@pytest.mark.cuda
def test_cuda_shift_fold_equals_multiply_bits(cuda_device, monkeypatch):
    """On the card the shift-add apply equals ``a*x + b`` bit for bit, and
    a multiplier-less ResNet inference through the fold equals the same
    forward through the multiply form (deterministic convolutions)."""
    from repro_torch.core.mlbn import apply_scale_offset_shift
    from repro_torch.models import resnet

    g = torch.Generator().manual_seed(32)
    e = torch.arange(-14, 16)
    a = (torch.where(torch.rand(e.numel(), generator=g) < 0.5, -1.0, 1.0)
         * torch.exp2(e.float())).to(cuda_device)
    a[[2, 11]] = 0.0
    b = torch.randn(e.numel(), generator=g).to(cuda_device)
    x = torch.randn(64, e.numel(), generator=g).to(cuda_device)
    assert torch.equal(apply_scale_offset_shift(x, a, b), a * x + b)

    model, stats = resnet.init_resnet20(g, widths=(8, 16), blocks=1,
                                        device=cuda_device)
    stats = {k: type(v)(v.mean + 0.3, v.var * 2.5) for k, v in stats.items()}
    xs = torch.rand(4, 8, 8, 3, generator=g).to(cuda_device)
    kw = dict(widths=(8, 16), blocks=1, training=False, multiplier_less=True,
              act_bits=8)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        fold, _ = resnet.resnet20_apply(model, stats, xs, **kw)
        monkeypatch.setattr(resnet, "apply_scale_offset_shift",
                            lambda h, a, b, **_: a * h + b)
        mul, _ = resnet.resnet20_apply(model, stats, xs, **kw)
    assert torch.equal(fold, mul)


@pytest.mark.cuda
def test_cuda_resnet_train_step_matches_cpu(cuda_device):
    """One cifar_table.train_step of the fully multiplier-less row on the
    reduced ResNet (8/16, one block, 8x8, B=8) from one quantized state on
    the card and on the CPU: loss within 1e-2 relative (an 8-bit
    activation may round the other way), every parameter within 2 lr
    (Adam's first step moves by lr), dictionaries equal, assignments
    equal except within 2 lr of a midpoint; no kernel or plain version
    runs (every leaf is dense k-means)."""
    import copy

    from repro_torch.core.policy import quantize_tree, split_trainable
    from repro_torch.data.synthetic import class_batches, shapes_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import cifar_table as ct
    from repro_torch.models.resnet import init_resnet20
    from repro_torch.nn.tree import QuantKernel
    from repro_torch.optim.optimizers import adamw, cosine_schedule

    _, spec, ml, act_bits = ct.config("LUT-Q 4-bit pow2 (fully ML)")
    spec = ct.table_spec(spec)
    model, stats = init_resnet20(torch.Generator().manual_seed(3),
                                 widths=(8, 16), blocks=1, device="cpu")
    quantize_tree(model, spec)
    xs, ys = shapes_dataset(64, seed=1, res=8)
    batch = next(class_batches(xs, ys, 8, seed=3))
    lr = cosine_schedule(2e-3, 20, ct.STEPS)(5)
    runs = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        s = {k: type(v)(v.mean.to(dev), v.var.to(dev))
             for k, v in stats.items()}
        opt = adamw(cosine_schedule(2e-3, 20, ct.STEPS))
        opt_state = opt.init(split_trainable(m)[0])
        before = ops.read_counts()
        _, loss, _ = ct.train_step(m, s, opt, opt_state, 5,
                                   ct.to_device(batch, dev), spec=spec,
                                   widths=(8, 16), blocks=1,
                                   multiplier_less=ml, act_bits=act_bits)
        delta = ops.count_delta(before)
        runs[dev] = (float(loss), {n: p.detach().cpu()
                                   for n, p in m.named_parameters()},
                     {n: (q.w.detach().cpu(), q.d.cpu(), q.a.cpu())
                      for n, q in m.named_modules()
                      if isinstance(q, QuantKernel)}, delta)
    (lc, pc, qc, _), (lg, pg, qg, dg) = runs["cpu"], runs["cuda"]
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    assert all(d.get("launches", 0) == 0 and d.get("plain", 0) == 0
               for d in dg[:4])
    for n, p in pc.items():
        assert float((pg[n] - p).abs().max()) <= 2 * lr + 1e-6 * float(
            p.abs().max()), n
    assert len(qc) == 4
    for n, (w, d, a) in qc.items():
        _, dd, aa = qg[n]
        assert torch.equal(dd, d), n
        diff = aa != a
        mid = (d[:-1] + d[1:]) * 0.5
        assert bool(((w[diff].reshape(-1, 1) - mid).abs().min(1).values
                     <= 2 * lr).all()), n


def _pow2_audit_model():
    """Reduced danube under serving_pow2 on the card, calibrated, and its
    prompt."""
    from repro_torch.configs import get_config
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    cfg = reduced(get_config("h2o-danube-1.8b")).replace(
        quant=serving_pow2(), act_bits=8)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(3)).cuda()
    model = api.serve_state(cfg, seed=0, device="cuda",
                            calib_batch={"tokens": toks})
    return cfg, model, toks


@pytest.mark.cuda
def test_cuda_audit_records_an_int_dot_a_lutq_shift_launch(cuda_device):
    """The kernel path's audit: one integer dot a lutq_shift launch, each
    the kernel's note at its (M, Kin) @ (Kin, N), and no plain version."""
    from repro_torch.kernels import audit
    from repro_torch.models import api

    cfg, model, toks = _pow2_audit_model()
    before = dict(lutq_shift.COUNTS)
    with torch.inference_mode():
        rep = audit.audit_multiplierless(
            lambda: api.prefill(model, cfg, {"tokens": toks})[0],
            params=model)
    launches = lutq_shift.COUNTS["launches"] - before["launches"]
    assert launches == 5 * cfg.n_layers
    assert len(rep["int_dots"]) == launches
    assert all(d["kernel"] and d["op"] == "lutq_shift" and d["dtype"] == "i32"
               and d["lhs"][0] == toks.numel() for d in rep["int_dots"])
    assert lutq_shift.COUNTS["plain"] == before["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "packed4"])
def test_cuda_audit_refuses_float_dictionary_kernels(cuda_device, backend):
    """A float dictionary through the LUT-decode kernels is a decoded-
    weight matmul, seen through the kernel's note."""
    from repro_torch.core.lutq import LutqState
    from repro_torch.kernels import audit, ops

    g = torch.Generator().manual_seed(4)
    d = torch.sort(torch.randn(16, generator=g)).values.cuda()
    a = torch.randint(0, 16, (256, 384), generator=g, dtype=torch.int8)
    leaf = LutqState(None, d, (a if backend == "fused" else pack4_kin(a))
                     .cuda())
    x = torch.randn(4, 256, generator=g).cuda()
    kname = "lutq_matmul" if backend == "fused" else "lutq_gemv_packed"
    with pytest.raises(AssertionError, match="decoded-weight matmul") as e:
        audit.audit_multiplierless(
            lambda: ops.lutq_dot(x, leaf, backend=backend),
            weight_shapes=[(256, 384)])
    assert f"'op': '{kname}'" in str(e.value)


@pytest.mark.cuda
def test_cuda_audit_refuses_the_decode_oracle(cuda_device):
    """On the card the integer decode oracle multiplies in float64 (no
    integer matmul on CUDA): its aten mm on the weight's shape is seen."""
    from repro_torch.kernels import audit
    from repro_torch.models import api

    cfg, model, toks = _pow2_audit_model()
    oracle = cfg.replace(kernel_backend="decode")
    with torch.inference_mode(), pytest.raises(
            AssertionError, match="decoded-weight matmul") as e:
        audit.audit_multiplierless(
            lambda: api.prefill(model, oracle, {"tokens": toks})[0],
            params=model)
    assert "'op': 'mm'" in str(e.value) and "'dtype': 'f64'" in str(e.value)


@pytest.mark.cuda
def test_cuda_audit_refuses_a_graph_replay(cuda_device):
    """An engine whose decode step replays a CUDA graph cannot be audited;
    stepping it under disable_graphs() can."""
    from repro_torch.kernels import audit
    from repro_torch.runtime.engine import Engine, disable_graphs

    cfg, model, toks = _pow2_audit_model()
    eng = Engine(model, cfg, capacity=2, max_len=48, device="cuda")
    for row in toks.cpu().numpy():
        eng.submit(row, max_new=12)
    eng.step()
    eng.step()
    assert eng.paged_trace_counts()["decode"] == 1
    with pytest.raises(RuntimeError, match="disable_graphs"):
        audit.record(eng.step)
    assert audit.RECORDER is None
    with disable_graphs():
        rep = audit.audit_multiplierless(eng.step, params=model)
    assert len(rep["int_dots"]) == 5 * cfg.n_layers


@pytest.mark.cuda
def test_cuda_serve_edge_cli(cuda_device, capsys):
    """The edge example on the card: the audit passes through lutq_shift
    launches, the tokens equal the decode oracle's, no plain version."""
    from repro_torch.launch import serve_edge

    plain = lutq_shift.COUNTS["plain"]
    assert serve_edge.main(["--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "PASS (10 integer dots, 10 of them lutq_shift launches" in out
    assert "token-identical" in out and "plain versions run 0" in out
    assert lutq_shift.COUNTS["plain"] == plain


# ---------------------------------------------------------------------------
# the expert-stacked kernels (the MoE family)
# ---------------------------------------------------------------------------

#: (E, C, Kin, N): a 128-expert stack at qwen3-moe's wi (4096 x 1536)
#: and wo (1536 x 4096) shapes, decode (C = 1) and a 4 x 128-token
#: prefill (C = 40), a 4-expert stack whose products split their
#: reduction, ragged shapes (unaligned rows, C past one tile), and
#: deepseek-v2-lite's 64-expert stacks (wi 2048 x 1408, wo 1408 x 2048:
#: Kin 1408 = 11 x 128) at decode and its 4 x 128-token prefill (C = 60)
EXPERT_CASES = [(128, 1, 4096, 1536), (128, 40, 1536, 4096),
                (4, 1, 4096, 1536), (4, 40, 1536, 4096), (3, 9, 130, 211),
                (5, 130, 256, 384), (2, 17, 2002, 211),
                (64, 1, 2048, 1408), (64, 60, 1408, 2048)]
EXPERT_KERNELS = ["lutq_matmul", "lutq_gemv_packed", "lutq_shift"]


def _expert_operands(kernel, E, C, Kin, N, dtype, seed=0):
    """(stacked wrapper, plain version, one-expert wrapper, CPU operands)
    with expert 1 an all-zero slab and a dictionary of its own an
    expert (lutq_shift: int8 xq and shifted pow2 dictionaries of spans
    0..9)."""
    from repro_torch.kernels.ref import (lutq_gemv_packed_experts_ref,
                                         lutq_matmul_experts_ref,
                                         lutq_shift_experts_ref)

    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 16, (E, Kin, N), generator=g, dtype=torch.int8)
    if kernel == "lutq_shift":
        x = torch.randint(-127, 128, (E, C, Kin), generator=g,
                          dtype=torch.int8)
        span = torch.arange(E) % 10
        mag = torch.randint(0, 1 << 20, (E, 16), generator=g) % (
            span[:, None] + 1) + 1
        sign = torch.randint(0, 2, (E, 16), generator=g) * 2 - 1
        d = pow2_shift_weights((mag * sign).to(torch.int8))
        fns = (lutq_shift.lutq_shift_experts, lutq_shift_experts_ref,
               lutq_shift.lutq_shift)
    else:
        x = torch.randn(E, C, Kin, generator=g).to(dtype)
        d = torch.sort(torch.randn(E, 16, generator=g), dim=-1).values
        if kernel == "lutq_gemv_packed":
            a = pack4_kin(a)
            fns = (lutq_gemv_packed.lutq_gemv_packed_experts,
                   lutq_gemv_packed_experts_ref,
                   lutq_gemv_packed.lutq_gemv_packed)
        else:
            fns = (lutq_matmul.lutq_matmul_experts, lutq_matmul_experts_ref,
                   lutq_matmul.lutq_matmul)
    x[1] = 0
    return fns + ((x, a, d),)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,Kin,N", EXPERT_CASES)
@pytest.mark.parametrize("kernel,dtype", [
    ("lutq_matmul", "float32"), ("lutq_matmul", "bfloat16"),
    ("lutq_gemv_packed", "float32"), ("lutq_gemv_packed", "bfloat16"),
    ("lutq_shift", "int8")])
def test_cuda_expert_kernel_matches_plain(cuda_device, kernel, E, C, Kin, N,
                                          dtype):
    """One launch a stacked product, against the plain version (a loop
    over the experts): the GEMMs' tolerance, lutq_shift bit for bit; the
    empty expert's slab exactly 0; each expert's slab against a
    one-expert launch of the plain kernel (bit for bit where the stacked
    and the single plan split alike)."""
    fn, plain, one, (x, a, d) = _expert_operands(kernel, E, C, Kin, N,
                                                 getattr(torch, dtype))
    counts = {"lutq_matmul": lutq_matmul, "lutq_gemv_packed":
              lutq_gemv_packed, "lutq_shift": lutq_shift}[kernel]
    before = dict(counts.EXPERT_COUNTS)
    dev = [t.to(cuda_device) for t in (x, a, d)]
    got = fn(*dev)
    torch.cuda.synchronize()
    assert counts.EXPERT_COUNTS["launches"] == before["launches"] + 1
    assert counts.EXPERT_COUNTS["plain"] == before["plain"]
    want = plain(x, a, d)
    assert not got[1].any()
    if kernel == "lutq_shift":
        assert torch.equal(got.cpu(), want)
    else:
        tol = 1e-4 if dtype == "float32" else 1e-3
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err <= tol, err
    plan_of = (lutq_shift.plan_splits if kernel == "lutq_shift"
               else lambda *s, **kw: build.plan_splits(s[0], s[1], s[2],
                                                       s[3], **kw))
    sms = build.sm_count(cuda_device)
    same = (plan_of(C, N, Kin, sms, experts=E)["splits"]
            == plan_of(C, N, Kin, sms)["splits"])
    for e in (0, E - 1):
        alone = one(dev[0][e], dev[1][e], dev[2][e])
        if same or kernel == "lutq_shift":
            assert torch.equal(alone, got[e])
        else:
            scale = alone.abs().max()
            assert (alone - got[e]).abs().max() <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,Kin,N", [(128, 1, 4096, 1536),
                                       (4, 1, 4096, 1536),
                                       (4, 40, 1536, 4096)])
@pytest.mark.parametrize("kernel", EXPERT_KERNELS)
def test_cuda_expert_kernel_repeats_and_replays(cuda_device, kernel, E, C,
                                                Kin, N):
    """A second call and two replays of a captured call give the first
    call's bits; the merge tickets are back at 0."""
    from repro_torch.kernels.ref import shift_planes

    fn, _, _, ops_cpu = _expert_operands(kernel, E, C, Kin, N,
                                         torch.bfloat16, seed=1)
    args = [t.to(cuda_device) for t in ops_cpu]
    if kernel == "lutq_shift":
        args.append(shift_planes(args[2]))
    first = fn(*args)
    assert torch.equal(fn(*args), first)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    tickets = build._GEMM_TICKETS.get(str(cuda_device))
    assert tickets is None or not tickets.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", EXPERT_KERNELS)
def test_cuda_expert_kernel_raises_instead_of_falling_back(cuda_device,
                                                           kernel,
                                                           monkeypatch):
    fn, _, _, ops_cpu = _expert_operands(kernel, 3, 2, 64, 96,
                                         torch.bfloat16)
    x, a, d = (t.to(cuda_device) for t in ops_cpu)
    launcher = ("lutq_shift_launch" if kernel == "lutq_shift"
                else f"{kernel}_launch")

    class FailedLaunch:
        pass

    setattr(FailedLaunch, launcher, staticmethod(lambda *args: 1))
    monkeypatch.setattr(build, "load_library", lambda: FailedLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1 at launch"):
        fn(x, a, d)
    with pytest.raises(ValueError):
        fn(x, a.cpu(), d)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_moe_serves_the_cpu_tokens(cuda_device, view):
    """Reduced qwen3-moe (4 experts top-2, qk-norm) served on the card
    through the expert-stacked kernels, graph-replayed and eager, gives
    the CPU's greedy tokens; three stacked launches a layer a forward,
    no plain version on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced
    from repro_torch.runtime.engine import disable_graphs
    from repro_torch.runtime.serving import generate

    base = reduced(get_config("qwen3-moe-235b-a22b")).replace(act_bits=32)
    if view == "pow2":
        cfg = base.replace(quant=serving_pow2())
    else:
        cfg = base.replace(quant=QuantSpec(bits=4, constraint="pow2",
                                           min_size=512))
    cpu = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    serve = serve_view(cpu, pack4=view == "packed4",
                       policy=api.resolved_policy(cfg))
    toks = torch.randint(0, cfg.vocab, (3, 16),
                         generator=torch.Generator().manual_seed(5))
    want = generate(serve, cfg, {"tokens": toks}, steps=6, device="cpu")
    card = serve.to(cuda_device)
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, {"tokens": toks}, steps=6,
                           device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        stacked = delta[{"int8": 8, "packed4": 9, "pow2": 10}[view]]
        assert stacked == {"launches": 6 * 3 * cfg.n_layers, "plain": 0}
        assert sum(c.get("plain", 0) for c in delta) == 0


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b: MLA and its leaf shapes
# ---------------------------------------------------------------------------

#: (M, Kin, N) at deepseek's leaves: dkv (2048 -> 576, not a multiple of
#: 128: a partial n tile and, packed, its byte pairs), uk / uv (512 ->
#: 2048), the dense MLP (2048 <-> 1408) and a shared expert (2816 ->
#: 2048), at decode, a 4 x 96 and a 4 x 128 prefill
DS_CASES = [(4, 2048, 576), (384, 2048, 576), (512, 2048, 576),
            (1, 512, 2048), (4, 512, 2048), (512, 512, 2048),
            (4, 2048, 1408), (512, 1408, 2048), (4, 2816, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,Kin,N", DS_CASES)
@pytest.mark.parametrize("kernel,dtype", [
    ("lutq_matmul", "float32"), ("lutq_matmul", "bfloat16"),
    ("lutq_gemv_packed", "float32"), ("lutq_gemv_packed", "bfloat16"),
    ("lutq_shift", "int8")])
def test_cuda_kernels_at_deepseek_shapes(cuda_device, kernel, dtype, M,
                                         Kin, N):
    """The GEMMs within their tolerance of the plain version and
    lutq_shift bit for bit at deepseek's shapes, a second call giving
    the first call's bits."""
    if kernel == "lutq_shift":
        xq, a, wsh = _shift_operands(M, Kin, N, 16,
                                     torch.Generator().manual_seed(3))
        args = [t.to(cuda_device) for t in (xq, a, wsh)]
        got = lutq_shift.lutq_shift(*args)
        assert torch.equal(got.cpu(), lutq_shift_ref(xq, a, wsh))
        assert torch.equal(lutq_shift.lutq_shift(*args), got)
        return
    fn, plain, cpu_args, card_args = _gemm_operands(
        kernel, M, Kin, N, getattr(torch, dtype), cuda_device)
    got = fn(*card_args)
    want = plain(*cpu_args)
    tol = 1e-4 if dtype == "float32" else 1e-3
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= tol, err
    assert torch.equal(fn(*card_args), got)


def _deepseek_serve(view, cuda_device=None):
    """Reduced deepseek (3 layers, the first dense; MLA kv_lora 24) at
    act_bits 32 under a floor-0 policy (every MLA leaf quantized): the
    config and its serve view (int8, packed4 or calibrated
    serving_pow2), on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2, with_size_floor
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    base = reduced(get_config("deepseek-v2-lite-16b")).replace(act_bits=32)
    if view == "pow2":
        cfg = base.replace(quant=with_size_floor(serving_pow2(), 0))
    else:
        cfg = base.replace(quant=QuantSpec(bits=4, constraint="pow2",
                                           min_size=0))
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    toks = torch.randint(0, cfg.vocab, (3, 16),
                         generator=torch.Generator().manual_seed(5))
    if view == "pow2":
        model = api.calibrate(model, cfg, {"tokens": toks[:2]})
    return cfg, serve_view(model, pack4=view == "packed4",
                           policy=api.resolved_policy(cfg)), toks


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_mla_decode_step_replays_as_eager(cuda_device, view):
    """The MLA decode step (absorbed form: uk / uv decoded in the step,
    the latent written in place at the cache length) captured as a CUDA
    graph and replayed equals the eager step bit for bit: logits, c_kv
    and k_rope; a second replay at the next length too."""
    from repro_torch.models import api
    from repro_torch.runtime import serving

    cfg, serve, toks = _deepseek_serve(view)
    card = serve.to(cuda_device)
    with torch.inference_mode():
        _, cache = api.prefill(card, cfg, {"tokens": toks.to(cuda_device)})
        cache = serving.adapt_prefill_cache(cfg, cache, 3, 20)
        eager = {"layers": [{k: v.clone() for k, v in c.items()}
                            for c in cache["layers"]],
                 "len": cache["len"].clone()}
        graphed = {"layers": [{k: v.clone() for k, v in c.items()}
                              for c in cache["layers"]],
                   "len": cache["len"].clone()}
        tok = torch.randint(0, cfg.vocab, (3, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(6)
                            ).to(cuda_device)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        warm = {"layers": [{k: v.clone() for k, v in c.items()}
                           for c in cache["layers"]],
                "len": cache["len"].clone()}
        with torch.cuda.stream(stream):
            api.decode_step(card, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.decode_step(card, cfg, tok, graphed)
        for step in range(2):
            graph.replay()
            want, after = api.decode_step(card, cfg, tok, eager)
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
            for g, e in zip(graphed["layers"], eager["layers"]):
                for k in ("c_kv", "k_rope"):
                    assert torch.equal(g[k], e[k]), (step, k)
            assert torch.equal(nxt["len"], after["len"])
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_deepseek_serves_the_cpu_tokens(cuda_device, view):
    """Reduced deepseek served on the card through kernels 1, 2, 4 and
    their stacks, graph-replayed and eager, gives the CPU's greedy
    tokens; three stacked launches a MoE layer a forward, no plain
    version on the card."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, toks = _deepseek_serve(view)
    want = generate(serve, cfg, {"tokens": toks}, steps=6, device="cpu")
    card = serve.to(cuda_device)
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, {"tokens": toks}, steps=6,
                           device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        stacked = delta[{"int8": 8, "packed4": 9, "pow2": 10}[view]]
        n_moe = cfg.n_layers - cfg.first_dense
        assert stacked == {"launches": 6 * 3 * n_moe, "plain": 0}
        assert sum(c.get("plain", 0) for c in delta) == 0


# ---------------------------------------------------------------------------
# seamless-m4t-medium: the encdec family (kernel 6 at G = 1, dh 64)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["g1", "g1_splits", "g1_engine"])
@pytest.mark.parametrize("budget", [None, 0], ids=["plan", "workspace"])
def test_cuda_paged_attention_g1_dh64(cuda_device, budget, shape):
    """Both variants at seamless's G = 1, dh 64 (16 KV heads), bf16 q
    over bf16 pages: each row within 2^-7 of its own max|plain| (an
    empty row exactly 0), a second call and NaN dead pages giving the
    same bits, and a CUDA graph replay equal to the eager call."""
    bf16 = torch.bfloat16
    q, kp, vp, block, cl, ks, vs, window = _paged_operands(
        shape, bf16, bf16, cuda_device)
    poisoned = _paged_operands(shape, bf16, bf16, cuda_device,
                               poison=True)[3]

    def call(blk=block, w=window):
        return paged_attn.paged_attention(q, kp, vp, blk, cl, window=w,
                                          smem_budget_bytes=budget)
    for w in (None, window):
        want = paged_attention_ref(q, kp, vp, block, cl, window=w)
        got = call(w=w)
        assert got.dtype == bf16 and _rows_within(got, want, PAGED_TOL[bf16])
    outs = [call(), call(), call(poisoned)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, outs[0])


def _seamless_serve(view, act_bits=32):
    """Reduced seamless (2 + 2 layers, 4 / 4 heads of 16, vocab 211) at
    ``act_bits``: the config, its serve view (int8, packed4 or calibrated
    serving_pow2) on the CPU, and a batch of 3 x 12 tokens over 10
    seeded frames."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    cfg = reduced(get_config("seamless-m4t-medium")).replace(
        act_bits=act_bits)
    if view == "pow2":
        cfg = cfg.replace(quant=serving_pow2())
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (3, 12), generator=g),
             "frames": torch.randn((3, 10, cfg.d_model), generator=g)}
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    if view == "pow2":
        model = api.calibrate(model, cfg, {k: v[:2] for k, v in batch.items()})
    return cfg, serve_view(model, pack4=view == "packed4",
                           policy=api.resolved_policy(cfg)), batch


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4"])
def test_cuda_encdec_paged_step_replays_as_eager(cuda_device, view):
    """The encdec paged decode step (self-attention through kernel 6,
    cross-attention masked by the rows' src_len on the device) captured
    as a CUDA graph equals the eager step bit for bit, logits and pages,
    at two successive lengths."""
    from repro_torch.models import api
    from repro_torch.models import encdec

    cfg, serve, batch = _seamless_serve(view)
    card = serve.to(cuda_device)
    B, P = batch["tokens"].shape

    def paged():
        c = api.init_paged_cache(cfg, B, 8, 8, 3, src_len=12,
                                 device="cuda")
        with torch.inference_mode():
            for i in range(B):
                b = {k: v[i:i + 1].to(cuda_device) for k, v in batch.items()}
                _, pc = api.prefill(card, cfg, b)
                row = torch.tensor([1 + 2 * i, 2 + 2 * i, 0],
                                   dtype=torch.int32, device=cuda_device)
                encdec.encdec_paged_splice(cfg, c, pc["layers"], row, P, i)
                c["block"][i] = row
                c["len"][i] = P
                c["src_len"][i] = 10
        return c
    eager, graphed, warm = paged(), paged(), paged()
    tok = torch.randint(0, cfg.vocab, (B, 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(6)
                        ).to(cuda_device)
    with torch.inference_mode():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            api.paged_decode_step(card, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.paged_decode_step(card, cfg, tok, graphed)
        for step in range(2):
            before = paged_attn.COUNTS["launches"]
            want, after = api.paged_decode_step(card, cfg, tok, eager)
            assert paged_attn.COUNTS["launches"] - before == cfg.n_layers
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
            for g, e in zip(graphed["pool"], eager["pool"]):
                assert torch.equal(g["k"], e["k"]) and torch.equal(g["v"],
                                                                   e["v"])
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]


@pytest.mark.cuda
def test_cuda_encdec_paged_engine_graph_and_speculative(cuda_device):
    """The paged encdec engine on the card (page 8, 2 slots, ragged
    sources of 10, 6 and 12 frames), plain and speculative (k = 2),
    with its captured decode step and greedy round and eagerly, gives
    every request its lone generate's tokens; kernel 6 launches
    n_layers times a step, (2k + 1) n_layers a round; no plain
    version."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine, disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, _ = _seamless_serve("int8")
    card = serve.to(cuda_device)
    g = torch.Generator().manual_seed(8)
    frames = [torch.randn((s, cfg.d_model), generator=g) for s in (10, 6, 12)]
    toks = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in (5, 11, 8)]
    lone = [generate(card, cfg, {"tokens": t[None], "frames": f[None]},
                     steps=4, max_len=20, device="cuda")[0].cpu()
            for t, f in zip(toks, frames)]
    for k in (0, 2):
        for graphs in (True, False):
            with contextlib.ExitStack() as stack:
                if not graphs:
                    stack.enter_context(disable_graphs())
                eng = Engine(card, cfg, capacity=2, max_len=20, src_len=12,
                             kv_pages=12, page_size=8, speculative=k,
                             device="cuda")
                before = ops.read_counts()
                for t, f in zip(toks, frames):
                    eng.submit(t, max_new=4, frames=f)
                res = eng.run()
                delta = ops.count_delta(before)
            st = eng.stats()
            steps = st["spec_rounds"] if k else st["decode_steps"]
            assert st["paged"] and eng.paged_trace_counts()["decode"] == int(
                graphs)
            for r, want in zip(res, lone):
                assert torch.equal(torch.as_tensor(r["tokens"]), want)
            assert delta[4]["launches"] == cfg.n_layers * (2 * k + 1) * steps
            assert sum(c.get("plain", 0) for c in delta) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_seamless_serves_the_cpu_tokens(cuda_device, view):
    """Reduced seamless served on the card (graph-replayed and eager)
    gives the CPU's greedy tokens: 36 body launches a prefill and 18 a
    decode step of the view's kernel, the tied head on kernel 1 (int8,
    and packed4 at the reduced odd vocab), no plain version."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, batch = _seamless_serve(view)
    want = generate(serve, cfg, batch, steps=6, device="cpu")
    card = serve.to(cuda_device)
    idx = {"int8": 0, "packed4": 1, "pow2": 2}[view]
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, batch, steps=6, device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        body = 7 * 2 + 11 * 2 + 5 * 9 * 2
        head = 0 if view == "pow2" else 6
        assert delta[idx]["launches"] == body + (head if view == "int8"
                                                 else 0)
        assert delta[0]["launches"] == (body if view == "int8" else 0) + head
        assert sum(c.get("plain", 0) for c in delta) == 0


# ---------------------------------------------------------------------------
# paligemma-3b: the vlm family (the 526.8 M-entry tied table)
# ---------------------------------------------------------------------------

#: paligemma's tied table: 257216 x 2048 f32 weights, 2.107 GB (its byte
#: offsets pass 2^31); the int8 view's head reads it transposed, N = 257216
PG_TABLE = (257216, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
def test_cuda_kmeans_stats_past_2_31_bytes(cuda_device, offset):
    """kmeans_stats over paligemma's 526.8 M-weight table (aligned, and 3
    elements into a buffer: a scalar head), one launch: assignments and
    counts equal to the plain version's, each entry's sum within 1e-5 of
    its sum|w|; the last weights (past 2^31 bytes) assigned too."""
    g = torch.Generator(device=cuda_device).manual_seed(offset)
    n = PG_TABLE[0] * PG_TABLE[1]
    buf = torch.randn(n + offset, generator=g, device=cuda_device) * 0.02
    w = buf[offset:]
    d = torch.sort(torch.randn(16, generator=g, device=cuda_device)
                   * 0.02).values
    before = dict(kmeans_stats.COUNTS)
    a1, s1, c1 = kmeans_stats.kmeans_stats(w, d)
    assert kmeans_stats.COUNTS["launches"] == before["launches"] + 1
    a0, s0, c0 = kmeans_stats_ref(w, d)
    assert torch.equal(a1, a0) and torch.equal(c1, c0)
    assert int(c0.sum()) == n
    mag = torch.zeros(16, dtype=torch.float64, device=cuda_device).index_add_(
        0, a0.view(torch.uint8).long(), w.abs().double()).float()
    assert ((s1 - s0).abs() <= 1e-5 * mag).all()
    tail = slice(n - 4099, n)
    assert torch.equal(a1[tail], a0[tail])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 9])
@pytest.mark.parametrize("kernel,dtype", [
    ("lutq_matmul", "float32"), ("lutq_matmul", "bfloat16"),
    ("lutq_shift", "int8")])
def test_cuda_kernels_on_the_paligemma_head(cuda_device, kernel, dtype, M):
    """Kernel 1 within its tolerance of the plain version and lutq_shift
    bit for bit on the transposed tied head (Kin 2048, N = 257216: a
    partial n tile of 64 at 128), a second call giving the first call's
    bits."""
    Kin, N = PG_TABLE[1], PG_TABLE[0]
    g = torch.Generator(device=cuda_device).manual_seed(M)
    if kernel == "lutq_shift":
        xq, a, wsh = (t.to(cuda_device) for t in _shift_operands(
            M, Kin, N, 16, torch.Generator().manual_seed(M)))
        got = lutq_shift.lutq_shift(xq, a, wsh)
        assert torch.equal(got, lutq_shift_ref(xq, a, wsh))
        assert torch.equal(lutq_shift.lutq_shift(xq, a, wsh), got)
        return
    x = torch.randn(M, Kin, generator=g, device=cuda_device).to(
        getattr(torch, dtype))
    a = torch.randint(0, 16, (Kin, N), generator=g, device=cuda_device,
                      dtype=torch.int8)
    d = torch.sort(torch.randn(16, generator=g, device=cuda_device)).values
    got = lutq_matmul.lutq_matmul(x, a, d)
    want = lutq_matmul_ref(x, a, d)
    tol = 1e-4 if dtype == "float32" else 1e-3
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max() / want.abs().max() <= tol
    assert torch.equal(lutq_matmul.lutq_matmul(x, a, d), got)


def _paligemma_serve(view, act_bits=32):
    """Reduced paligemma (2 layers, 4 / 1 heads of 16, vocab 211, a
    prefix of 8) at ``act_bits``: the config, its serve view (int8,
    packed4 or calibrated serving_pow2) on the CPU, and a batch of 3 x
    12 tokens after a seeded prefix."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    cfg = reduced(get_config("paligemma-3b")).replace(act_bits=act_bits)
    if view == "pow2":
        cfg = cfg.replace(quant=serving_pow2())
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (3, 12), generator=g),
             "prefix_embeds": torch.randn((3, cfg.n_prefix_tokens,
                                           cfg.d_model), generator=g)}
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    if view == "pow2":
        model = api.calibrate(model, cfg, {k: v[:2] for k, v in batch.items()})
    return cfg, serve_view(model, pack4=view == "packed4",
                           policy=api.resolved_policy(cfg)), batch


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_vlm_decode_step_replays_as_eager(cuda_device, view):
    """A vlm decode step (the cache's len counting the 8 prefix slots)
    captured as a CUDA graph and replayed equals the eager step bit for
    bit: logits and every layer's K/V; a second replay at the next
    length too."""
    from repro_torch.models import api
    from repro_torch.runtime import serving

    cfg, serve, batch = _paligemma_serve(view)
    card = serve.to(cuda_device)
    width = cfg.n_prefix_tokens + 12 + 4

    def clone(c):
        return {"layers": [{k: v.clone() for k, v in layer.items()}
                           for layer in c["layers"]],
                "len": c["len"].clone()}

    with torch.inference_mode():
        _, cache = api.prefill(card, cfg, {k: v.to(cuda_device)
                                           for k, v in batch.items()})
        cache = serving.adapt_prefill_cache(cfg, cache, 3, width)
        assert cache["len"].tolist() == [cfg.n_prefix_tokens + 12] * 3
        eager, graphed, warm = clone(cache), clone(cache), clone(cache)
        tok = torch.randint(0, cfg.vocab, (3, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(8)
                            ).to(cuda_device)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            api.decode_step(card, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.decode_step(card, cfg, tok, graphed)
        for step in range(2):
            graph.replay()
            want, after = api.decode_step(card, cfg, tok, eager)
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
            for g, e in zip(graphed["layers"], eager["layers"]):
                for k in ("k", "v"):
                    assert torch.equal(g[k], e[k]), (step, k)
            assert torch.equal(nxt["len"], after["len"])
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_paligemma_serves_the_cpu_tokens(cuda_device, view):
    """Reduced paligemma served on the card (graph-replayed and eager)
    after its image prefix gives the CPU's greedy tokens: 10 body
    launches a forward of the view's kernel (the config's size floor,
    4096, leaves the reduced k and v float), the tied head on kernel 1
    (int8, and packed4 at the reduced odd vocab), no plain version."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, batch = _paligemma_serve(view)
    want = generate(serve, cfg, batch, steps=6, device="cpu")
    card = serve.to(cuda_device)
    idx = {"int8": 0, "packed4": 1, "pow2": 2}[view]
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, batch, steps=6, device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        body = 5 * 2 * 6
        head = 0 if view == "pow2" else 6
        assert delta[idx]["launches"] == body + (head if view == "int8"
                                                 else 0)
        assert delta[0]["launches"] == (body if view == "int8" else 0) + head
        assert sum(c.get("plain", 0) for c in delta) == 0


# ---------------------------------------------------------------------------
# zamba2-2.7b: the hybrid family (Mamba2 state updated in place)
# ---------------------------------------------------------------------------

#: zamba's (Kin, N) products: in_proj (2 x 5120 + 2 x 64 + 80 = 10448:
#: a partial n tile of 64), out_proj, the shared block's MLP
ZB_SHAPES = [(2560, 10448), (5120, 2560), (2560, 10240), (10240, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 9, 128])
@pytest.mark.parametrize("Kin,N", ZB_SHAPES)
@pytest.mark.parametrize("kernel,dtype", [
    ("lutq_matmul", "float32"), ("lutq_matmul", "bfloat16"),
    ("lutq_gemv_packed", "bfloat16"), ("lutq_shift", "int8")])
def test_cuda_kernels_at_zamba_shapes(cuda_device, kernel, dtype, Kin, N, M):
    """Kernels 1 and 2 within their tolerance of the plain version and
    lutq_shift bit for bit at zamba's product shapes, a second call
    giving the first call's bits."""
    if kernel == "lutq_shift":
        xq, a, wsh = (t.to(cuda_device) for t in _shift_operands(
            M, Kin, N, 16, torch.Generator().manual_seed(M)))
        got = lutq_shift.lutq_shift(xq, a, wsh)
        assert torch.equal(got, lutq_shift_ref(xq, a, wsh))
        assert torch.equal(lutq_shift.lutq_shift(xq, a, wsh), got)
        return
    fn, plain, _, args = _gemm_operands(kernel, M, Kin, N,
                                        getattr(torch, dtype), cuda_device)
    got, want = fn(*args), plain(*args)
    tol = 1e-4 if dtype == "float32" else 1e-3
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max() / want.abs().max() <= tol
    assert torch.equal(fn(*args), got)


def _zamba_serve(view, act_bits=32):
    """Reduced zamba (4 Mamba2 layers in 2 super-blocks, d_inner 128,
    vocab 211) at ``act_bits``: the config, its serve view (int8, packed4
    or calibrated serving_pow2 with its floor at 1024, so that conv_w is
    pow2-encoded) on the CPU, and a batch of 3 x 13 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2, with_size_floor
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    cfg = reduced(get_config("zamba2-2.7b")).replace(
        act_bits=act_bits, quant=QuantSpec(bits=4, constraint="pow2",
                                           min_size=1024))
    if view == "pow2":
        cfg = cfg.replace(quant=with_size_floor(serving_pow2(), 1024))
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (3, 13), generator=g)}
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    if view == "pow2":
        model = api.calibrate(model, cfg, {"tokens": batch["tokens"][:2]})
    return cfg, serve_view(model, pack4=view == "packed4",
                           policy=api.resolved_policy(cfg)), batch


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_hybrid_decode_step_replays_and_advances(cuda_device, view):
    """The hybrid decode step captured once as a CUDA graph and replayed
    three times equals three eager steps bit for bit: logits, every SSM
    state, conv window and K/V after each; each replay moves the state
    (a replay that re-read the captured state would repeat itself)."""
    from repro_torch.models import api
    from repro_torch.runtime import serving

    cfg, serve, batch = _zamba_serve(view)
    card = serve.to(cuda_device)

    def clone(c):
        return {"layers": [{k: v.clone() for k, v in layer.items()}
                           for layer in c["layers"]],
                "len": c["len"].clone()}

    with torch.inference_mode():
        _, cache = api.prefill(card, cfg, {"tokens": batch["tokens"].to(
            cuda_device)})
        cache = serving.adapt_prefill_cache(cfg, cache, 3, 13 + 6)
        eager, graphed, warm = clone(cache), clone(cache), clone(cache)
        tok = torch.randint(0, cfg.vocab, (3, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(8)
                            ).to(cuda_device)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            api.decode_step(card, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.decode_step(card, cfg, tok, graphed)
        prev = graphed["layers"][0]["ssm"].clone()
        for step in range(3):
            graph.replay()
            want, after = api.decode_step(card, cfg, tok, eager)
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
            for g, e in zip(graphed["layers"], eager["layers"]):
                for k in g:
                    assert torch.equal(g[k], e[k]), (step, k)
            assert not torch.equal(graphed["layers"][0]["ssm"], prev), step
            prev = graphed["layers"][0]["ssm"].clone()
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_zamba_serves_the_cpu_tokens(cuda_device, view):
    """Reduced zamba served on the card (graph-replayed and eager) gives
    the CPU's greedy tokens: 22 body launches a forward of the view's
    kernel (in_proj and out_proj a Mamba layer, the shared block's 7
    twice), the tied head on kernel 1 (int8, and packed4 at the reduced
    odd vocab), no plain version; and a 2-slot engine over prompts of 5,
    13 and 8 tokens the CPU engine's."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine, disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, batch = _zamba_serve(view)
    want = generate(serve, cfg, batch, steps=6, device="cpu")

    def engine(model, dev):
        eng = Engine(model, cfg, capacity=2, max_len=20, device=dev)
        for i, L in enumerate((5, 13, 8)):
            eng.submit(batch["tokens"][i, :L].numpy(), max_new=5)
        return [r["tokens"].tolist() for r in eng.run()]

    want_eng = engine(serve, "cpu")
    card = serve.to(cuda_device)
    idx = {"int8": 0, "packed4": 1, "pow2": 2}[view]
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, batch, steps=6, device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        body = 22 * 6
        head = 0 if view == "pow2" else 6
        assert delta[idx]["launches"] == body + (head if view == "int8"
                                                 else 0)
        assert delta[0]["launches"] == (body if view == "int8" else 0) + head
        assert sum(c.get("plain", 0) for c in delta) == 0
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            assert engine(card, "cuda") == want_eng


# ---------------------------------------------------------------------------
# rwkv6-1.6b: the ssm family (WKV state and token shifts updated in place)
# ---------------------------------------------------------------------------

#: rwkv's (Kin, N) products no other family has: the decay LoRA's w1 (N =
#: 64) and w2 (Kin = 64, one pipeline stage), the channel-mix's cm_k and
#: cm_v
RW_SHAPES = [(2048, 64), (64, 2048), (2048, 7168), (7168, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 9, 128, 256])
@pytest.mark.parametrize("Kin,N", RW_SHAPES)
@pytest.mark.parametrize("kernel,dtype", [
    ("lutq_matmul", "float32"), ("lutq_gemv_packed", "float32"),
    ("lutq_shift", "int8")])
def test_cuda_kernels_at_rwkv_shapes(cuda_device, kernel, dtype, Kin, N, M):
    """Kernels 1 and 2 on f32 x (rwkv's residual stream is f32, so are
    its products' activations) within 1e-4 of the plain version, and
    lutq_shift bit for bit, at rwkv's product shapes; a second call
    gives the first call's bits."""
    if kernel == "lutq_shift":
        xq, a, wsh = (t.to(cuda_device) for t in _shift_operands(
            M, Kin, N, 16, torch.Generator().manual_seed(M)))
        got = lutq_shift.lutq_shift(xq, a, wsh)
        assert torch.equal(got, lutq_shift_ref(xq, a, wsh))
        assert torch.equal(lutq_shift.lutq_shift(xq, a, wsh), got)
        return
    fn, plain, _, args = _gemm_operands(kernel, M, Kin, N,
                                        getattr(torch, dtype), cuda_device)
    got, want = fn(*args), plain(*args)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert (got - want).abs().max() / want.abs().max() <= 1e-4
    assert torch.equal(fn(*args), got)


def _rwkv_serve(view, act_bits=32):
    """Reduced rwkv (2 layers, d_model 64 = 4 WKV heads of 16, vocab 211)
    at ``act_bits``: the config, its serve view (int8, packed4 or
    calibrated serving_pow2) on the CPU, and a batch of 3 x 13 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import serve_view
    from repro_torch.core.rules import serving_pow2
    from repro_torch.core.spec import QuantSpec
    from repro_torch.models import api
    from repro_torch.models.reduce import reduced

    cfg = reduced(get_config("rwkv6-1.6b")).replace(
        act_bits=act_bits, quant=QuantSpec(bits=4, constraint="pow2"))
    if view == "pow2":
        cfg = cfg.replace(quant=serving_pow2())
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (3, 13), generator=g)}
    model = api.quantize(api.init(cfg, seed=0, device="cpu"), cfg)
    if view == "pow2":
        model = api.calibrate(model, cfg, {"tokens": batch["tokens"][:2]})
    return cfg, serve_view(model, pack4=view == "packed4",
                           policy=api.resolved_policy(cfg)), batch


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_ssm_decode_step_replays_and_advances(cuda_device, view):
    """The ssm decode step captured once as a CUDA graph and replayed
    three times equals three eager steps bit for bit: logits, every WKV
    state and token-shift row after each; each replay moves the state (a
    replay that re-read the captured state would repeat itself). The
    same step from a copy of the cache whose WKV states and shift rows
    are zeroed lands at least 1.25 x 1e-3 a layer of max |logit| away
    from the true step, so that a lost state would show."""
    from repro_torch.models import api
    from repro_torch.runtime import serving

    cfg, serve, batch = _rwkv_serve(view)
    card = serve.to(cuda_device)

    def clone(c):
        return {"layers": [{k: v.clone() for k, v in layer.items()}
                           for layer in c["layers"]],
                "len": c["len"].clone()}

    with torch.inference_mode():
        _, cache = api.prefill(card, cfg, {"tokens": batch["tokens"].to(
            cuda_device)})
        cache = serving.adapt_prefill_cache(cfg, cache, 3, 13 + 6)
        eager, graphed, warm, zeroed = (clone(cache) for _ in range(4))
        for layer in zeroed["layers"]:
            for t in layer.values():
                t.zero_()
        tok = torch.randint(0, cfg.vocab, (3, 1), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(8)
                            ).to(cuda_device)
        lost = api.decode_step(card, cfg, tok, zeroed)[0]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            api.decode_step(card, cfg, tok, warm)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, nxt = api.decode_step(card, cfg, tok, graphed)
        prev = graphed["layers"][0]["wkv"].clone()
        for step in range(3):
            graph.replay()
            want, after = api.decode_step(card, cfg, tok, eager)
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
            if step == 0:
                apart = ((lost - want).abs().max() / want.abs().max())
                assert apart >= 1.25 * 1e-3 * cfg.n_layers
            for g, e in zip(graphed["layers"], eager["layers"]):
                for k in g:
                    assert torch.equal(g[k], e[k]), (step, k)
            assert not torch.equal(graphed["layers"][0]["wkv"], prev), step
            prev = graphed["layers"][0]["wkv"].clone()
            graphed["len"].copy_(nxt["len"])
            eager["len"] = after["len"]


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["int8", "packed4", "pow2"])
def test_cuda_rwkv_serves_the_cpu_tokens(cuda_device, view):
    """Reduced rwkv served on the card (graph-replayed and eager) gives
    the CPU's greedy tokens: 20 body launches a forward of the view's
    kernel (10 a layer, w1 and w2 among them), the tied head on kernel 1
    (int8, and packed4 at the reduced odd vocab), no plain version; and a
    2-slot engine over prompts of 5, 13 and 8 tokens the CPU engine's."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine, disable_graphs
    from repro_torch.runtime.serving import generate

    cfg, serve, batch = _rwkv_serve(view)
    want = generate(serve, cfg, batch, steps=6, device="cpu")

    def engine(model, dev):
        eng = Engine(model, cfg, capacity=2, max_len=20, device=dev)
        for i, L in enumerate((5, 13, 8)):
            eng.submit(batch["tokens"][i, :L].numpy(), max_new=5)
        return [r["tokens"].tolist() for r in eng.run()]

    want_eng = engine(serve, "cpu")
    card = serve.to(cuda_device)
    idx = {"int8": 0, "packed4": 1, "pow2": 2}[view]
    for graphs in (True, False):
        before = ops.read_counts()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            got = generate(card, cfg, batch, steps=6, device="cuda")
        delta = ops.count_delta(before)
        assert torch.equal(got.cpu(), want)
        body = 20 * 6
        head = 0 if view == "pow2" else 6
        assert delta[idx]["launches"] == body + (head if view == "int8"
                                                 else 0)
        assert delta[0]["launches"] == (body if view == "int8" else 0) + head
        assert sum(c.get("plain", 0) for c in delta) == 0
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            assert engine(card, "cuda") == want_eng
