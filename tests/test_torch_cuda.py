"""The CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: skipped (from a fixture) where there is no card. This
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src:tests python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance of the GEMMs, relative to the output's scale: 1e-4 for f32 x
(f32 accumulation in another order), 1e-3 for bf16 x (tensor-core bf16
products accumulated in f32). ``kmeans_stats``: assignments equal byte
for byte and counts exactly equal; each entry's sum within 1e-5 of the
sum of |w| over that entry (f32 accumulation in another order).
"""
import pytest
import torch

from repro_torch.kernels import kmeans_stats, lutq_gemv_packed, lutq_matmul
from repro_torch.kernels.ref import (kmeans_stats_ref, lutq_gemv_packed_ref,
                                     lutq_matmul_ref, pack4_kin)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested against JAX "
                    "in tests/test_torch_kernels.py)")
    return torch.device("cuda")


CUDA_CASES = [(1, 96, 211), (3, 2560, 640), (17, 64, 130), (96, 128, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,Kin,N", CUDA_CASES)
@pytest.mark.parametrize("kernel", ["lutq_matmul", "lutq_gemv_packed"])
def test_cuda_kernel_matches_plain(cuda_device, kernel, M, Kin, N, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, Kin, generator=g).to(getattr(torch, dtype))
    K = 16
    a = torch.randint(0, K, (Kin, N), generator=g, dtype=torch.int8)
    d = torch.sort(torch.randn(K, generator=g)).values
    if kernel == "lutq_matmul":
        fn, plain, idx = lutq_matmul.lutq_matmul, lutq_matmul_ref, a
    else:
        fn, plain, idx = (lutq_gemv_packed.lutq_gemv_packed,
                          lutq_gemv_packed_ref, pack4_kin(a))
    want = plain(x, idx, d)
    got = fn(x.to(cuda_device), idx.to(cuda_device), d.to(cuda_device))
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 1e-3
    err = (got.cpu() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


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


def _kmeans_case(N, K, ties, g):
    w = torch.randn(N, generator=g) * 0.05
    if ties:  # a dictionary whose midpoints are exactly weights
        d = torch.arange(K, dtype=torch.float32) - (K - 1) / 2.0
        w = (torch.randint(0, 2 * K, (N,), generator=g) - K) * 0.5
        w[: K - 1] = (d[:-1] + d[1:]) * 0.5
    else:
        d = torch.sort(torch.randn(K, generator=g) * 0.05).values
    return w, d


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,ties", [(2560 * 6912, 16, False),
                                      (2560 * 6912, 256, False),
                                      (1_000_003, 16, False),
                                      (4099, 16, True), (70_001, 256, True)])
def test_cuda_kmeans_stats_matches_plain(cuda_device, N, K, ties):
    w, d = _kmeans_case(N, K, ties, torch.Generator().manual_seed(N + K))
    a0, s0, c0 = kmeans_stats_ref(w, d)
    a1, s1, c1 = kmeans_stats.kmeans_stats(w.to(cuda_device),
                                           d.to(cuda_device))
    torch.cuda.synchronize()
    assert a1.dtype == torch.int8 and a1.shape == (N,)
    assert torch.equal(a1.cpu(), a0)
    assert torch.equal(c1.cpu(), c0)
    idx = a0.view(torch.uint8).long()
    mag = torch.zeros(K).index_add_(0, idx, w.abs())
    assert ((s1.cpu() - s0).abs() <= 1e-5 * mag).all()
