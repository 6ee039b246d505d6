"""The CUDA kernels against their plain versions, on an NVIDIA card.

Marked ``cuda``: skipped (from a fixture) where there is no card. This
file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src:tests python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance, relative to the output's scale: 1e-4 for f32 x (f32
accumulation in another order), 1e-3 for bf16 x (tensor-core bf16
products accumulated in f32).
"""
import pytest
import torch

from repro_torch.kernels import lutq_gemv_packed, lutq_matmul
from repro_torch.kernels.ref import (lutq_gemv_packed_ref, lutq_matmul_ref,
                                     pack4_kin)


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
