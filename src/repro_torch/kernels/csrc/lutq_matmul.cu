// Fused LUT-decode matmul over int8 assignments: y = x @ d[A].
//
// Replaces the TPU kernel src/repro/kernels/lutq_matmul.py::lutq_matmul
// (body _kernel), the `fused` backend of kernels/ops.lutq_dot, and its
// jax.vmap over a MoE layer's experts (src/repro/nn/moe.py::_expert_dot):
// an expert stack is one launch, a grid dimension selecting the expert
// (kernels/ops.lutq_dot_experts).
//
// Bound on the H100: at decode (M = 4 or 8) the kernel reads 1 byte per
// weight and does 2 M flops on it, far below the ~295 flops per byte
// where bf16 tensor cores become the limit, so device-memory bytes bound
// it (Kin * N index bytes at 3.35 TB/s). At prefill (M = 512) it does
// 1024 flops per index byte and bf16 tensor-core throughput bounds it.
//
// What the design does about it (lutq_gemm.cuh): the assignments stream
// from device memory once, as bytes, through a cp.async ring; each warp
// decodes its bytes straight into tensor-core A fragments in registers
// (K <= 16: two rows' indices merged into one byte select a bf16 pair
// from a per-lane shared table; K = 256: a 512-byte shared table of bf16
// entries), so no decoded weight is written anywhere. Prefill runs 64 x
// 128 output tiles on mma.sync and 128 x 256 tiles on wgmma; decode runs
// 8 x 256 or 16 x 256 tiles with the reduction split over enough blocks
// to keep every SM's bytes in flight, the splits merged inside the
// kernel by the last block of each tile (integer ticket, fixed order):
// one launch a call.
#include "lutq_gemm.cuh"

// experts > 1: an expert stack (x (E, M, Kin), its assignments and
// dictionaries stacked the same way, y (E, M, N)) in one launch.
extern "C" int lutq_matmul_launch(int device, const void* x, int x_bf16, const void* a,
                                  int avec, int xvec, const void* d, int n_dict, void* y,
                                  void* part, void* ticket, int M, int N, int Kin, int bm,
                                  int bn, int splits, int kchunk, int experts, void* stream) {
  return launch<false>(device, x, x_bf16, a, avec, xvec, d, n_dict, y, part, ticket, M, N,
                       Kin, bm, bn, splits, kchunk, experts, static_cast<cudaStream_t>(stream));
}
