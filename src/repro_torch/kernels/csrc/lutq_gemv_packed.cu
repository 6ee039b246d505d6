// Packed 4-bit LUT-decode matmul: y = x @ d[unpack4(P)], P (Kin/2, N).
//
// Replaces the TPU kernel src/repro/kernels/lutq_gemv_packed.py::
// lutq_gemv_packed (body _kernel), the `packed4` backend of
// kernels/ops.lutq_dot. It serves every M: the auto backend sends the
// prefill of a packed tree through it too, and an expert stack (the
// reference's jax.vmap of it in src/repro/nn/moe.py::_expert_dot) in one
// launch.
//
// Bound on the H100: at decode (M = 4 or 8) it reads half a byte per
// weight, so device-memory bytes bound it (Kin * N / 2 bytes at 3.35
// TB/s: one 2560 x 6912 MLP kernel is 8.85 MB, about 2.7 us). At
// prefill (M = 512) bf16 tensor-core throughput bounds it.
//
// What the design does about it (lutq_gemm.cuh): packed bytes stay
// packed in device memory and stream through a cp.async ring; each
// packed byte already holds the two reduction rows one tensor-core A
// register needs, so one shared load from a per-lane table of the 256
// bf16 pairs (d[low], d[high]) turns it into that register, never
// writing a decoded weight. Prefill runs 64 x 128 tiles on mma.sync and
// 128 x 256 tiles on wgmma; decode splits the reduction over enough
// blocks to fill all 132 SMs and the last block of each tile merges the
// splits in a fixed order (integer ticket): one launch a call, the same
// bits on every run.
#include "lutq_gemm.cuh"

// experts > 1: an expert stack (x (E, M, Kin), its assignments and
// dictionaries stacked the same way, y (E, M, N)) in one launch.
extern "C" int lutq_gemv_packed_launch(int device, const void* x, int x_bf16, const void* p,
                                  int avec, int xvec, const void* d, int n_dict, void* y,
                                  void* part, void* ticket, int M, int N, int Kin, int bm,
                                  int bn, int splits, int kchunk, int experts, void* stream) {
  return launch<true>(device, x, x_bf16, p, avec, xvec, d, n_dict, y, part, ticket, M, N,
                       Kin, bm, bn, splits, kchunk, experts, static_cast<cudaStream_t>(stream));
}
