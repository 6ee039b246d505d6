// Fused LUT-decode matmul over int8 assignments: y = x @ d[A].
//
// Replaces the TPU kernel src/repro/kernels/lutq_matmul.py::lutq_matmul
// (body _kernel), the `fused` backend of kernels/ops.lutq_dot.
//
// Bound on the H100: at decode (M = 4) the kernel reads 1 byte per weight
// and does 2 * M flops on it, far below the ~295 flops per byte where
// bf16 tensor cores become the limit, so device-memory bytes bound it
// (Kin * N index bytes at 3.35 TB/s). At prefill (M = 512) it does 1024
// flops per index byte and bf16 tensor-core throughput bounds it.
//
// What the design does about it: the assignments stream from device
// memory once, as int8, coalesced 16 bytes a thread; the decode to
// bf16/f32 happens in shared memory against a shared-memory dictionary,
// so no decoded weight is ever written back. Decode shapes, which have
// few output tiles, split the reduction over more blocks to keep all
// SMs reading (fixed-order second pass); prefill shapes use 64 x 128
// tiles on WMMA bf16 tensor-core products. See lutq_gemm.cuh.
#include "lutq_gemm.cuh"

extern "C" int lutq_matmul_launch(int device, const void* x, int x_bf16, const void* a,
                                  int vec, const void* d, int n_dict,
                                  void* y, void* part, int M, int N, int Kin,
                                  int splits, int kchunk, void* stream) {
  return launch<false>(device, x, x_bf16, a, vec, d, n_dict, y, part, M, N, Kin,
                       splits, kchunk, static_cast<cudaStream_t>(stream));
}
