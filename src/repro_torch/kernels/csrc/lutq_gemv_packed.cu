// Packed 4-bit LUT-decode matmul: y = x @ d[unpack4(P)], P (Kin/2, N).
//
// Replaces the TPU kernel src/repro/kernels/lutq_gemv_packed.py::
// lutq_gemv_packed (body _kernel), the `packed4` backend of
// kernels/ops.lutq_dot. It serves every M: the auto backend sends the
// prefill of a packed tree through it too.
//
// Bound on the H100: at decode (M = 4) it reads half a byte per weight,
// so device-memory bytes bound it (Kin * N / 2 bytes at 3.35 TB/s: one
// 2560 x 6912 MLP kernel is 8.85 MB, about 2.7 us). At prefill
// (M = 512) bf16 tensor-core throughput bounds it.
//
// What the design does about it: packed bytes stay packed in device
// memory and are read coalesced 8 bytes a thread; each byte is split
// into its two nibbles (row 2i low, row 2i + 1 high) and decoded against
// the shared-memory dictionary into a shared-memory tile, never written
// back. At small M the reduction is split over enough blocks to fill all
// 132 SMs, and the per-split partials are summed by a second pass in a
// fixed order, so results are the same on every run. See lutq_gemm.cuh.
#include "lutq_gemm.cuh"

extern "C" int lutq_gemv_packed_launch(int device, const void* x, int x_bf16,
                                       const void* p, int vec, const void* d,
                                       int n_dict, void* y, void* part, int M,
                                       int N, int Kin, int splits, int kchunk,
                                       void* stream) {
  return launch<true>(device, x, x_bf16, p, vec, d, n_dict, y, part, M, N, Kin,
                      splits, kchunk, static_cast<cudaStream_t>(stream));
}
