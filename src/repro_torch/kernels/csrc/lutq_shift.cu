// Shift-add LUT matmul of the multiplier-less pow2 path:
// acc (M, N) int32 = xq (M, Kin) int8 @ wsh[A], A (Kin, N) int8 read as
// unsigned bytes, wsh (K <= 256,) int32.
//
// Replaces the TPU kernel src/repro/kernels/lutq_shift.py::lutq_shift
// (body _kernel), the `pow2` backend of kernels/ops.lutq_dot. wsh is the
// pow2 dictionary lowered to integer shifts (sign * 2^(e - e_min),
// kernels/ref.pow2_shift_weights); the caller applies the one float
// multiply, acc * (act_scale * 2^e_min), at the O(M * N) epilogue.
//
// Exactness: every sum is int32, so the result equals the plain version
// (kernels/ref.lutq_shift_ref) bit for bit under any tiling and any order
// of the partial sums. The serve-time guard (core/policy._pow2_encodable:
// 7 + span + ceil(log2 Kin) <= 31) bounds |acc| by 127 * 2^span * Kin <
// 2^31, so no partial sum overflows (signed overflow would be undefined).
// Products are int32 multiplies, as the TPU kernel's dot_general is.
//
// Bound on the H100: at decode (M <= 8) the kernel reads 1 byte of A per
// weight and does M multiply-adds on it, so device-memory bytes bound it
// (Kin * N bytes at 3.35 TB/s). At prefill (M = 512) it does 512
// multiply-adds per byte; on CUDA cores (int32, no tensor cores here)
// those bound it long before the bytes do.
//
// Design:
//  * shift_gemv (M <= 8): 128 threads a block, 4 adjacent columns a
//    thread (one 4-byte load of A per reduction row, a warp reading 128
//    contiguous bytes), eight rows' loads in flight before the adds; wsh
//    and the block's xq rows sit in shared memory (the xq reads are
//    broadcasts); each thread keeps its M x 4 sums in registers.
//  * shift_gemm (M > 8): 64 x 128 output tiles, 32 reduction rows a step;
//    the xq tile (transposed) and the A tile, decoded against the
//    shared-memory wsh, are staged in shared memory as int32; each of the
//    256 threads owns a 4 x 8 register tile.
//  * Split-K: with few output tiles the wrapper splits the reduction over
//    the grid's last dimension, each block adding its int32 partial sums
//    into the zeroed output with atomicAdd. Integer addition is associative, so the order
//    the atomics land in does not change the result (no second pass).
//  * Ragged M, N and Kin are masked in the kernels: no padded copies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDict = 256;

// ---- decode shapes ---------------------------------------------------
constexpr int kGemvThreads = 128;
constexpr int kGemvCols = 4;                            // columns a thread
constexpr int kGemvBN = kGemvThreads * kGemvCols;       // 512
constexpr int kGemvMaxRows = 512;                       // kchunk at most
constexpr int kGemvUnroll = 8;                          // loads in flight

template <int BM>
__device__ __forceinline__ void gemv_row(int32_t (&acc)[BM][kGemvCols],
                                         uint32_t b, const int32_t* sw,
                                         int32_t (*sx)[kGemvMaxRows],
                                         int k) {
  int32_t w[kGemvCols];
#pragma unroll
  for (int j = 0; j < kGemvCols; ++j) w[j] = sw[(b >> (8 * j)) & 0xFFu];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const int32_t xv = sx[m][k];
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) acc[m][j] += xv * w[j];
  }
}

// grid (ceil(N / 512), splits); block y covers reduction rows
// [y * kchunk, min(Kin, (y + 1) * kchunk)).
template <int BM>
__global__ void __launch_bounds__(kGemvThreads)
    shift_gemv(const int8_t* __restrict__ xq, const uint8_t* __restrict__ a,
               const int32_t* __restrict__ wsh, int n_dict,
               int32_t* __restrict__ y, int M, int N, int Kin, int kchunk,
               int align, int atomic) {
  __shared__ int32_t sw[kMaxDict];
  __shared__ int32_t sx[BM][kGemvMaxRows];
  const int kbeg = blockIdx.y * kchunk;
  const int rows = min(Kin, kbeg + kchunk) - kbeg;
  for (int i = threadIdx.x; i < kMaxDict; i += kGemvThreads)
    sw[i] = i < n_dict ? wsh[i] : 0;
  for (int i = threadIdx.x; i < BM * rows; i += kGemvThreads) {
    const int m = i / rows, k = i % rows;
    sx[m][k] = m < M ? (int32_t)xq[(size_t)m * Kin + kbeg + k] : 0;
  }
  __syncthreads();

  const int c = blockIdx.x * kGemvBN + threadIdx.x * kGemvCols;
  if (c >= N) return;
  const int ncol = min(kGemvCols, N - c);
  int32_t acc[BM][kGemvCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) acc[m][j] = 0;

  const uint8_t* src = a + (size_t)kbeg * N + c;
  if (align >= 4 && ncol == kGemvCols) {
    int k = 0;
    for (; k + kGemvUnroll <= rows; k += kGemvUnroll) {
      uint32_t b[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u)
        b[u] = __ldg(reinterpret_cast<const uint32_t*>(src +
                                                       (size_t)(k + u) * N));
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u)
        gemv_row<BM>(acc, b[u], sw, sx, k + u);
    }
    for (; k < rows; ++k)
      gemv_row<BM>(acc,
                   __ldg(reinterpret_cast<const uint32_t*>(src +
                                                           (size_t)k * N)),
                   sw, sx, k);
  } else {
    // unaligned rows or the ragged last columns: byte loads; a missing
    // column reads index 0 and is never written
    for (int k = 0; k < rows; ++k) {
      uint32_t b = 0;
      for (int j = 0; j < ncol; ++j)
        b |= (uint32_t)src[(size_t)k * N + j] << (8 * j);
      gemv_row<BM>(acc, b, sw, sx, k);
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) {
      if (j >= ncol) break;
      int32_t* out = y + (size_t)m * N + c + j;
      if (atomic)
        atomicAdd(out, acc[m][j]);
      else
        *out = acc[m][j];
    }
  }
}

// ---- prefill shapes --------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kTR = 4, kTC = 8;  // thread tile: rows ty*4.., cols tx+16j

// grid (ceil(N / 128), ceil(M / 64), splits)
__global__ void __launch_bounds__(kThreads)
    shift_gemm(const int8_t* __restrict__ xq, const uint8_t* __restrict__ a,
               const int32_t* __restrict__ wsh, int n_dict,
               int32_t* __restrict__ y, int M, int N, int Kin, int kchunk,
               int align, int atomic) {
  __shared__ int32_t sw[kMaxDict];
  __shared__ int32_t Xs[kBK][kBM + 4];  // Xs[k][m]
  __shared__ int32_t Ws[kBK][kBN + 4];  // Ws[k][n]
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(Kin, kbeg + kchunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int i = threadIdx.x; i < kMaxDict; i += kThreads)
    sw[i] = i < n_dict ? wsh[i] : 0;

  int32_t acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0;

  // loaders: xq row xr, 8 reduction columns from xc; A row ar, 16
  // columns from ac
  const int xr = threadIdx.x >> 2, xc = (threadIdx.x & 3) * 8;
  const int ar = threadIdx.x >> 3, ac = (threadIdx.x & 7) * 16;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // previous step's reads done (and sw loaded)
    {
      const int gm = m0 + xr;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int gk = k0 + xc + u;
        Xs[xc + u][xr] =
            (gm < M && gk < kend) ? (int32_t)xq[(size_t)gm * Kin + gk] : 0;
      }
    }
    {
      const int gk = k0 + ar, gn = n0 + ac;
      union {
        uint4 v;
        uint8_t b[16];
      } idx;
      idx.v = make_uint4(0u, 0u, 0u, 0u);
      const bool row_ok = gk < kend;
      if (row_ok) {
        const uint8_t* src = a + (size_t)gk * N + gn;
        if (align >= 16 && gn + 16 <= N) {
          idx.v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (gn + j < N) idx.b[j] = src[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        Ws[ar][ac + j] = (row_ok && gn + j < N) ? sw[idx.b[j]] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      int32_t xv[kTR], wv[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) xv[i] = Xs[k][ty * kTR + i];
#pragma unroll
      for (int j = 0; j < kTC; ++j) wv[j] = Ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] += xv[i] * wv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int gm = m0 + ty * kTR + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      int32_t* out = y + (size_t)gm * N + gn;
      if (atomic)
        atomicAdd(out, acc[i][j]);
      else
        *out = acc[i][j];
    }
  }
}

template <int BM>
void launch_gemv(const int8_t* xq, const uint8_t* a, const int32_t* wsh,
                 int n_dict, int32_t* y, int M, int N, int Kin, int splits,
                 int kchunk, int align, cudaStream_t stream) {
  dim3 grid((N + kGemvBN - 1) / kGemvBN, splits);
  shift_gemv<BM><<<grid, kGemvThreads, 0, stream>>>(
      xq, a, wsh, n_dict, y, M, N, Kin, kchunk, align, splits > 1);
}

}  // namespace

// Returns the first CUDA error of the launches (0 on success), or -1 for
// a plan the kernels do not take. The library links its own CUDA
// runtime, whose current device is not the caller's: it is set here from
// the wrapper's device index. With splits > 1 the output is zeroed on
// the stream first, then the blocks add into it.
extern "C" int lutq_shift_launch(int device, const void* xq, const void* a,
                                 int align, const void* wsh, int n_dict,
                                 void* y, int M, int N, int Kin, int splits,
                                 int kchunk, void* stream_ptr) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const int32_t* wp = static_cast<const int32_t*>(wsh);
  int32_t* yp = static_cast<int32_t*>(y);
  if (n_dict < 1 || n_dict > kMaxDict || splits < 1 || kchunk < 1) return -1;
  if (splits > 1) {
    const cudaError_t z =
        cudaMemsetAsync(yp, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (z != cudaSuccess) return (int)z;
  }
  if (M <= 8) {
    if (kchunk > kGemvMaxRows) return -1;
    if (M == 1)
      launch_gemv<1>(xp, ap, wp, n_dict, yp, M, N, Kin, splits, kchunk,
                     align, stream);
    else if (M == 2)
      launch_gemv<2>(xp, ap, wp, n_dict, yp, M, N, Kin, splits, kchunk,
                     align, stream);
    else if (M <= 4)
      launch_gemv<4>(xp, ap, wp, n_dict, yp, M, N, Kin, splits, kchunk,
                     align, stream);
    else
      launch_gemv<8>(xp, ap, wp, n_dict, yp, M, N, Kin, splits, kchunk,
                     align, stream);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    shift_gemm<<<grid, kThreads, 0, stream>>>(xp, ap, wp, n_dict, yp, M, N,
                                              Kin, kchunk, align, splits > 1);
  }
  return (int)cudaGetLastError();
}
