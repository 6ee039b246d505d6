// Tiled LUT-decode GEMM shared by lutq_matmul.cu (int8 assignments) and
// lutq_gemv_packed.cu (two 4-bit assignments per byte).
//
// y (M, N) f32 = x (M, Kin) @ d[A], A (Kin, N), d (K <= 256,) f32.
//
// One block computes a BM x 128 output tile over one slice of the
// reduction axis. Each step of 32 reduction rows:
//   * the dictionary sits in shared memory (1 KB, loaded once);
//   * the x tile (BM x 32) is staged in shared memory;
//   * the index tile is read coalesced along N (16 bytes a thread for
//     int8, 8 packed bytes a thread for 4-bit), decoded against the
//     shared dictionary and written to shared memory already cast to
//     x's type, so the decoded weights never reach device memory;
//   * bf16 x: eight warps run WMMA 16x16x16 bf16 products with f32
//     accumulators; f32 x: every thread runs full-precision fmaf on a
//     (BM/8) x 4 register tile (no TF32).
// Ragged M, N and Kin are masked here: out-of-range x and weights are
// zero and out-of-range outputs are not written.
//
// Split-K: with few output tiles (decode, M <= 16) the wrapper splits the
// reduction over gridDim.z blocks; each writes its own f32 partial plane
// and reduce_splits sums the planes in a fixed order (z = 0, 1, ...),
// so results do not vary from run to run (no float atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // reduction rows per step
constexpr int kMaxDict = 256;  // dictionary entries held in shared memory
constexpr int kPad = 8;        // shared row padding, in elements

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

// x tile: rows m0.., reduction columns k0..; zero outside M and kend.
template <typename T, int BM>
__device__ __forceinline__ void load_x_tile(T (*Xs)[kBK + kPad],
                                            const T* __restrict__ x, int M,
                                            int Kin, int m0, int k0,
                                            int kend) {
  for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
    const int r = i / kBK, c = i % kBK;
    const int gm = m0 + r, gk = k0 + c;
    Xs[r][c] = (gm < M && gk < kend) ? x[(size_t)gm * Kin + gk]
                                     : Cvt<T>::from(0.f);
  }
}

// Weight tile from int8 (read as uint8) assignments: 32 rows of 128
// bytes, one 16-byte chunk per thread. Reading the byte unsigned makes a
// K=256 dictionary's int8 -128 entry 128, as the reference's take does.
template <typename T>
__device__ __forceinline__ void decode_tile_u8(T (*Ws)[kBN + kPad],
                                               const float* sdict,
                                               const uint8_t* __restrict__ a,
                                               int N, int k0, int kend,
                                               int n0, int vec) {
  const int r = threadIdx.x >> 3;
  const int c0 = (threadIdx.x & 7) * 16;
  const int gk = k0 + r, gn = n0 + c0;
  union {
    uint4 v;
    uint8_t b[16];
  } idx;
  idx.v = make_uint4(0u, 0u, 0u, 0u);
  const bool row_ok = gk < kend;
  if (row_ok) {
    const uint8_t* src = a + (size_t)gk * N + gn;
    if (vec && gn + 16 <= N) {
      idx.v = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (gn + j < N) idx.b[j] = src[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool ok = row_ok && gn + j < N;
    Ws[r][c0 + j] = Cvt<T>::from(ok ? sdict[idx.b[j]] : 0.f);
  }
}

// Weight tile from packed 4-bit assignments (Kin/2, N): 16 packed rows of
// 128 bytes, 8 bytes per thread. Packed row i holds reduction row 2i in
// the low nibble and 2i+1 in the high nibble. k0 and kend are even.
template <typename T>
__device__ __forceinline__ void decode_tile_u4(T (*Ws)[kBN + kPad],
                                               const float* sdict,
                                               const uint8_t* __restrict__ p,
                                               int N, int k0, int kend,
                                               int n0, int vec) {
  const int pr = threadIdx.x >> 4;
  const int c0 = (threadIdx.x & 15) * 8;
  const int gk = k0 + 2 * pr, gn = n0 + c0;
  union {
    uint2 v;
    uint8_t b[8];
  } pk;
  pk.v = make_uint2(0u, 0u);
  const bool row_ok = gk < kend;
  if (row_ok) {
    const uint8_t* src = p + (size_t)(gk >> 1) * N + gn;
    if (vec && gn + 8 <= N) {
      pk.v = __ldg(reinterpret_cast<const uint2*>(src));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gn + j < N) pk.b[j] = src[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool ok = row_ok && gn + j < N;
    Ws[2 * pr][c0 + j] = Cvt<T>::from(ok ? sdict[pk.b[j] & 0xF] : 0.f);
    Ws[2 * pr + 1][c0 + j] = Cvt<T>::from(ok ? sdict[pk.b[j] >> 4] : 0.f);
  }
}

template <typename T, int BM, bool PACKED>
__device__ __forceinline__ void load_step(T (*Xs)[kBK + kPad],
                                          T (*Ws)[kBN + kPad],
                                          const float* sdict,
                                          const T* __restrict__ x,
                                          const uint8_t* __restrict__ a,
                                          int M, int N, int Kin, int m0,
                                          int n0, int k0, int kend, int vec) {
  load_x_tile<T, BM>(Xs, x, M, Kin, m0, k0, kend);
  if (PACKED)
    decode_tile_u4<T>(Ws, sdict, a, N, k0, kend, n0, vec);
  else
    decode_tile_u8<T>(Ws, sdict, a, N, k0, kend, n0, vec);
}

// f32 x: thread (ty, tx) owns rows ty + 8i and columns tx + 32j.
template <int BM, bool PACKED>
__device__ __forceinline__ void body_f32(float (*Xs)[kBK + kPad],
                                         float (*Ws)[kBN + kPad],
                                         const float* sdict,
                                         const float* __restrict__ x,
                                         const uint8_t* __restrict__ a,
                                         float* __restrict__ dst, int M,
                                         int N, int Kin, int m0, int n0,
                                         int kbeg, int kend, int vec) {
  constexpr int TR = BM / 8;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // previous step's reads done (and sdict loaded)
    load_step<float, BM, PACKED>(Xs, Ws, sdict, x, a, M, N, Kin, m0, n0, k0,
                                 kend, vec);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float xv = Xs[ty + 8 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 8 * i, gn = n0 + tx + 32 * j;
      if (gm < M && gn < N) dst[(size_t)gm * N + gn] = acc[i][j];
    }
}

// bf16 x: warps tile the block as WM x WN, each owning (BM/WM) x (128/WN)
// outputs as 16x16 WMMA fragments.
template <int BM, bool PACKED>
__device__ __forceinline__ void body_bf16(__nv_bfloat16 (*Xs)[kBK + kPad],
                                          __nv_bfloat16 (*Ws)[kBN + kPad],
                                          const float* sdict,
                                          const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ a,
                                          float* __restrict__ dst, int M,
                                          int N, int Kin, int m0, int n0,
                                          int kbeg, int kend, int vec) {
  using namespace nvcuda;
  constexpr int WN = (BM == 16) ? 8 : 4;
  constexpr int WM = 8 / WN;
  constexpr int TM = BM / WM, TN = kBN / WN;
  constexpr int FM = TM / 16, FN = TN / 16;
  __shared__ __align__(128) float Cs[8][16 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();
    load_step<__nv_bfloat16, BM, PACKED>(Xs, Ws, sdict, x, a, M, N, Kin, m0,
                                         n0, k0, kend, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &Xs[wm * TM + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[kk][wn * TN + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  // epilogue through a per-warp 16x16 staging tile, masked at the edges
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * TM + i * 16 + e / 16;
        const int gn = n0 + wn * TN + j * 16 + e % 16;
        if (gm < M && gn < N) dst[(size_t)gm * N + gn] = Cs[warp][e];
      }
      __syncwarp();
    }
}

// grid (ceil(N/128), ceil(M/BM), splits); block z covers reduction rows
// [z * kchunk, min(Kin, (z + 1) * kchunk)) and writes plane z of `out`.
template <typename T, int BM, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    lutq_gemm(const T* __restrict__ x, const uint8_t* __restrict__ a,
              const float* __restrict__ d, int n_dict,
              float* __restrict__ out, int M, int N, int Kin, int kchunk,
              int vec) {
  __shared__ float sdict[kMaxDict];
  __shared__ __align__(128) T Xs[BM][kBK + kPad];
  __shared__ __align__(128) T Ws[kBK][kBN + kPad];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(Kin, kbeg + kchunk);
  float* dst = out + (size_t)blockIdx.z * M * N;

  for (int i = threadIdx.x; i < kMaxDict; i += kThreads)
    sdict[i] = i < n_dict ? d[i] : 0.f;

  if constexpr (std::is_same<T, float>::value)
    body_f32<BM, PACKED>(Xs, Ws, sdict, x, a, dst, M, N, Kin, m0, n0, kbeg,
                         kend, vec);
  else
    body_bf16<BM, PACKED>(Xs, Ws, sdict, x, a, dst, M, N, Kin, m0, n0, kbeg,
                          kend, vec);
}

// y[i] = sum_z part[z][i], z in increasing order.
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ y, int splits,
                              long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    y[i] = s;
  }
}

template <typename T, bool PACKED>
void launch_typed(const void* x, const void* a, int vec, const void* d,
                  int n_dict, float* out, int M, int N, int Kin, int splits,
                  int kchunk, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const float* dp = static_cast<const float*>(d);
  if (M <= 16) {
    dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, splits);
    lutq_gemm<T, 16, PACKED><<<grid, kThreads, 0, stream>>>(
        xp, ap, dp, n_dict, out, M, N, Kin, kchunk, vec);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, splits);
    lutq_gemm<T, 64, PACKED><<<grid, kThreads, 0, stream>>>(
        xp, ap, dp, n_dict, out, M, N, Kin, kchunk, vec);
  }
}

// Returns the first CUDA error of the launches (0 on success). The
// library links its own CUDA runtime, whose current device is not the
// caller's: it is set here from the wrapper's device index.
template <bool PACKED>
int launch(int device, const void* x, int x_bf16, const void* a, int vec,
           const void* d, int n_dict, void* y, void* part, int M, int N,
           int Kin, int splits, int kchunk, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  float* out = static_cast<float*>(splits > 1 ? part : y);
  if (x_bf16)
    launch_typed<__nv_bfloat16, PACKED>(x, a, vec, d, n_dict, out, M, N, Kin,
                                        splits, kchunk, stream);
  else
    launch_typed<float, PACKED>(x, a, vec, d, n_dict, out, M, N, Kin, splits,
                                kchunk, stream);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const long long want = (mn + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    reduce_splits<<<blocks, 256, 0, stream>>>(out, static_cast<float*>(y),
                                              splits, mn);
  }
  return (int)cudaGetLastError();
}

}  // namespace
