// k-means step-4 statistics: assignment of every weight to its nearest
// dictionary entry, plus per-entry sums and counts, in one pass over w.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_tpu.py::kmeans_stats
// (body _kernel), which core/lutq.kmeans_update_stats calls once per
// k-means iteration and once more for the final assignment.
//
// For a sorted dictionary d (K <= 256) the nearest entry of w is the
// number of midpoints (d[k] + d[k+1]) * 0.5 strictly below w: ties go to
// the lower entry, as searchsorted(side="left") does. The index is
// written as one byte, so entries 128..255 of a K=256 dictionary read
// back as negative int8, exactly as a.astype(int8) stores them.
//
// Bound on the H100: each weight is read once (4 B) and its index
// written once (1 B), and the work per weight is a binary search of at
// most 8 steps over shared memory, so device-memory bytes bound it
// (5 B per weight at 3.35 TB/s).
//
// What the design does about it, and about order:
//   * the grid strides over N; each block keeps d and its K-1 midpoints
//     in shared memory, computed in f32 in the reference's order;
//   * every thread owns a private column of per-entry f32 sums and int
//     counts in shared memory (entry k of thread t at [k * T + t], so a
//     warp's 32 threads always hit 32 different banks) and adds its own
//     weights in the order it visits them: no atomics of any kind;
//   * at the end the block folds the T columns by a fixed tree and
//     writes one partial row per block; a second kernel sums the rows in
//     block order (as lutq_gemm.cuh's split-K second pass does), so the
//     result is the same in every run;
//   * the ragged tail needs no padding copy: the grid-stride loop stops
//     at N.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDict = 256;
constexpr int kUnroll = 4;     // weights loaded ahead per thread
constexpr int kBlocksPerSm = 4;

__global__ void kmeans_partials(const float* __restrict__ w, long long n,
                                const float* __restrict__ d, int n_dict,
                                uint8_t* __restrict__ a,
                                float* __restrict__ part_sums,
                                int* __restrict__ part_counts) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  float* smid = smem;                                     // K - 1 used
  float* ssum = smem + kMaxDict;                          // K * T
  int* scnt = reinterpret_cast<int*>(ssum + n_dict * T);  // K * T

  __shared__ float sdict[kMaxDict];
  for (int k = t; k < n_dict; k += T) sdict[k] = d[k];
  for (int i = t; i < n_dict * T; i += T) {
    ssum[i] = 0.f;
    scnt[i] = 0;
  }
  __syncthreads();
  for (int k = t; k < n_dict - 1; k += T)
    smid[k] = (sdict[k] + sdict[k + 1]) * 0.5f;
  __syncthreads();

  // kUnroll loads in flight per thread, then the searches in order
  const int n_mid = n_dict - 1;
  const long long stride = (long long)gridDim.x * T;
  for (long long base = (long long)blockIdx.x * T + t; base < n;
       base += stride * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      x[u] = i < n ? w[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i >= n) break;
      // number of midpoints strictly below x (midpoints non-decreasing)
      int lo = 0, hi = n_mid;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (smid[m] < x[u])
          lo = m + 1;
        else
          hi = m;
      }
      a[i] = (uint8_t)lo;
      ssum[lo * T + t] += x[u];
      scnt[lo * T + t] += 1;
    }
  }
  __syncthreads();

  // fold the T private columns: a fixed tree over t (T is a power of two)
  for (int h = T >> 1; h > 0; h >>= 1) {
    for (int i = t; i < n_dict * h; i += T) {
      const int k = i / h, c = i % h;
      ssum[k * T + c] += ssum[k * T + c + h];
      scnt[k * T + c] += scnt[k * T + c + h];
    }
    __syncthreads();
  }
  for (int k = t; k < n_dict; k += T) {
    part_sums[(size_t)blockIdx.x * n_dict + k] = ssum[k * T];
    part_counts[(size_t)blockIdx.x * n_dict + k] = scnt[k * T];
  }
}

// sums[k] = sum_b part_sums[b][k] and counts[k] likewise, b in
// increasing order; counts are summed as integers and rounded to f32
// once. One block of kMaxDict threads: all of them stage the partial
// rows in shared memory, kStage values at a time with coalesced loads,
// then thread k adds column k of the staged rows in block order.
__global__ void kmeans_reduce_partials(const float* __restrict__ part_sums,
                                       const int* __restrict__ part_counts,
                                       int blocks, int n_dict,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts) {
  constexpr int kStage = 4096;
  __shared__ float ss[kStage];
  __shared__ int sc[kStage];
  const int k = threadIdx.x;
  const int rows = kStage / n_dict;
  float s = 0.f;
  long long c = 0;
  for (int b0 = 0; b0 < blocks; b0 += rows) {
    const int nb = min(rows, blocks - b0);
    const size_t base = (size_t)b0 * n_dict;
    for (int i = threadIdx.x; i < nb * n_dict; i += blockDim.x) {
      ss[i] = part_sums[base + i];
      sc[i] = part_counts[base + i];
    }
    __syncthreads();
    if (k < n_dict) {
      for (int r = 0; r < nb; ++r) {
        s += ss[r * n_dict + k];
        c += sc[r * n_dict + k];
      }
    }
    __syncthreads();
  }
  if (k < n_dict) {
    sums[k] = s;
    counts[k] = (float)c;
  }
}

// Threads per block for a K-entry dictionary: the private columns take
// T * K * 8 bytes of shared memory (32 KB up to K = 128, 64 KB at 256).
int threads_for(int n_dict) {
  if (n_dict <= 16) return 256;
  if (n_dict <= 32) return 128;
  if (n_dict <= 64) return 64;
  return 32;
}

}  // namespace

// Blocks of the first kernel (the rows of the partials the wrapper
// allocates): enough to cover n once at kUnroll weights a thread, at
// most kBlocksPerSm per SM.
extern "C" int kmeans_stats_blocks(long long n, int n_dict, int sms) {
  const long long per_block = (long long)threads_for(n_dict) * kUnroll;
  const long long want = (n + per_block - 1) / per_block;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
}

// Returns the first CUDA error of the launches (0 on success). The
// library links its own CUDA runtime, whose current device is not the
// caller's: it is set here from the wrapper's device index.
extern "C" int kmeans_stats_launch(int device, const void* w, long long n,
                                   const void* d, int n_dict, void* a,
                                   void* part_sums, void* part_counts,
                                   int blocks, void* sums, void* counts,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_dict < 1 || n_dict > kMaxDict || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int T = threads_for(n_dict);
  const size_t smem = (size_t)kMaxDict * sizeof(float) +
                      (size_t)n_dict * T * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kmeans_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_partials<<<blocks, T, smem, s>>>(
      static_cast<const float*>(w), n, static_cast<const float*>(d), n_dict,
      static_cast<uint8_t*>(a), static_cast<float*>(part_sums),
      static_cast<int*>(part_counts));
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return (int)first;
  kmeans_reduce_partials<<<1, kMaxDict, 0, s>>>(
      static_cast<const float*>(part_sums),
      static_cast<const int*>(part_counts), blocks, n_dict,
      static_cast<float*>(sums), static_cast<float*>(counts));
  return (int)cudaGetLastError();
}
