// k-means step-4 statistics: assignment of every weight to its nearest
// dictionary entry, plus per-entry sums and counts, in one pass over w.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_tpu.py::kmeans_stats
// (body _kernel), which core/lutq.kmeans_update_stats calls once per
// k-means iteration and once more for the final assignment.
//
// For a sorted dictionary d (K <= 256) the nearest entry of w is the
// number of midpoints (d[k] + d[k+1]) * 0.5 strictly below w: ties go to
// the lower entry, as searchsorted(side="left") does, and a NaN weight
// goes to entry 0. The index is written as one byte, so entries 128..255
// of a K=256 dictionary read back as negative int8, exactly as
// a.astype(int8) stores them.
//
// Bound on the H100: device-memory bytes. Each weight is read once (4 B)
// and its index written once (1 B): 5 B a weight at 3.35 TB/s, 4 B when
// the caller throws the assignments away (a == nullptr). At that rate an
// SM has to take ~2.9 weights a cycle, ~44 thread-instructions a weight.
//
// What the design does about it, one launch a call, no memset:
//   * the plan (kmeans_stats.plan in the wrapper, from n, K, the SM count
//     and w's misalignment alone) cuts w into a scalar head up to the
//     first 16-byte boundary, nvec float4 vectors and a scalar tail; block
//     b takes vectors [b * chunk, (b + 1) * chunk) (chunk a multiple of
//     32, so a warp's stores of a fill whole 128-byte lines), thread t of
//     it vectors t, t + T, ... of that range; block 0's first threads take
//     the head and tail elements after their vectors;
//   * every thread streams float4 loads, kRound of them a round, and
//     issues the next round's loads before it searches this round's
//     weights (2 resident blocks of 512 threads an SM: 32 KB in flight);
//     the first round goes out before the block's set-up. The wrapper
//     allocates a at w's misalignment mod 4, so the four indices of a
//     vector go out as one 32-bit store;
//   * K <= 16 keeps its 15 midpoints in registers (padded with +inf) and
//     finds the count below x by a binary search whose probes are picked
//     by selects: 4 compares and 11 selects a weight, no load and no
//     branch (counting all 15 compares took twice the instructions and
//     left the kernel bound by issue). Larger K searches the +inf-padded
//     midpoints in shared memory in ceil(log2 K) fixed, branch-free steps,
//     the four weights of a vector side by side;
//   * every thread owns a private column of per-entry (f32 sum, int
//     count) pairs in shared memory (entry k of thread t at [k * T + t]:
//     a half-warp's 16 64-bit words always hit 32 different banks) and
//     adds its own weights in the order it visits them: no atomics on
//     the statistics;
//   * at the end each block folds its T columns by a fixed order (lane l
//     of an entry adds columns l, l + L, l + 2L, ... in turn, then the L
//     lanes meet in a shuffle tree), writes one partial row of (sum,
//     count) pairs and draws the shared merge ticket with one acq_rel
//     atomic; the block that draws the last one adds every row in block
//     order (slice s of the rows by one thread an entry, 16 rows' loads in
//     flight, counts in int64, then the slices by a fixed tree), writes
//     sums and counts and resets the ticket. The order is fixed for a
//     given (n, K, SM count, misalignment), so the result is the same in
//     every run (ref.kmeans_stats_order_ref adds in the same order).
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxDict = 256;
constexpr int kRegDict = 16;      // K <= 16: midpoints in registers
constexpr int kRegThreads = 512;  // threads of a block on that path
constexpr int kRound = 2;         // float4s a thread loads a round
constexpr int kMaxLanes = 16;     // fold lanes an entry, merge slices
constexpr int kMergeBatch = 16;   // partial rows a merging thread loads at once

// number of the 15 sorted, +inf-padded register midpoints m strictly
// below x (a NaN x is below none): a binary search whose probes are
// picked by selects, so no load and no branch. Each step settles one bit
// of the count c: c >= 8 iff m[7] < x, then c >= 8b + 4 iff m[8b + 3] < x,
// and so on; 4 compares and 11 selects a weight
__device__ __forceinline__ int count_below(const float (&m)[kRegDict - 1], float x) {
  const bool p1 = m[7] < x;
  const float c2 = p1 ? m[11] : m[3];
  const float c3a = p1 ? m[9] : m[1], c3b = p1 ? m[13] : m[5];
  const float c4a = p1 ? m[8] : m[0], c4b = p1 ? m[10] : m[2];
  const float c4c = p1 ? m[12] : m[4], c4d = p1 ? m[14] : m[6];
  const bool p2 = c2 < x;
  const float c3 = p2 ? c3b : c3a;
  const float c4e = p2 ? c4c : c4a, c4f = p2 ? c4d : c4b;
  const bool p3 = c3 < x;
  const float c4 = p3 ? c4f : c4e;
  const bool p4 = c4 < x;
  return (p1 ? 8 : 0) + (p2 ? 4 : 0) + (p3 ? 2 : 0) + (p4 ? 1 : 0);
}

// for each of x's four weights, the number of the sorted, +inf-padded
// shared midpoints (2^steps - 1 of them) strictly below it: fixed halving
// steps, no branch, the four searches' loads side by side
__device__ __forceinline__ void search_smem4(const float* smid, int steps, float4 x,
                                             int (&idx)[4]) {
  int p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  for (int step = 1 << (steps - 1); step > 0; step >>= 1) {
    const int o = step - 1;
    const float m0 = smid[p0 + o], m1 = smid[p1 + o], m2 = smid[p2 + o], m3 = smid[p3 + o];
    p0 += m0 < x.x ? step : 0;
    p1 += m1 < x.y ? step : 0;
    p2 += m2 < x.z ? step : 0;
    p3 += m3 < x.w ? step : 0;
  }
  idx[0] = p0;
  idx[1] = p1;
  idx[2] = p2;
  idx[3] = p3;
}

// this thread's (sum, count) of entry idx: add x, count one
__device__ __forceinline__ void add_col(float2* col, float x) {
  float2 c = *col;
  c.x += x;
  c.y = __int_as_float(__float_as_int(c.y) + 1);
  *col = c;
}

// kRegs: K <= 16 at kRegThreads threads, midpoints in registers; else the
// midpoints in shared memory. a == nullptr skips the assignments' stores
// (kWriteA false). part holds gridDim.x rows of K (f32 sum, int32 count)
// pairs.
template <bool kRegs, bool kWriteA>
__global__ void __launch_bounds__(kRegThreads, 2)
    kmeans_stats_kernel(const float* __restrict__ w, long long head, long long nvec,
                        long long tail, long long chunk, const float* __restrict__ d,
                        int n_dict, int steps, int lanes, int slices, uint8_t* __restrict__ a,
                        float2* __restrict__ part, int* __restrict__ ticket,
                        float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ float2 cols[];  // [k * T + t]: thread t's sum and count of entry k
  __shared__ float smid[kMaxDict];
  __shared__ float msum[kMaxDict];  // the merge's slice sums, slices * K <= 256
  __shared__ long long mcnt[kMaxDict];
  __shared__ int last;
  const int T = kRegs ? kRegThreads : (int)blockDim.x;
  const int t = threadIdx.x;

  // the first round's loads go out before anything else
  const float4* wv = reinterpret_cast<const float4*>(w + head);
  uint32_t* av = reinterpret_cast<uint32_t*>(a + head);
  const long long vbeg = (long long)blockIdx.x * chunk;
  const long long vend = min(vbeg + chunk, nvec);
  const long long stride = (long long)kRound * T;
  float4 cur[kRound];
#pragma unroll
  for (int u = 0; u < kRound; ++u) {
    const long long i = vbeg + t + (long long)u * T;
    cur[u] = i < vend ? __ldg(wv + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = t; i < n_dict * T; i += T) cols[i] = make_float2(0.f, 0.f);
  float mid[kRegDict - 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < kRegDict - 1; ++k)
      mid[k] = k < n_dict - 1 ? (__ldg(d + k) + __ldg(d + k + 1)) * 0.5f : CUDART_INF_F;
  } else {
    for (int k = t; k < (1 << steps) - 1; k += T)
      smid[k] = k < n_dict - 1 ? (d[k] + d[k + 1]) * 0.5f : CUDART_INF_F;
  }
  __syncthreads();

  float2* mine = cols + t;

  // the block's vectors, kRound a round, the next round's loads in flight
  for (long long v = vbeg + t; v < vend; v += stride) {
    float4 nxt[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const long long i = v + stride + (long long)u * T;
      nxt[u] = i < vend ? __ldg(wv + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const long long i = v + (long long)u * T;
      if (i < vend) {
        int idx[4];
        if constexpr (kRegs) {
          idx[0] = count_below(mid, cur[u].x);
          idx[1] = count_below(mid, cur[u].y);
          idx[2] = count_below(mid, cur[u].z);
          idx[3] = count_below(mid, cur[u].w);
        } else {
          search_smem4(smid, steps, cur[u], idx);
        }
        if constexpr (kWriteA)
          av[i] = (uint32_t)idx[0] | ((uint32_t)idx[1] << 8) | ((uint32_t)idx[2] << 16) |
                  ((uint32_t)idx[3] << 24);
        add_col(mine + idx[0] * T, cur[u].x);
        add_col(mine + idx[1] * T, cur[u].y);
        add_col(mine + idx[2] * T, cur[u].z);
        add_col(mine + idx[3] * T, cur[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) cur[u] = nxt[u];
  }
  // the head and tail elements, after block 0's vectors
  if (blockIdx.x == 0 && t < head + tail) {
    const long long e = t < head ? t : head + 4 * nvec + (t - head);
    const float x = w[e];
    int idx;
    if constexpr (kRegs) {
      idx = count_below(mid, x);
    } else {
      int q[4];
      search_smem4(smid, steps, make_float4(x, x, x, x), q);
      idx = q[0];
    }
    if constexpr (kWriteA) a[e] = (uint8_t)idx;
    add_col(mine + idx * T, x);
  }
  __syncthreads();

  // fold the T columns: item j = k * lanes + lane adds columns lane, lane
  // + lanes, ... of entry k in turn; the lanes (neighbouring threads of
  // one warp) meet in a shuffle tree; one partial row a block
  const int items = n_dict * lanes;
  const int per = T / lanes;
  for (int j0 = 0; j0 < items; j0 += T) {  // the same trip count in every thread
    const int j = j0 + t;
    const int k = j / lanes, lane = j % lanes;
    float s = 0.f;
    int c = 0;
    if (j < items) {
      const float2* col = cols + k * T + lane;
      for (int m = 0; m < per; ++m) {
        const float2 v = col[m * lanes];
        s += v.x;
        c += __float_as_int(v.y);
      }
    }
    for (int off = 1; off < lanes; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (j < items && lane == 0)
      part[(size_t)blockIdx.x * n_dict + k] = make_float2(s, __int_as_float(c));
  }
  // the ticket: the block's barrier orders its row before thread 0's
  // release, and the acquire of the block that draws the last ticket
  // orders every row before its barrier and its reads (from L2) below
  __syncthreads();
  if (t == 0) {
    int drawn;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(drawn)
                 : "l"(ticket)
                 : "memory");
    last = drawn == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: slice s of the rows, one thread an (s, k), in block
  // order, kMergeBatch rows' loads in flight at a time; then the slices by
  // a fixed tree
  const int B = gridDim.x;
  const int rps = (B + slices - 1) / slices;
  for (int j = t; j < slices * n_dict; j += T) {
    const int s = j / n_dict, k = j % n_dict;
    const int r1 = min(B, (s + 1) * rps);
    float acc = 0.f;
    long long cnt = 0;
    for (int r = s * rps; r < r1; r += kMergeBatch) {
      float2 v[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        v[u] = r + u < r1 ? __ldcg(part + (size_t)(r + u) * n_dict + k) : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (r + u < r1) acc += v[u].x;
        cnt += __float_as_int(v[u].y);
      }
    }
    msum[j] = acc;
    mcnt[j] = cnt;
  }
  __syncthreads();
  for (int h = slices >> 1; h > 0; h >>= 1) {
    for (int j = t; j < h * n_dict; j += T) {
      msum[j] += msum[j + h * n_dict];
      mcnt[j] += mcnt[j + h * n_dict];
    }
    __syncthreads();
  }
  for (int k = t; k < n_dict; k += T) {
    sums[k] = msum[k];
    counts[k] = (float)mcnt[k];
  }
  if (t == 0) *ticket = 0;  // for the next call (or graph replay)
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// One call: the kernel of the wrapper's plan (kmeans_stats.plan). w: the
// n = head + 4 * nvec + tail weights, w + head 16-byte aligned; a: n
// bytes (nullptr: no assignments), a + head 4-byte aligned; part: blocks *
// n_dict pairs of words, 8-byte aligned; ticket: one int32, zero on entry
// and on return;
// sums, counts: n_dict f32. Returns the CUDA error of the launch (0 on
// success). The library links its own CUDA runtime, whose current device
// is not the caller's: it is set here from the wrapper's device index.
extern "C" int kmeans_stats_launch(int device, const void* w, long long head, long long nvec,
                                   long long tail, long long chunk, int blocks, int threads,
                                   int lanes, int slices, const void* d, int n_dict, void* a,
                                   void* part, void* ticket, void* sums, void* counts,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const bool regs = n_dict <= kRegDict;
  const long long covered = (long long)blocks * chunk;
  const uintptr_t wv = reinterpret_cast<uintptr_t>(static_cast<const float*>(w) + head);
  const uintptr_t av = reinterpret_cast<uintptr_t>(static_cast<uint8_t*>(a) + head);
  if (n_dict < 1 || n_dict > kMaxDict || blocks < 1 || !pow2(threads) || threads < 32 ||
      threads > kRegThreads || (regs && threads != kRegThreads) || head < 0 || head > 3 ||
      tail < 0 || tail > 3 || head + tail > threads || nvec < 0 || chunk < 0 ||
      covered < nvec || !pow2(lanes) || lanes > kMaxLanes ||
      lanes > threads || !pow2(slices) || slices > kMaxLanes ||
      slices * n_dict > kMaxDict || wv % 16 != 0 || (a && av % 4 != 0) ||
      !part || reinterpret_cast<uintptr_t>(part) % 8 != 0 || !ticket)
    return (int)cudaErrorInvalidValue;
  int steps = 0;
  while ((1 << steps) < n_dict) ++steps;
  const size_t smem = (size_t)threads * n_dict * sizeof(float2);
  void (*kernel)(const float*, long long, long long, long long, long long, const float*, int,
                 int, int, int, uint8_t*, float2*, int*, float*, float*) =
      regs ? (a ? kmeans_stats_kernel<true, true> : kmeans_stats_kernel<true, false>)
           : (a ? kmeans_stats_kernel<false, true> : kmeans_stats_kernel<false, false>);
  static size_t opted[4][kMaxDevices] = {};  // one row a kernel
  const int rc = opt_in(kernel, device, smem, opted[2 * regs + (a != nullptr)]);
  if (rc != 0) return rc;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), head, nvec, tail, chunk, static_cast<const float*>(d),
      n_dict, steps, lanes, slices, static_cast<uint8_t*>(a), static_cast<float2*>(part),
      static_cast<int*>(ticket), static_cast<float*>(sums), static_cast<float*>(counts));
  return (int)cudaGetLastError();
}
