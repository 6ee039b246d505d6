// Paged decode attention: one query token per sequence, GQA, attending
// the KV cache through a block table, with the reference's exact softmax.
//
// Replaces the TPU kernels src/repro/kernels/paged_attn.py::
// paged_attention_tpu (body _decode_kernel) and
// _paged_attention_multipass (body _decode_kernel_multipass), reached
// from every layer of every paged decode step (models/lm.py
// paged_attn_decode -> kernels/ops.paged_attention).
//
// Function, per (sequence b, KV head h), for the G query heads of h:
//   q_s  = round_q(q * scale)                          (q's dtype)
//   k, v = pool[block[b, pos / page], pos % page, h]   int8 pages are
//          dequantized as round_bf16(int8 * bf16 scale), as the
//          reference's bf16 product does
//   s    = q_s . k, accumulated in f32, rounded to bf16 when q and the
//          dequantized pages are both bf16 (jnp's einsum gives bf16
//          scores there), then held in f32
//   p    = softmax over the valid positions [max(0, len - window), len)
//   o    = sum p * v in f32, written in q's dtype; 0 where len = 0
// Positions outside the valid range have weight exactly 0 in the
// reference (exp(-1e30 - max) == 0 in f32), so they are skipped, and
// no page outside the range is ever read: dead block entries and pages
// wholly behind the window may hold anything, NaN included.
//
// Bound on the H100: decode reads each live K/V row once (dh bytes
// int8 or 2 dh bytes bf16, plus a bf16 scale) and does 4 G dh flops on
// it, a few flops per byte, so device-memory bytes bound it (the live
// pages at 3.35 TB/s).
//
// What the design does about it: one block per (b, h) stages the G
// scaled query rows and the row's block-table entries in shared memory
// (so no K/V load waits on a block-table load from device memory) and
// makes three passes over the valid range. Pass A: each thread takes
// whole positions and loads their K rows 16 bytes at a time, four loads
// in flight, writing G scores into the score row.
// The score row lives in shared memory (single-pass variant, the
// counterpart of _decode_kernel) or, for a row whose score row outgrows
// the shared-memory budget, in a global f32 workspace (B, Hkv, G, span)
// that stays in L2 (the counterpart of _decode_kernel_multipass, whose
// phase A and B are the same passes; its dh chunking was a VMEM
// artifact and has no counterpart here). Softmax: the max and the
// exponent sum are block reductions in a fixed order, so a run gives
// the same bits every time; probabilities replace the scores in place.
// Pass B: each warp takes every 8th position, its lanes the head-dim
// columns, and loads eight rows and their weights before it uses any
// (no branch between the loads) to accumulate p * v in registers; the
// eight warp partials are added in warp order. No atomics. A row is
// never split across blocks (B x Hkv blocks; 64 at the full-width
// decode batch of 8): splitting it while keeping the exact softmax is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;   // query heads per KV head
constexpr int kMaxCols = 4;    // head-dim columns per lane in pass B: dh <= 128
constexpr int kInFlight = 4;   // 16-byte chunks in flight per thread (pass A)
constexpr int kRowsB = 8;      // rows in flight per warp (pass B)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can opt into
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return round_bf16(x);
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __float2bfloat16_rn(x);
  else return x;
}

// One pool element as the reference's attention reads it; `s` is the
// row's bf16 scale (int8 pools only).
template <typename TKV>
__device__ __forceinline__ float dequant(TKV x, float s) {
  if constexpr (std::is_same<TKV, int8_t>::value) return round_bf16(to_f(x) * s);
  else return to_f(x);
}

// Adds q_s[g, d0 + e] * k[e] for the E = 16 / sizeof(TKV) elements of
// one 16-byte chunk into acc[g].
template <typename TKV>
__device__ __forceinline__ void dot_chunk(const uint4& u, float s, const float* qs,
                                          int dh, int d0, int G,
                                          float (&acc)[kMaxGroup]) {
  constexpr int E = 16 / sizeof(TKV);
  const TKV* x = reinterpret_cast<const TKV*>(&u);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float kv = dequant<TKV>(x[e], s);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] = fmaf(qs[g * dh + d0 + e], kv, acc[g]);
  }
}

// Block-wide max (is_max) or sum of v[g] for g < G; lane 0 of each warp
// holds its warp's result, warps combine in order. out[g] for all threads.
__device__ __forceinline__ void block_reduce(float (&v)[kMaxGroup], int G, bool is_max,
                                             float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
    float x = v[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, off);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[warp * kMaxGroup + g] = x;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float r = red[g];
    for (int w = 1; w < kWarps; ++w)
      r = is_max ? fmaxf(r, red[w * kMaxGroup + g]) : r + red[w * kMaxGroup + g];
    out[g] = r;
  }
  __syncthreads();
}

template <typename TQ, typename TKV, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
paged_decode(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
             const TKV* __restrict__ vpool, const __nv_bfloat16* __restrict__ kscale,
             const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ block,
             const int* __restrict__ lens, TQ* __restrict__ out, float* __restrict__ ws,
             int Hkv, int G, int dh, int page, int NB, int window, int span,
             float scale, int vec) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr bool kScoreBf16 =
      std::is_same<TQ, __nv_bfloat16>::value && !std::is_same<TKV, float>::value;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G;
  const size_t head0 = ((size_t)b * H + (size_t)h * G) * dh;  // q / out row of (b, h, g=0)

  float* qs = smem;                           // G * dh
  float* red = qs + G * dh;                   // kWarps * kMaxGroup
  float* stat = red + kWarps * kMaxGroup;     // kMaxGroup
  float* part = stat + kMaxGroup;             // kWarps * G * dh
  float* srow = GLOBAL ? ws + ((size_t)b * Hkv + h) * G * span
                       : part + kWarps * G * dh;  // G * span
  int* blk = reinterpret_cast<int*>(part + kWarps * G * dh + (GLOBAL ? 0 : G * span));

  const int len = lens[b];
  const int hi = min(len, NB * page);
  const int lo = window > 0 ? max(0, len - window) : 0;
  if (hi <= lo) {  // no valid position (len = 0): the row is 0
    for (int t = tid; t < G * dh; t += kThreads) out[head0 + t] = from_f<TQ>(0.f);
    return;
  }
  const int n = hi - lo;

  for (int t = tid; t < G * dh; t += kThreads)
    qs[t] = round_to<TQ>(to_f(q[head0 + t]) * scale);
  for (int t = tid; t < NB; t += kThreads) blk[t] = block[(size_t)b * NB + t];
  __syncthreads();

  // ---- pass A: scores -----------------------------------------------------
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int j = i / page;
    const size_t row = ((size_t)blk[j] * page + (i - j * page)) * Hkv + h;
    const TKV* kr = kpool + row * dh;
    const float s = kQuant ? __bfloat162float(kscale[row]) : 1.f;
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
    if (vec) {
      constexpr int E = 16 / sizeof(TKV);
      const int nch = dh / E;
      const uint4* kc = reinterpret_cast<const uint4*>(kr);
      for (int c0 = 0; c0 < nch; c0 += kInFlight) {
        uint4 u[kInFlight];
#pragma unroll
        for (int c = 0; c < kInFlight; ++c)
          if (c0 + c < nch) u[c] = kc[c0 + c];
#pragma unroll
        for (int c = 0; c < kInFlight; ++c)
          if (c0 + c < nch) dot_chunk<TKV>(u[c], s, qs, dh, (c0 + c) * E, G, acc);
      }
    } else {
      for (int d = 0; d < dh; ++d) {
        const float kv = dequant<TKV>(kr[d], s);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g] = fmaf(qs[g * dh + d], kv, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) srow[g * span + (i - lo)] = kScoreBf16 ? round_bf16(acc[g]) : acc[g];
  }
  __syncthreads();

  // ---- softmax over [lo, hi), in place --------------------------------------
  float r[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) r[g] = -CUDART_INF_F;
  for (int t = tid; t < n; t += kThreads) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) r[g] = fmaxf(r[g], srow[g * span + t]);
  }
  block_reduce(r, G, true, red, stat);
  float m[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = g < G ? stat[g] : 0.f;
    r[g] = 0.f;
  }
  __syncthreads();  // stat is rewritten by the next reduction
  for (int t = tid; t < n; t += kThreads) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) {
        const float e = expf(srow[g * span + t] - m[g]);
        srow[g * span + t] = e;
        r[g] += e;
      }
  }
  block_reduce(r, G, false, red, stat);
  for (int t = tid; t < n; t += kThreads) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) srow[g * span + t] = srow[g * span + t] / stat[g];
  }
  __syncthreads();

  // ---- pass B: o = sum p * v --------------------------------------------------
  float acc[kMaxCols][kMaxGroup];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[c][g] = 0.f;
  for (int base = lo + warp; base < hi; base += kWarps * kRowsB) {
    // all loads first, without branches: a row past hi re-reads the
    // last valid row (finite) and is skipped below
    float vv[kRowsB][kMaxCols];
    float pp[kRowsB][kMaxGroup];
#pragma unroll
    for (int u = 0; u < kRowsB; ++u) {
      const int i = min(base + u * kWarps, hi - 1);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) pp[u][g] = g < G ? srow[g * span + (i - lo)] : 0.f;
      const int j = i / page;
      const size_t row = ((size_t)blk[j] * page + (i - j * page)) * Hkv + h;
      const TKV* vr = vpool + row * dh;
      const float s = kQuant ? __bfloat162float(vscale[row]) : 1.f;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int d = lane + 32 * c;
        vv[u][c] = d < dh ? dequant<TKV>(vr[d], s) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsB; ++u) {
      const int i = base + u * kWarps;
      if (i >= hi) break;  // the same for the whole warp
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) acc[c][g] = fmaf(pp[u][g], vv[u][c], acc[c][g]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) part[(warp * G + g) * dh + d] = acc[c][g];
    }
  }
  __syncthreads();
  for (int t = tid; t < G * dh; t += kThreads) {
    float o = part[t];
    for (int w = 1; w < kWarps; ++w) o += part[w * G * dh + t];
    out[head0 + t] = from_f<TQ>(o);
  }
}

template <typename TQ, typename TKV, bool GLOBAL>
int launch_one(int device, const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const int* block, const int* lens, void* out, float* ws,
               int B, int Hkv, int G, int dh, int page, int NB, int window, int span,
               float scale, int vec, size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode<TQ, TKV, GLOBAL>;
  // opt in to more than 48 KB once per device and size (not a stream
  // operation, so it stays out of a CUDA graph being captured)
  static size_t opted[kMaxDevices] = {};
  if (smem > 48 * 1024 && (device >= kMaxDevices || smem > opted[device])) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    if (device < kMaxDevices) opted[device] = smem;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs), block,
      lens, static_cast<TQ*>(out), ws, Hkv, G, dh, page, NB, window, span, scale, vec);
  return (int)cudaGetLastError();
}

template <typename TQ, bool GLOBAL>
int launch_kv(int device, int kv_dtype, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const int* block, const int* lens,
              void* out, float* ws, int B, int Hkv, int G, int dh, int page, int NB,
              int window, int span, float scale, int vec, size_t smem,
              cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_one<TQ, float, GLOBAL>(device, q, kp, vp, ks, vs, block, lens, out, ws, B,
                                           Hkv, G, dh, page, NB, window, span, scale,
                                           vec, smem, stream);
    case 1:
      return launch_one<TQ, __nv_bfloat16, GLOBAL>(device, q, kp, vp, ks, vs, block, lens, out,
                                                   ws, B, Hkv, G, dh, page, NB, window,
                                                   span, scale, vec, smem, stream);
    case 2:
      return launch_one<TQ, int8_t, GLOBAL>(device, q, kp, vp, ks, vs, block, lens, out, ws, B,
                                            Hkv, G, dh, page, NB, window, span, scale,
                                            vec, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes of one block: the scaled queries, the reduction
// scratch, the warp partials of pass B, (single-pass) the score row and
// the row's block-table entries.
// kernels/paged_attn.py's smem_plan repeats this sum.
long long smem_bytes(int G, int dh, int span, int NB, int global_scores) {
  long long words = (long long)G * dh + kWarps * kMaxGroup + kMaxGroup +
                    (long long)kWarps * G * dh + NB;
  if (!global_scores) words += (long long)G * span;
  return words * 4;
}

}  // namespace

// dtypes: q 0 = f32, 1 = bf16; pools 0 = f32, 1 = bf16, 2 = int8 (with
// bf16 scale planes). window <= 0 means none. span: the score row's
// width, >= the valid range of every row. ws: (B, Hkv, G, span) f32
// when global_scores, else unused. vec: K rows may be read 16 bytes at a
// time (16-byte aligned pool, dh * itemsize a multiple of 16). Returns
// the first CUDA error of the launch (0 on success); the current device
// is set from the wrapper's device index (the library links its own
// CUDA runtime).
extern "C" int paged_attention_launch(int device, const void* q, int q_dtype,
                                      const void* k_pool, const void* v_pool,
                                      int kv_dtype, const void* k_scale,
                                      const void* v_scale, const void* block,
                                      const void* lens, void* out, void* ws, int B,
                                      int Hkv, int G, int dh, int page, int NB,
                                      int window, int span, float scale, int vec,
                                      int global_scores, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxGroup || dh < 1 || dh > 32 * kMaxCols ||
      page < 1 || NB < 1 || span < 1 || (global_scores && ws == nullptr) ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(G, dh, span, NB, global_scores);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* blk = static_cast<const int*>(block);
  const int* ln = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  if (q_dtype == 0) {
    return global_scores
               ? launch_kv<float, true>(device, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, blk,
                                        ln, out, w, B, Hkv, G, dh, page, NB, window, span,
                                        scale, vec, (size_t)smem, s)
               : launch_kv<float, false>(device, kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                                         blk, ln, out, w, B, Hkv, G, dh, page, NB, window,
                                         span, scale, vec, (size_t)smem, s);
  }
  if (q_dtype == 1) {
    return global_scores
               ? launch_kv<__nv_bfloat16, true>(device, kv_dtype, q, k_pool, v_pool, k_scale,
                                                v_scale, blk, ln, out, w, B, Hkv, G, dh,
                                                page, NB, window, span, scale, vec,
                                                (size_t)smem, s)
               : launch_kv<__nv_bfloat16, false>(device, kv_dtype, q, k_pool, v_pool, k_scale,
                                                 v_scale, blk, ln, out, w, B, Hkv, G, dh,
                                                 page, NB, window, span, scale, vec,
                                                 (size_t)smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
