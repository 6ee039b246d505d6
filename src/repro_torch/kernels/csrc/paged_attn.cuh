// The paged decode attention kernel of paged_attn.cu (see its comment
// for the function, the bound and the design), its launch and the
// instantiation of one (G, dh) shape over every dtype pair. The shapes
// are compiled by separate sources, built in parallel: paged_attn.cu
// (danube's (4, 80) and the narrow generic kernel, G <= 8),
// paged_attn_g8.cu ((8, 128), qwen1.5-110b's), paged_attn_g12.cu
// ((12, 128), mistral-large-123b's) and paged_attn_wide.cu (the wide
// generic kernel, 8 < G <= 16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace paged_attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kNarrowGroup = 8; // head-loop bound of the narrow generic instantiation
constexpr int kMaxCols = 4;     // head-dim columns per lane in the PV pass: dh <= 128
constexpr int kTile = 64;       // positions per ring stage
constexpr int kStages = 4;      // ring depth
constexpr int kMaxSplits = 64;  // splits of one row
constexpr int kMaxMergeGroups = 8;  // groups of splits a merge sums apart
constexpr int kMaxParts = 8;        // partial dot products of a K row
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

// The bf16 scale of a staged row: the stage holds the aligned 4-byte
// word around it, whose half `half` (the row index's parity) it is.
__device__ __forceinline__ float scale_of(uint32_t word, int half) {
  return __uint_as_float((word >> (16 * half)) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block-wide max (is_max) or sum of v[g] for g < G; lane 0 of each warp
// holds its warp's result, warps combine in order. out[g] for all threads.
template <int GM>
__device__ __forceinline__ void block_reduce(float (&v)[GM], int G, bool is_max,
                                             float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
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

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Partial dot products a position's K row is cut into: its 16-byte
// pieces in at most kMaxParts groups of equal size.
__host__ __device__ constexpr int score_parts(int rowbytes) {
  const int nc = rowbytes / 16 > 0 ? rowbytes / 16 : 1;
  const int cpt = (nc + kMaxParts - 1) / kMaxParts;
  return (nc + cpt - 1) / cpt;
}

// Byte offsets of a block's shared memory, every region 16-byte
// aligned: the scaled queries; the ring (kStages stages of kTile rows,
// later the PV pass's warp partials and the merge's group sums); the
// staged scales (int8 pools); the reduction slots with the split's max
// and sum and the ticket's verdict; every split's max (then weight) and
// sum for the merge (nsplit > 1); the split's block-table entries; a
// tile's partial scores; (single-pass) the split's score rows.
// kernels/paged_attn.py's smem_plan repeats this.
struct Smem {
  int ring, sc, red, wts, blk, sp, srow, total, stage;
  __host__ __device__ Smem(int G, int dh, int isz, int chunk, int nsplit, int nbs,
                           bool quant, bool global_scores) {
    stage = align16(kTile * dh * isz);
    int ring_bytes = kStages * stage;
    if (ring_bytes < kWarps * G * dh * 4) ring_bytes = kWarps * G * dh * 4;
    ring = align16(G * dh * 4);
    sc = ring + align16(ring_bytes);
    red = sc + (quant ? kStages * kTile * 4 : 0);
    wts = red + align16(((kWarps + 2) * kMaxGroup + 1) * 4);
    blk = wts + align16(nsplit > 1 ? nsplit * G * 8 : 0);
    sp = blk + align16(nbs * 4);
    srow = sp + align16(kTile * score_parts(dh * isz) * G * 4);
    total = srow + (global_scores ? 0 : align16(G * chunk * 4));
  }
};

__host__ __device__ inline int split_pages(int chunk, int page, int NB) {
  const int n = chunk / page + 2;  // pages a chunk of positions can touch
  return n < NB ? n : NB;
}

// KG, KDH: the group and head dim at compile time, or 0 (read from g_rt,
// dh_rt); GMAX: the head loops' bound when KG is 0
template <typename TQ, typename TKV, bool GLOBAL, int KG, int KDH, int GMAX>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
             const TKV* __restrict__ vpool, const __nv_bfloat16* __restrict__ kscale,
             const __nv_bfloat16* __restrict__ vscale, const int* __restrict__ block,
             const int* __restrict__ lens, TQ* __restrict__ out, float* __restrict__ ws,
             float* __restrict__ part, int* __restrict__ ticket, int Hkv, int g_rt,
             int dh_rt, int page, int NB, int window, int span, int chunk, float scale,
             int vec, int svec) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr bool kScoreBf16 =
      std::is_same<TQ, __nv_bfloat16>::value && !std::is_same<TKV, float>::value;
  constexpr int GM = KG ? KG : GMAX;                     // bound of the head loops
  constexpr int CM = KDH ? (KDH + 31) / 32 : kMaxCols;   // columns per lane (PV)
  constexpr int E = 16 / sizeof(TKV);                    // elements of 16 bytes
  const int G = KG ? KG : g_rt;
  const int dh = KDH ? KDH : dh_rt;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = b * Hkv + h;
  const int H = Hkv * G;
  const size_t head0 = ((size_t)b * H + (size_t)h * G) * dh;  // q / out row of (b, h, g=0)
  const int rowbytes = dh * (int)sizeof(TKV);
  const bool v16 = KDH ? (KDH * sizeof(TKV)) % 16 == 0 : rowbytes % 16 == 0;
  const int nbs = split_pages(chunk, page, NB);
  const Smem lay(G, dh, (int)sizeof(TKV), chunk, nsplit, nbs, kQuant, GLOBAL);

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                       // G * dh
  unsigned char* ring = smem + lay.ring;
  uint32_t* sc = reinterpret_cast<uint32_t*>(smem + lay.sc);        // kStages * kTile
  float* red = reinterpret_cast<float*>(smem + lay.red);            // kWarps * kMaxGroup
  float* mrow = red + kWarps * kMaxGroup;                            // kMaxGroup
  float* lrow = mrow + kMaxGroup;                                    // kMaxGroup
  int* last = reinterpret_cast<int*>(lrow + kMaxGroup);             // 1
  float* wts = reinterpret_cast<float*>(smem + lay.wts);            // nsplit * G * 2
  int* blk = reinterpret_cast<int*>(smem + lay.blk);                // nbs
  float* sp = reinterpret_cast<float*>(smem + lay.sp);              // kTile x parts x G
  const int sstride = GLOBAL ? span : chunk;
  float* srow = GLOBAL ? ws + (size_t)row * G * span + (size_t)s * chunk
                       : reinterpret_cast<float*>(smem + lay.srow);  // G x sstride

  const int len = lens[b];
  // the scaled queries: their loads overlap the length's
  for (int t = tid; t < G * dh; t += kThreads)
    qs[t] = round_to<TQ>(to_f(q[head0 + t]) * scale);
  const int hi = min(len, NB * page);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c0 = lo + s * chunk;
  const int c1 = min(hi, c0 + chunk);
  const int n = c1 - c0;  // valid positions of this split (<= 0: none)

  if (n > 0) {
    const int p0 = c0 / page;
    const int np = (c1 - 1) / page - p0 + 1;
    for (int t = tid; t < np; t += kThreads) blk[t] = block[(size_t)b * NB + p0 + t];
    __syncthreads();

    const int nt = (n + kTile - 1) / kTile;  // tiles of K, then as many of V
    // stage k of the ring: K tile k (k < nt) or V tile k - nt, into slot
    // k % kStages; one commit group per stage, empty past the last
    auto issue = [&](int k) {
      if (k < 2 * nt) {
        const bool is_v = k >= nt;
        const int i0 = c0 + (is_v ? k - nt : k) * kTile;
        const int cnt = min(kTile, c1 - i0);
        unsigned char* dst = ring + (k % kStages) * lay.stage;
        uint32_t* dsc = sc + (k % kStages) * kTile;
        const TKV* pool = is_v ? vpool : kpool;
        if (vec) {
          const int cpr = rowbytes / 16;
          for (int idx = tid; idx < cnt * cpr; idx += kThreads) {
            const int t = idx / cpr, c = idx - t * cpr;
            const int i = i0 + t, j = i / page;
            const size_t pr = ((size_t)blk[j - p0] * page + (i - j * page)) * Hkv + h;
            cp_async16(dst + t * rowbytes + c * 16,
                       reinterpret_cast<const unsigned char*>(pool + pr * dh) + c * 16);
          }
        } else {
          TKV* d = reinterpret_cast<TKV*>(dst);
          for (int idx = tid; idx < cnt * dh; idx += kThreads) {
            const int t = idx / dh, e = idx - t * dh;
            const int i = i0 + t, j = i / page;
            const size_t pr = ((size_t)blk[j - p0] * page + (i - j * page)) * Hkv + h;
            d[idx] = pool[pr * dh + e];
          }
        }
        if constexpr (kQuant) {
          const __nv_bfloat16* spl = is_v ? vscale : kscale;
          for (int t = tid; t < cnt; t += kThreads) {
            const int i = i0 + t, j = i / page;
            const size_t pr = ((size_t)blk[j - p0] * page + (i - j * page)) * Hkv + h;
            if (svec) {
              cp_async4(dsc + t, spl + (pr & ~(size_t)1));
            } else {
              const uint32_t bits = __bfloat16_as_ushort(spl[pr]);
              dsc[t] = bits | (bits << 16);
            }
          }
        }
      }
      cp_async_commit();
    };
    // svec: Hkv is even, so a row's parity is h's
    const int half = h & 1;

    float acc[CM][GM];
#pragma unroll
    for (int c = 0; c < CM; ++c)
#pragma unroll
      for (int g = 0; g < GM; ++g) acc[c][g] = 0.f;

#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    for (int k = 0; k < 2 * nt; ++k) {
      cp_async_wait<kStages - 2>();
      __syncthreads();          // stage k landed for every thread; slot of k - 1 free
      issue(k + kStages - 1);
      const unsigned char* st = ring + (k % kStages) * lay.stage;
      const uint32_t* ssc = sc + (k % kStages) * kTile;
      if (k < nt) {
        // ---- scores of K tile k ----------------------------------------------
        const int t0 = k * kTile, cnt = min(kTile, n - t0);
        if (v16) {
          // one task per (position, group of up to `cpt` 16-byte pieces of
          // its K row): every head's partial dot product over those pieces,
          // in head-dim order, each element dequantized once; then one
          // thread per (position, head) adds the np partials in order
          const int nc = rowbytes / 16, cpt = (nc + kMaxParts - 1) / kMaxParts;
          const int np = (nc + cpt - 1) / cpt;
          for (int task = tid; task < cnt * np; task += kThreads) {
            // neighbouring threads take neighbouring positions of one group:
            // their query reads are one broadcast, their K rows distinct banks
            const int p = task / cnt, t = task - p * cnt;
            const float sk = kQuant ? scale_of(ssc[t], half) : 1.f;
            const uint4* kr = reinterpret_cast<const uint4*>(st + t * rowbytes);
            float a[GM];
#pragma unroll
            for (int g = 0; g < GM; ++g) a[g] = 0.f;
            const int cend = min(nc, (p + 1) * cpt);
            for (int c = p * cpt; c < cend; ++c) {
              const uint4 u = kr[c];
              const TKV* x = reinterpret_cast<const TKV*>(&u);
#pragma unroll
              for (int e = 0; e < E; e += 4) {
                const float k0 = dequant<TKV>(x[e], sk), k1 = dequant<TKV>(x[e + 1], sk);
                const float k2 = dequant<TKV>(x[e + 2], sk), k3 = dequant<TKV>(x[e + 3], sk);
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                  if (g >= G) break;
                  const float4 qq = *reinterpret_cast<const float4*>(qs + g * dh + c * E + e);
                  a[g] = fmaf(qq.x, k0, a[g]);
                  a[g] = fmaf(qq.y, k1, a[g]);
                  a[g] = fmaf(qq.z, k2, a[g]);
                  a[g] = fmaf(qq.w, k3, a[g]);
                }
              }
            }
#pragma unroll
            for (int g = 0; g < GM; ++g)
              if (g < G) sp[(t * np + p) * G + g] = a[g];
          }
          __syncthreads();
          for (int task = tid; task < cnt * G; task += kThreads) {
            const int t = task / G, g = task - t * G;
            float a = sp[t * np * G + g];
            for (int p = 1; p < np; ++p) a += sp[(t * np + p) * G + g];
            srow[g * sstride + t0 + t] = kScoreBf16 ? round_bf16(a) : a;
          }
        } else {
          // one thread per (position, head), the head dim in order
          const int ppr = kThreads / G;  // positions per round
          const int g = tid % G, ti = tid / G;
          if (ti < ppr) {
            const float* qg = qs + g * dh;
            for (int t = ti; t < cnt; t += ppr) {
              const float sk = kQuant ? scale_of(ssc[t], half) : 1.f;
              const TKV* kr = reinterpret_cast<const TKV*>(st + t * rowbytes);
              float a = 0.f;
              for (int d = 0; d < dh; ++d) a = fmaf(qg[d], dequant<TKV>(kr[d], sk), a);
              srow[g * sstride + t0 + t] = kScoreBf16 ? round_bf16(a) : a;
            }
          }
        }
        continue;
      }
      if (k == nt) {
        // ---- the split's softmax statistics; exponents replace scores ------
        // (the barrier above ordered every score write before these reads)
        float r[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) r[g] = -CUDART_INF_F;
        for (int t = tid; t < n; t += kThreads) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            if (g < G) r[g] = fmaxf(r[g], srow[g * sstride + t]);
        }
        block_reduce<GM>(r, G, true, red, mrow);
        float pm[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          pm[g] = g < G ? mrow[g] : 0.f;
          r[g] = 0.f;
        }
        for (int t = tid; t < n; t += kThreads) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            if (g < G) {
              const float e = expf(srow[g * sstride + t] - pm[g]);
              srow[g * sstride + t] = e;
              r[g] += e;
            }
        }
        block_reduce<GM>(r, G, false, red, lrow);  // ends in a barrier
      }
      // ---- acc += exp(s - m) * v over V tile k - nt --------------------------
      const int t0 = (k - nt) * kTile, cnt = min(kTile, n - t0);
#pragma unroll 4
      for (int t = warp; t < cnt; t += kWarps) {
        const float sv = kQuant ? scale_of(ssc[t], half) : 1.f;
        const TKV* vr = reinterpret_cast<const TKV*>(st + t * rowbytes);
        float pp[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) pp[g] = g < G ? srow[g * sstride + t0 + t] : 0.f;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            const float v = dequant<TKV>(vr[d], sv);
#pragma unroll
            for (int g = 0; g < GM; ++g)
              if (g < G) acc[c][g] = fmaf(pp[g], v, acc[c][g]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it takes the warp partials

    float* wpart = reinterpret_cast<float*>(ring);  // kWarps x G x dh
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) wpart[(warp * G + g) * dh + d] = acc[c][g];
      }
    }
    __syncthreads();
    if (nsplit == 1) {
      for (int t = tid; t < G * dh; t += kThreads) {
        float o = wpart[t];
        for (int w = 1; w < kWarps; ++w) o += wpart[w * G * dh + t];
        out[head0 + t] = from_f<TQ>(o / lrow[t / dh]);
      }
      return;
    }
    float* po = part + ((size_t)row * nsplit + s) * G * dh;
    for (int t = tid; t < G * dh; t += kThreads) {
      float o = wpart[t];
      for (int w = 1; w < kWarps; ++w) o += wpart[w * G * dh + t];
      po[t] = o;
    }
  } else if (nsplit == 1) {  // no valid position (len = 0): the row is 0
    for (int t = tid; t < G * dh; t += kThreads) out[head0 + t] = from_f<TQ>(0.f);
    return;
  }

  // ---- nsplit > 1: publish (m_s, l_s), draw a ticket; the last merges -----
  float* pml = part + (size_t)gridDim.y * Hkv * nsplit * G * dh;  // (B*Hkv, nsplit, G, 2)
  if (tid < G) {
    float* ml = pml + (((size_t)row * nsplit + s) * G + tid) * 2;
    ml[0] = n > 0 ? mrow[tid] : -CUDART_INF_F;
    ml[1] = n > 0 ? lrow[tid] : 0.f;
  }
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();  // ... before its ticket is drawn
  if (tid == 0) *last = atomicAdd(ticket + row, 1) == nsplit - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the other splits' partials, read below from L2

  // every split's (m_s, l_s) into shared memory at once; then per head m,
  // the weights w_s (replacing m_s) and L, in split order
  const float* mlr = pml + (size_t)row * nsplit * G * 2;
  for (int t = tid; t < nsplit * G * 2; t += kThreads) wts[t] = __ldcg(mlr + t);
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {  // head g: lane i takes the splits i, i + 32, ...
    float m = -CUDART_INF_F;
    for (int i = lane; i < nsplit; i += 32) m = fmaxf(m, wts[(i * G + g) * 2]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float L = 0.f;
    for (int i = lane; i < nsplit; i += 32) {
      const float mi = wts[(i * G + g) * 2];
      const float w = mi == -CUDART_INF_F ? 0.f : expf(mi - m);
      L = fmaf(w, wts[(i * G + g) * 2 + 1], L);
      wts[(i * G + g) * 2] = w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) lrow[g] = L;
  }
  __syncthreads();
  // sum_s w_s acc_s: each task takes V-wide columns of the G x dh sums
  // and the splits s = j, j + J, ... (J groups of splits, so that many
  // independent loads are in flight); the groups are added in order
  const int V = dh % 4 == 0 ? 4 : 1;
  const int cols = G * dh / V;
  const int J = min(kMaxMergeGroups, max(1, kThreads / cols));
  float* grp = reinterpret_cast<float*>(ring);  // J x G x dh (the ring is free)
  const float* por = part + (size_t)row * nsplit * G * dh;
  for (int task = tid; task < cols * J; task += kThreads) {
    const int c = task % cols, j = task / cols;
    const int g = c * V / dh;
    if (V == 4) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = j; i < nsplit; i += J) {
        const float w = wts[(i * G + g) * 2];
        const float4 x =
            w != 0.f ? __ldcg(reinterpret_cast<const float4*>(por + (size_t)i * G * dh) + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
      reinterpret_cast<float4*>(grp + (size_t)j * G * dh)[c] = o;
    } else {
      float o = 0.f;
#pragma unroll 8
      for (int i = j; i < nsplit; i += J) {
        const float w = wts[(i * G + g) * 2];
        const float x = w != 0.f ? __ldcg(por + (size_t)i * G * dh + c) : 0.f;
        o = fmaf(w, x, o);
      }
      grp[(size_t)j * G * dh + c] = o;
    }
  }
  __syncthreads();
  for (int t = tid; t < G * dh; t += kThreads) {
    float o = grp[t];
    for (int j = 1; j < J; ++j) o += grp[(size_t)j * G * dh + t];
    const float L = lrow[t / dh];
    out[head0 + t] = from_f<TQ>(L > 0.f ? o / L : 0.f);
  }
  if (tid == 0) {
    __threadfence();
    ticket[row] = 0;  // for the next call (or graph replay) on this row
  }
}

template <typename TQ, typename TKV, bool GLOBAL, int KG, int KDH, int GMAX>
int launch_one(int device, const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const int* block, const int* lens, void* out, float* ws,
               float* part, int* ticket, int B, int Hkv, int G, int dh, int page, int NB,
               int window, int span, int chunk, int nsplit, float scale, int vec, int svec,
               size_t smem, cudaStream_t stream) {
  auto kernel = paged_decode<TQ, TKV, GLOBAL, KG, KDH, GMAX>;
  // opt in to more than 48 KB once per device and size (not a stream
  // operation, so it stays out of a CUDA graph being captured)
  static size_t opted[kMaxDevices] = {};
  if (smem > 48 * 1024 && (device >= kMaxDevices || smem > opted[device])) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    if (device < kMaxDevices) opted[device] = smem;
  }
  kernel<<<dim3(Hkv, B, nsplit), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs), block,
      lens, static_cast<TQ*>(out), ws, part, ticket, Hkv, G, dh, page, NB, window, span,
      chunk, scale, vec, svec);
  return (int)cudaGetLastError();
}

struct Args {
  int device;
  const void *q, *kp, *vp, *ks, *vs;
  const int *block, *lens;
  void* out;
  float *ws, *part;
  int* ticket;
  int B, Hkv, G, dh, page, NB, window, span, chunk, nsplit;
  float scale;
  int vec, svec;
  size_t smem;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, bool GLOBAL, int KG, int KDH, int GMAX>
int launch_shape(const Args& a) {
  return launch_one<TQ, TKV, GLOBAL, KG, KDH, GMAX>(
      a.device, a.q, a.kp, a.vp, a.ks, a.vs, a.block, a.lens, a.out, a.ws, a.part, a.ticket,
      a.B, a.Hkv, a.G, a.dh, a.page, a.NB, a.window, a.span, a.chunk, a.nsplit, a.scale,
      a.vec, a.svec, a.smem, a.stream);
}

// one (G, dh) shape (KG, KDH; 0, 0 and the head loops' bound GMAX for a
// generic kernel) for every q dtype (0 f32, 1 bf16), pool dtype (0 f32,
// 1 bf16, 2 int8) and score home (global: the workspace variant)
template <typename TQ, bool GLOBAL, int KG, int KDH, int GMAX>
int launch_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0: return launch_shape<TQ, float, GLOBAL, KG, KDH, GMAX>(a);
    case 1: return launch_shape<TQ, __nv_bfloat16, GLOBAL, KG, KDH, GMAX>(a);
    case 2: return launch_shape<TQ, int8_t, GLOBAL, KG, KDH, GMAX>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int KG, int KDH, int GMAX>
int launch_dtypes(const Args& a, int q_dtype, int kv_dtype, bool global) {
  if (q_dtype == 0)
    return global ? launch_kv<float, true, KG, KDH, GMAX>(kv_dtype, a)
                  : launch_kv<float, false, KG, KDH, GMAX>(kv_dtype, a);
  if (q_dtype == 1)
    return global ? launch_kv<__nv_bfloat16, true, KG, KDH, GMAX>(kv_dtype, a)
                  : launch_kv<__nv_bfloat16, false, KG, KDH, GMAX>(kv_dtype, a);
  return (int)cudaErrorInvalidValue;
}

// defined by paged_attn_g8.cu, paged_attn_g12.cu and paged_attn_wide.cu
int launch_g8_dh128(const Args& a, int q_dtype, int kv_dtype, bool global);
int launch_g12_dh128(const Args& a, int q_dtype, int kv_dtype, bool global);
int launch_wide(const Args& a, int q_dtype, int kv_dtype, bool global);

}  // namespace paged_attn
