// LUT-decode GEMM shared by lutq_matmul.cu (int8 assignments) and
// lutq_gemv_packed.cu (two 4-bit assignments per byte), for sm_90a. Its
// copy and lookup helpers (and hopper.cuh's TMA and wgmma helpers) also
// serve lutq_shift.cu.
//
// y (M, N) f32 = x (M, Kin) @ d[A]; A (Kin, N) int8 read as unsigned
// bytes, or packed (Kin/2, N) uint8 with row 2i in the low nibble and
// row 2i + 1 in the high one; d (K <= 256,) f32.
//
// Grid (ceil(M/BM), ceil(N/BN), experts x splits): block (i, j, e splits
// + z) computes the output tile (i, j) of expert e over the reduction rows
// [z kchunk, min(Kin, (z + 1) kchunk)). An expert stack (a MoE layer's
// experts: x (E, M, Kin), A (E, Kin, N), d (E, K), y (E, M, N)) is one
// launch: expert e's block reads its own x slab, assignments and
// dictionary and writes its own output slab, split partials and merge
// tickets; a plain product is the stack of one. The m tiles of one n tile are neighbours in launch order, so
// they share the assignment bytes in L2 and each byte leaves device
// memory about once. The tiles (BM x BN), the split and kchunk come from
// build.plan_splits (static shapes only): 8 x 256 and 16 x 256 for
// decode (M <= 16), 64 x 128 for prefill up to 256 rows (at the decode
// tiles' split, so its rows do not depend on M) and 128 x 256 above.
//
// Pipeline: a ring of shared-memory stages (5 for the 128 x 256 tile, 4
// for the other bf16 tiles, 2 for f32 x), each holding the x tile (BM x
// 64) and the raw assignment bytes of 64 reduction rows x BN columns,
// filled by cp.async 16-byte copies (zero-filled past M, N and the
// split's end) STAGES - 1 steps ahead of the products (STAGES - 2 on
// wgmma, whose products of a step still run during the next one), one
// __syncthreads a step. The 128 x 256 tile takes its x tiles by TMA
// (completion on an mbarrier a stage): the tensor cores read x through
// the async proxy, and after plain copies the proxy fence, a MEMBAR, would
// wait every step for all copies in flight, the later stages' too.
// Unaligned x or A (a ragged Kin or N, an odd base address) are copied by
// plain loads into the same ring. Decoded weights never reach device
// memory, nor shared memory.
//
// bf16 x: tensor cores, with the weights as the 16-row operand:
// y^T = W^T x^T. For each 16 reduction rows a warp decodes its weights
// from the raw bytes straight into mma A fragments in registers. A
// lane's four fragment rows are four adjacent columns n..n+3, so it reads
// one 32-bit word of index bytes per reduction row and stores each output
// row as one float4.
//   Decode and 64 x 128 tiles: each warp owns 32 columns and 8 MF rows of
//     x, loads x's B fragments with ldmatrix from a swizzled tile and
//     issues mma.sync.m16n8k16 bf16 -> f32.
//   128 x 256 (M > 64): two warpgroups of 128 columns each issue
//     wgmma.m64n128k16 with A (the decoded weights) from registers and B
//     (x, 128 rows) read by the tensor cores from the ring under the
//     128-byte swizzle; slice k's registers are rewritten once slice k of
//     the previous step is done, so decode overlaps the products.
// Dictionary:
//   K <= 16: a byte holding two 4-bit indices (a packed byte, or two
//     int8 rows' indices merged) selects one A register, the bf16 pair
//     (d[low nibble], d[high nibble]), from a 256-entry pair table
//     replicated once per lane (32 KB of shared memory, entry b of lane l
//     at word 32 b + l): one conflict-free shared load per two weights.
//     (It measured faster at decode than prmt selects from a 16-entry
//     register table, 22 integer instructions per 8 weights.)
//   K > 16 (int8 only): a 512-byte shared table of bf16 entries.
// Indices are unsigned: a K = 256 dictionary's int8 -128 entry is 128.
// f32 x: CUDA cores, full-precision fmaf (no TF32) on an R x 4 register
// tile per thread against a shared f32 dictionary.
//
// Split reduction (few output tiles: decode, and prefill of narrow
// shapes): each split writes its f32 partial tile to part[z], then draws
// an integer ticket for its tile; the block that draws the last ticket
// sums the partials in the fixed order z = 0, 1, ..., writes y and resets
// the ticket to 0. One launch a call, no float atomics, the same bits on
// every call and CUDA-graph replay.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 64;        // reduction rows per pipeline stage
constexpr int kMaxDict = 256;  // dictionary entries

template <typename T, int BM, int BN, bool PACKED>
struct Tile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kRawRows = PACKED ? kBK / 2 : kBK;  // A rows a stage
  static constexpr int kXRow = kBK * (int)sizeof(T);       // bytes of an x row
  static constexpr int kXBytes = BM * kXRow;
  static constexpr int kStageBytes = kXBytes + kRawRows * BN;
  static constexpr int kStages = kBf16 ? (BM == 128 ? 5 : 4) : 2;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kWN = BN / 32;       // bf16: warps along n
  static constexpr int kWM = 8 / kWN;       // bf16: warps along m
  static constexpr int kMF = BM / (8 * kWM);  // bf16: m8 fragments a warp
  static constexpr int kTN = BN / 4;        // f32: threads along n
  static constexpr int kTM = kThreads / kTN;  // f32: threads along m
  static constexpr int kR = BM / kTM;       // f32: x rows a thread
  // resident blocks an SM the registers are sized for: the 128-row
  // tiles' 128 accumulators a thread need more than 128 registers
  static constexpr int kMinBlocks = BM >= 128 ? 1 : 2;
  // bf16 128 x 256: two warpgroups, 128 columns each, on wgmma
  static constexpr bool kWgmma = kBf16 && BM == 128 && BN == 256;
  static_assert(kXBytes % 128 == 0 && kStageBytes % 128 == 0, "alignment");
  static_assert(!kBf16 || kMF * 8 * kWM == BM, "bf16 warp tiling");
  static_assert(kBf16 || kR * kTM == BM, "f32 thread tiling");
};

// 16-byte asynchronous copy; valid = false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma descriptor of a K-major bf16 tile of 128-byte rows (64 values)
// under the 128-byte swizzle (chunk c of row r at c ^ (r % 8), 8-row
// groups 1024 bytes apart, the tile 1024-byte aligned); addr may step
// 32 bytes a 16-deep slice into the rows
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// 16-byte chunk c of raw row r sits at chunk c ^ raw_swz(r): the four
// rows a warp reads with one instruction (int8: 2q, packed: q, q = lane
// % 4) land on distinct banks
template <bool PACKED>
__device__ __forceinline__ int raw_swz(int r) {
  return ((r >> (PACKED ? 0 : 1)) & 3) << 1;
}

// ---------------------------------------------------------------------------
// weight decode (bf16)
// ---------------------------------------------------------------------------

// the pair table: 256 entries (a byte of two 4-bit indices) x 32 lanes
constexpr int kPairTable = 256 * 32 * 4;

// z: byte j = (index at an even reduction row) | (index at the next row)
// << 4, of column n + j. out[j] = bf16x2 (w[even][n + j], w[odd][n + j]),
// read from this lane's column of the pair table (shared address tab).
__device__ __forceinline__ void lookup_nibble_pairs(uint32_t z, uint32_t tab,
                                                    uint32_t (&out)[4]) {
  const uint32_t off[4] = {(z & 0xFFu) << 7, (z >> 1) & 0x7F80u, (z >> 9) & 0x7F80u,
                           (z >> 17) & 0x7F80u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(out[j]) : "r"(tab + off[j]));
}

// two rows of int8 indices (< 16), 4 columns each, as lookup_nibble_pairs' z
__device__ __forceinline__ uint32_t nibbles(uint32_t even, uint32_t odd) {
  return (even & 0x0F0F0F0Fu) | ((odd << 4) & 0xF0F0F0F0u);
}

// K > 16: out[j] = bf16x2 (tab[even byte j], tab[odd byte j])
__device__ __forceinline__ void lookup_pairs(uint32_t even, uint32_t odd,
                                             const uint16_t* tab, uint32_t (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = (uint32_t)tab[(even >> (8 * j)) & 0xFF] |
             ((uint32_t)tab[(odd >> (8 * j)) & 0xFF] << 16);
}

// The A registers of 16-deep slice kk of a stage's raw bytes for lane
// (g, q) whose columns start at byte coff of a row: p[j] holds reduction
// rows 2q, 2q + 1 of column j, r[j] rows 2q + 8, 2q + 9 (as bf16 pairs).
template <int BN, bool PACKED, bool PAIRS>
__device__ __forceinline__ void decode_slice(const uint8_t* raw, int kk, int q, int coff,
                                             uint32_t pairs, const uint16_t* tab,
                                             uint32_t (&p)[4], uint32_t (&r)[4]) {
  if constexpr (PACKED) {
    const uint8_t* row = raw + (8 * kk + q) * BN + coff;
    lookup_nibble_pairs(lds32(row), pairs, p);
    lookup_nibble_pairs(lds32(row + 4 * BN), pairs, r);
  } else {
    const uint8_t* row = raw + (16 * kk + 2 * q) * BN + coff;
    const uint32_t w0 = lds32(row), w1 = lds32(row + BN);
    const uint32_t w2 = lds32(row + 8 * BN), w3 = lds32(row + 9 * BN);
    if constexpr (PAIRS) {
      lookup_nibble_pairs(nibbles(w0, w1), pairs, p);
      lookup_nibble_pairs(nibbles(w2, w3), pairs, r);
    } else {
      lookup_pairs(w0, w1, tab, p);
      lookup_pairs(w2, w3, tab, r);
    }
  }
}

// ---------------------------------------------------------------------------
// one pipeline stage: x tile and raw assignment bytes
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, bool PACKED>
__device__ __forceinline__ void load_stage(uint8_t* st, const T* __restrict__ x,
                                           const uint8_t* __restrict__ a, int M, int N,
                                           int Kin, int m0, int n0, int k0, int kend,
                                           int xvec, int avec, bool x_by_tma = false) {
  using Tl = Tile<T, BM, BN, PACKED>;
  constexpr int CH = 16 / (int)sizeof(T);  // x elements a chunk
  constexpr int XC = kBK / CH;             // chunks of an x row
  for (int i = threadIdx.x; i < (x_by_tma ? 0 : BM * XC); i += kThreads) {
    const int r = i / XC, c = i % XC;
    const int gm = m0 + r, gk = k0 + c * CH;
    // bf16: chunk c of row r at c ^ (r % 8), so ldmatrix's rows hit
    // distinct banks
    uint8_t* dst = st + r * Tl::kXRow + ((Tl::kBf16 ? (c ^ (r & 7)) : c) << 4);
    if (xvec) {
      const bool ok = gm < M && gk < kend;
      cp_async16(dst, ok ? static_cast<const void*>(x + (size_t)gm * Kin + gk) : x, ok);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      T* e = reinterpret_cast<T*>(&v);
      if (gm < M)
#pragma unroll
        for (int j = 0; j < CH; ++j)
          if (gk + j < kend) e[j] = x[(size_t)gm * Kin + gk + j];
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  constexpr int RC = BN / 16;  // chunks of a raw row
  uint8_t* raw = st + Tl::kXBytes;
  for (int i = threadIdx.x; i < Tl::kRawRows * RC; i += kThreads) {
    const int r = i / RC, c = i % RC;
    const int gr = (PACKED ? k0 / 2 : k0) + r;  // row of A
    const bool row_ok = (PACKED ? 2 * gr : gr) < kend;
    const int gn = n0 + c * 16;
    uint8_t* dst = raw + r * BN + ((c ^ raw_swz<PACKED>(r)) << 4);
    if (avec) {
      const bool ok = row_ok && gn < N;
      cp_async16(dst, ok ? a + (size_t)gr * N + gn : a, ok);
    } else {
      union {
        uint4 v;
        uint8_t b[16];
      } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < N) u.b[e] = a[(size_t)gr * N + gn + e];
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }
}

// ---------------------------------------------------------------------------
// epilogue: float4 groups (row gm[g], columns gn..gn+3), masked at M and N
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* row, int gn, const float (&v)[4], int N,
                                       bool nvec) {
  if (nvec && gn + 4 <= N) {
    *reinterpret_cast<float4*>(row + gn) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (gn + e < N) row[gn + e] = v[e];
  }
}

__device__ __forceinline__ void load4(const float* row, int gn, float (&v)[4], int N,
                                      bool nvec) {
  if (nvec && gn + 4 <= N) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(row + gn));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = gn + e < N ? __ldcg(row + gn + e) : 0.f;
  }
}

template <int BM, int BN, int G>
__device__ __forceinline__ void finish(const float (&v)[G][4], const int (&gm)[G], int gn,
                                       float* __restrict__ y, float* __restrict__ part,
                                       int* __restrict__ ticket, int M, int N, int m0,
                                       int n0, int splits, int z) {
  const bool nvec = (N & 3) == 0;
  float* dst = splits == 1 ? y : part + (size_t)z * M * N;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (gm[g] < M) store4(dst + (size_t)gm[g] * N, gn, v[g], N, nvec);
  if (splits == 1) return;
  // this split's partial tile is published; draw the tile's ticket
  __shared__ int last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();  // ... before its ticket is drawn
  if (threadIdx.x == 0) last = atomicAdd(ticket + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other splits' partials, read below from L2
  // the last block: y = part[0] + part[1] + ... in split order. A thread
  // merges E float4 of the tile at a time, U splits of each, E x U loads
  // in flight: decode tiles (a few rows, many splits) one float4 over 8
  // splits, prefill tiles (64 or 128 rows, at most 8 or 4 splits) 4 or 8
  // over 2 (the registers of 128-register tiles allow 32 floats here).
  constexpr int E = BM > 64 ? 8 : (BM > 16 ? 4 : 1), U = BM > 16 ? 2 : 8, C4 = BN / 4;
  const size_t plane = (size_t)M * N;
  const int cells = min(BM, M - m0) * C4;
  for (int i0 = threadIdx.x; i0 < cells; i0 += E * kThreads) {
    float s[E][4];
    for (int z0 = 0; z0 < splits; z0 += U) {
      float t[U][E][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = i0 + e * kThreads;
          if (z0 + u < splits && i < cells)
            load4(part + (z0 + u) * plane + (size_t)(m0 + i / C4) * N, n0 + 4 * (i % C4),
                  t[u][e], N, nvec);
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (z0 + u < splits) s[e][c] = z0 + u == 0 ? t[u][e][c] : s[e][c] + t[u][e][c];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e * kThreads;
      if (i < cells) store4(y + (size_t)(m0 + i / C4) * N, n0 + 4 * (i % C4), s[e], N, nvec);
    }
  }
  if (threadIdx.x == 0) ticket[tile] = 0;  // for the next call (or replay)
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, bool PACKED, bool PAIRS>
__global__ void __launch_bounds__(kThreads, (Tile<T, BM, BN, PACKED>::kMinBlocks))
    lutq_gemm(const T* __restrict__ x, const uint8_t* __restrict__ a,
              const float* __restrict__ d, int n_dict, float* __restrict__ y,
              float* __restrict__ part, int* __restrict__ ticket, int M, int N, int Kin,
              int kchunk, int splits, int xvec, int avec,
              const __grid_constant__ CUtensorMap xmap) {
  using Tl = Tile<T, BM, BN, PACKED>;
  constexpr bool kPairs = Tl::kBf16 && PAIRS;
  // this block's expert and split, and the expert's operands
  const int e = blockIdx.z / splits, z = blockIdx.z % splits;
  x += (size_t)e * M * Kin;
  a += (size_t)e * (PACKED ? Kin / 2 : Kin) * N;
  d += (size_t)e * n_dict;
  y += (size_t)e * M * N;
  if (splits > 1) {
    part += (size_t)e * splits * M * N;
    ticket += (size_t)e * gridDim.x * gridDim.y;
  }
  const int xrow = e * M;  // the expert's first row in the TMA map of x
  extern __shared__ __align__(128) uint8_t smem_dyn[];
  // 1024-byte aligned (the swizzled x tiles wgmma reads), then the pair
  // table, then the ring
  uint8_t* smem_all = smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  uint8_t* smem = smem_all + (kPairs ? kPairTable : 0);
  __shared__ __align__(16) float sdict[kMaxDict];  // f32 entries, or bf16 bits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = z * kchunk;
  const int kend = min(Kin, kbeg + kchunk);
  const int steps = (kend - kbeg + kBK - 1) / kBK;

  // wgmma with aligned x rows: the x tiles come by TMA (see the top)
  __shared__ __align__(8) uint64_t xbar[Tl::kStages];
  const bool tma = Tl::kWgmma && xvec;
  if (tma && tid == 0) {
    for (int s = 0; s < Tl::kStages; ++s) mbar_init(&xbar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tma) __syncthreads();
  // the ring's first stages are in flight while the dictionary is set up
  constexpr int kAhead = Tl::kWgmma ? Tl::kStages - 2 : Tl::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) {
      load_stage<T, BM, BN, PACKED>(smem + s * Tl::kStageBytes, x, a, M, N, Kin, m0, n0,
                                    kbeg + s * kBK, kend, xvec, avec, tma);
      if (tma && tid == 0)
        tma_load_x(smem + s * Tl::kStageBytes, &xmap, kbeg + s * kBK, xrow + m0, &xbar[s],
                   Tl::kXBytes);
    }
    cp_async_commit();
  }

  if constexpr (kPairs) {
    // thread b writes entry b's 32 copies, 16 bytes at a time, starting
    // at its own offset so that a store's 8 lanes hit distinct banks
    const int b = tid;
    const float lo = (b & 15) < n_dict ? __ldg(d + (b & 15)) : 0.f;
    const float hi = (b >> 4) < n_dict ? __ldg(d + (b >> 4)) : 0.f;
    const uint32_t pair = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
                          ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
    uint4* row = reinterpret_cast<uint4*>(smem_all + b * 128);
#pragma unroll
    for (int c = 0; c < 8; ++c) row[(c + b) & 7] = make_uint4(pair, pair, pair, pair);
  } else {
    for (int i = tid; i < kMaxDict; i += kThreads) {
      const float v = i < n_dict ? d[i] : 0.f;
      if constexpr (Tl::kBf16)
        reinterpret_cast<uint16_t*>(sdict)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      else
        sdict[i] = v;
    }
  }

  // step i: wait for stage i, refill the slot step i - 1 used, then the
  // products of stage i
#define LUTQ_NEXT_STAGE(i)                                                                  \
  cp_async_wait<Tl::kStages - 2>();                                                         \
  __syncthreads(); /* stage i landed for all; the slot of step i - 1 is free */            \
  if ((i) + Tl::kStages - 1 < steps)                                                        \
    load_stage<T, BM, BN, PACKED>(                                                          \
        smem + (((i) + Tl::kStages - 1) % Tl::kStages) * Tl::kStageBytes, x, a, M, N, Kin, \
        m0, n0, kbeg + ((i) + Tl::kStages - 1) * kBK, kend, xvec, avec);                    \
  cp_async_commit();                                                                        \
  const uint8_t* st = smem + ((i) % Tl::kStages) * Tl::kStageBytes;

  if constexpr (Tl::kWgmma) {
    // warpgroup wg owns columns 128 wg .. + 127; warp w of it rows 16 w ..
    // of both 64-row A operands: wgmma j's row 16 w + g is column
    // 128 wg + 32 w + 4 g + 2 j, row 16 w + g + 8 the next column
    const int wg = warp >> 2, w = warp & 3;
    const int g = lane >> 2, q = lane & 3;
    const int nb = 128 * wg + 32 * w + 4 * g;
    const int coff = (((nb >> 4) ^ (q << 1)) << 4) | (nb & 15);
    const uint16_t* tab = reinterpret_cast<const uint16_t*>(sdict);
    const uint32_t pairs = smem_u32(smem_all) + 4 * lane;
    float acc[2][64];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[j][e] = 0.f;

    // Step i refills the slot of step i - 2, STAGES - 2 steps ahead, so
    // that step i - 1's products may still run while step i is decoded;
    // slice kk of step i decodes into A[kk] once slice kk of step i - 1
    // is done (at most 3 later commit groups still in flight).
    uint32_t A[kBK / 16][2][4];
    for (int i = 0; i < steps; ++i) {
      cp_async_wait<Tl::kStages - 3>();
      if (!tma) fence_proxy_async();
      wgmma_wait<kBK / 16>();  // step i - 2's products are done ...
      __syncthreads();         // ... in both warpgroups: refill its slot
      const int nx = i + Tl::kStages - 2;
      if (nx < steps) {
        uint8_t* slot = smem + (nx % Tl::kStages) * Tl::kStageBytes;
        load_stage<T, BM, BN, PACKED>(slot, x, a, M, N, Kin, m0, n0, kbeg + nx * kBK, kend,
                                      xvec, avec, tma);
        if (tma && tid == 0)
          tma_load_x(slot, &xmap, kbeg + nx * kBK, xrow + m0, &xbar[nx % Tl::kStages],
                     Tl::kXBytes);
      }
      cp_async_commit();
      if (tma) mbar_wait(&xbar[i % Tl::kStages], (i / Tl::kStages) & 1);
      const uint8_t* st = smem + (i % Tl::kStages) * Tl::kStageBytes;
      const uint8_t* raw = st + Tl::kXBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t p[4], r[4];
        decode_slice<BN, PACKED, PAIRS>(raw, kk, q, coff, pairs, tab, p, r);
        wgmma_wait<kBK / 16 - 1>();  // slice kk of step i - 1 read A[kk]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(A[kk][j][e]);
        A[kk][0][0] = p[0], A[kk][0][1] = p[1], A[kk][0][2] = r[0], A[kk][0][3] = r[1];
        A[kk][1][0] = p[2], A[kk][1][1] = p[3], A[kk][1][2] = r[2], A[kk][1][3] = r[3];
        const uint64_t desc = sw128_desc(smem_u32(st) + 32 * kk);
        wgmma_fence();
        WgmmaRS<128>::mma<0>(acc[0], A[kk][0], desc, 1);
        WgmmaRS<128>::mma<0>(acc[1], A[kk][1], desc, 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(A[kk][j][e]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 64; ++e) pin(acc[j][e]);

    // acc[j][4 t + e]: token 8 t + 2 q + (e & 1), column nb + 2 j + (e >> 1)
    float v[32][4];
    int gm[32];
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[2 * t + h][0] = acc[0][4 * t + h];
        v[2 * t + h][1] = acc[0][4 * t + 2 + h];
        v[2 * t + h][2] = acc[1][4 * t + h];
        v[2 * t + h][3] = acc[1][4 * t + 2 + h];
        gm[2 * t + h] = m0 + 8 * t + 2 * q + h;
      }
    finish<BM, BN, 32>(v, gm, n0 + nb, y, part, ticket, M, N, m0, n0, splits, z);
  } else if constexpr (Tl::kBf16) {
    constexpr int MF = Tl::kMF;
    const int wn = warp % Tl::kWN, wm = warp / Tl::kWN;
    const int g = lane >> 2, q = lane & 3;
    const int nb = 32 * wn + 4 * g;  // the lane's 4 columns in the tile
    const int coff = (((nb >> 4) ^ (q << 1)) << 4) | (nb & 15);
    const int xrow0 = wm * 8 * MF;
    // ldmatrix: lane l addresses row l % 8 of matrix l / 8; matrices
    // (fragment f, k 0-7), (f, k 8-15), (f + 1, k 0-7), (f + 1, k 8-15)
    const int mi = lane >> 3, ri = lane & 7;
    const int lrow = xrow0 + 8 * (MF > 1 ? (mi >> 1) : 0) + ri;
    const uint16_t* tab = reinterpret_cast<const uint16_t*>(sdict);
    const uint32_t pairs = smem_u32(smem_all) + 4 * lane;  // this lane's column
    float acc[MF][2][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

    for (int i = 0; i < steps; ++i) {
      LUTQ_NEXT_STAGE(i)
      const uint8_t* raw = st + Tl::kXBytes;
      const uint32_t xs = smem_u32(st) + lrow * Tl::kXRow;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A fragments of the two 16-column tiles: tile j's row g is
        // column nb + 2j, row g + 8 is nb + 2j + 1
        uint32_t p[4], r[4];
        decode_slice<BN, PACKED, PAIRS>(raw, kk, q, coff, pairs, tab, p, r);
        const uint32_t A0[4] = {p[0], p[1], r[0], r[1]};
        const uint32_t A1[4] = {p[2], p[3], r[2], r[3]};
        const uint32_t xa = xs + (((2 * kk + (mi & 1)) ^ ri) << 4);
        if constexpr (MF == 1) {
          uint32_t b0, b1;
          ldsm_x2(xa, b0, b1);
          mma_bf16(acc[0][0], A0, b0, b1);
          mma_bf16(acc[0][1], A1, b0, b1);
        } else {
#pragma unroll
          for (int f = 0; f < MF; f += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(xa + f * 8 * Tl::kXRow, b0, b1, b2, b3);
            mma_bf16(acc[f][0], A0, b0, b1);
            mma_bf16(acc[f][1], A1, b0, b1);
            mma_bf16(acc[f + 1][0], A0, b2, b3);
            mma_bf16(acc[f + 1][1], A1, b2, b3);
          }
        }
      }
    }

    // c0, c1: (column nb + 2j, rows 2q, 2q + 1); c2, c3: column nb + 2j + 1
    float v[2 * MF][4];
    int gm[2 * MF];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[2 * f + h][0] = acc[f][0][h];
        v[2 * f + h][1] = acc[f][0][2 + h];
        v[2 * f + h][2] = acc[f][1][h];
        v[2 * f + h][3] = acc[f][1][2 + h];
        gm[2 * f + h] = m0 + xrow0 + 8 * f + 2 * q + h;
      }
    finish<BM, BN, 2 * MF>(v, gm, n0 + nb, y, part, ticket, M, N, m0, n0, splits, z);
  } else {
    // f32: thread (tm, tn) owns rows tm + kTM r and columns 4 tn .. + 3
    constexpr int R = Tl::kR;
    const int tn = tid % Tl::kTN, tm = tid / Tl::kTN;
    const int col = 4 * tn;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

    for (int i = 0; i < steps; ++i) {
      LUTQ_NEXT_STAGE(i)
      const float* xs = reinterpret_cast<const float*>(st);
      const uint8_t* raw = st + Tl::kXBytes;
#pragma unroll 4
      for (int r = 0; r < Tl::kRawRows; ++r) {
        const uint32_t w =
            lds32(raw + r * BN + (((col >> 4) ^ raw_swz<PACKED>(r)) << 4) + (col & 15));
#pragma unroll
        for (int h = 0; h < (PACKED ? 2 : 1); ++h) {
          const int k = PACKED ? 2 * r + h : r;
          float wv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wv[e] = sdict[PACKED ? (w >> (8 * e + 4 * h)) & 0xF : (w >> (8 * e)) & 0xFF];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float xv = xs[(tm + Tl::kTM * rr) * kBK + k];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rr][e] = fmaf(xv, wv[e], acc[rr][e]);
          }
        }
      }
    }

    int gm[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) gm[rr] = m0 + tm + Tl::kTM * rr;
    finish<BM, BN, R>(acc, gm, n0 + col, y, part, ticket, M, N, m0, n0, splits, z);
  }
#undef LUTQ_NEXT_STAGE
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// x (M, Kin) bf16 (elem 2) or int8 (elem 1, lutq_shift.cu) as a TMA
// tensor map: boxes of one 128-byte row segment (64 or 128 values) x
// rows, 128-byte swizzle, zero fill past the edges. 0 on success.
int x_tensor_map(CUtensorMap* map, const void* x, int M, int Kin, int elem = 2,
                 int rows = 128) {
  int rc;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder(&rc);
  if (encode == nullptr) return rc;
  const cuuint64_t dims[2] = {(cuuint64_t)Kin, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)Kin * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            2, const_cast<void*>(x),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int BM, int BN, bool PACKED, bool PAIRS>
int launch_tile(int device, const void* x, const void* a, const void* d, int n_dict,
                float* y, float* part, int* ticket, int M, int N, int Kin, int splits,
                int kchunk, int experts, int xvec, int avec, cudaStream_t stream) {
  auto kernel = lutq_gemm<T, BM, BN, PACKED, PAIRS>;
  CUtensorMap xmap = {};
  if (Tile<T, BM, BN, PACKED>::kWgmma && xvec) {
    // every expert's rows in one map: an expert's tile past its M rows
    // reads the next expert's (or zero-filled) rows, whose outputs are
    // masked, and each output row depends on its own x row only
    const int rc = x_tensor_map(&xmap, x, experts * M, Kin);
    if (rc != 0) return rc;
  }
  constexpr int smem =
      1024 + Tile<T, BM, BN, PACKED>::kSmem + (sizeof(T) == 2 && PAIRS ? kPairTable : 0);
  // opt in to the ring's dynamic shared memory once per device (not a
  // stream operation, so it stays out of a CUDA graph being captured)
  static bool opted[kMaxDevices] = {};
  if (device >= kMaxDevices || !opted[device]) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    if (device < kMaxDevices) opted[device] = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits * experts);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(a), static_cast<const float*>(d),
      n_dict, y, part, ticket, M, N, Kin, kchunk, splits, xvec, avec, xmap);
  return (int)cudaGetLastError();
}

// the tiles build.GEMM_TILES names, and nothing else
template <typename T, bool PACKED, bool PAIRS>
int launch_typed(int bm, int bn, int device, const void* x, const void* a, const void* d,
                 int n_dict, float* y, float* part, int* ticket, int M, int N, int Kin,
                 int splits, int kchunk, int experts, int xvec, int avec,
                 cudaStream_t stream) {
#define LUTQ_TILE(BM_, BN_)                                                                \
  if (bm == BM_ && bn == BN_)                                                              \
    return launch_tile<T, BM_, BN_, PACKED, PAIRS>(device, x, a, d, n_dict, y, part,     \
                                                     ticket, M, N, Kin, splits, kchunk,    \
                                                     experts, xvec, avec, stream);
  LUTQ_TILE(8, 256)
  LUTQ_TILE(16, 256)
  LUTQ_TILE(64, 128)
  LUTQ_TILE(128, 256)
#undef LUTQ_TILE
  return (int)cudaErrorInvalidValue;
}

// Returns the first CUDA error of the launch (0 on success). The library
// links its own CUDA runtime, whose current device is not the caller's:
// it is set here from the wrapper's device index. part (experts, splits,
// M, N) f32 and ticket (one int32 per output tile of every expert, zero on
// entry and left zero) are needed when splits > 1. experts: the products
// of the stack (1 for a plain product); n_dict is each expert's K.
template <bool PACKED>
int launch(int device, const void* x, int x_bf16, const void* a, int avec, int xvec,
           const void* d, int n_dict, void* y, void* part, void* ticket, int M, int N,
           int Kin, int bm, int bn, int splits, int kchunk, int experts,
           cudaStream_t stream) {
  if (splits < 1 || kchunk < 1 || kchunk % kBK != 0 || (splits > 1 && (!part || !ticket)) ||
      n_dict < 1 || n_dict > (PACKED ? 16 : kMaxDict) || (PACKED && Kin % 2 != 0) ||
      experts < 1 || (long long)experts * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  float* yp = static_cast<float*>(y);
  float* pp = static_cast<float*>(part);
  int* tp = static_cast<int*>(ticket);
  if (!x_bf16)
    return launch_typed<float, PACKED, false>(bm, bn, device, x, a, d, n_dict, yp, pp, tp, M,
                                              N, Kin, splits, kchunk, experts, xvec, avec,
                                              stream);
  if (PACKED || n_dict <= 16)
    return launch_typed<__nv_bfloat16, PACKED, true>(bm, bn, device, x, a, d, n_dict, yp, pp,
                                                     tp, M, N, Kin, splits, kchunk, experts,
                                                     xvec, avec, stream);
  if constexpr (!PACKED)
    return launch_typed<__nv_bfloat16, false, false>(bm, bn, device, x, a, d, n_dict, yp, pp,
                                                     tp, M, N, Kin, splits, kchunk, experts,
                                                     xvec, avec, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
