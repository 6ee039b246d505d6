// Blocked attention with an online softmax, causal or full, per
// flattened (batch, head) row: q (BH, S, D), k and v (BH, Skv, D), all
// bf16 or all f32, output in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::
// flash_attention_tpu (body _kernel, pallas_call at :93). Function, for
// each kv block j of bk rows in order (the reference's innermost grid
// axis, so the running max moves where the reference's does):
//   s     = (q . k^T accumulated in f32) * scale
//   s     = -1e30 where query row < key row (causal; no offset when
//           Skv != S)
//   m_new = max(m, rowmax(s)); p = exp(s - m_new); alpha = exp(m - m_new)
//   l     = l * alpha + rowsum(p)               (p in f32)
//   acc   = acc * alpha + round_to_v_dtype(p) . v   (f32 accumulation)
// and out = acc / max(l, 1e-30) in q's dtype, with m = -1e30, l = 0,
// acc = 0 at the start. Under causal a kv block whose first row lies
// past the last query row of a warpgroup (flash_wgmma), a warp
// (flash_bf16) or a thread's row (flash_f32) is never read: the
// reference skips every such block of its q block (j*bk >= (i+1)*bq),
// and a block that is wholly masked for a row adds exactly nothing (p =
// 0, alpha = 1), so skipping it keeps the bits. The wrapper's plan
// (flash_attn.plan, shapes only) sends a bf16 call to flash_wgmma when
// bq is a multiple of 64 or all of S (so the 64 rows of a warpgroup lie
// in one of the reference's q blocks and no block the reference skips is
// read for them) and bk is 16, 32, 64 or 128; other bf16 calls (bq a
// multiple of 16) to flash_bf16, whose 16-row warps lie in one q block.
//
// Bound on the H100: at danube's prefill geometry (BH = 128, S = 512,
// D = 80, causal) the bytes of q, k, v and out (41.9 MB, 12.5 us at
// 3.35 TB/s) outweigh the causal bf16 operations (5.4 us at 989
// TFLOP/s); at one 4096-token row (BH = 32) the operations bound it
// (86.9 us of bf16 tensor-core work against 25 us of bytes).
//
// What the design does about it, flash_wgmma (bf16, sm_90a): a
// persistent block an SM of two consumer warpgroups (64 query rows each)
// and a producer warpgroup walks the (bh, 128-row q tile) pairs, longest
// causal tiles first, in a snake order that evens out the blocks' work;
// the producer hands its registers to the consumers (setmaxnreg), and
// one of its lanes loads each q tile once and streams the K and V
// tiles (bk x D) by TMA into a ring of shared-memory stages: each K or V
// tile completes on its own "full" mbarrier, and every consumer warp
// releases a stage through its "empty" mbarrier once its products have
// read it; under causal the producer loads only the tiles up to the q
// tile's last row. The tiles are 32-byte panels (16 head-dim values a
// row, TMA's 32-byte swizzle), so any D that is a multiple of 16 fits
// (D = 80 is five panels; the 128-byte swizzle would need 64-wide rows).
// Each consumer warp keeps its q rows as wgmma A fragments in registers
// for the whole kv loop. S = q K^T is wgmma.m64n{bk}k16 (A from
// registers, B the K tile, K-major, D / 16 steps); the mask (only on
// tiles that cross the diagonal) and the online softmax run on
// the accumulator registers (a warp's rows keep the m16n8 C layout: a
// row's max and sum are 4-lane shuffles), in base 2 with the scale folded
// into one FMA before the SFU's 2^x (kernels.ref.flash_attention_exp2_ref
// emulates that order); the probabilities are rounded to bf16 pairs in
// registers, which are exactly the A fragments of PV: wgmma.m64n{D}k16
// with the V tile as B in N-major layout (the transpose bit). The PV of
// tile j runs while the scores of tile j + 1 are reduced (the two
// products are issued back to back, the softmax waits only for the
// first), and the two warpgroups issue in alternate turns (named
// barriers), so that one's softmax runs under the other's products. The
// output divides by l through one correctly rounded reciprocal a row
// (Markstein's correction gives the IEEE quotient).
// flash_bf16 (the first, simple kernel, kept for q blocks of 16, 32 or
// 48 rows mod 64): one block of four warps per (bh, 64-row q tile), each
// warp owning 16 query rows whose q fragments stay in registers; K and V
// tiles staged in shared memory by synchronous loads, QK^T and PV as
// mma.sync.m16n8k16 bf16 fed by ldmatrix. flash_f32: one thread per
// query row on CUDA cores (f32 FMA, no TF32: the reference's f32 result
// is full f32), with the K/V tiles, the row's q, accumulator and
// probabilities in shared memory.
#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows of a bf16 block
constexpr int kMaxBk = 128;          // kv rows of a tile
constexpr int kPad = 8;              // bf16 elements of padding per shared row
constexpr int kF32Rows = 64;         // query rows (= threads) of an f32 block
constexpr float kNegInf = -1e30f;    // the reference's mask value
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block can opt into

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bf16: grid (BH, q tiles); block of kWarps warps, warp w owning query
// rows q0 + 16 w .. + 15. Fragment layouts of m16n8k16 (g = lane / 4,
// t = lane % 4): A holds rows g and g + 8, columns 2t, 2t + 1 (+ 8);
// B holds k rows 2t, 2t + 1 (+ 8) of column g; C holds rows g and g + 8,
// columns 2t and 2t + 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
               int Skv, int bk, int causal, float scale) {
  constexpr int LD = D + kPad;  // shared row stride, elements
  constexpr int KT = D / 16;    // k steps of QK^T
  constexpr int NO = D / 8;     // n tiles of the output
  constexpr int CH = D / 8;     // 16-byte chunks of a row
  constexpr int NS = kMaxBk / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * LD;
  __nv_bfloat16* vs = ks + bk * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: matrix and row of this lane
  const size_t qoff = (size_t)bh * S * D;
  const size_t koff = (size_t)bh * Skv * D;

  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(q + qoff + (size_t)(q0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = val;
  }
  __syncthreads();

  const int r0 = q0 + warp * 16;               // the warp's first query row
  const int last_row = min(r0 + 15, S - 1);    // its last valid one
  uint32_t qf[KT][4];
  {
    const __nv_bfloat16* base = qs + (warp * 16 + ri + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      ldsm_x4(smem_u32(base + kt * 16), qf[kt][0], qf[kt][1], qf[kt][2], qf[kt][3]);
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int row_a = r0 + g, row_b = r0 + g + 8;

  const int block_last = min(q0 + kRows - 1, S - 1);
  const int nkv = Skv / bk;
  const int nblk = causal ? min(nkv, block_last / bk + 1) : nkv;
  for (int j = 0; j < nblk; ++j) {
    const __nv_bfloat16* kg = k + koff + (size_t)j * bk * D;
    const __nv_bfloat16* vg = v + koff + (size_t)j * bk * D;
    for (int i = threadIdx.x; i < bk * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      *reinterpret_cast<uint4*>(ks + r * LD + c * 8) =
          *reinterpret_cast<const uint4*>(kg + (size_t)r * D + c * 8);
      *reinterpret_cast<uint4*>(vs + r * LD + c * 8) =
          *reinterpret_cast<const uint4*>(vg + (size_t)r * D + c * 8);
    }
    __syncthreads();
    if (r0 < S && (!causal || j * bk <= last_row)) {  // warp-uniform
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // s = q k^T: ldmatrix.x4 of K rows gives the B fragments of two
      // n tiles (16 kv rows) at one k step of 16 head-dim columns
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        if (np * 16 < bk) {
          const __nv_bfloat16* kb = ks + (np * 16 + ri + (mi >> 1) * 8) * LD + (mi & 1) * 8;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(smem_u32(kb + kt * 16), b0, b1, b2, b3);
            mma_bf16(s[2 * np], qf[kt][0], qf[kt][1], qf[kt][2], qf[kt][3], b0, b1);
            mma_bf16(s[2 * np + 1], qf[kt][0], qf[kt][1], qf[kt][2], qf[kt][3], b2, b3);
          }
        }
      }
      // scale, mask, row max over the four lanes of a row
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      const int kbase = j * bk + tig * 2;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n * 8 < bk) {
          const int col = kbase + n * 8;
          s[n][0] *= scale;
          s[n][1] *= scale;
          s[n][2] *= scale;
          s[n][3] *= scale;
          if (causal) {
            if (col > row_a) s[n][0] = kNegInf;
            if (col + 1 > row_a) s[n][1] = kNegInf;
            if (col > row_b) s[n][2] = kNegInf;
            if (col + 1 > row_b) s[n][3] = kNegInf;
          }
          mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
      }
      float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m_run[h], mx[h]);
        alpha[h] = expf(m_run[h] - m_new[h]);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n * 8 < bk) {
          s[n][0] = expf(s[n][0] - m_new[0]);
          s[n][1] = expf(s[n][1] - m_new[0]);
          s[n][2] = expf(s[n][2] - m_new[1]);
          s[n][3] = expf(s[n][3] - m_new[1]);
          psum[0] += s[n][0] + s[n][1];
          psum[1] += s[n][2] + s[n][3];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] = l_run[h] * alpha[h] + psum[h];
        m_run[h] = m_new[h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // acc += bf16(p) v: the C fragments of two score n tiles are the A
      // fragment of one 16-wide k step; ldmatrix.x4.trans of V rows gives
      // the B fragments of two output n tiles
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        if (kc * 16 < bk) {
          const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
          const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
          const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
          const __nv_bfloat16* vb = vs + (kc * 16 + ri + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(smem_u32(vb + dp * 16), b0, b1, b2, b3);
            mma_bf16(o[2 * dp], a0, a1, a2, a3, b0, b1);
            mma_bf16(o[2 * dp + 1], a0, a1, a2, a3, b2, b3);
          }
        }
      }
    }
    __syncthreads();
  }

  if (r0 < S) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], off);
      l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], off);
    }
    const float den_a = fmaxf(l_run[0], 1e-30f), den_b = fmaxf(l_run[1], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + tig * 2;
      if (row_a < S)
        *reinterpret_cast<__nv_bfloat162*>(out + qoff + (size_t)row_a * D + col) =
            __floats2bfloat162_rn(o[n][0] / den_a, o[n][1] / den_a);
      if (row_b < S)
        *reinterpret_cast<__nv_bfloat162*>(out + qoff + (size_t)row_b * D + col) =
            __floats2bfloat162_rn(o[n][2] / den_b, o[n][3] / den_b);
    }
  }
}

// f32: grid (BH, q tiles of kF32Rows rows), one thread per query row.
// Shared: the K and V tiles (bk x D), then per row (padded to odd
// strides, so the rows of a warp hit distinct banks) q, the
// accumulator and the tile's scores / probabilities.
__global__ void __launch_bounds__(kF32Rows)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S, int Skv, int D,
              int bk, int causal, float scale) {
  extern __shared__ float fsm[];
  const int ldq = D + 1, lds = bk + 1;
  float* ks = fsm;
  float* vs = ks + bk * D;
  float* qs = vs + bk * D;
  float* acc = qs + kF32Rows * ldq;
  float* ps = acc + kF32Rows * ldq;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Rows;
  const int t = threadIdx.x;
  const int row = q0 + t;
  const size_t qoff = (size_t)bh * S * D;
  const size_t koff = (size_t)bh * Skv * D;
  for (int i = t; i < kF32Rows * D; i += kF32Rows) {
    const int r = i / D, d = i % D;
    qs[r * ldq + d] = q0 + r < S ? q[qoff + (size_t)(q0 + r) * D + d] : 0.f;
    acc[r * ldq + d] = 0.f;
  }
  float* qr = qs + t * ldq;
  float* ar = acc + t * ldq;
  float* pr = ps + t * lds;
  float m_run = kNegInf, l_run = 0.f;

  const int block_last = min(q0 + kF32Rows - 1, S - 1);
  const int nkv = Skv / bk;
  const int nblk = causal ? min(nkv, block_last / bk + 1) : nkv;
  for (int j = 0; j < nblk; ++j) {
    __syncthreads();  // the previous tile is consumed (and q staged)
    for (int i = t; i < bk * D; i += kF32Rows) {
      ks[i] = k[koff + (size_t)j * bk * D + i];
      vs[i] = v[koff + (size_t)j * bk * D + i];
    }
    __syncthreads();
    if (row < S && (!causal || j * bk <= row)) {
      float mx = -CUDART_INF_F;
      for (int c = 0; c < bk; ++c) {
        const float* kr = ks + c * D;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        float sc = dot * scale;
        if (causal && j * bk + c > row) sc = kNegInf;
        pr[c] = sc;
        mx = fmaxf(mx, sc);
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float psum = 0.f;
      for (int c = 0; c < bk; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        psum += p;
      }
      l_run = l_run * alpha + psum;
      for (int d = 0; d < D; ++d) {
        float pv = 0.f;
        for (int c = 0; c < bk; ++c) pv = fmaf(pr[c], vs[c * D + d], pv);
        ar[d] = ar[d] * alpha + pv;
      }
      m_run = m_new;
    }
  }
  if (row < S) {
    const float den = fmaxf(l_run, 1e-30f);
    for (int d = 0; d < D; ++d) out[qoff + (size_t)row * D + d] = ar[d] / den;
  }
}

// ---------------------------------------------------------------------------
// flash_wgmma: bf16 on wgmma, K/V streamed by TMA from a producer warp
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // query rows of a consumer warpgroup

template <int D, int BK>
struct WgTile {
  static constexpr int kCons = 2;                    // consumer warpgroups
  static constexpr int kRows = kWgRows * kCons;      // query rows of a q tile
  static constexpr int kThreads = 128 * (kCons + 1); // consumers, then the producer
  static constexpr int kPanel = 32;                  // bytes of a panel row: 16 values
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = BK * D * 2;      // one K or V tile
  static constexpr int kFit = (kMaxSmem - 1024 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
  // registers a thread after setmaxnreg: the producer's few, the rest of
  // the SM's 64K to the consumers
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static_assert(kStages >= 2, "two stages of K and V must fit");
  static_assert(128 * (kProducerRegs + kCons * kConsumerRegs) <= 65536, "registers");
};

// wgmma descriptor of a bf16 tile of 32-byte panel rows under the 32-byte
// swizzle (16-byte half h of row r at h ^ ((r >> 2) & 1), 8-row groups
// 256 bytes apart, 256-byte aligned); lbo: bytes from one panel (16
// N-values) to the next, read for an N-major operand
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// kv tiles of consumer warpgroup c of the block at q0: all of them, or
// under causal those up to the one that holds its last row; none for a
// warpgroup wholly past S
__device__ __forceinline__ int wg_tiles(int q0, int c, int S, int nkv, int bk, int causal) {
  const int r0 = q0 + kWgRows * c;
  if (r0 >= S) return 0;
  return causal ? min(nkv, min(r0 + kWgRows - 1, S - 1) / bk + 1) : nkv;
}

// o += p v (V tile at shared address vt, bk rows of D / 16 panels):
// issued, not waited for
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    WgmmaRS<D>::template mma<1>(o, p[kc], sw32_desc(vt + kc * 16 * 32, BK * 32), 1);
  wgmma_commit();
}

// after a PV is done: its registers stay where they are until here, and
// the warp releases the stage it read
template <int D, int BK>
__device__ __forceinline__ void retire_pv(float (&o)[D / 2], uint32_t (&p)[BK / 16][4],
                                          uint64_t* empty) {
#pragma unroll
  for (int e = 0; e < D / 2; ++e) pin(o[e]);
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(p[kc][e]);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// named barriers (0 is __syncthreads'): wait for `threads` arrivals, or
// arrive without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a / b correctly rounded, from r = 1 / b correctly rounded (one
// reciprocal a row instead of one a quotient): q = a r is within an ulp,
// its remainder a - b q is exact in one FMA, and q + r (a - b q) rounds to
// a / b (Markstein); a, b finite, b >= 1e-30 and the quotient normal
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}

// 2^x by the SFU (ex2.approx, flush to zero: 2^x below 2^-126 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = q k^T of one tile (K tile at shared address kt, bk rows of D / 16
// panels): issued, not waited for
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const uint32_t (&qf)[D / 16][4],
                                         uint32_t kt) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    WgmmaRS<BK>::template mma<0>(s, qf[k], sw32_desc(kt + k * BK * 32, 16), k);
  wgmma_commit();
}

// the operands' last writes (the softmax's) come before the fence that
// precedes the products reading them
template <int D, int BK>
__device__ __forceinline__ void pin_operands(float (&o)[D / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int e = 0; e < D / 2; ++e) pin(o[e]);
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(p[kc][e]);
}

// The online-softmax update of one tile in base 2: s holds the lane's raw
// scores (rows row_a, row_b; element 4 j + e at column col0 + 8 j + (e &
// 1)), masked where the tile crosses the diagonal (diag), and leaves p;
// m_run (raw) and l_run (this lane's share) move on, alpha scales o.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], bool diag,
                                             int col0, int row_a, int row_b, float sl2) {
  // each row's max in four independent chains and its sum in two (the
  // lane's 32 scores of a row are one dependent chain otherwise): the max
  // is exact in any order; the sum's order is the kernel's own
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h][0] = mx[h][1] = mx[h][2] = mx[h][3] = m_run[h];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (diag && col0 + 8 * j + (e & 1) > (e < 2 ? row_a : row_b)) s[4 * j + e] = -CUDART_INF_F;
      const int c = 2 * (j & 1) + (e & 1);
      mx[e >> 1][c] = fmaxf(mx[e >> 1][c], s[4 * j + e]);
    }
  float m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the four lanes of a row
    m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], off));
    m[1] = fmaxf(m[1], __shfl_xor_sync(0xffffffffu, m[1], off));
  }
  float ms[2], psum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ms[h] = m[h] == -CUDART_INF_F ? 0.f : m[h] * sl2;  // a row with no score yet
    alpha[h] = ex2(m_run[h] * sl2 - ms[h]);
    m_run[h] = m[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms[e >> 1]));
      psum[e >> 1][e & 1] += s[4 * j + e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + (psum[h][0] + psum[h][1]);
}

// o *= alpha, and the probabilities rounded to bf16 pairs: the C
// fragments of score tiles 2 kc and 2 kc + 1 are the A fragment of PV's k
// step kc
template <int D, int BK>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2], uint32_t (&p)[BK / 16][4],
                                             const float (&s)[BK / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// round r of block b in a grid of G: forward in even rounds, backward in
// odd ones (a snake), so that every block's causal tiles sum to about the
// same work
__device__ __forceinline__ int q_tile_of(int r, int b, int G) {
  return r * G + ((r & 1) ? G - 1 - b : b);
}

// A persistent grid walks the q tiles (bh, 128 query rows), tile i at bh
// = i % BH and the (i / BH)-th q tile from the end (the longest causal
// tiles first): block b takes tile q_tile_of(r, b, G) in round r = 0, 1,
// ..., which pairs long and short causal tiles. Three warpgroups: two
// consumers (warpgroup c owns rows q0 + 64 c ..) and the producer. Shared
// memory (1024-byte aligned): the q tile, then the ring's stages, each a
// K tile and a V tile; every tile D / 16 panels of its rows x 32 bytes.
// The ring's stages and phases count the kv tiles the block loads over
// all its q tiles; the producer loads the next q tile once every consumer
// warp holds the last one in registers. The softmax runs in base 2 on the raw scores (FlashAttention's
// order): the running max m is taken over raw scores (masked ones -inf),
// and p = 2^(s log2(e) scale - m log2(e) scale) with the product folded
// into one FMA, alpha = 2^((m_old - m) log2(e) scale); scale > 0, so the
// max moves where the reference's moves (kernels.ref.flash_attention_
// exp2_ref emulates this order).
template <int D, int BK>
__global__ void __launch_bounds__(WgTile<D, BK>::kThreads, 1)
    flash_wgmma(__nv_bfloat16* __restrict__ out, int BH, int S, int Skv, int causal,
                float scale, const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap) {
  using T = WgTile<D, BK>;
  constexpr int KT = D / 16;  // k steps of QK^T: the panels of a row
  constexpr int NS = BK / 8;  // n tiles of the scores
  constexpr int NO = D / 8;   // n tiles of the output
  constexpr int ST = T::kStages;
  extern __shared__ __align__(128) uint8_t smem_dyn[];
  uint8_t* qs = smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  uint8_t* ring = qs + T::kQBytes;  // stage s: K at 2 s tiles, V after it
  __shared__ __align__(8) uint64_t qfull, qempty, kfull[ST], vfull[ST], empty[ST];

  const int nq = (S + T::kRows - 1) / T::kRows;
  const int ntiles = BH * nq;
  const int nkv = Skv / BK;
  // the warpgroup, read through a shuffle so that the compiler knows it
  // is uniform (ptxas serializes wgmma on a path it takes as divergent)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&qfull);
    mbar_init(&qempty, 4 * T::kCons);  // every consumer warp has read q
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kfull[s]);
      mbar_init(&vfull[s]);
      mbar_init(&empty[s], 4 * T::kCons);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::kCons) {  // the producer: one lane issues every copy
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 128 * T::kCons) {
      int it = 0;  // kv tiles loaded
      int k = 0;   // q tiles of this block
      for (int r = 0; r * (int)gridDim.x < ntiles; ++r) {
        const int i = q_tile_of(r, blockIdx.x, gridDim.x);
        if (i >= ntiles) continue;  // the last round's short end
        const int bh = i % BH, q0 = (nq - 1 - i / BH) * T::kRows;
        int nblk = 0;  // the most kv tiles either warpgroup reads
#pragma unroll
        for (int c = 0; c < T::kCons; ++c) nblk = max(nblk, wg_tiles(q0, c, S, nkv, BK, causal));
        if (k > 0) mbar_wait(&qempty, (k - 1) & 1);  // the last q tile is in registers
        mbar_expect_tx(&qfull, T::kQBytes);
        for (int c = 0; c < KT; ++c)
          tma_load_3d(qs + c * T::kRows * T::kPanel, &qmap, 16 * c, q0, bh, &qfull);
        for (int t = 0; t < nblk; ++t, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(&empty[s], ((it / ST) - 1) & 1);  // its last use released
          uint8_t* kt = ring + 2 * s * T::kTileBytes;
          uint8_t* vt = kt + T::kTileBytes;
          mbar_expect_tx(&kfull[s], T::kTileBytes);
          for (int c = 0; c < KT; ++c)
            tma_load_3d(kt + c * BK * T::kPanel, &kmap, 16 * c, t * BK, bh, &kfull[s]);
          mbar_expect_tx(&vfull[s], T::kTileBytes);
          for (int c = 0; c < KT; ++c)
            tma_load_3d(vt + c * BK * T::kPanel, &vmap, 16 * c, t * BK, bh, &vfull[s]);
        }
        ++k;
      }
    }
    return;
  }
  setmaxnreg_inc<T::kConsumerRegs>();

  const int w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, qd = lane & 3;
  const float sl2 = scale * 1.44269504088896340736f;  // scale log2(e)
  // ldmatrix of q's A fragments from the panels: lane l addresses row l %
  // 8 of matrix l / 8 = (rows + 8 (l / 8 % 2), half l / 16)
  const int qrow = kWgRows * wg + 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t qaddr =
      smem_u32(qs) + qrow * T::kPanel + ((((lane >> 4) & 1) ^ ((qrow >> 2) & 1)) << 4);
  auto kaddr = [&](int it) { return smem_u32(ring + 2 * (it % ST) * T::kTileBytes); };
  auto vaddr = [&](int it) { return smem_u32(ring + (2 * (it % ST) + 1) * T::kTileBytes); };
  auto release = [&](int it) {  // a kv tile loaded for the other warpgroup
    mbar_wait(&kfull[it % ST], (it / ST) & 1);
    mbar_wait(&vfull[it % ST], (it / ST) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % ST]);
  };

  // The two warpgroups issue their products in alternate turns (named
  // barriers 1 and 2), so that one's softmax runs under the other's
  // products; warpgroup 0 issues first.
  if (wg == 1) named_arrive(1, 256);
  int it0 = 0;  // the ring's count of kv tiles at this q tile's first
  int k = 0;    // q tiles of this block
  const int G = gridDim.x;
  for (int r = 0; r * G < ntiles; ++r) {
    const int i = q_tile_of(r, blockIdx.x, G);
    if (i >= ntiles) continue;  // the last round's short end
    const int bh = i % BH, q0 = (nq - 1 - i / BH) * T::kRows;
    int nblk = 0;
#pragma unroll
    for (int c = 0; c < T::kCons; ++c) nblk = max(nblk, wg_tiles(q0, c, S, nkv, BK, causal));
    const int nt = wg_tiles(q0, wg, S, nkv, BK, causal);
    const bool last_q_tile = (r + 1) * G >= ntiles || q_tile_of(r + 1, blockIdx.x, G) >= ntiles;
    const int rw = q0 + kWgRows * wg + 16 * w;  // the warp's first query row
    const int row_a = rw + g, row_b = rw + g + 8;

    uint32_t qf[KT][4];
    mbar_wait(&qfull, k++ & 1);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      ldsm_x4(qaddr + kt * T::kRows * T::kPanel, qf[kt][0], qf[kt][1], qf[kt][2], qf[kt][3]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty);  // the producer may load the next q tile

    float o[4 * NO];  // element 4 j + e: row (e < 2 ? row_a : row_b), column 8 j + 2 qd + (e & 1)
    float s[4 * NS];  // the same layout over the tile's kv rows
    uint32_t p[BK / 16][4];  // bf16 probabilities: the A fragments of PV
#pragma unroll
    for (int e = 0; e < 4 * NO; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NS; ++e) s[e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) p[kc][0] = p[kc][1] = p[kc][2] = p[kc][3] = 0u;
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // the running max of the raw scores
    float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums
    float alpha[2];

    // Turn t issues the scores of kv tile t and the PV of tile t - 1, then
    // reduces the scores while that PV runs; the turn after the last tile
    // issues its PV alone. Each warpgroup takes nblk + 1 turns a q tile:
    // past its own tiles it releases each tile loaded for the other
    // warpgroup once the tile landed (so that the arrival counts toward
    // that use). The wgmma issues and waits sit on straight-line paths
    // (the first turn peeled), where ptxas need not serialize them.
    const int turns = nblk + 1;
    int t = 0;
    if (nt > 0) {
      mbar_wait(&kfull[it0 % ST], (it0 / ST) & 1);
      named_sync(1 + wg, 256);
      wgmma_fence();
      issue_qk<D, BK>(s, qf, kaddr(it0));
      named_arrive(2 - wg, 256);
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 4 * NS; ++e) pin(s[e]);
      softmax_tile<BK>(s, m_run, l_run, alpha, causal && BK - 1 > rw, 2 * qd, row_a, row_b, sl2);
      rescale_pack<D, BK>(o, p, s, alpha);
      for (t = 1; t < nt; ++t) {
        const int it = it0 + t;
        mbar_wait(&kfull[it % ST], (it / ST) & 1);
        mbar_wait(&vfull[(it - 1) % ST], ((it - 1) / ST) & 1);
        named_sync(1 + wg, 256);
        pin_operands<D, BK>(o, p);
        wgmma_fence();
        issue_qk<D, BK>(s, qf, kaddr(it));
        issue_pv<D, BK>(o, p, vaddr(it - 1));
        named_arrive(2 - wg, 256);
        wgmma_wait<1>();  // the scores; the PV of tile t - 1 may still run
#pragma unroll
        for (int e = 0; e < 4 * NS; ++e) pin(s[e]);
        softmax_tile<BK>(s, m_run, l_run, alpha, causal && t * BK + BK - 1 > rw,
                         t * BK + 2 * qd, row_a, row_b, sl2);
        wgmma_wait<0>();  // the PV of tile t - 1 is in o and has read p
        retire_pv<D, BK>(o, p, &empty[(it - 1) % ST]);
        rescale_pack<D, BK>(o, p, s, alpha);
      }
      const int il = it0 + nt - 1;  // the last kv tile
      if (nt < nblk) release(il + 1);
      mbar_wait(&vfull[il % ST], (il / ST) & 1);
      named_sync(1 + wg, 256);
      pin_operands<D, BK>(o, p);
      wgmma_fence();
      issue_pv<D, BK>(o, p, vaddr(il));
      if (!(wg == 1 && nt == nblk && last_q_tile)) named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      retire_pv<D, BK>(o, p, &empty[il % ST]);
      t = nt + 1;
    }
    for (; t < turns; ++t) {
      if (t < nblk) release(it0 + t);
      named_sync(1 + wg, 256);
      if (!(wg == 1 && t == turns - 1 && last_q_tile)) named_arrive(2 - wg, 256);
    }
    it0 += nblk;

    if (nt > 0) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l_run[0] += __shfl_xor_sync(0xffffffffu, l_run[0], off);
        l_run[1] += __shfl_xor_sync(0xffffffffu, l_run[1], off);
      }
      const float den[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
      const float rcp[2] = {__frcp_rn(den[0]), __frcp_rn(den[1])};
#pragma unroll
      for (int e = 0; e < 4 * NO; ++e) o[e] = div_rn(o[e], den[(e >> 1) & 1], rcp[(e >> 1) & 1]);
      __nv_bfloat16* ob = out + (size_t)bh * S * D;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = 8 * j + 2 * qd;
        if (row_a < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * D + col) =
              __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
        if (row_b < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
      }
    }
  }
}

template <int D>
int launch_bf16(int device, const void* q, const void* k, const void* v, void* out, int BH,
                int S, int Skv, int bk, int causal, float scale, cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  const size_t smem = (size_t)(kRows + 2 * bk) * (D + kPad) * sizeof(__nv_bfloat16);
  const int rc = opt_in(flash_bf16<D>, device, smem, opted);
  if (rc != 0) return rc;
  const dim3 grid(BH, (S + kRows - 1) / kRows);
  flash_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Skv, bk,
      causal, scale);
  return (int)cudaGetLastError();
}

int launch_f32(int device, const void* q, const void* k, const void* v, void* out, int BH,
               int S, int Skv, int D, int bk, int causal, float scale, cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  const size_t smem =
      (size_t)(2 * bk * D + kF32Rows * (2 * (D + 1) + bk + 1)) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int rc = opt_in(flash_f32, device, smem, opted);
  if (rc != 0) return rc;
  const dim3 grid(BH, (S + kF32Rows - 1) / kF32Rows);
  flash_f32<<<grid, kF32Rows, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, Skv, D, bk, causal, scale);
  return (int)cudaGetLastError();
}

// q (BH, rows, D) bf16 as a 3-d TMA map of boxes (16 values x box_rows x
// 1): one 32-byte panel of box_rows rows, 32-byte swizzle, zero past the
// rows of each bh. 0 on success.
int panel_map(CUtensorMap* map, const void* base, int BH, int rows, int D, int box_rows) {
  int rc;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder(&rc);
  if (encode == nullptr) return rc;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the maps hold the operands' addresses: made on every call and passed by
// value, so each call (or CUDA-graph node) carries its own. The grid is
// persistent: one block an SM, or one a q tile where there are fewer.
template <int D, int BK>
int launch_wgmma(int device, const void* q, const void* k, const void* v, void* out, int BH,
                 int S, int Skv, int causal, float scale, cudaStream_t stream) {
  using T = WgTile<D, BK>;
  static size_t opted[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};  // each device's SM count, once read
  int blocks = device < kMaxDevices ? sms[device] : 0;
  int rc = 0;
  if (blocks == 0) {
    rc = (int)cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount, device);
    if (rc == 0 && device < kMaxDevices) sms[device] = blocks;
  }
  CUtensorMap qm, km, vm;
  if (rc == 0) rc = panel_map(&qm, q, BH, S, D, T::kRows);
  if (rc == 0) rc = panel_map(&km, k, BH, Skv, D, BK);
  if (rc == 0) rc = panel_map(&vm, v, BH, Skv, D, BK);
  if (rc == 0) rc = opt_in(flash_wgmma<D, BK>, device, T::kSmem, opted);
  if (rc != 0) return rc;
  const long long tiles = (long long)BH * ((S + T::kRows - 1) / T::kRows);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = blocks < tiles ? blocks : (int)tiles;
  flash_wgmma<D, BK><<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<__nv_bfloat16*>(out), BH, S, Skv, causal, scale, qm, km, vm);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma_bk(int device, const void* q, const void* k, const void* v, void* out, int BH,
                    int S, int Skv, int bk, int causal, float scale, cudaStream_t stream) {
  switch (bk) {
    case 16: return launch_wgmma<D, 16>(device, q, k, v, out, BH, S, Skv, causal, scale, stream);
    case 32: return launch_wgmma<D, 32>(device, q, k, v, out, BH, S, Skv, causal, scale, stream);
    case 64: return launch_wgmma<D, 64>(device, q, k, v, out, BH, S, Skv, causal, scale, stream);
    case 128: return launch_wgmma<D, 128>(device, q, k, v, out, BH, S, Skv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// kernel: 0 = flash_f32 (q, k, v and out f32), 1 = flash_bf16, 2 =
// flash_wgmma (bf16; bk 16, 32, 64 or 128), as flash_attn.KERNEL_CODES
// names them. q and out (BH, S, D), k and v (BH, Skv, D), contiguous and
// 16-byte aligned. D and bk multiples of 16 up to 128, Skv a multiple of bk, S /
// 64 rounded up at most 65535. Returns the first CUDA error of the launch
// (0 on success); the current device is set from the wrapper's device
// index (the library links its own CUDA runtime).
extern "C" int flash_attention_launch(int device, const void* q, const void* k, const void* v,
                                      void* out, int kernel, int BH, int S, int Skv, int D,
                                      int bk, int causal, float scale, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (BH < 1 || S < 1 || Skv < 1 || D < 16 || D > 128 || D % 16 != 0 || bk < 16 ||
      bk > kMaxBk || bk % 16 != 0 || Skv % bk != 0 || (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return launch_f32(device, q, k, v, out, BH, S, Skv, D, bk, causal, scale, s);
  if (kernel == 2) {
    switch (D / 16) {
      case 1: return launch_wgmma_bk<16>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 2: return launch_wgmma_bk<32>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 3: return launch_wgmma_bk<48>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 4: return launch_wgmma_bk<64>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 5: return launch_wgmma_bk<80>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 6: return launch_wgmma_bk<96>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      case 7: return launch_wgmma_bk<112>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
      default: return launch_wgmma_bk<128>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    }
  }
  if (kernel != 1) return (int)cudaErrorInvalidValue;
  switch (D / 16) {
    case 1: return launch_bf16<16>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 2: return launch_bf16<32>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 3: return launch_bf16<48>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 4: return launch_bf16<64>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 5: return launch_bf16<80>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 6: return launch_bf16<96>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    case 7: return launch_bf16<112>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
    default: return launch_bf16<128>(device, q, k, v, out, BH, S, Skv, bk, causal, scale, s);
  }
}
