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
// past the last query row of a warp (bf16) or of a thread's row (f32)
// is never read: the reference skips every such block of its q block
// (j*bk >= (i+1)*bq), and a block that is wholly masked for a row adds
// exactly nothing (p = 0, alpha = 1), so skipping it keeps the bits;
// the wrapper requires bq to be a multiple of 16 (or all of S), so the
// 16 rows of a warp lie in one of the reference's q blocks and no
// block that the reference skips is read for them.
//
// Bound on the H100: at danube's prefill geometry (BH = 128, S = 512,
// D = 80, causal) the bytes of q, k, v and out (41.9 MB, 12.5 us at
// 3.35 TB/s) outweigh the causal bf16 operations (5.4 us at 989
// TFLOP/s); at one 4096-token row (BH = 32) the operations bound it
// (86.9 us of bf16 tensor-core work against 25 us of bytes).
//
// What the design does about it, bf16: one block of four warps per
// (bh, 64-row q tile), the longest causal tiles launched first; each
// warp owns 16 query rows whose q fragments stay in registers for the
// whole kv loop. K and V tiles of bk rows are staged in shared memory
// (rows padded by 16 bytes, so ldmatrix reads hit distinct banks); QK^T
// and PV run on tensor cores as mma.sync.m16n8k16 bf16 with f32
// accumulators, fed by ldmatrix (V through ldmatrix.trans); the scores
// of a kv tile and the online softmax stay in f32 registers, the row
// max is reduced over the four lanes of a row, and the exponentials
// use expf, as the plain version uses torch.exp. The probabilities are
// rounded to bf16 only as the A operand of PV, as the reference's
// p.astype(v.dtype) does. f32: one thread per query row on CUDA cores
// (f32 FMA, no TF32: the reference's f32 result is full f32), with the
// K/V tiles, the row's q, accumulator and probabilities in shared
// memory. Loads are synchronous (no cp.async / TMA pipeline) and the
// products use mma.sync, not wgmma: a first kernel that is right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows of a bf16 block
constexpr int kMaxBk = 128;          // kv rows of a tile
constexpr int kPad = 8;              // bf16 elements of padding per shared row
constexpr int kF32Rows = 64;         // query rows (= threads) of an f32 block
constexpr float kNegInf = -1e30f;    // the reference's mask value
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block can opt into
constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

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

// opt in to more than 48 KB of dynamic shared memory once per device and
// size (not a stream operation, so it stays out of a CUDA graph being
// captured)
template <typename Kernel>
int opt_in(Kernel kernel, int device, size_t smem, size_t* opted) {
  if (smem <= 48 * 1024 || (device < kMaxDevices && smem <= opted[device])) return 0;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  if (device < kMaxDevices) opted[device] = smem;
  return 0;
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

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out alike). q and out (BH, S,
// D), k and v (BH, Skv, D), contiguous and 16-byte aligned. D and bk
// multiples of 16 up to 128, Skv a multiple of bk, S / 64 rounded up at
// most 65535. Returns the first CUDA error of the launch (0 on
// success); the current device is set from the wrapper's device index
// (the library links its own CUDA runtime).
extern "C" int flash_attention_launch(int device, const void* q, const void* k, const void* v,
                                      void* out, int dtype, int BH, int S, int Skv, int D,
                                      int bk, int causal, float scale, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (BH < 1 || S < 1 || Skv < 1 || D < 16 || D > 128 || D % 16 != 0 || bk < 16 ||
      bk > kMaxBk || bk % 16 != 0 || Skv % bk != 0 || (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(device, q, k, v, out, BH, S, Skv, D, bk, causal, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
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
