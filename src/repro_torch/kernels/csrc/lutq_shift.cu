// Shift-add LUT matmul of the multiplier-less pow2 path, for sm_90a:
// acc (M, N) int32 = xq (M, Kin) int8 @ wsh[A], A (Kin, N) int8 read as
// unsigned bytes, wsh (K <= 256,) int32.
//
// Replaces the TPU kernel src/repro/kernels/lutq_shift.py::lutq_shift
// (body _kernel), the `pow2` backend of kernels/ops.lutq_dot, and its
// jax.vmap over a MoE layer's experts (one launch a stack). wsh is the
// pow2 dictionary lowered to integer shifts (sign * 2^s, s in 0..span,
// kernels/ref.pow2_shift_weights); the caller applies the one float
// multiply, acc * (act_scale * 2^e_min), at the O(M * N) epilogue.
//
// Bound on the H100: at decode (M <= 16) the kernel reads 1 byte of A per
// weight and does M multiply-adds on it, so device-memory bytes bound it
// (Kin * N bytes at 3.35 TB/s). At prefill (M = 512) it does 1024 int8
// operations per byte of A, above the ~590 where the tensor cores become
// the limit, but its int32 output is 4 bytes a result: the bytes (A, xq
// and y once) and the tensor-core operations (2 M N Kin at 1979 TOPS)
// bound it about equally (danube's leaves: 0.914 ms against 0.86 ms a
// forward).
//
// Products on int8 tensor cores, exact. Every shifted entry splits into
// digit planes of base 2^7 (sign-magnitude): digit_p(v) = sign(v) *
// ((|v| >> 7p) & 127), so wsh = sum_p 2^(7p) digit_p and every digit fits
// s8 (a pow2 entry 2^s is the single digit 2^(s - 7p) of plane s / 7).
// Each plane is an s8 x s8 -> s32 product, and acc = sum_p (xq @
// digit_p[A]) << 7p, taken by Horner: the planes run from the highest
// down, the accumulator shifted left by 7 between them. The plane count
// (planes = ceil(bits of max |wsh| / 7), 1 for every full-width danube
// leaf, whose |wsh| <= 32) is a property of the dictionary that the
// wrapper passes in. The serve-time guard (core/policy._pow2_encodable:
// 7 + span + ceil(log2 Kin) <= 31) bounds the sum of |xq * w| over a row
// below 2^31, and with it every partial sum the planes, the splits and
// Horner's shifts form: no accumulator overflows, and the result equals
// the plain version (kernels/ref.lutq_shift_ref) bit for bit under any
// tiling and split. Shifts and the split merge use unsigned (wrapping)
// arithmetic, so nothing is undefined even past the guard.
//
// Design. The weights are the 16-row operand of the tensor cores, y^T =
// W^T xq^T, as in lutq_gemm.cuh, whose helpers (cp.async, ldmatrix, TMA
// map and mbarriers, wgmma fences, the nibble merge of two index rows)
// this file uses. Integer mma and wgmma take only K-major operands, and A
// is stored (Kin, N) row-major, so a lane reads rows k..k+3 of its C
// columns n..n+C-1, looks each byte up in a per-lane table of the current
// plane's digits (32 KB of shared memory, entry b of lane l at word 32 b +
// l: conflict-free) and transposes the 4 x C bytes with prmt into C
// K-major A registers, one a column. K <= 16: a byte holding two rows' 4-bit
// indices selects both digits at once (one lookup per 2 weights); K > 16:
// one lookup a byte. A lane's C (4 or 2) A-rows are adjacent columns, so
// each output row leaves as one int4 or int2. Decoded weights are stored
// nowhere. (Selecting the digits with prmt from four registers instead of
// the pair table measured slower at decode and level at prefill.)
//  * Decode (M <= 16; the engine's 8-slot step, generate's 4 rows): 8 x
//    256 or 16 x 256 tiles, each warp 32 columns (C = 4) on
//    mma.sync.m16n8k32 s8; xq's fragments by ldmatrix from a swizzled
//    tile. Bytes bound it,
//    so the plan splits the reduction over up to 16 blocks a tile to keep
//    every SM's copies in flight.
//  * Prefill (M > 16): two warpgroups, each BN / 2 columns of the tile,
//    issue wgmma.m64nBMk32.s32.s8.s8 with the decoded digits as A from
//    registers and xq as B, a K-major tile brought by TMA into a
//    128-byte-swizzled ring (an mbarrier a stage: after plain copies the
//    proxy fence wgmma needs would wait for the whole ring every step);
//    slice k of a step is decoded while the step before still multiplies.
//    On the H100 this loop is bound by the instructions it issues (the
//    decode's table lookups and transposes, the copies) at two warps a
//    scheduler, well before the tensor cores, so the tile for M > 128 is
//    256 x 128 (one m64n256 operand a warpgroup, 2 columns a lane): each
//    decoded weight serves 256 rows, and the decode's instructions a
//    multiply-add fall by ~40 % against the 128 x 256 tile (two m64n128
//    operands, 4 columns a lane) that M <= 128 keeps.
//  * A ring of 4 stages of 128 reduction rows (xq 128-byte rows, the raw
//    index bytes by cp.async, each thread the same chunk of a few rows),
//    zero-filled past M, N and the split's end.
//  * Split reduction (few output tiles: decode, narrow prefill): each
//    split writes its whole int32 tile to a workspace, in the threads' own
//    layout, and draws the tile's integer ticket; the last block adds the
//    other splits' tiles to its own sums in registers (one other split's
//    tile a round of 32 coalesced 16-byte loads a thread at prefill),
//    writes y and resets the ticket. One launch a call, no memset, no atomics on
//    the output: the same bits on every call and CUDA-graph replay.
//  * Ragged M, N and Kin are masked in the kernel: no padded copies.
//    Unaligned xq or A rows take plain loads into the same ring.
//  * An expert stack (a MoE layer's experts, the reference's vmap of the
//    kernel: xq (E, M, Kin), A (E, Kin, N), wsh (E, K), acc (E, M, N)) is
//    one launch: the grid's third dimension is experts x splits, and
//    expert e's blocks read its own xq slab, assignments and shifted
//    dictionary (its own digit tables) and write its own output slab,
//    partial tiles and merge tickets. A plain product is the stack of one.
#include "lutq_gemm.cuh"

namespace {

constexpr int kSBK = 128;               // reduction rows a stage: one 128-byte xq row
constexpr int kDigitTable = 256 * 32 * 4;  // 256 entries x 32 lanes, a word each
constexpr int kMaxPlanes = 5;           // 32 bits of |wsh| in 7-bit digits

// (BM, BN): decode 8 x 256 and 16 x 256 on mma.sync; prefill 128 x 256 and
// 256 x 128 on wgmma (two warpgroups, BN / 2 columns each, every lane C =
// BN / 64 of them; 128 accumulators a thread either way)
template <int BM, int BN>
struct ShiftTile {
  static constexpr bool kWgmma = BM >= 128;
  static constexpr int kC = kWgmma ? BN / 64 : 4;  // columns a lane
  static constexpr int kNW = kC / 2;               // wgmma: m64 operands a slice
  static constexpr int kXBytes = BM * kSBK;        // xq tile, 128-byte rows
  static constexpr int kStageBytes = kXBytes + kSBK * BN;
  static constexpr int kStages = 4;
  static constexpr int kSmem = 1024 + kDigitTable + kStages * kStageBytes;
  static constexpr int kMF = BM / 8;  // decode: m8 fragments of xq
  static_assert(kWgmma ? BM * BN == 128 * 256 && BM <= 256 : (BN == 256 && BM <= 16),
                "the tiles lutq_shift.SHIFT_TILES names");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void pin(int32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// 16-byte chunk c of raw row r sits at chunk c ^ shift_swz(r): the rows
// 4q + i a lane reads (q = lane % 4) land on distinct banks
__device__ __forceinline__ int shift_swz(int r) { return ((r >> 2) & 3) << 1; }

// digit p of v in base 2^7, sign-magnitude: in [-127, 127]
__device__ __forceinline__ int digit(int32_t v, int p) {
  const uint32_t m = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  const int d = (int)((m >> (7 * p)) & 127u);
  return v < 0 ? -d : d;
}

// Plane p's lookup table, one copy a lane; thread b writes entry b. K <=
// 16 (pairs): entry b holds the digits of index b & 15 (byte 0) and b >> 4
// (byte 1); K > 16: entry b holds index b's digit in byte 0.
template <bool PAIRS>
__device__ __forceinline__ void build_table(uint8_t* tab, const int32_t* __restrict__ wsh,
                                            int n_dict, int p) {
  const int b = threadIdx.x;
  uint32_t e;
  if constexpr (PAIRS) {
    const int lo = (b & 15) < n_dict ? digit(__ldg(wsh + (b & 15)), p) : 0;
    const int hi = (b >> 4) < n_dict ? digit(__ldg(wsh + (b >> 4)), p) : 0;
    e = ((uint32_t)lo & 0xFFu) | (((uint32_t)hi & 0xFFu) << 8);
  } else {
    e = (uint32_t)(b < n_dict ? digit(__ldg(wsh + b), p) : 0) & 0xFFu;
  }
  // 16 bytes at a time, from the thread's own offset so that a store's 8
  // lanes hit distinct banks
  uint4* row = reinterpret_cast<uint4*>(tab + b * 128);
#pragma unroll
  for (int c = 0; c < 8; ++c) row[(c + b) & 7] = make_uint4(e, e, e, e);
}

// the lane's C index bytes of a raw row (C = 4 or 2), in the low bytes
template <int C>
__device__ __forceinline__ uint32_t lds_cols(const uint8_t* p) {
  if constexpr (C == 4)
    return lds32(p);
  else
    return *reinterpret_cast<const uint16_t*>(p);
}

// out[j] = this lane's table entry for byte j of z
template <int C>
__device__ __forceinline__ void lookup(uint32_t z, uint32_t tab, uint32_t (&out)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    asm volatile("ld.shared.u32 %0, [%1];\n"
                 : "=r"(out[j])
                 : "r"(tab + (((z >> (8 * j)) & 0xFFu) << 7)));
}

// C K-major A registers from rows r..r + 3 (row points at row r, the
// lane's columns): out[j] holds the four rows' digits of column j
template <int BN, bool PAIRS, int C>
__device__ __forceinline__ void decode_rows(const uint8_t* row, uint32_t tab,
                                            uint32_t (&out)[C]) {
  const uint32_t w0 = lds_cols<C>(row), w1 = lds_cols<C>(row + BN);
  const uint32_t w2 = lds_cols<C>(row + 2 * BN), w3 = lds_cols<C>(row + 3 * BN);
  uint32_t p[C], r[C];  // byte 0: row r (r + 2), byte 1: row r + 1 (r + 3)
  if constexpr (PAIRS) {
    lookup<C>(nibbles(w0, w1), tab, p);
    lookup<C>(nibbles(w2, w3), tab, r);
  } else {
    uint32_t t[C];
    lookup<C>(w0, tab, p);
    lookup<C>(w1, tab, t);
#pragma unroll
    for (int j = 0; j < C; ++j) p[j] |= t[j] << 8;
    lookup<C>(w2, tab, r);
    lookup<C>(w3, tab, t);
#pragma unroll
    for (int j = 0; j < C; ++j) r[j] |= t[j] << 8;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) out[j] = __byte_perm(p[j], r[j], 0x5410);
}

// The A registers of 32-deep slice kk of a stage's raw bytes for lane (g,
// q) whose columns start at byte coff of a row: lo[j] holds reduction rows
// 4q..4q + 3 of column j, hi[j] rows 16 + 4q..16 + 4q + 3
template <int BN, bool PAIRS, int C>
__device__ __forceinline__ void decode_slice(const uint8_t* raw, int kk, int q, int coff,
                                             uint32_t tab, uint32_t (&lo)[C],
                                             uint32_t (&hi)[C]) {
  const uint8_t* row = raw + (32 * kk + 4 * q) * BN + coff;
  decode_rows<BN, PAIRS, C>(row, tab, lo);
  decode_rows<BN, PAIRS, C>(row + 16 * BN, tab, hi);
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (64 x N s32 of the warpgroup, N = 128 or 256) += a (64 x 32 s8,
// registers; warp w holds rows 16 w .. 16 w + 15 as an mma.m16n8k32 A
// fragment) x b (32 x N s8 in shared memory, K-major, 128-byte swizzle,
// descriptor desc)
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// v << 7 modulo 2^32: Horner's step between two planes
__device__ __forceinline__ int32_t shl7(int32_t v) { return (int32_t)((uint32_t)v << 7); }

// one ring stage: the xq tile (BM rows of 128 bytes, chunk c of row r at
// c ^ (r % 8), the layout of the TMA copy's 128-byte swizzle) unless it
// comes by TMA, and the raw index bytes of 128 rows x BN columns
template <int BM, int BN>
__device__ __forceinline__ void load_shift_stage(uint8_t* st, const int8_t* __restrict__ xq,
                                                 const uint8_t* __restrict__ a, int M, int N,
                                                 int Kin, int m0, int n0, int k0, int kend,
                                                 int xvec, int avec, bool x_by_tma) {
  using Tl = ShiftTile<BM, BN>;
  for (int i = threadIdx.x; i < (x_by_tma ? 0 : BM * 8); i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const int gm = m0 + r, gk = k0 + 16 * c;
    uint8_t* dst = st + r * kSBK + ((c ^ (r & 7)) << 4);
    if (xvec) {
      const bool ok = gm < M && gk < kend;
      cp_async16(dst, ok ? static_cast<const void*>(xq + (size_t)gm * Kin + gk) : xq, ok);
    } else {
      union {
        uint4 v;
        int8_t b[16];
      } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gk + j < kend) u.b[j] = xq[(size_t)gm * Kin + gk + j];
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }
  // raw bytes: thread t copies chunk t % 16 of rows t / 16 + 16 i, whose
  // swizzle is the same for every i
  constexpr int RC = BN / 16;             // chunks of a raw row
  constexpr int RSTEP = kThreads / RC;    // rows a pass
  static_assert(RSTEP % 16 == 0, "the swizzle repeats every 16 rows");
  const int c = threadIdx.x % RC, r0 = threadIdx.x / RC;
  const int gn = n0 + 16 * c;
  uint8_t* dst = st + Tl::kXBytes + r0 * BN + ((c ^ shift_swz(r0)) << 4);
  const uint8_t* src = a + (size_t)(k0 + r0) * N + gn;
#pragma unroll
  for (int i = 0; i < kSBK / RSTEP; ++i) {
    const bool row_ok = k0 + r0 + RSTEP * i < kend;
    const uint8_t* from = src + (size_t)RSTEP * i * N;
    uint8_t* to = dst + RSTEP * i * BN;
    if (avec) {
      const bool ok = row_ok && gn < N;
      cp_async16(to, ok ? from : a, ok);
    } else {
      union {
        uint4 v;
        uint8_t b[16];
      } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gn + e < N) u.b[e] = from[e];
      *reinterpret_cast<uint4*>(to) = u.v;
    }
  }
}

// ---------------------------------------------------------------------------
// epilogue and split merge
// ---------------------------------------------------------------------------

// C (4 or 2) int32 as one vector store
template <int C>
struct IntVec;
template <>
struct IntVec<4> {
  using T = int4;
  static __device__ __forceinline__ T make(const int32_t (&v)[4]) {
    return make_int4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct IntVec<2> {
  using T = int2;
  static __device__ __forceinline__ T make(const int32_t (&v)[2]) {
    return make_int2(v[0], v[1]);
  }
};

// columns gn..gn + C - 1 of a row of y, masked at N
template <int C>
__device__ __forceinline__ void store_cols(int32_t* row, int gn, const int32_t (&v)[C],
                                           int N) {
  if (N % C == 0 && gn + C <= N) {
    *reinterpret_cast<typename IntVec<C>::T*>(row + gn) = IntVec<C>::make(v);
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e)
      if (gn + e < N) row[gn + e] = v[e];
  }
}

// The output tile: v[g] holds row gm[g], columns gn..gn + C - 1. Without a
// split it goes to y. With one, each split writes its whole tile to its
// part[(tile * splits + z) * BM * BN] in the threads' own layout (int4
// word w of thread t at word w * kThreads + t: every load and store
// coalesced), then draws the tile's integer ticket; the block that draws
// the last one adds the other splits' words to its own sums in registers
// (modulo 2^32: the order does not change a bit), up to 32 16-byte loads
// a thread in flight, writes y and resets the ticket for the next call or
// CUDA-graph replay.
template <int BM, int BN, int G, int C>
__device__ __forceinline__ void shift_finish(int32_t (&v)[G][C], const int (&gm)[G], int gn,
                                             int32_t* __restrict__ y,
                                             int32_t* __restrict__ part,
                                             int* __restrict__ ticket, int M, int N,
                                             int splits, int zs) {
  constexpr int W = G * C / 4;  // int4 words a thread holds
  static_assert(W * 4 * kThreads == BM * BN, "a tile is every thread's words");
  if (splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int4* tiles = reinterpret_cast<const int4*>(part) + (size_t)tile * splits * W * kThreads;
    int4* own = reinterpret_cast<int4*>(part) +
                ((size_t)tile * splits + zs) * W * kThreads + threadIdx.x;
#pragma unroll
    for (int w = 0; w < W; ++w)
      own[w * kThreads] =
          make_int4(v[(4 * w) / C][(4 * w) % C], v[(4 * w + 1) / C][(4 * w + 1) % C],
                    v[(4 * w + 2) / C][(4 * w + 2) % C], v[(4 * w + 3) / C][(4 * w + 3) % C]);
    __shared__ int last;
    __threadfence();  // this block's partial tile is visible device-wide ...
    __syncthreads();  // ... before its ticket is drawn
    if (threadIdx.x == 0) last = atomicAdd(ticket + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();  // the other splits' partials, read below from L2
    constexpr int ZB = W < 32 ? 32 / W : 1;  // other splits a round
    for (int o0 = 0; o0 < splits - 1; o0 += ZB) {
      int4 t[ZB][W];
#pragma unroll
      for (int u = 0; u < ZB; ++u) {
        const int o = o0 + u, z = o + (o >= zs);
#pragma unroll
        for (int w = 0; w < W; ++w)
          t[u][w] = o < splits - 1
                        ? __ldcg(tiles + ((size_t)z * W + w) * kThreads + threadIdx.x)
                        : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < ZB; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t x[4] = {(uint32_t)t[u][w].x, (uint32_t)t[u][w].y, (uint32_t)t[u][w].z,
                                 (uint32_t)t[u][w].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int32_t& s = v[(4 * w + e) / C][(4 * w + e) % C];
            s = (int32_t)((uint32_t)s + x[e]);
          }
        }
    }
    if (threadIdx.x == 0) ticket[tile] = 0;  // for the next call (or replay)
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (gm[g] < M) store_cols<C>(y + (size_t)gm[g] * N, gn, v[g], N);
}

// Grid (ceil(M / BM), ceil(N / BN), experts x splits): block (i, j, e
// splits + z) computes the output tile (i, j) of expert e over the
// reduction rows [z kchunk, min(Kin, (z + 1) kchunk)), every plane:
// `planes` passes over those rows, step i of the loop the k-step i % steps
// of plane planes - 1 - i / steps.
template <int BM, int BN, bool PAIRS>
__global__ void __launch_bounds__(kThreads, 1)
    lutq_shift_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ a,
                      const int32_t* __restrict__ wsh, int n_dict, int planes,
                      int32_t* __restrict__ y, int32_t* __restrict__ part,
                      int* __restrict__ ticket, int M, int N, int Kin, int kchunk, int splits,
                      int xvec, int avec, const __grid_constant__ CUtensorMap xmap) {
  using Tl = ShiftTile<BM, BN>;
  // this block's expert and split, and the expert's operands
  const int e = blockIdx.z / splits, zs = blockIdx.z % splits;
  xq += (size_t)e * M * Kin;
  a += (size_t)e * Kin * N;
  wsh += (size_t)e * n_dict;
  y += (size_t)e * M * N;
  if (splits > 1) {
    part += (size_t)e * gridDim.x * gridDim.y * splits * BM * BN;
    ticket += (size_t)e * gridDim.x * gridDim.y;
  }
  const int xrow = e * M;  // the expert's first row in the TMA map of xq
  extern __shared__ __align__(128) uint8_t smem_dyn[];
  // 1024-byte aligned (the swizzled xq tiles wgmma reads), then the
  // digit table, then the ring
  uint8_t* table = smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  uint8_t* smem = table + kDigitTable;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = zs * kchunk;
  const int kend = min(Kin, kbeg + kchunk);
  const int steps = (kend - kbeg + kSBK - 1) / kSBK;
  const int total = planes * steps;
  const uint32_t tab = smem_u32(table) + 4 * lane;  // this lane's column

  // prefill with aligned xq rows: the xq tiles come by TMA (see the top)
  __shared__ __align__(8) uint64_t xbar[Tl::kStages];
  const bool tma = Tl::kWgmma && xvec;
  if (tma && tid == 0) {
    for (int s = 0; s < Tl::kStages; ++s) mbar_init(&xbar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tma) __syncthreads();
  // the ring's first stages are in flight while the table is built
  constexpr int kAhead = Tl::kWgmma ? Tl::kStages - 2 : Tl::kStages - 1;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < total) {
      const int k0 = kbeg + (s % steps) * kSBK;
      load_shift_stage<BM, BN>(smem + s * Tl::kStageBytes, xq, a, M, N, Kin, m0, n0, k0, kend,
                               xvec, avec, tma);
      if (tma && tid == 0)
        tma_load_x(smem + s * Tl::kStageBytes, &xmap, k0, xrow + m0, &xbar[s], Tl::kXBytes);
    }
    cp_async_commit();
  }
  build_table<PAIRS>(table, wsh, n_dict, planes - 1);

  if constexpr (Tl::kWgmma) {
    // warpgroup wg owns columns BN / 2 wg .. + BN / 2 - 1 as NW 64-row A
    // operands of m64nBMk32; warp w of it holds their rows 16 w .. + 15:
    // wgmma j's row 16 w + g is column nb + 2 j, row 16 w + g + 8 the next
    // column, nb = BN / 2 wg + BN / 8 w + C g (a lane's C columns)
    constexpr int C = Tl::kC, NW = Tl::kNW, ND = BM / 2;
    const int wg = warp >> 2, w = warp & 3;
    const int nb = BN / 2 * wg + BN / 8 * w + C * g;
    const int coff = (((nb >> 4) ^ (q << 1)) << 4) | (nb & 15);
    int32_t acc[NW][ND];
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[j][e] = 0;

    // Step i refills the slot of step i - 2, STAGES - 2 steps ahead, so
    // that step i - 1's products may still run while step i is decoded;
    // slice kk of step i decodes into A[kk] once slice kk of step i - 1
    // is done (at most 3 later commit groups still in flight).
    uint32_t A[kSBK / 32][NW][4];
    for (int i = 0; i < total; ++i) {
      if (i > 0 && i % steps == 0) {
        // the next plane: every product and every decode of this one
        // done, its table in place, the sums so far shifted by 7 bits
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < ND; ++e) pin(acc[j][e]);
        __syncthreads();
        build_table<PAIRS>(table, wsh, n_dict, planes - 1 - i / steps);
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < ND; ++e) acc[j][e] = shl7(acc[j][e]);
      }
      cp_async_wait<Tl::kStages - 3>();
      if (!tma) fence_proxy_async();
      wgmma_wait<kSBK / 32>();  // step i - 2's products are done ...
      __syncthreads();          // ... in both warpgroups: refill its slot
      const int nx = i + Tl::kStages - 2;
      if (nx < total) {
        uint8_t* slot = smem + (nx % Tl::kStages) * Tl::kStageBytes;
        const int k0 = kbeg + (nx % steps) * kSBK;
        load_shift_stage<BM, BN>(slot, xq, a, M, N, Kin, m0, n0, k0, kend, xvec, avec, tma);
        if (tma && tid == 0)
          tma_load_x(slot, &xmap, k0, xrow + m0, &xbar[nx % Tl::kStages], Tl::kXBytes);
      }
      cp_async_commit();
      if (tma) mbar_wait(&xbar[i % Tl::kStages], (i / Tl::kStages) & 1);
      const uint8_t* st = smem + (i % Tl::kStages) * Tl::kStageBytes;
      const uint8_t* raw = st + Tl::kXBytes;
#pragma unroll
      for (int kk = 0; kk < kSBK / 32; ++kk) {
        uint32_t lo[C], hi[C];
        decode_slice<BN, PAIRS, C>(raw, kk, q, coff, tab, lo, hi);
        wgmma_wait<kSBK / 32 - 1>();  // slice kk of step i - 1 read A[kk]
#pragma unroll
        for (int j = 0; j < NW; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(A[kk][j][e]);
          A[kk][j][0] = lo[2 * j], A[kk][j][1] = lo[2 * j + 1];
          A[kk][j][2] = hi[2 * j], A[kk][j][3] = hi[2 * j + 1];
        }
        const uint64_t desc = sw128_desc(smem_u32(st) + 32 * kk);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NW; ++j) wgmma_s8(acc[j], A[kk][j], desc);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < kSBK / 32; ++kk)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(A[kk][j][e]);
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < ND; ++e) pin(acc[j][e]);

    // acc[j][4 t + e]: token 8 t + 2 q + (e & 1), column nb + 2 j + (e >> 1)
    constexpr int G = BM / 4;
    int32_t v[G][C];
    int gm[G];
#pragma unroll
    for (int t = 0; t < BM / 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          v[2 * t + h][2 * j] = acc[j][4 * t + h];
          v[2 * t + h][2 * j + 1] = acc[j][4 * t + 2 + h];
        }
        gm[2 * t + h] = m0 + 8 * t + 2 * q + h;
      }
    shift_finish<BM, BN, G, C>(v, gm, n0 + nb, y, part, ticket, M, N, splits, zs);
  } else {
    // warp w owns columns 32 w .. + 31: mma tile j's row g is column
    // nb + 2 j, row g + 8 column nb + 2 j + 1
    constexpr int MF = Tl::kMF;
    const int nb = 32 * warp + 4 * g;
    const int coff = (((nb >> 4) ^ (q << 1)) << 4) | (nb & 15);
    // ldmatrix: lane l addresses row l % 8 of matrix l / 8; matrices
    // (fragment f, k 0-15 of the slice), (f, k 16-31), (f + 1, k 0-15),
    // (f + 1, k 16-31)
    const int mi = lane >> 3, ri = lane & 7;
    const int lrow = 8 * (MF > 1 ? (mi >> 1) : 0) + ri;
    int32_t acc[MF][2][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;

    for (int i = 0; i < total; ++i) {
      cp_async_wait<Tl::kStages - 2>();
      __syncthreads();  // stage i landed for all; the slot of step i - 1 is free
      if (i > 0 && i % steps == 0) {
        // the next plane: its table (every decode of this one is done),
        // the sums so far shifted by 7 bits
        build_table<PAIRS>(table, wsh, n_dict, planes - 1 - i / steps);
        __syncthreads();
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][j][e] = shl7(acc[f][j][e]);
      }
      const int nx = i + Tl::kStages - 1;
      if (nx < total)
        load_shift_stage<BM, BN>(smem + (nx % Tl::kStages) * Tl::kStageBytes, xq, a, M, N,
                                 Kin, m0, n0, kbeg + (nx % steps) * kSBK, kend, xvec, avec,
                                 false);
      cp_async_commit();
      const uint8_t* st = smem + (i % Tl::kStages) * Tl::kStageBytes;
      const uint8_t* raw = st + Tl::kXBytes;
      const uint32_t xs = smem_u32(st) + lrow * kSBK;
#pragma unroll
      for (int kk = 0; kk < kSBK / 32; ++kk) {
        uint32_t lo[4], hi[4];
        decode_slice<BN, PAIRS, 4>(raw, kk, q, coff, tab, lo, hi);
        const uint32_t A0[4] = {lo[0], lo[1], hi[0], hi[1]};
        const uint32_t A1[4] = {lo[2], lo[3], hi[2], hi[3]};
        const uint32_t xa = xs + (((2 * kk + (mi & 1)) ^ ri) << 4);
        if constexpr (MF == 1) {
          uint32_t b0, b1;
          ldsm_x2(xa, b0, b1);
          mma_s8(acc[0][0], A0, b0, b1);
          mma_s8(acc[0][1], A1, b0, b1);
        } else {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(xa, b0, b1, b2, b3);
          mma_s8(acc[0][0], A0, b0, b1);
          mma_s8(acc[0][1], A1, b0, b1);
          mma_s8(acc[1][0], A0, b2, b3);
          mma_s8(acc[1][1], A1, b2, b3);
        }
      }
    }

    // c0, c1: (column nb + 2j, tokens 2q, 2q + 1); c2, c3: column nb + 2j + 1
    int32_t v[2 * MF][4];
    int gm[2 * MF];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[2 * f + h][0] = acc[f][0][h];
        v[2 * f + h][1] = acc[f][0][2 + h];
        v[2 * f + h][2] = acc[f][1][h];
        v[2 * f + h][3] = acc[f][1][2 + h];
        gm[2 * f + h] = m0 + 8 * f + 2 * q + h;
      }
    shift_finish<BM, BN, 2 * MF, 4>(v, gm, n0 + nb, y, part, ticket, M, N, splits, zs);
  }
}

template <int BM, int BN, bool PAIRS>
int launch_shift_tile(int device, const int8_t* xq, const uint8_t* a, const int32_t* wsh,
                      int n_dict, int planes, int32_t* y, int32_t* part, int* ticket, int M,
                      int N, int Kin, int splits, int kchunk, int experts, int xvec, int avec,
                      cudaStream_t stream) {
  using Tl = ShiftTile<BM, BN>;
  auto kernel = lutq_shift_kernel<BM, BN, PAIRS>;
  CUtensorMap xmap = {};
  if (Tl::kWgmma && xvec) {
    // every expert's rows in one map (rows past an expert's M are the
    // next expert's or zero fill; their outputs are masked)
    const int rc = x_tensor_map(&xmap, xq, experts * M, Kin, 1, BM);
    if (rc != 0) return rc;
  }
  // opt in to the ring's dynamic shared memory once per device (not a
  // stream operation, so it stays out of a CUDA graph being captured)
  static bool opted[kMaxDevices] = {};
  if (device >= kMaxDevices || !opted[device]) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
    if (attr != cudaSuccess) return (int)attr;
    if (device < kMaxDevices) opted[device] = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits * experts);
  kernel<<<grid, kThreads, Tl::kSmem, stream>>>(xq, a, wsh, n_dict, planes, y, part, ticket, M,
                                                N, Kin, kchunk, splits, xvec, avec, xmap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a plan or operands the kernel does not take.
// The library links its own CUDA runtime, whose current device is not the
// caller's: it is set here from the wrapper's device index. The tiles are
// the ones lutq_shift.SHIFT_TILES names; part (experts x tiles x splits x
// bm x bn int32, 16-byte aligned) and ticket (one int32 a tile of every
// expert, zero on entry and left zero) are needed when splits > 1. avec /
// xvec: A / xq rows are 16-byte aligned. experts: the products of the
// stack (1 for a plain product), n_dict each expert's K, planes the most
// any expert's dictionary needs.
extern "C" int lutq_shift_launch(int device, const void* xq, const void* a, int avec, int xvec,
                                 const void* wsh, int n_dict, int planes, void* y, void* part,
                                 void* ticket, int M, int N, int Kin, int bm, int bn, int splits,
                                 int kchunk, int experts, void* stream_ptr) {
  if (splits < 1 || kchunk < 1 || kchunk % kSBK != 0 || (splits > 1 && (!part || !ticket)) ||
      n_dict < 1 || n_dict > kMaxDict || planes < 1 || planes > kMaxPlanes || experts < 1 ||
      (long long)experts * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const int32_t* wp = static_cast<const int32_t*>(wsh);
  int32_t* yp = static_cast<int32_t*>(y);
  int32_t* pp = static_cast<int32_t*>(part);
  int* tp = static_cast<int*>(ticket);
  const bool pairs = n_dict <= 16;
#define LUTQ_SHIFT_TILE(BM_, BN_)                                                            \
  if (bm == BM_ && bn == BN_)                                                              \
    return pairs ? launch_shift_tile<BM_, BN_, true>(device, xp, ap, wp, n_dict, planes, yp, \
                                                     pp, tp, M, N, Kin, splits, kchunk,     \
                                                     experts, xvec, avec, stream)           \
                 : launch_shift_tile<BM_, BN_, false>(device, xp, ap, wp, n_dict, planes,   \
                                                      yp, pp, tp, M, N, Kin, splits,        \
                                                      kchunk, experts, xvec, avec, stream);
  LUTQ_SHIFT_TILE(8, 256)
  LUTQ_SHIFT_TILE(16, 256)
  LUTQ_SHIFT_TILE(128, 256)
  LUTQ_SHIFT_TILE(256, 128)
#undef LUTQ_SHIFT_TILE
  return (int)cudaErrorInvalidValue;
}
