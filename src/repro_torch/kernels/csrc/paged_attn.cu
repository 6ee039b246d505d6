// Paged decode attention: one query token per sequence, GQA, attending
// the KV cache through a block table, with the reference's exact softmax.
//
// Replaces the TPU kernels src/repro/kernels/paged_attn.py::
// paged_attention_tpu (:253, body _decode_kernel: the score row in VMEM)
// and _paged_attention_multipass (:342, body _decode_kernel_multipass:
// the score row outside fast memory), reached from every layer of every
// paged decode step (models/lm.py paged_attn_decode ->
// kernels/ops.paged_attention).
//
// Function, per (sequence b, KV head h), for the G query heads of h:
//   q_s  = round_q(q * scale)                          (q's dtype)
//   k, v = pool[block[b, pos / page], pos % page, h]   int8 pages are
//          dequantized as round_bf16(int8 * bf16 scale), as the
//          reference's bf16 product does
//   s    = q_s . k, accumulated in f32 over the head dim in order,
//          rounded to bf16 when q and the dequantized pages are both
//          bf16 (jnp's einsum gives bf16 scores there), then held in f32
//   p    = softmax over the valid positions [lo, hi) = [max(0, len -
//          window), min(len, NB * page))
//   o    = sum p * v in f32, written in q's dtype; 0 where len = 0
// Positions outside the valid range have weight exactly 0 in the
// reference (exp(-1e30 - max) == 0 in f32), so they are skipped, and
// no page outside the range is ever read: dead block entries and pages
// wholly behind the window may hold anything, NaN included.
//
// Bound on the H100: decode reads each live K/V row once (dh bytes
// int8 or 2 dh bytes bf16, plus a bf16 scale) and does 4 G dh flops on
// it, a few flops per byte, so device-memory bytes bound it: the valid
// positions' K/V rows at 3.35 TB/s (1.61 us for one 4096-position row
// of danube's 8 KV heads in int8, 1.02 us for the engine's 8-slot
// decode batch). One block per (b, h) row would fill 8 of 132 SMs at
// such a row and stream it through one SM's loads: far from the bound.
//
// What the design does about it:
// - Split. The grid is (Hkv, B, nsplit): split s of row (b, h) owns the
//   positions [lo + s * chunk, min(hi, lo + (s + 1) * chunk)). The host
//   picks nsplit and chunk from static shapes only (NB, page, window, B,
//   Hkv and the SM count; kernels/paged_attn.py split_plan), never from
//   the lengths, so a launch needs no device-to-host read and can be
//   captured in a CUDA graph. A split with no valid position reads
//   nothing and reports an empty partial (m = -inf, l = 0).
// - Async page loads. A split streams its positions in tiles of kTile
//   rows through a ring of kStages shared-memory stages, first its K
//   tiles, then its V tiles: one thread per 16-byte piece of a row
//   issues cp.async.cg (the scale's aligned 4-byte word rides in the
//   same stage), so up to kStages - 1 tiles are in flight while one is
//   consumed, and the V tiles arrive while the scores are formed. Where
//   16-byte copies are not possible (unaligned pools, dh * itemsize not
//   a multiple of 16) the stage is filled by ordinary loads; no page is
//   ever touched outside the split's valid positions.
// - Order of operations, per split: the score of every valid position,
//   each K row's 16-byte pieces cut into at most kMaxParts groups, one
//   thread per (position, group) forming every head's partial dot
//   product over its group in head-dim order (each element dequantized
//   once), the partials then added in order by one thread per
//   (position, head) (rows that cannot be read 16 bytes at a time: one
//   thread per (position, head), the head dim in order); the scores
//   stored in shared memory (single-pass variant, the counterpart of
//   _decode_kernel) or in a global f32 workspace (B, Hkv, G, span) at
//   the split's offsets (the workspace variant, the counterpart of
//   _decode_kernel_multipass; forced by a zero shared-memory budget);
//   the split's max m_s and exponent sum l_s = sum exp(s - m_s) as block
//   reductions in a fixed order; the unnormalised acc_s = sum exp(s -
//   m_s) * v, each warp taking every 8th position and its lanes the
//   head-dim columns, the eight warp partials added in warp order. All
//   partials stay in f32.
// - Merge. With one split the block writes acc / l. Otherwise each
//   split writes (m_s, l_s, acc_s) to the partials buffer, fences, and
//   takes an integer ticket for its row; the block that draws the last
//   ticket loads every (m_s, l_s) at once and, per head (one warp, its
//   lanes taking every 32nd split, combined by a fixed shuffle tree),
//   takes m = max m_s, w_s = exp(m_s - m) (0 for an empty split, whose
//   acc it never reads) and L = sum w_s l_s; then sum w_s acc_s over the
//   splits s = j, j + J, ... of each of J groups (so that many loads are
//   in flight), the groups added in order, o = that sum / L (0 where
//   L = 0: len = 0); it writes o and resets the ticket to 0 for the next
//   call or graph replay. No float atomics: a run gives the same bits
//   every time.
// - Groups. One block reads each K/V row once for all G query heads of
//   its KV head (reading KV once is what a GQA decode kernel is for), so
//   what grows with G is per block: the scaled queries, the score rows,
//   the tile's partial scores, the reduction slots and each thread's PV
//   accumulators (G registers a head-dim column); the merge's per-head
//   statistics take one warp a head, each warp taking every kWarps-th
//   head. G <= kMaxGroup = 16.
// - Compile-time shapes. (G, dh) = (4, 80), danube's, (8, 128),
//   qwen1.5-110b's, and (12, 128), mistral-large-123b's, are instantiated
//   for every dtype pair, with their loops fully unrolled; every other
//   shape (dh <= 128) runs one of two generic instantiations, whose head
//   loops are bounded by 8 (G <= 8) or by kMaxGroup (8 < G <= 16), so a
//   small group does not hold a large group's accumulators. The kernel
//   lives in paged_attn.cuh; this source compiles danube's shape and the
//   narrow generic kernel, paged_attn_g8.cu, paged_attn_g12.cu and
//   paged_attn_wide.cu the others, all built in parallel.
#include "paged_attn.cuh"

using namespace paged_attn;

// dtypes: q 0 = f32, 1 = bf16; pools 0 = f32, 1 = bf16, 2 = int8 (with
// bf16 scale planes). window <= 0 means none. span: the score row's
// width, >= the valid range of every row; the row is split into nsplit
// chunks of `chunk` positions (nsplit * chunk >= span). ws: (B, Hkv, G,
// span) f32 when global_scores, else unused. part: B * Hkv * nsplit * G
// * (dh + 2) f32 and ticket: B * Hkv int32, zero on entry (and left
// zero), when nsplit > 1, else unused. vec: K/V rows may be copied 16
// bytes at a time (16-byte aligned pools, dh * itemsize a multiple of
// 16); svec: scales may be copied as aligned 4-byte words (4-byte
// aligned planes, Hkv even). Returns the first CUDA error of the launch
// (0 on success); the current device is set from the wrapper's device
// index (the library links its own CUDA runtime).
extern "C" int paged_attention_launch(int device, const void* q, int q_dtype,
                                      const void* k_pool, const void* v_pool,
                                      int kv_dtype, const void* k_scale,
                                      const void* v_scale, const void* block,
                                      const void* lens, void* out, void* ws, void* part,
                                      void* ticket, int B, int Hkv, int G, int dh,
                                      int page, int NB, int window, int span, int chunk,
                                      int nsplit, float scale, int vec, int svec,
                                      int global_scores, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxGroup || dh < 1 || dh > 32 * kMaxCols ||
      page < 1 || NB < 1 || span < 1 || chunk < 1 || nsplit < 1 || nsplit > kMaxSplits ||
      (long long)nsplit * chunk < span || (global_scores && ws == nullptr) ||
      (nsplit > 1 && (part == nullptr || ticket == nullptr)) ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) ||
      (svec && Hkv % 2))
    return (int)cudaErrorInvalidValue;
  const int isz = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  const Smem lay(G, dh, isz, chunk, nsplit, split_pages(chunk, page, NB), kv_dtype == 2,
                 global_scores != 0);
  if (lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a{device, q, k_pool, v_pool, k_scale, v_scale, static_cast<const int*>(block),
         static_cast<const int*>(lens), out, static_cast<float*>(ws),
         static_cast<float*>(part), static_cast<int*>(ticket), B, Hkv, G, dh, page, NB,
         window, span, chunk, nsplit, scale, vec, svec, (size_t)lay.total,
         static_cast<cudaStream_t>(stream)};
  // danube's (4, 80) here, qwen1.5-110b's (8, 128) and mistral-large-
  // 123b's (12, 128) at compile time in their own sources, every other
  // shape generic: narrow (G <= 8) here, wide in paged_attn_wide.cu
  const bool global = global_scores != 0;
  if (G == 4 && dh == 80) return launch_dtypes<4, 80, 4>(a, q_dtype, kv_dtype, global);
  if (G == 8 && dh == 128) return launch_g8_dh128(a, q_dtype, kv_dtype, global);
  if (G == 12 && dh == 128) return launch_g12_dh128(a, q_dtype, kv_dtype, global);
  if (G <= kNarrowGroup)
    return launch_dtypes<0, 0, kNarrowGroup>(a, q_dtype, kv_dtype, global);
  return launch_wide(a, q_dtype, kv_dtype, global);
}
