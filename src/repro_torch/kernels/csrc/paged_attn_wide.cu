// Paged decode attention (paged_attn.cu), the wide generic kernel: 8 < G
// <= 16, any dh <= 128, its head loops bounded by kMaxGroup; compiled
// apart so that the kernel's shapes build in parallel (paged_attn.cuh).
#include "paged_attn.cuh"

namespace paged_attn {

int launch_wide(const Args& a, int q_dtype, int kv_dtype, bool global) {
  return launch_dtypes<0, 0, kMaxGroup>(a, q_dtype, kv_dtype, global);
}

}  // namespace paged_attn
