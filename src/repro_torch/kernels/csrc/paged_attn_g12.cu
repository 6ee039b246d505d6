// Paged decode attention (paged_attn.cu) at (G, dh) = (12, 128),
// mistral-large-123b's 96 query heads over 8 KV heads, compiled apart so
// that the kernel's shapes build in parallel (paged_attn.cuh).
#include "paged_attn.cuh"

namespace paged_attn {

int launch_g12_dh128(const Args& a, int q_dtype, int kv_dtype, bool global) {
  return launch_dtypes<12, 128, 12>(a, q_dtype, kv_dtype, global);
}

}  // namespace paged_attn
