// What the attention sources share: the tensors of one call, and the wgmma
// body's launch (csrc/attention_wgmma.cu), which the dispatch in
// csrc/attention_packed.cu calls for bf16 at head dim 64, with or without a
// bias.
#pragma once

#include <cuda_runtime.h>

namespace depth_pro_attention {

// The tensors of one call, as untyped pointers and element strides
// (batch, head, row); q, k and v share their strides.
struct Layout {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;
  long long in_b, in_h, in_r, out_b, out_h, out_r;
};

// Whether a bf16 hd = 64 call takes 128-query blocks: only if they fill every
// SM's two block slots; a smaller grid spreads wider over the card in
// 64-query blocks. A function of the shape alone, never of the layout or the
// bias, so K1 and K4 run the same instance on the same data.
inline bool wide_blocks(int B, int S, int H, int sm_count) {
  return (long long)B * H * ((S + 127) / 128) >= 2LL * sm_count;
}

// The wgmma + TMA body (bf16, hd = 64). `packed`: q, k and v are the slots
// 3h, 3h + 1, 3h + 2 of one (B, S, 3 * H * 64) tensor at L.q (K1, and K3
// where L.bias is set: a (B, S) fp32 bias, 16-byte aligned); else three
// (B, H, S, 64) tensors (K4). Returns a cudaError_t code, or
// depth_pro_kernels::kTensorMapError (csrc/common.cuh) + the CUresult of a
// refused tensor map.
int launch_wgmma(const Layout& L, bool packed, int B, int S, int H, float scale, bool wide,
                 cudaStream_t stream);

}  // namespace depth_pro_attention
