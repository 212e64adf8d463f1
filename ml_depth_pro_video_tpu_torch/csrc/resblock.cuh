// What the fused residual block's sources share: the wgmma + TMA body
// (csrc/resblock_wgmma.cu), which the entry point in csrc/resblock.cu calls at
// C = kWgmmaChannels, and the bias rounding of both bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace depth_pro_resblock {

// a bias pair rounded to bf16 (as the TPU kernel reads it), then fp32: both
// bodies' epilogues
__device__ __forceinline__ float2 bias_pair(const float* __restrict__ b, int n) {
  const float2 v = *reinterpret_cast<const float2*>(b + n);
  return make_float2(__bfloat162float(__float2bfloat16(v.x)),
                     __bfloat162float(__float2bfloat16(v.y)));
}

// The one width the wgmma body takes: the large preset's decoder. Other
// widths (24-128 in the card tests; 96 and 192 in `small` and `base`) stay on
// the mma.sync body in csrc/resblock.cu: a rule of the shape alone.
constexpr int kWgmmaChannels = 256;

// The output tile of a (B, H, W, 256) launch: 6 x 14 where those tiles give
// every SM a block, else 8 x 8 (a function of the shape alone).
void wgmma_tile(int B, int H, int W, int sm_count, int* th, int* tw);

// x, out: (B, H, W, 256) bf16; w1, w2: (9, 256, 256) bf16 (K = tap * 256 +
// c_in rows, c_out contiguous), all 16-byte aligned; b1, b2: (256,) fp32.
// Launches on `stream` on the current device. Returns a cudaError_t code, or
// depth_pro_kernels::kTensorMapError + the CUresult of a refused tensor map.
int launch_wgmma(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                 void* out, int B, int H, int W, int sm_count, cudaStream_t stream);

}  // namespace depth_pro_resblock
