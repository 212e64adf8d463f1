// K5: the ViT block's residual add with LayerScale and the LayerNorm that
// follows it, in one pass over the rows (`add_layer_norm_forward`).
//
// Replaces no Pallas kernel: the JAX package leaves this glue of
// ml_depth_pro_video_tpu/models/vit.py::_block to XLA, which fuses it. The
// port's plain composition (ops/norm.py::add_layer_norm_reference) runs it
// as separate passes over the residual stream: a cast of the bf16 stream to
// fp32, the fp32 LayerNorm, a cast back, and an addcmul whose (D,) LayerScale
// broadcast takes PyTorch's unvectorised elementwise path.
//
// What it computes, per row of D elements (x and branch bf16, ls, g and b
// fp32), in one of three modes (ADD, NORM):
//   ADD:  x_new = bf16(f32(x) + f32(bf16(ls)) * f32(branch)), stored. This is
//         torch.addcmul(x, ls.to(bf16), branch) bit for bit: the product of
//         two bf16 values is exact in fp32, so one fp32 rounding and one bf16
//         rounding follow, with or without a fused multiply-add.
//   NORM: mean and biased variance in fp32 of the row (x_new's bf16 values
//         where ADD, else x's), y = bf16((v - mean) * rsqrt(var + eps) * g + b),
//         stored.
// ADD and NORM is a block's residual and the next LayerNorm; NORM alone a
// LayerNorm (a segment's first block, the final norm); ADD alone settles a
// segment's last residual.
//
// What bounds it on an H100: ~1 FLOP per byte against the card's ~295, so
// memory. Add and LayerNorm moves 8 bytes an element (x and branch read, x_new
// and y written), the least any version can; the plain composition moves 26
// over five passes. The design keeps bytes in flight at full width and
// nothing else in the way:
// - one warp a row; lane l holds the row's 16-byte chunks l, l + 32, ... (8
//   bf16 each) in registers, issues every load of its row before any
//   arithmetic, and reduces the statistics with warp shuffles: no shared
//   memory round trip and no block barrier per row;
// - ls (rounded to bf16 once), g and b go to shared memory once a CTA;
// - persistent CTAs (as many as fit on the card) stride over the rows, so
//   the parameters are loaded once per CTA, not per row;
// - VPL, the chunks a lane holds, is a template constant (1, 2, 4, 8 or 16 for
//   D up to 256, 512, 1024, 2048, 4096), its ragged last chunks masked.
// TMA and wgmma buy nothing here: there is no reuse to stage and no product.
//
// The entry point runs under the device rule of csrc/common.cuh (`on_device`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace depth_pro_add_layer_norm {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // rows in flight per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;  // bf16 per 16-byte chunk
constexpr int kMaxD = 4096;

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: [ls (ADD) | g, b (NORM)], D fp32 each.
template <int VPL, bool ADD, bool NORM>
__global__ void __launch_bounds__(kThreads)
    add_layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ branch,
                          const float* __restrict__ ls, const float* __restrict__ g,
                          const float* __restrict__ b, bf16* __restrict__ x_out,
                          bf16* __restrict__ y_out, long long rows, int D, float eps) {
  extern __shared__ float params[];
  float* s_ls = params;
  float* s_g = params + (ADD ? D : 0);
  float* s_b = s_g + D;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    if (ADD) s_ls[i] = __bfloat162float(__float2bfloat16_rn(ls[i]));
    if (NORM) {
      s_g[i] = g[i];
      s_b[i] = b[i];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int chunks = D / kVec;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const size_t base = (size_t)row * D;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* br = reinterpret_cast<const uint4*>(ADD ? branch + base : x);
    uint4 xv[VPL], bv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        xv[j] = __ldcs(xr + c);
        if (ADD) bv[j] = __ldcs(br + c);
      }
    }
    float v[VPL][kVec];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      if (c >= chunks) continue;
      unpack(xv[j], v[j]);
      if (ADD) {
        float t[kVec];
        unpack(bv[j], t);
        const float* l = s_ls + c * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[j][k] = v[j][k] + l[k] * t[k];
        const uint4 o = pack(v[j]);
        reinterpret_cast<uint4*>(x_out + base)[c] = o;
        if (NORM) unpack(o, v[j]);  // the statistics are of the stored bf16 values
      }
      if (NORM) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) sum += v[j][k];
      }
    }
    if (!NORM) continue;
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (j * 32 + lane >= chunks) continue;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = v[j][k] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      if (c >= chunks) continue;
      const float* gc = s_g + c * kVec;
      const float* bc = s_b + c * kVec;
      float y[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) y[k] = (v[j][k] - mean) * rstd * gc[k] + bc[k];
      reinterpret_cast<uint4*>(y_out + base)[c] = pack(y);
    }
  }
}

struct Args {
  const void* x;
  const void* branch;
  const void* ls;
  const void* g;
  const void* b;
  void* x_out;
  void* y_out;
  long long rows;
  int D;
  float eps;
};

template <int VPL, bool ADD, bool NORM>
int launch(const Args& a, int sms, cudaStream_t stream) {
  const auto kernel = add_layer_norm_kernel<VPL, ADD, NORM>;
  const size_t smem = (size_t)((ADD ? 1 : 0) + (NORM ? 2 : 0)) * a.D * sizeof(float);
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long need = (a.rows + kWarps - 1) / kWarps;
  const long long grid = std::min(need, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.branch),
      static_cast<const float*>(a.ls), static_cast<const float*>(a.g),
      static_cast<const float*>(a.b), static_cast<bf16*>(a.x_out), static_cast<bf16*>(a.y_out),
      a.rows, a.D, a.eps);
  return (int)cudaGetLastError();
}

template <bool ADD, bool NORM>
int by_width(const Args& a, int sms, cudaStream_t stream) {
  const int vpl = (a.D + 32 * kVec - 1) / (32 * kVec);
  if (vpl <= 1) return launch<1, ADD, NORM>(a, sms, stream);
  if (vpl <= 2) return launch<2, ADD, NORM>(a, sms, stream);
  if (vpl <= 4) return launch<4, ADD, NORM>(a, sms, stream);
  if (vpl <= 8) return launch<8, ADD, NORM>(a, sms, stream);
  return launch<16, ADD, NORM>(a, sms, stream);
}

}  // namespace
}  // namespace depth_pro_add_layer_norm

// x, branch, x_out, y_out: (rows, D) bf16 contiguous, 16-byte aligned; ls, g,
// b: (D,) fp32 contiguous; D % 8 == 0, 8 <= D <= 4096. The mode follows the
// pointers: branch (with ls and x_out) non-null adds the residual, g (with b
// and y_out) non-null normalises; at least one of the two. Runs on `device`,
// on `stream`. Returns a cudaError_t code.
extern "C" int add_layer_norm_forward(const void* x, const void* branch, const void* ls,
                                      const void* g, const void* b, void* x_out, void* y_out,
                                      long long rows, int D, float eps, int device,
                                      void* stream) {
  using namespace depth_pro_add_layer_norm;
  const bool add = branch != nullptr, norm = g != nullptr;
  if (!x || rows < 0 || D < kVec || D % kVec || D > kMaxD || device < 0 || !(add || norm) ||
      (add && (!ls || !x_out)) || (norm && (!b || !y_out)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Args a{x, branch, ls, g, b, x_out, y_out, rows, D, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return depth_pro_kernels::on_device(device, [&](int sms) -> int {
    if (add && norm) return by_width<true, true>(a, sms, st);
    if (add) return by_width<true, false>(a, sms, st);
    return by_width<false, true>(a, sms, st);
  });
}
