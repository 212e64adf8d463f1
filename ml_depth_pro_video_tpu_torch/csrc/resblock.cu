// Fused DPT residual block: out = x + conv3x3(relu(conv3x3(relu(x)) + b1)) + b2.
//
// Replaces: ml_depth_pro_video_tpu/ops/resblock.py::_resblock_pallas
// (Pallas body `_resblock_kernel`). Both convs are 3x3, stride 1, pad 1,
// NHWC activations, weights (9, C, C) = HWIO with the taps flattened. The
// intermediate h is zero outside the image (torch's pad semantics for the
// second conv) and is rounded to bf16, as the TPU kernel rounds it.
//
// What bounds it on an H100: at the decoder's small levels (C=256 at 48^2
// and 96^2) one block is 2 x 9 x 256 x 256 MACs per pixel, ~2.4 kFLOP
// per byte of x read and out written: far above the ~295 FLOP/byte ridge,
// so it is bound by the tensor cores. The plain composition (two cuDNN
// convs plus three elementwise passes) also round-trips h and relu(x)
// through device memory; this kernel keeps them in shared memory.
//
// Design: one block of 8 warps per (batch item, 8x8 output tile). The block
// stages relu(x) over the tile plus a 2-pixel halo (12x12 pixels) in shared
// memory, computes h = relu(conv1 + b1) over the tile plus a 1-pixel halo
// (10x10) into shared memory as bf16, then conv2 + b2 + x for the tile.
// Each conv is an implicit GEMM on the tensor cores (WMMA 16x16x16 bf16,
// fp32 accumulate). The trick that makes every tap a plain GEMM operand:
// both pixel grids are stored row-flattened with the staged tile's width
// (12), so tap (dy, dx) of GEMM row p reads staged pixel p + dy*12 + dx --
// a constant-stride matrix. The two junk columns per row (and the junk
// rows that round the GEMM up to 16) never reach a valid output. Each warp
// owns a slice of output channels across all GEMM rows, so every weight
// fragment is read from global memory (L2) once per block. Channels are
// padded to a multiple of 16 by the caller (zero weights and bias).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TILE = 8;              // output tile: TILE x TILE pixels
constexpr int XW = TILE + 4;         // staged relu(x) tile width (2-pixel halo)
constexpr int HW = TILE + 2;         // h tile width (1-pixel halo)
constexpr int M1 = 128;              // conv1 GEMM rows: HW*XW = 120, rounded up to 16
constexpr int M2 = TILE * XW;        // conv2 GEMM rows: 96
constexpr int XROWS = 160;           // staged pixels: >= M1 + 2*XW + 2 = 154, 16-aligned
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NPW = 2;               // 16-channel output tiles per warp job

static_assert(M1 >= HW * XW && M1 % 16 == 0, "conv1 rows");
static_assert(M2 % 16 == 0, "conv2 rows");
static_assert(M1 >= M2 + 2 * XW + 2, "conv2 reads stay inside h");
static_assert(XROWS >= M1 + 2 * XW + 2, "conv1 reads stay inside staged x");

struct Geometry {
  int ldc;            // shared-memory row stride in elements (Cp + 16)
  size_t x_off, h_off, scratch_off, bytes;
  __host__ __device__ explicit Geometry(int cp) {
    ldc = cp + 16;
    x_off = 0;
    h_off = x_off + (size_t)XROWS * ldc * sizeof(bf16);
    scratch_off = h_off + (size_t)M1 * ldc * sizeof(bf16);
    bytes = scratch_off + (size_t)NWARPS * 16 * 16 * sizeof(float);
  }
};

// One 3x3 conv as an implicit GEMM: rows p in [0, MT*16) of the
// row-flattened grid, all Cp output channels. `epilogue(p, co, value)` is
// called once per (row, channel) with the fp32 sum (bias not added).
template <int MT, typename Epilogue>
__device__ __forceinline__ void conv3x3_gemm(const bf16* A, const bf16* __restrict__ w, int cp,
                                             int ldc, float* scratch, Epilogue epilogue) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = cp / 16;
  for (int job = warp; job * NPW < n_tiles; job += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NPW];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NPW; ++j) wmma::fill_fragment(acc[m][j], 0.f);

    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * XW + (tap % 3);
      const bf16* wt = w + (size_t)tap * cp * cp;
      for (int k = 0; k < cp; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int n = (job * NPW + j) * 16;
          if (n < cp) wmma::load_matrix_sync(bw[j], wt + (size_t)k * cp + n, cp);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + (size_t)(off + 16 * m) * ldc + k, ldc);
#pragma unroll
          for (int j = 0; j < NPW; ++j)
            if ((job * NPW + j) * 16 < cp) wmma::mma_sync(acc[m][j], a, bw[j], acc[m][j]);
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = (job * NPW + j) * 16;
        if (n >= cp) continue;
        wmma::store_matrix_sync(scratch, acc[m][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) epilogue(16 * m + e / 16, n + e % 16, scratch[e]);
        __syncwarp();
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
resblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C,
                int cp) {
  const Geometry g(cp);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + g.x_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + g.h_off);
  float* scratch = reinterpret_cast<float*>(smem + g.scratch_off) + (threadIdx.x / 32) * 256;

  const int tiles_x = (W + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int b = blockIdx.y;
  const size_t img = (size_t)b * H * W;

  // stage relu(x) over image rows [y0-2, y0+10) x cols [x0-2, x0+10);
  // zero outside the image, in the padded channels and in the tail rows
  const int chunks = cp / 8;  // 16-byte chunks per pixel
  for (int i = threadIdx.x; i < XROWS * chunks; i += NTHREADS) {
    const int p = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (p < XW * XW && c < C) {
      const int gy = y0 - 2 + p / XW;
      const int gx = x0 - 2 + p % XW;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        u = *reinterpret_cast<const uint4*>(x + (img + (size_t)gy * W + gx) * C + c);
        __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&u);
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __hmax2(v[e], zero);
      }
    }
    *reinterpret_cast<uint4*>(xs + (size_t)p * g.ldc + c) = u;
  }
  __syncthreads();

  // h = relu(conv1(relu x) + b1) over h rows/cols [-1, 9) relative to the
  // tile, row-flattened with width XW; zero outside the image and at junk
  // positions, so conv2 sees torch's zero padding
  conv3x3_gemm<M1 / 16>(xs, w1, cp, g.ldc, scratch, [&](int p, int co, float v) {
    const int hy = p / XW;
    const int hx = p % XW;
    const int gy = y0 - 1 + hy;
    const int gx = x0 - 1 + hx;
    const bool valid = hy < HW && hx < HW && gy >= 0 && gy < H && gx >= 0 && gx < W;
    hs[(size_t)p * g.ldc + co] = __float2bfloat16(valid ? fmaxf(v + b1[co], 0.f) : 0.f);
  });
  __syncthreads();

  // out = conv2(h) + b2 + x over the tile; GEMM row p = r*XW + c
  conv3x3_gemm<M2 / 16>(hs, w2, cp, g.ldc, scratch, [&](int p, int co, float v) {
    const int r = p / XW;
    const int c = p % XW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (c < TILE && gy < H && gx < W && co < C) {
      const size_t idx = (img + (size_t)gy * W + gx) * C + co;
      out[idx] = __float2bfloat16(v + b2[co] + __bfloat162float(x[idx]));
    }
  });
}

}  // namespace

// x, out: (B, H, W, C) bf16 contiguous, 16-byte aligned, C % 8 == 0.
// w1, w2: (9, cp, cp) bf16 and b1, b2: (cp,) fp32, zero-padded from C to
// cp = C rounded up to 16. Returns a cudaError_t code.
extern "C" int resblock_forward(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int B, int H, int W, int C, int cp,
                                int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || C <= 0 || C % 8 || cp % 16 || cp < C ||
      cp - C >= 16)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Geometry g(cp);
  e = cudaFuncSetAttribute(resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)g.bytes);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, B);
  resblock_kernel<<<grid, NTHREADS, g.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), H,
      W, C, cp);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one resblock launch needs for padded width cp.
extern "C" long long resblock_smem_bytes(int cp) { return (long long)Geometry(cp).bytes; }
