// The fused DPT residual block on Hopper at C = 256: an implicit GEMM on
// wgmma, its weights fed by TMA through an mbarrier ring.
//
// Replaces, with csrc/resblock.cu (entry point, dispatch, and the mma.sync
// body for other widths), the Pallas kernel
// ml_depth_pro_video_tpu/ops/resblock.py::_resblock_pallas (`:130`,
// pallas_call `:138`, body `_resblock_kernel`) at the large preset's decoder
// width: out = x + conv3x3(relu(conv3x3(relu x) + b1)) + b2, both convs 3x3,
// stride 1, pad 1, NHWC bf16, weights (9, C, C) HWIO with the taps flattened.
// Rounding as the mma.sync body's (csrc/resblock.cu): h is zero outside the image
// and rounded to bf16; the biases are rounded to bf16 and added in fp32;
// conv2 + b2 + x is summed in fp32 and rounded once.
//
// What bounds it on an H100: at (2, 96, 96, 256) one call is ~43.5 GFLOP
// against ~21 MB of x and out read and written and weights read once, ~2,000
// FLOP/byte, far above the ~295 bf16 FLOP/byte ridge: the tensor cores bound
// it (0.044 ms at 989 TFLOP/s). So the products must run on wgmma, the only
// instruction that reaches that rate, fed without stalls, while h and relu(x)
// stay in shared memory. Behind the tensor cores comes L2: every block reads
// both weight sets (2.36 MB) once, so the tiles are as large as the
// accumulators allow.
//
// Design. One block per (batch item, TH x TW output tile): two consumer
// warpgroups and one producer warpgroup, which hands registers to the
// consumers (setmaxnreg: 40 a thread for it, 232 for them).
// - The producer's one thread streams both convs' weights as one sequence of
//   72 chunks (KC = 64 rows of K = tap * 256 + c_in, all 256 columns)
//   through a ring of STAGES stages with full and empty mbarriers. A chunk is
//   four TMA boxes (cp.async.bulk.tensor.2d) of 64 columns x 64 rows from a
//   2-D map over the (9 * 256, 256) weight matrix, in the 128-byte swizzle:
//   each box is an MN-major B operand one swizzle atom wide, the layout of
//   the V tile in csrc/attention_wgmma.cu, read through the same descriptor.
//   conv2's first chunks land while conv1 finishes.
// - The consumers stage relu(x) over the tile plus a 2-pixel halo in shared
//   memory (cp.async, zero outside the image; rows padded by 16 bytes so
//   ldmatrix's 8 rows hit 8 bank groups). Each conv is a GEMM whose rows are
//   the positions it computes and whose K is 9 taps x 256: for tap (dy, dx)
//   each lane's ldmatrix reads the staged pixel its row needs, which gives
//   the A fragment in registers (wgmma's A from registers has mma.sync's
//   layout per warp), so no im2col copy is made. Each chunk is 4 k16 steps,
//   each one wgmma over the warpgroup's columns (m64n256k16, or m64n128k16
//   where the columns are split), fp32 accumulators in registers;
//   the next chunk's A fragments load while this chunk's products run
//   (wgmma.wait_group 1), and a stage goes back to the producer once its
//   products are done.
// - Work per warpgroup: a conv whose rows span two m64 tiles gives each
//   warpgroup one tile and all 256 columns (128 accumulators a thread); one
//   of a single m64 tile splits the columns, 128 each. conv1's epilogue adds
//   b1, applies ReLU, zeroes positions outside the image and rounds h to
//   bf16 into shared memory over relu(x) (both warpgroups meet at a named
//   barrier first); conv2's adds b2 and x (read from device memory) and
//   stores bf16 pairs.
// - Tiles, of the shape alone: 6 x 14 (conv1 8 x 16 = 128 rows, two full m64
//   tiles; conv2 84) where they give every SM a block, else 8 x 8 (conv1 100
//   rows; conv2 64, one m64 tile). Where 6 x 14 leaves SMs idle, the smaller
//   block finishes sooner: on an H100 (700 W) 8 x 8 took 21-22% less device
//   time than 6 x 14 at (2, 48, 48), (1, 26, 48) and (1, 50, 96) (PERF.md).
// - The body is simple, not yet fast: one block per SM, no cluster multicast
//   of the weight stream, no persistent tiles. With 9 or more warps a block
//   gets at most 168 registers a thread (three warps share an SM
//   sub-partition's 16K), whatever setmaxnreg grants later; ptxas then
//   serialises the wgmma ("insufficient register resources") and spills
//   48-160 bytes. On an H100 (700 W), measured in one call each (PERF.md):
//   a producer warp without setmaxnreg ran 5-7% slower; a block of
//   the two warpgroups alone, thread 0 issuing the loads (238 registers, no
//   spill, no serialisation), ran 6% slower at 48^2 and 2-3% faster at 96^2
//   and 384^2. So the serialisation is not what bounds it; the 2.36 MB of
//   weights each block streams from L2 and each warpgroup's wait per chunk
//   are the suspects.
// - A wait on an mbarrier that outlasts kHangNs traps, as in the attention
//   body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "common.cuh"
#include "resblock.cuh"

namespace depth_pro_resblock {
namespace {

using namespace depth_pro_kernels;
using bf16 = __nv_bfloat16;

constexpr int C = kWgmmaChannels;
constexpr int LD = C + 8;             // staged pixel (elements): 528 bytes, 33 16-byte units
constexpr int PIECES = C / 8;         // 16-byte pieces per staged pixel
constexpr int KC = 64;                // weight rows (input channels of one tap) per chunk
constexpr int KSTEPS = KC / 16;       // k16 steps per chunk
constexpr int ATOMS = C / 64;         // 64-column swizzle atoms across N
constexpr int ATOM_BYTES = KC * 128;  // one TMA box: 8 KB
constexpr int STAGE_BYTES = ATOMS * ATOM_BYTES;  // one chunk: 32 KB
constexpr int STAGES = 4;
constexpr int CHUNKS = 9 * C / KC;    // chunks per conv: 36
constexpr int CONSUMERS = 2;          // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536,
              "the register budgets exceed the SM's 65,536");

// Shared memory of a TH x TW tile, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes): relu(x) over the tile
// plus a 2-pixel halo, h over it once conv1 is done, the ring, the barriers.
template <int TH, int TW>
struct Geometry {
  static constexpr int XW = TW + 4, XPX = (TH + 4) * XW;  // staged relu(x)
  static constexpr int HW = TW + 2, HPX = (TH + 2) * HW;  // h
  static constexpr int OPX = TH * TW;
  static constexpr int T1 = (HPX + 63) / 64, T2 = (OPX + 63) / 64;  // m64 tiles per conv
  static constexpr int kRing = ((XPX > HPX ? XPX : HPX) * LD * 2 + 1023) / 1024 * 1024;
  static constexpr int kBars = kRing + STAGES * STAGE_BYTES;  // full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBars + 16 * STAGES + 1024;   // + alignment slack
  static_assert(T1 <= CONSUMERS && T2 <= CONSUMERS, "a conv takes one m64 tile a warpgroup");
  static_assert(kBytes <= 227 * 1024, "K2's wgmma body exceeds 227 KB of shared memory");
};

// The two tiles (rows, columns).
struct Wide {
  static constexpr int TH = 6, TW = 14;
};
struct Narrow {
  static constexpr int TH = 8, TW = 8;
};

// the consumer warpgroups meet (the producer warpgroup does not take part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// acc += A B for one k16 step: one wgmma over the NA atoms from the
// descriptor's start (m64n256k16 for 4, m64n128k16 for 2)
template <int NA>
__device__ __forceinline__ void wgmma_atoms(float (&acc)[NA * 32], const uint32_t (&a)[4],
                                            uint64_t b) {
  static_assert(NA == 2 || NA == 4, "a warpgroup takes 2 or 4 atoms");
  if constexpr (NA == 4)
    wgmma_rs_tb_n256(acc, a, b);
  else
    wgmma_rs_tb_n128(acc, a, b);
}

// Chunk r (0 .. CHUNKS - 1) of the conv whose chunks start at q0 in the
// stream, for one warpgroup: af <- this lane's A fragments (its row at the
// chunk's tap, the chunk's KC input channels); acc += A B over the stage's
// atoms [atom0, atom0 + NA). Then waits until the previous chunk's products
// are done (their A fragments, `prev`, and their stage are free) and
// releases that stage. a_row: this lane's A address at tap (0, 0), channel
// 0; AW: pixels per row of the grid A is read from.
template <int NA, int AW>
__device__ __forceinline__ void chunk(float (&acc)[NA * 32], uint32_t (&af)[KSTEPS][4],
                                      uint32_t (&prev)[KSTEPS][4], uint32_t a_row, int atom0,
                                      uint32_t ring, uint32_t full_bar, uint32_t empty_bar,
                                      int q0, int r) {
  const int q = q0 + r;
  const int st = q % STAGES;
  const int tap = r / (C / KC);
  const uint32_t k_addr = a_row + (((tap / 3) * AW + tap % 3) * LD + (r % (C / KC)) * KC) * 2;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(af[kk], k_addr + kk * 32);
  mbar_wait(full_bar + 8 * st, (q / STAGES) & 1);
  // a k16 step starts 16 rows (2048 bytes) into each 64-row box; the boxes
  // (64-column atoms) are ATOM_BYTES apart
  const uint32_t stage = ring + st * STAGE_BYTES + atom0 * ATOM_BYTES;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_atoms<NA>(acc, af[kk], smem_desc(stage + kk * 2048, ATOM_BYTES >> 4));
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc);
  fence_regs(prev);
  if (r > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty_bar + 8 * ((q - 1) % STAGES));
}

// acc = A W over one conv's CHUNKS chunks, the stream's from q0 on.
template <int NA, int AW>
__device__ __forceinline__ void conv_gemm(float (&acc)[NA * 32], uint32_t a_row, int atom0,
                                          uint32_t ring, uint32_t full_bar, uint32_t empty_bar,
                                          int q0) {
  static_assert(CHUNKS % 2 == 0, "the chunks alternate between two fragment sets");
  uint32_t af[2][KSTEPS][4];
#pragma unroll
  for (int i = 0; i < NA * 32; ++i) acc[i] = 0.f;
  for (int r = 0; r < CHUNKS; r += 2) {
    chunk<NA, AW>(acc, af[0], af[1], a_row, atom0, ring, full_bar, empty_bar, q0, r);
    chunk<NA, AW>(acc, af[1], af[0], a_row, atom0, ring, full_bar, empty_bar, q0, r + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(af[1]);
  if (threadIdx.x % 32 == 0) mbar_arrive(empty_bar + 8 * ((q0 + CHUNKS - 1) % STAGES));
}

// The accumulator of an m64nN wgmma, per thread of the warpgroup: warp w
// owns rows 16w + g and 16w + g + 8 (g = lane / 4); register 4j + e holds
// column 8j + 2 (lane % 4) + e of the first row (e < 2) or of the second
// (e >= 2); so acc[32 i + 4 j + e] is column 64 (atom0 + i) + 8 j + 2 (lane % 4) + e.
template <int TH, int TW>
__global__ void __launch_bounds__(THREADS, 1)
    resblock_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2,
                          const bf16* __restrict__ x, const float* __restrict__ b1,
                          const float* __restrict__ b2, bf16* __restrict__ out, int H, int W) {
  using G = Geometry<TH, TW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  bf16* act = reinterpret_cast<bf16*>(smem_raw + (base - raw));  // relu(x), then h
  const uint32_t ring = base + G::kRing;
  const uint32_t full_bar = base + G::kBars;  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const size_t img = (size_t)blockIdx.y * H;  // pixel (gy, gx) is ((img + gy) * W + gx)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * CONSUMERS && lane == 0) {
      prefetch_map(&map_w1);
      prefetch_map(&map_w2);
      for (int q = 0; q < 2 * CHUNKS; ++q) {
        const int st = q % STAGES;
        mbar_wait(empty_bar + 8 * st, ((q / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_bar + 8 * st, STAGE_BYTES);
        const CUtensorMap* map = q < CHUNKS ? &map_w1 : &map_w2;
        const int k0 = (q % CHUNKS) * KC;
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load_2d(ring + st * STAGE_BYTES + a * ATOM_BYTES, map, 64 * a, k0,
                      full_bar + 8 * st);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  // relu(x) over image rows [y0 - 2, y0 + TH + 2) x cols [x0 - 2, x0 + TW + 2),
  // zero outside the image; each thread ReLUs the pieces it copied
  for (int i = threadIdx.x; i < G::XPX * PIECES; i += 128 * CONSUMERS) {
    const int p = i / PIECES;
    const int n = (i % PIECES) * 8;
    const int gy = y0 - 2 + p / G::XW;
    const int gx = x0 - 2 + p % G::XW;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(base + (p * LD + n) * 2, valid ? x + ((img + gy) * W + gx) * C + n : x, valid);
  }
  cp_async_wait_all();
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  for (int i = threadIdx.x; i < G::XPX * PIECES; i += 128 * CONSUMERS) {
    uint4* v = reinterpret_cast<uint4*>(act + (i / PIECES) * LD + (i % PIECES) * 8);
    uint4 u = *v;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h2[e] = __hmax2(h2[e], zero);
    *v = u;
  }
  consumer_sync();  // relu(x) staged

  const int wg = warp / 4;
  const int g = lane >> 2;    // accumulator row (and row + 8) within the warp's 16
  const int tig = lane & 3;   // accumulator column pair
  const int row = 16 * (warp % 4);                 // this warp's first row of an m64 tile
  const uint32_t khalf = (lane >> 4) * 8 * 2;      // this lane's k half of an ldmatrix, bytes

  {  // conv1: h = relu(conv1(relu x) + b1) over the (TH + 2) x (TW + 2) positions
    constexpr int NA = G::T1 == CONSUMERS ? ATOMS : ATOMS / CONSUMERS;
    const int mt = G::T1 == CONSUMERS ? wg : 0;
    const int atom0 = G::T1 == CONSUMERS ? 0 : wg * NA;
    int p = mt * 64 + row + (lane & 15);
    if (p >= G::HPX) p = 0;  // round-up rows: read any pixel, never stored
    float acc[NA * 32];
    conv_gemm<NA, G::XW>(acc, base + ((p / G::HW) * G::XW + p % G::HW) * LD * 2 + khalf, atom0,
                         ring, full_bar, empty_bar, 0);
    consumer_sync();  // every warpgroup is done reading relu(x): h goes over it
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * (atom0 + i) + 8 * j + 2 * tig;
        const float2 bb = bias_pair(b1, n);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ph = mt * 64 + row + g + 8 * half;
          if (ph >= G::HPX) continue;
          const int gy = y0 - 1 + ph / G::HW;
          const int gx = x0 - 1 + ph % G::HW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float v0 = inside ? fmaxf(acc[32 * i + 4 * j + 2 * half] + bb.x, 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[32 * i + 4 * j + 2 * half + 1] + bb.y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(act + ph * LD + n) = pack_bf16(v0, v1);
        }
      }
    }
  }
  consumer_sync();  // h written

  {  // conv2: out = conv2(h) + b2 + x over the tile
    constexpr int NA = G::T2 == CONSUMERS ? ATOMS : ATOMS / CONSUMERS;
    const int mt = G::T2 == CONSUMERS ? wg : 0;
    const int atom0 = G::T2 == CONSUMERS ? 0 : wg * NA;
    int o = mt * 64 + row + (lane & 15);
    if (o >= G::OPX) o = 0;
    float acc[NA * 32];
    conv_gemm<NA, G::HW>(acc, base + ((o / TW) * G::HW + o % TW) * LD * 2 + khalf, atom0, ring,
                         full_bar, empty_bar, CHUNKS);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * (atom0 + i) + 8 * j + 2 * tig;
        const float2 bb = bias_pair(b2, n);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int oh = mt * 64 + row + g + 8 * half;
          const int gy = y0 + oh / TW;
          const int gx = x0 + oh % TW;
          if (oh >= G::OPX || gy >= H || gx >= W) continue;
          const size_t at = ((img + gy) * W + gx) * C + n;
          const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
          *reinterpret_cast<uint32_t*>(out + at) =
              pack_bf16(acc[32 * i + 4 * j + 2 * half] + bb.x + xr.x,
                        acc[32 * i + 4 * j + 2 * half + 1] + bb.y + xr.y);
        }
      }
    }
  }
}

// a 2-D map over one (9 * C, C) weight matrix: box 64 columns x KC rows, 128-byte swizzle
CUresult encode_weights(EncodeTiled fn, CUtensorMap* map, const void* w) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};  // bytes, dim 1
  const cuuint32_t box[2] = {64, KC};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <class T>
cudaError_t launch_tile(const CUtensorMap (&maps)[2], const void* x, const float* b1,
                        const float* b2, void* out, int B, int H, int W, cudaStream_t stream) {
  using G = Geometry<T::TH, T::TW>;
  const auto kernel = resblock_wgmma_kernel<T::TH, T::TW>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kBytes);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((H + T::TH - 1) / T::TH) * ((W + T::TW - 1) / T::TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, B);
  kernel<<<grid, THREADS, G::kBytes, stream>>>(maps[0], maps[1], static_cast<const bf16*>(x), b1,
                                               b2, static_cast<bf16*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

void wgmma_tile(int B, int H, int W, int sm_count, int* th, int* tw) {
  const bool wide = (long long)B * ((H + Wide::TH - 1) / Wide::TH) *
                        ((W + Wide::TW - 1) / Wide::TW) >=
                    sm_count;
  *th = wide ? Wide::TH : Narrow::TH;
  *tw = wide ? Wide::TW : Narrow::TW;
}

int launch_wgmma(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
                 void* out, int B, int H, int W, int sm_count, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[2];
  CUresult r = encode_weights(fn, &maps[0], w1);
  if (r == CUDA_SUCCESS) r = encode_weights(fn, &maps[1], w2);
  if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  int th = 0, tw = 0;
  wgmma_tile(B, H, W, sm_count, &th, &tw);
  return (int)(th == Wide::TH ? launch_tile<Wide>(maps, x, b1, b2, out, B, H, W, stream)
                              : launch_tile<Narrow>(maps, x, b1, b2, out, B, H, W, stream));
}

}  // namespace depth_pro_resblock
