// Fused DPT residual block: out = x + conv3x3(relu(conv3x3(relu(x)) + b1)) + b2.
// The entry point K2 (`resblock_forward`), its dispatch, and the mma.sync
// body for widths other than 256.
//
// Replaces: ml_depth_pro_video_tpu/ops/resblock.py::_resblock_pallas
// (Pallas body `_resblock_kernel`). Dispatch, of the shape alone: C = 256
// (the large preset's decoder, every model path's K2) takes the wgmma + TMA
// body of csrc/resblock_wgmma.cu; every other width (a multiple of 8 up to
// 256: 96 and 192 in `small` and `base`, 24-128 in the card tests) takes the
// body below. Either body's failed launch is returned as an error, never
// retried on the other. The entry point runs under the one device rule of
// csrc/common.cuh (`on_device`). Both convs are 3x3, stride 1, pad 1,
// NHWC activations, weights (9, C, C) = HWIO with the taps flattened. The
// intermediate h is zero outside the image (torch's pad semantics for the
// second conv) and is rounded to bf16, as the TPU kernel rounds it; the
// biases are rounded to bf16 and added in fp32; conv2 + b2 + x is summed in
// fp32 and rounded once.
//
// What bounds it on an H100: at the decoder's levels (C = 256 at 48^2 and
// up) one block is 2 x 9 x 256 x 256 MACs per pixel, ~2.4 kFLOP per byte of
// x read and out written: far above the ~295 FLOP/byte ridge, so the
// function is bound by the tensor cores. The plain composition (two cuDNN
// convs plus three elementwise passes) also round-trips h and relu(x)
// through device memory; this kernel keeps them in shared memory. What
// bounds this design is the weight stream: every block reads both weight
// sets (2.36 MB at C = 256) from L2, so bigger tiles read fewer bytes per
// output pixel.
//
// Design of the body below (mma.sync, ldmatrix and cp.async; no TMA, no wgmma):
// - One block of 8 warps per (batch item, TH x TW output tile). cp.async
//   stages x over the tile plus a 2-pixel halo in shared memory (zero
//   outside the image and past C), ReLU'd in place; conv1 computes h over
//   the tile plus a 1-pixel halo into shared memory; conv2 writes the tile.
// - Each conv is an implicit GEMM on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulate): rows are the pixels it computes, K is 9 taps
//   x C, N is C. ldmatrix takes one row address per lane, so for tap
//   (dy, dx) each lane points at the staged pixel its GEMM row needs: the
//   rows are exactly the positions computed, rounded up to 16 (a 10x8
//   tile: conv1 120 -> 128 rows, conv2 80), with no junk columns.
// - Each warp owns 32 output channels and every GEMM row: each A fragment
//   feeds 4 MMAs, each B fragment every m-tile (8 / 5 of a 10x8 tile).
// - Each warp streams its own 32 columns of the weights through a private
//   ring of STAGES chunks (KC input channels of one tap) in shared memory,
//   filled by cp.async STAGES - 1 chunks ahead and read with ldmatrix.trans.
//   The ring needs only __syncwarp, so the warps drift apart and one warp's
//   fragment loads overlap another's MMAs; the block meets at a barrier
//   twice (relu(x) staged, h written). The two convs' chunks form one
//   stream, so conv2's first chunks land while conv1 finishes. No fragment
//   is read from global memory inside the MMA loop.
// - The epilogues work on the accumulator fragments in registers: conv1
//   adds b1, applies ReLU, zeroes positions outside the image and rounds h
//   to bf16 into shared memory; conv2 adds b2 and x and stores bf16 pairs.
// - Tiling: 10x8 tiles where they give every SM a block, else 6x6 tiles.
//   On an H100 (700 W) a 10x8 tile with 64-row chunks beat 12x8 with 32-row
//   ones (the most a 12x8 tile leaves room for) and 8x8 at (2, 96, 96, 256),
//   measured when this body still took C = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

#include "common.cuh"
#include "resblock.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WARP_N = 32;              // output channels per warp
constexpr int NT = WARP_N / 8;          // n8 tiles per warp
constexpr int MAX_C = NWARPS * WARP_N;  // 256: one pass over the output channels
constexpr int KC = 64;                  // weight rows (input channels) per ring chunk
constexpr int STAGES = 2;               // chunks in each warp's ring
constexpr int RING_ROW = WARP_N * 2;    // bytes of one ring row: a warp's 32 columns
constexpr uint32_t CHUNK = KC * RING_ROW;  // bytes per ring stage

// Shared memory for width C: staged relu(x), h, the warps' weight rings of
// STAGES chunks of KC rows. Channels are rounded up to cn, a multiple of KC
// and of a warp's 32 (warps whose channels lie past C compute zeros); x and
// h rows are padded by 8 elements, an odd number of 16-byte units, so the 8
// rows of one ldmatrix hit 8 distinct bank groups (ring rows are swizzled
// instead: see WarpWeights).
template <int TH, int TW>
struct Geometry {
  static constexpr int XW = TW + 4, XPX = (TH + 4) * XW;  // staged x: tile + 2-pixel halo
  static constexpr int HW = TW + 2, HPX = (TH + 2) * HW;  // h: tile + 1-pixel halo
  static constexpr int OPX = TH * TW;
  static constexpr int MT1 = (HPX + 15) / 16, MT2 = (OPX + 15) / 16;  // m16 tiles per conv
  int cn = 0, ld = 0;  // rounded channels; x and h row stride in elements
  uint32_t h_off = 0, w_off = 0, bytes = 0;
  __host__ __device__ constexpr explicit Geometry(int C) {
    constexpr int R = KC > WARP_N ? KC : WARP_N;
    cn = (C + R - 1) / R * R;
    ld = cn + 8;
    h_off = XPX * ld * 2;
    w_off = h_off + HPX * ld * 2;
    bytes = w_off + (cn / WARP_N) * STAGES * CHUNK;
  }
};

using depth_pro_kernels::cp_async16;  // zero-fills outside the image and past C
using depth_pro_kernels::ldmatrix_x4;
using depth_pro_kernels::pack_bf16;
using depth_pro_kernels::smem_u32;
using depth_pro_resblock::bias_pair;

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators. Not
// volatile: it touches registers only, so the compiler may interleave it
// with the fragment loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's weight stream: conv1's 9 * cn / KC chunks, then conv2's, issued
// in order into a ring of STAGES chunks. A chunk is input channels
// [k0, k0 + KC) of one tap and the warp's 32 output channels, zero past C:
// KC rows of 64 bytes, whose four 16-byte units are stored XOR-swizzled by
// bits 1-2 of the row (unit u of row r at u ^ (r >> 1 & 3)), so the 8 rows
// an ldmatrix reads hit 8 distinct bank groups. A lane copies the same
// units of every chunk: rows lane / 4 + 8 j, unit lane % 4.
struct WarpWeights {
  static constexpr int PIECES = KC / 8;  // 16-byte pieces per lane and chunk
  const bf16* w;   // the weights the next chunk comes from: w1, then w2
  const bf16* w2;
  int C, cn;
  int tap, k0;     // the next chunk
  int issued;      // chunks issued so far
  int col;         // this lane's first column (output channel)
  uint32_t ring;   // shared address of this warp's ring
  uint32_t dst;    // this lane's byte offset in a ring stage

  __device__ WarpWeights(const bf16* w1_, const bf16* w2_, int C_, int cn_, int n0, uint32_t ring_)
      : w(w1_), w2(w2_), C(C_), cn(cn_), tap(0), k0(0), issued(0) {
    const int lane = threadIdx.x % 32, r = lane / 4, u = lane % 4;
    col = n0 + 8 * u;
    ring = ring_;
    dst = r * RING_ROW + 16 * (u ^ ((r >> 1) & 3));
  }

  // the next chunk -> ring stage issued % STAGES (the caller commits)
  __device__ __forceinline__ void load_next() {
    const uint32_t stage = ring + (issued % STAGES) * CHUNK + dst;
    const int r0 = k0 + (threadIdx.x % 32) / 4;
    const bf16* src = w + ((size_t)tap * C + r0) * C + col;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const bool valid = r0 + 8 * j < C && col < C;
      cp_async16(stage + 8 * j * RING_ROW, valid ? src + 8 * j * C : w, valid);
    }
    ++issued;
    k0 += KC;
    if (k0 >= cn) {
      k0 = 0;
      if (++tap == 9) {
        tap = 0;
        w = w2;
      }
    }
  }
};

// acc += A x W over one conv's 9 * cn / KC chunks of the warp's stream, the
// chunks from q on (q is advanced past them). a_row[mt]: shared address of
// this lane's A row of m-tile mt at tap (0, 0), its k half included; AW:
// pixels per row of the grid A is read from; ld: its row stride in elements.
template <int MT, int AW>
__device__ __forceinline__ void conv_gemm(float (&acc)[MT][NT][4], const uint32_t (&a_row)[MT],
                                          WarpWeights& wt, int ld, int& q) {
  const int lane = threadIdx.x % 32;
  const int total = 2 * 9 * (wt.cn / KC);  // chunks in the whole stream
  // ldmatrix.trans of a 16 x 16 (k x n) block: lanes 0-7 give rows 0-7 of
  // columns 0-7, lanes 8-15 rows 8-15, lanes 16-31 the same for columns
  // 8-15; units 2 np + lane / 16 of rows with swizzle (lane >> 1) & 3
  const uint32_t b_row = ((lane & 7) + ((lane >> 3) & 1) * 8) * RING_ROW;
  uint32_t b_unit[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) b_unit[np] = 16 * ((2 * np + (lane >> 4)) ^ ((lane >> 1) & 3));
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t tap_off = ((tap / 3) * AW + tap % 3) * ld * 2;
    for (int k0 = 0; k0 < wt.cn; k0 += KC, ++q) {
      cp_async_wait<STAGES - 2>();  // chunk q has landed (this lane's copies)
      __syncwarp();                 // ... every lane's; and chunk q - 1 is consumed
      if (wt.issued < total) wt.load_next();
      cp_async_commit();
      const uint32_t w_addr = wt.ring + (q % STAGES) * CHUNK + b_row;
      const uint32_t k_off = tap_off + k0 * 2;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t b[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, w_addr + 16 * kk * RING_ROW + b_unit[np]);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
        uint32_t a[2][4];  // the next m-tile's fragment loads while this one's MMAs issue
        ldmatrix_x4(a[0], a_row[0] + k_off + kk * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt + 1 < MT) ldmatrix_x4(a[(mt + 1) & 1], a_row[mt + 1] + k_off + kk * 32);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt & 1], b[nt][0], b[nt][1]);
        }
      }
    }
  }
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
    resblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C) {
  using G = Geometry<TH, TW>;
  const G geo(C);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + geo.h_off);
  const int ld = geo.ld;

  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const size_t img = (size_t)blockIdx.y * H;  // pixel (gy, gx) is ((img + gy) * W + gx)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = warp * WARP_N;     // this warp's output channels
  const bool active = n0 < geo.cn;  // narrow C leaves warps without channels
  WarpWeights wt(w1, w2, C, geo.cn, n0, smem_u32(smem + geo.w_off + warp * STAGES * CHUNK));

  // x over image rows [y0-2, y0+TH+2) x cols [x0-2, x0+TW+2) and each warp's
  // first weight chunks, then relu(x) in place on this thread's own pieces
  const int per_row = geo.cn / 8;
  for (int i = threadIdx.x; i < G::XPX * per_row; i += NTHREADS) {
    const int p = i / per_row;
    const int n = (i - p * per_row) * 8;
    const int gy = y0 - 2 + p / G::XW;
    const int gx = x0 - 2 + p % G::XW;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W && n < C;
    cp_async16(smem_u32(xs + p * ld + n), valid ? x + ((img + gy) * W + gx) * C + n : x, valid);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (active) wt.load_next();
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  for (int i = threadIdx.x; i < G::XPX * per_row; i += NTHREADS) {
    const int p = i / per_row;
    uint4* v = reinterpret_cast<uint4*>(xs + p * ld + (i - p * per_row) * 8);
    uint4 u = *v;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h2[e] = __hmax2(h2[e], zero);
    *v = u;
  }
  __syncthreads();  // relu(x) staged

  const int g = lane >> 2;   // accumulator fragment row (and row + 8)
  const int tig = lane & 3;  // accumulator fragment column pair
  int q = 0;

  if (active) {  // conv1: h = relu(conv1(relu x) + b1) over the (TH+2) x (TW+2) positions
    float acc[G::MT1][NT][4] = {};
    uint32_t a_row[G::MT1];
#pragma unroll
    for (int mt = 0; mt < G::MT1; ++mt) {
      int p = mt * 16 + (lane & 15);
      if (p >= G::HPX) p = 0;  // round-up rows: read any pixel, never stored
      a_row[mt] = smem_u32(xs + ((p / G::HW) * G::XW + p % G::HW) * ld + (lane >> 4) * 8);
    }
    conv_gemm<G::MT1, G::XW>(acc, a_row, wt, ld, q);
    float2 bias[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + 2 * tig;
      bias[nt] = n < C ? bias_pair(b1, n) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int mt = 0; mt < G::MT1; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + 8 * half;
        if (p >= G::HPX) continue;
        const int gy = y0 - 1 + p / G::HW;
        const int gx = x0 - 1 + p % G::HW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + nt * 8 + 2 * tig;
          const bool valid = inside && n < C;  // C % 8 == 0: both of the pair or neither
          const float v0 = valid ? fmaxf(acc[mt][nt][2 * half] + bias[nt].x, 0.f) : 0.f;
          const float v1 = valid ? fmaxf(acc[mt][nt][2 * half + 1] + bias[nt].y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(hs + p * ld + n) = pack_bf16(v0, v1);
        }
      }
    }
  }
  __syncthreads();  // h written
  if (!active) return;

  {  // conv2: out = conv2(h) + b2 + x over the tile
    float acc[G::MT2][NT][4] = {};
    uint32_t a_row[G::MT2];
#pragma unroll
    for (int mt = 0; mt < G::MT2; ++mt) {
      int o = mt * 16 + (lane & 15);
      if (o >= G::OPX) o = 0;
      a_row[mt] = smem_u32(hs + ((o / TW) * G::HW + o % TW) * ld + (lane >> 4) * 8);
    }
    conv_gemm<G::MT2, G::HW>(acc, a_row, wt, ld, q);
    float2 bias[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + 2 * tig;
      bias[nt] = n < C ? bias_pair(b2, n) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int mt = 0; mt < G::MT2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = mt * 16 + g + 8 * half;
        const int gy = y0 + o / TW;
        const int gx = x0 + o % TW;
        if (o >= G::OPX || gy >= H || gx >= W) continue;
        const size_t base = ((img + gy) * W + gx) * C;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + nt * 8 + 2 * tig;
          if (n >= C) continue;
          const float2 xr =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + base + n));
          *reinterpret_cast<uint32_t*>(out + base + n) =
              pack_bf16(acc[mt][nt][2 * half] + bias[nt].x + xr.x,
                        acc[mt][nt][2 * half + 1] + bias[nt].y + xr.y);
        }
      }
    }
  }
}

// The two instances' output tiles (rows, columns).
struct Wide {
  static constexpr int TH = 10, TW = 8;
};
struct Narrow {
  static constexpr int TH = 6, TW = 6;
};

template <class T>
using GeometryOf = Geometry<T::TH, T::TW>;

// every C the entry takes fits one Hopper block's dynamic shared memory
static_assert(GeometryOf<Wide>(MAX_C).bytes <= 227 * 1024 &&
                  GeometryOf<Narrow>(MAX_C).bytes <= 227 * 1024,
              "K2 at C = MAX_C exceeds 227 KB of shared memory");

// Wide tiles where they give every SM a block; a smaller grid spreads wider
// over the card in narrow tiles.
bool wide_tiles(int B, int H, int W, int sm_count) {
  return (long long)B * ((H + Wide::TH - 1) / Wide::TH) * ((W + Wide::TW - 1) / Wide::TW) >=
         sm_count;
}

template <class T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, int B, int H, int W, int C, int device, cudaStream_t stream) {
  const auto kernel = resblock_kernel<T::TH, T::TW>;
  // the shared-memory limit is raised once per device (of the first 64) for
  // this instance, to what its widest C needs
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(raised.load() & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GeometryOf<T>(MAX_C).bytes);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit);
  }
  const long long tiles = (long long)((H + T::TH - 1) / T::TH) * ((W + T::TW - 1) / T::TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, B);
  kernel<<<grid, NTHREADS, GeometryOf<T>(C).bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), H,
      W, C);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, C) bf16 contiguous, 16-byte aligned, C % 8 == 0 and
// C <= 256. w1, w2: (9, C, C) bf16 contiguous, 16-byte aligned; b1, b2: (C,)
// fp32, 8-byte aligned. Runs on `device`, on `stream`. Returns a cudaError_t
// code, or depth_pro_kernels::kTensorMapError + the CUresult of a refused
// tensor map.
extern "C" int resblock_forward(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int B, int H, int W, int C,
                                int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || C <= 0 || C % 8 || C > MAX_C || device < 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return depth_pro_kernels::on_device(device, [&](int sms) -> int {
    if (C == depth_pro_resblock::kWgmmaChannels)
      return depth_pro_resblock::launch_wgmma(x, w1, static_cast<const float*>(b1), w2,
                                              static_cast<const float*>(b2), out, B, H, W, sms,
                                              st);
    return (int)(wide_tiles(B, H, W, sms)
                     ? launch<Wide>(x, w1, b1, w2, b2, out, B, H, W, C, device, st)
                     : launch<Narrow>(x, w1, b1, w2, b2, out, B, H, W, C, device, st));
  });
}

// The body a launch of this shape takes on `device` (*body: 0 the mma.sync
// body, 1 the wgmma body) and its output tile (*th rows x *tw columns).
// Returns a cudaError_t code.
extern "C" int resblock_kernel_body(int B, int H, int W, int C, int device, int* body, int* th,
                                    int* tw) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (C == depth_pro_resblock::kWgmmaChannels) {
    *body = 1;
    depth_pro_resblock::wgmma_tile(B, H, W, sms, th, tw);
  } else {
    const bool wide = wide_tiles(B, H, W, sms);
    *body = 0;
    *th = wide ? Wide::TH : Narrow::TH;
    *tw = wide ? Wide::TW : Narrow::TW;
  }
  return (int)e;
}
