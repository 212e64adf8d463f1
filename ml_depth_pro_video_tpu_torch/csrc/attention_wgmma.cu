// The bf16 attention body for Hopper at head dim 64: TMA loads into an
// mbarrier ring, wgmma for Q.K^T and P.V.
//
// Replaces, with csrc/attention_packed.cu (entry points and dispatch), the
// bf16 hd = 64 no-bias instance of two Pallas kernels of
// ml_depth_pro_video_tpu/ops/attention.py:
// - K1 `attention_packed_forward` <- flash_attention_packed (`:212`,
//   pallas_call `:241`): out[b, s, 64h:64h+64] = softmax(q_h k_h^T / 8) v_h,
//   with q_h, k_h, v_h the slots 3h, 3h + 1, 3h + 2 of the packed qkv
//   (B, S, 3 * H * 64);
// - K4 `attention_bhsd_forward` <- _flash_attention (`:75`, pallas_call
//   `:90`): the same function on separate q, k, v and out of (B, H, S, 64).
// Scores and softmax are fp32, inputs and output bf16; keys >= S are masked
// in the kernel; a row with no finite score writes zeros.
//
// What bounds it on an H100: at (70, 577, 3072) one call is ~95 GFLOP of
// Q.K^T and P.V against ~331 MB read and written, ~290 FLOP/byte, next to
// the card's ~295 bf16 FLOP/byte ridge: tensor-core rate and bandwidth both
// bound it, and only while the (B * H, S, S) scores stay out of device
// memory. So the tensor cores must be fed at their rate (wgmma, the only
// instruction that reaches it) while each K and V tile crosses from L2 once
// per 128 queries, and no score leaves the SM.
//
// Design. One block per (query tile, head, batch item): C consumer
// warpgroups of 64 query rows each (C = 2, 128 queries, where such blocks
// fill the card twice over: the rule `wide_blocks`, of the shape alone, so
// K1 and K4 run the same instance on the same data and agree bit for bit;
// else C = 1) and one producer warp.
// - The producer's one thread issues TMA loads (cp.async.bulk.tensor.4d):
//   the block's Q rows once, then 64-key tiles of K and V through a ring of
//   two stages, each with a full and an empty mbarrier. The tensor maps are
//   4-D: the packed qkv is (64, 3H, S, B) with strides (1, 64, 3 * H * 64,
//   S * 3 * H * 64) elements, the (B, H, S, 64) tensors are (64, S, H, B).
//   TMA's zero fill covers the rows past S of each batch item: no read
//   crosses into the next item and no padded copy is made; zero keys still
//   score 0, so the softmax masks them. The 128-byte swizzle (a row of 64
//   bf16 is 128 bytes) is the layout wgmma's descriptors read.
// - Each consumer warpgroup computes S = Q K^T with four wgmma m64n64k16
//   (both operands in shared memory, K-major), runs the fp32 online softmax
//   on the accumulator in registers (base 2, the scale folded into one FMA),
//   converts it in place to the bf16 A fragments of P.V (the accumulator's
//   layout is the A operand's, as in FlashAttention-3), and adds P V with
//   four wgmma m64n64k16 whose B operand is the V tile read transposed
//   through its descriptor (MN-major; 16-bit types allow it). It then
//   releases the stage to the producer. O stays in registers; each thread
//   writes its rows once at the end.
// - The body is simple, not yet fast: each warpgroup waits on its Q.K^T
//   before the softmax and on its P.V before the next tile; the overlap
//   comes from the other warpgroups on the SM (two blocks per SM where the
//   registers allow). Ping-pong scheduling, intra-warpgroup overlap and
//   setmaxnreg are left for later.
// - A wait on an mbarrier that outlasts kHangNs traps: a fault in the ring
//   becomes a launch failure that the next synchronise reports, not a hang.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace depth_pro_attention {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;       // head dim: one 128-byte swizzled row per key or query
constexpr int BM = 64;       // query rows per consumer warpgroup (wgmma's M)
constexpr int BN = 64;       // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int TILE = BN * HD * (int)sizeof(bf16);  // bytes of one 64-row box: 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned long long kHangNs = 20000000000ull;  // 20 s

// Shared memory of a block with C consumer warpgroups, from a 1024-byte
// aligned base (the 128-byte swizzle repeats every 8 rows = 1024 bytes)
template <int C>
struct Smem {
  static constexpr int kQ = 0;                          // C boxes of 64 query rows
  static constexpr int kK = C * TILE;                   // STAGES boxes of 64 keys
  static constexpr int kV = kK + STAGES * TILE;         // STAGES boxes of 64 values
  static constexpr int kBars = kV + STAGES * TILE;      // q, full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct WgArgs {
  bf16* o;
  long long out_b, out_h, out_r;
  int S;
  float c2;    // hd^-0.5 * log2(e): the softmax runs in base 2
  int packed;  // map dims (64, 3H, S, B), slot 3h + i (K1); else (64, S, H, B) (K4)
};

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; trap after kHangNs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// one 4-D TMA box -> shared memory, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A shared-memory matrix descriptor for a tile of 128-byte rows in the
// 128-byte swizzle: start address >> 4 (bits 0-13), leading byte offset
// (16-29) and stride byte offset (32-45) in 16-byte units, layout type 1 =
// SWIZZLE_128B (62-63). The stride byte offset steps over 8 rows (1024
// bytes): along M or N for the K-major Q and K, along K for the MN-major V.
// A K-major swizzled operand ignores the leading offset (1 by convention);
// V's steps from one 64-column swizzle atom to the next along N, and N = 64
// is one atom, so it is never stepped either: set to the 8-row step all the same.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_units) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lead_units << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator's registers at this point of the program: reads of
// an asynchronous wgmma's result may not move above its wait, nor writes
// below the next issue.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_D32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D32_OPERANDS(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) = [d +] A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_D32_OPERANDS

__device__ __forceinline__ float fast_exp2(float x) {  // 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes that share a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the max to subtract before exp: 0 while the running max is still -inf
__device__ __forceinline__ float finite_or_zero(float m) { return m == -INFINITY ? 0.f : m; }

// ---------------------------------------------------------------------------
// the kernel

// The accumulator of an m64nN wgmma, per thread of the warpgroup: warp w
// owns rows 16w + g and 16w + g + 8 (g = lane / 4); register 4j + e holds
// column 8j + 2 (lane % 4) + e of the first row (e < 2) or of the second
// (e >= 2). The A fragment from registers has the same layout per k16 slice.
template <int C>
__global__ void __launch_bounds__(C * 128 + 32, C == 2 ? 2 : 3)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const WgArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + Smem<C>::kQ;
  const uint32_t k_s = base + Smem<C>::kK;
  const uint32_t v_s = base + Smem<C>::kV;
  const uint32_t q_bar = base + Smem<C>::kBars;
  const uint32_t full_bar = q_bar + 8;                // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // + 8 * stage

  const int S = a.S;
  const int q0 = blockIdx.x * C * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_active = min(C, (S - q0 + BM - 1) / BM);  // warpgroups with a row below S
  const int n_tiles = (S + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * n_active);  // one arrival per active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      // coordinates (d, slot or row, row or head, item): K1 (64, 3H, S, B), K4 (64, S, H, B)
      const int hq = a.packed ? 3 * h : h;
      const int hk = a.packed ? 3 * h + 1 : h;
      const int hv = a.packed ? 3 * h + 2 : h;
      mbar_expect_tx(q_bar, n_active * TILE);
      for (int w = 0; w < n_active; ++w) {
        const int r = q0 + w * BM;
        tma_load(q_s + w * TILE, &map_q, 0, a.packed ? hq : r, a.packed ? r : hq, b, q_bar);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int r = t * BN;
        mbar_wait(empty_bar + 8 * st, ((t / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_bar + 8 * st, 2 * TILE);
        tma_load(k_s + st * TILE, &map_k, 0, a.packed ? hk : r, a.packed ? r : hk, b,
                 full_bar + 8 * st);
        tma_load(v_s + st * TILE, &map_v, 0, a.packed ? hv : r, a.packed ? r : hv, b,
                 full_bar + 8 * st);
      }
    }
    return;
  }

  const int wg = warp / 4;
  if (wg >= n_active) return;  // rows all past S: not counted on the empty barriers
  const int g = lane >> 2;     // accumulator row (and row + 8) within the warp's 16
  const int tig = lane & 3;    // accumulator column pair
  const uint64_t q_desc = smem_desc(q_s + wg * TILE, 1);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8, base-2 units
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of their sums

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(full_bar + 8 * st, (t / STAGES) & 1);
    const uint64_t k_desc = smem_desc(k_s + st * TILE, 1);
    const uint64_t v_desc = smem_desc(v_s + st * TILE, 1024 >> 4);

    // S = Q K^T: four k16 slices of the 128-byte rows, 32 bytes apart
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int kv = S - t * BN;  // valid keys from this tile on
    if (kv < BN) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * tig + e >= kv) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }

    // the online softmax, in base 2: exp(x / 8 - max) = 2^(x * c2 - max * c2)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * a.c2);
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * a.c2);
    const float sub_lo = finite_or_zero(mn_lo), sub_hi = finite_or_zero(mn_hi);
    const float alpha_lo = fast_exp2(m_lo - sub_lo);  // 0 while nothing was finite before
    const float alpha_hi = fast_exp2(m_hi - sub_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P in bf16, converted in place into the A fragments of P.V: slice kk
    // holds keys 16kk .. 16kk + 15, i.e. accumulator column blocks 2kk, 2kk + 1
    uint32_t pa[BN / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = fast_exp2(fmaf(s[4 * j], a.c2, -sub_lo));
      const float p1 = fast_exp2(fmaf(s[4 * j + 1], a.c2, -sub_lo));
      const float p2 = fast_exp2(fmaf(s[4 * j + 2], a.c2, -sub_hi));
      const float p3 = fast_exp2(fmaf(s[4 * j + 3], a.c2, -sub_hi));
      sum_lo += p0 + p1;  // the fp32 values, not the rounded ones
      sum_hi += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= alpha_lo;
      o[4 * n + 1] *= alpha_lo;
      o[4 * n + 2] *= alpha_hi;
      o[4 * n + 3] *= alpha_hi;
    }

    // O += P V: V (keys x 64) read as the MN-major B operand; the k16 slice
    // kk starts 16 rows (2048 bytes) further on
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb(o, pa[kk], v_desc + ((16 * 128 * kk) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);  // this warp is done with the stage
  }

  // full row sums across the quad; a row with no finite score writes zeros
  const float sl_lo = quad_sum(l_lo), sl_hi = quad_sum(l_hi);
  const float inv_lo = sl_lo > 0.f ? 1.f / sl_lo : 0.f;
  const float inv_hi = sl_hi > 0.f ? 1.f / sl_hi : 0.f;
  const int row_lo = q0 + wg * BM + (warp % 4) * 16 + g;
  const int row_hi = row_lo + 8;
  bf16* dst = a.o + b * a.out_b + h * a.out_h + 2 * tig;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(dst + row_lo * a.out_r + 8 * n) =
          pack_bf16(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(dst + row_hi * a.out_r + 8 * n) =
          pack_bf16(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so the library links nothing but the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D bf16 map of innermost dim 64 (one 128-byte row), box (64, box1, box2, 1)
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* base, long long d1, long long d2,
                long long d3, long long s1, long long s2, long long s3, int box1, int box2) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)s1 * sizeof(bf16), (cuuint64_t)s2 * sizeof(bf16),
                                 (cuuint64_t)s3 * sizeof(bf16)};  // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)HD, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int C>
cudaError_t launch_c(const CUtensorMap (&maps)[3], const WgArgs& args, int B, int S, int H,
                     cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      attention_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<C>::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + C * BM - 1) / (C * BM), H, B);
  attention_wgmma_kernel<C><<<grid, C * 128 + 32, Smem<C>::kBytes, stream>>>(maps[0], maps[1],
                                                                            maps[2], args);
  return cudaGetLastError();
}

}  // namespace

int launch_wgmma(const Layout& L, bool packed, int B, int S, int H, float scale, bool wide,
                 cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[3];
  CUresult r = CUDA_SUCCESS;
  if (packed) {  // one map (64, 3H, S, B): q, k, v are slots of it
    r = encode(fn, &maps[0], L.q, 3LL * H, S, B, HD, L.in_r, L.in_b, 1, BN);
    maps[1] = maps[0];
    maps[2] = maps[0];
  } else {  // a map (64, S, H, B) per tensor
    const void* ptrs[3] = {L.q, L.k, L.v};
    for (int i = 0; i < 3 && r == CUDA_SUCCESS; ++i)
      r = encode(fn, &maps[i], ptrs[i], S, H, B, L.in_r, L.in_h, L.in_b, BN, 1);
  }
  if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  const WgArgs args{static_cast<bf16*>(L.o), L.out_b, L.out_h, L.out_r, S, scale * LOG2E,
                    packed ? 1 : 0};
  return (int)(wide ? launch_c<2>(maps, args, B, S, H, stream)
                    : launch_c<1>(maps, args, B, S, H, stream));
}

}  // namespace depth_pro_attention
