// The bf16 attention body for Hopper at head dim 64: TMA loads into an
// mbarrier ring, wgmma for Q.K^T and P.V.
//
// Replaces, with csrc/attention_packed.cu (entry points and dispatch), the
// bf16 hd = 64 instances of three Pallas kernels of
// ml_depth_pro_video_tpu/ops/attention.py:
// - K1 `attention_packed_forward` <- flash_attention_packed (`:212`,
//   pallas_call `:241`): out[b, s, 64h:64h+64] = softmax(q_h k_h^T / 8) v_h,
//   with q_h, k_h, v_h the slots 3h, 3h + 1, 3h + 2 of the packed qkv
//   (B, S, 3 * H * 64);
// - K3 `attention_packed_bias_forward` <- flash_attention_packed_bias
//   (`:168`, pallas_call `:193`, body `_packed_kernel_bias`): K1 with an fp32
//   per-key bias (B, S) added to the scaled scores (ToMe's log token sizes,
//   which may hold -inf): the `BIAS` instances;
// - K4 `attention_bhsd_forward` <- _flash_attention (`:75`, pallas_call
//   `:90`): the same function as K1 on separate q, k, v and out of
//   (B, H, S, 64).
// Scores and softmax are fp32, inputs and output bf16; keys >= S are masked
// in the kernel; a row with no finite score writes zeros.
//
// What bounds it on an H100: at (70, 577, 3072) one call is ~95 GFLOP of
// Q.K^T and P.V against ~331 MB read and written, ~290 FLOP/byte, next to
// the card's ~295 bf16 FLOP/byte ridge (K3 at (70, 433, 3072): ~54 GFLOP
// against ~249 MB, ~215 FLOP/byte): tensor-core rate and bandwidth both
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
// - With a bias, each stage also holds the fp32 biases of its 64 keys,
//   loaded by TMA through a 1-D map over the flattened (B * S) bias (a 2-D
//   map would need a row stride of 4 * S bytes, a multiple of 16, which S =
//   433 and 289 are not). A box must start 16-byte aligned, so it starts at
//   the multiple of 4 at or below b * S + k0 and holds 68 values; the
//   consumers read from that offset on. Past S the box reads the next item's
//   biases or TMA's zeros; the key mask covers them, since it comes after
//   the bias add.
// - Each consumer warpgroup computes S = Q K^T with four wgmma m64n64k16
//   (both operands in shared memory, K-major), runs the fp32 online softmax
//   on the accumulator in registers (base 2: without a bias the scale folds
//   into one FMA per score; with one each score is first scale * s + bias,
//   as in the mma.sync body, then the key mask and the running max), converts it
//   in place to the bf16 A fragments of P.V (the accumulator's layout is the
//   A operand's, as in FlashAttention-3), and adds P V with four wgmma
//   m64n64k16 whose B operand is the V tile read transposed through its
//   descriptor (MN-major; 16-bit types allow it). It then releases the stage
//   to the producer. O stays in registers; each thread writes its rows once
//   at the end. The running max is guarded (`finite_or_zero`), so a key tile
//   or a row whose scores are all -inf gives 0, not NaN.
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
#include "common.cuh"

namespace depth_pro_attention {
namespace {

using namespace depth_pro_kernels;
using bf16 = __nv_bfloat16;

constexpr int HD = 64;       // head dim: one 128-byte swizzled row per key or query
constexpr int BM = 64;       // query rows per consumer warpgroup (wgmma's M)
constexpr int BN = 64;       // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int TILE = BN * HD * (int)sizeof(bf16);  // bytes of one 64-row box: 8 KB
constexpr int BIAS_N = BN + 4;        // biases a stage loads: its 64 from a 16-byte aligned start
constexpr int BIAS_BYTES = BIAS_N * (int)sizeof(float);  // 272, a multiple of 16
constexpr int BIAS_STRIDE = 384;      // bytes between stages' biases: 128-byte aligned boxes
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a block with C consumer warpgroups, from a 1024-byte
// aligned base (the 128-byte swizzle repeats every 8 rows = 1024 bytes)
template <int C>
struct Smem {
  static constexpr int kQ = 0;                          // C boxes of 64 query rows
  static constexpr int kK = C * TILE;                   // STAGES boxes of 64 keys
  static constexpr int kV = kK + STAGES * TILE;         // STAGES boxes of 64 values
  static constexpr int kB = kV + STAGES * TILE;            // STAGES rows of key biases
  static constexpr int kBars = kB + STAGES * BIAS_STRIDE;  // q, full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct WgArgs {
  bf16* o;
  long long out_b, out_h, out_r;
  int S;
  float scale;  // hd^-0.5, applied before the bias (BIAS only)
  float c2;     // the softmax runs in base 2: hd^-0.5 * log2(e), or log2(e) with a bias
  int packed;  // map dims (64, 3H, S, B), slot 3h + i (K1); else (64, S, H, B) (K4)
};

__device__ __forceinline__ float fast_exp2(float x) {  // 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// map_b: the 1-D map over the flattened (B * S) fp32 bias (BIAS only).
template <int C, bool BIAS>
__global__ void __launch_bounds__(C * 128 + 32, C == 2 ? 2 : 3)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_b, const WgArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* bias_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + Smem<C>::kB);
  const uint32_t b_s = base + Smem<C>::kB;
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
      if (BIAS) prefetch_map(&map_b);
      // coordinates (d, slot or row, row or head, item): K1 (64, 3H, S, B), K4 (64, S, H, B)
      const int hq = a.packed ? 3 * h : h;
      const int hk = a.packed ? 3 * h + 1 : h;
      const int hv = a.packed ? 3 * h + 2 : h;
      mbar_expect_tx(q_bar, n_active * TILE);
      for (int w = 0; w < n_active; ++w) {
        const int r = q0 + w * BM;
        tma_load_4d(q_s + w * TILE, &map_q, 0, a.packed ? hq : r, a.packed ? r : hq, b, q_bar);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int r = t * BN;
        mbar_wait(empty_bar + 8 * st, ((t / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_bar + 8 * st, 2 * TILE + (BIAS ? BIAS_BYTES : 0));
        tma_load_4d(k_s + st * TILE, &map_k, 0, a.packed ? hk : r, a.packed ? r : hk, b,
                 full_bar + 8 * st);
        tma_load_4d(v_s + st * TILE, &map_v, 0, a.packed ? hv : r, a.packed ? r : hv, b,
                    full_bar + 8 * st);
        if (BIAS)
          tma_load_1d(b_s + st * BIAS_STRIDE, &map_b, (b * S + r) & ~3, full_bar + 8 * st);
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
    wgmma_wait<0>();
    fence_regs(s);

    if (BIAS) {  // scale * score + bias of this thread's two keys per 8-key block
      const float* bt = bias_s + st * (BIAS_STRIDE / 4) + ((b * S + t * BN) & 3) + 2 * tig;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float k0 = bt[8 * j], k1 = bt[8 * j + 1];
        s[4 * j] = fmaf(s[4 * j], a.scale, k0);
        s[4 * j + 1] = fmaf(s[4 * j + 1], a.scale, k1);
        s[4 * j + 2] = fmaf(s[4 * j + 2], a.scale, k0);
        s[4 * j + 3] = fmaf(s[4 * j + 3], a.scale, k1);
      }
    }

    const int kv = S - t * BN;  // valid keys from this tile on
    if (kv < BN) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * tig + e >= kv) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }

    // the online softmax, in base 2: exp(x - max) = 2^(x * c2 - max * c2), x the
    // raw score (c2 folds the scale in) or, with a bias, scale * score + bias
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
    wgmma_wait<0>();
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

// a 1-D fp32 map over n values, box of one stage's BIAS_N biases, zero past n
CUresult encode_bias(EncodeTiled fn, CUtensorMap* map, const float* bias, long long n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a 1-D map has none; not read
  const cuuint32_t box[1] = {(cuuint32_t)BIAS_N};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(bias), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int C, bool BIAS>
cudaError_t launch_c(const CUtensorMap (&maps)[4], const WgArgs& args, int B, int S, int H,
                     cudaStream_t stream) {
  const auto kernel = attention_wgmma_kernel<C, BIAS>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<C>::kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + C * BM - 1) / (C * BM), H, B);
  kernel<<<grid, C * 128 + 32, Smem<C>::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                          args);
  return cudaGetLastError();
}

}  // namespace

int launch_wgmma(const Layout& L, bool packed, int B, int S, int H, float scale, bool wide,
                 cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[4];  // q, k, v, bias
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
  const bool bias = L.bias != nullptr;
  if (r == CUDA_SUCCESS && bias) r = encode_bias(fn, &maps[3], L.bias, (long long)B * S);
  if (!bias) maps[3] = maps[0];  // not read
  if (r != CUDA_SUCCESS) return kTensorMapError + (int)r;
  const WgArgs args{static_cast<bf16*>(L.o), L.out_b, L.out_h, L.out_r, S, scale,
                    bias ? LOG2E : scale * LOG2E, packed ? 1 : 0};
  cudaError_t e;
  if (bias)
    e = wide ? launch_c<2, true>(maps, args, B, S, H, stream)
             : launch_c<1, true>(maps, args, B, S, H, stream);
  else
    e = wide ? launch_c<2, false>(maps, args, B, S, H, stream)
             : launch_c<1, false>(maps, args, B, S, H, stream);
  return (int)e;
}

}  // namespace depth_pro_attention
