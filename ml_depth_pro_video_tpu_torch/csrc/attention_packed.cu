// Fused multi-head attention, read through per-tensor (batch, head, row)
// strides: one kernel body serves three entry points.
//
// Replaces three Pallas kernels of ml_depth_pro_video_tpu/ops/attention.py:
// - K1 `attention_packed_forward` <- flash_attention_packed (body
//   `_packed_kernel`): for every head h,
//     out[b, s, h*hd:(h+1)*hd] = softmax(q_h k_h^T * hd^-0.5) v_h
//   where q_h, k_h, v_h are the columns [h*3hd, h*3hd+hd), [+hd, +2hd),
//   [+2hd, +3hd) of qkv (B, S, 3*H*hd) -- the head-contiguous packing of the
//   ViT qkv projection;
// - K3 `attention_packed_bias_forward` <- flash_attention_packed_bias (body
//   `_packed_kernel_bias`): K1 plus an fp32 per-key bias row (B, S) added to
//   the scaled scores (ToMe proportional attention: log token sizes);
// - K4 `attention_bhsd_forward` <- _flash_attention (body `_flash_kernel`):
//   the same function on separate q, k, v and out of shape (B, H, S, hd).
// Scores and softmax are fp32; keys >= S are masked in the kernel (no padded
// bias row or padded copy of the inputs, unlike the TPU kernels).
//
// What bounds it on an H100: at the Depth Pro shapes (S=577, hd=64, 16
// heads, 70 patches at batch 2) one call is ~95 GFLOP of Q.K^T and P.V
// against ~331 MB of input read and output written, ~290 FLOP/byte: at the
// card's ~295 bf16 FLOP/byte ridge, so tensor-core rate and bandwidth both
// bound it -- but only while the (B*H, S, S) scores stay out of device
// memory. The plain version writes and re-reads them in fp32.
//
// Design: one block per (query tile, head, batch item), 4 warps; the block
// loops over 64-key tiles with an fp32 online softmax, so any S works and no
// score leaves the SM. Ragged query and key tiles are zero-filled on load
// and masked in the softmax. The running max is guarded so that a key tile
// (or a whole row) whose scores are all -inf -- a -inf bias -- gives 0, not
// exp(-inf - -inf) = NaN; a row with no finite score at all writes zeros.
// - bf16 (the production path): the FlashAttention-2 tiling on the tensor
//   cores. mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the scores,
//   the probabilities and the output accumulator kept in registers (the
//   score accumulator fragment is re-packed as the A operand of P.V); K and
//   V tiles ride a cp.async ring in shared memory and are read with
//   ldmatrix (V transposed on the fly). A warp that owns 16 query rows
//   reads each K and V fragment for one mma pair, and those shared-memory
//   reads weigh as much as the tensor-core time; so at hd = 64 a warp owns
//   32 rows (128 queries per block) and uses each fragment twice; a grid
//   too small to fill the card with such blocks keeps 64-query blocks
//   (chosen from the shape alone, so K4 and K1 run the same instance on
//   the same data). S = 577 is
//   9 * 64 + 1: warps whose rows all lie past S skip their compute, a ragged
//   rest of at most 64 rows takes a 64-query block, and only the last key
//   tile pays for the key mask. That last tile still computes all of its
//   key fragments: skipping the 16-key fragments past S was tried and
//   dropped, because it measured 5% slower on an H100 (700 W) at
//   (70, 577, 3072), 0.4938 ms against 0.4690, and 4% slower with a bias at
//   (70, 433, 3072), 0.3118 against 0.3001: the branches cut the unrolled
//   tile into blocks across which ldmatrix and mma no longer overlap.
// - fp32 (parity mode): plain fp32 FMAs (no TF32, no tensor cores), register
//   tiled as an SGEMM is: see the fp32 section.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // queries per block (fp32; the bf16 body's blocks hold 64 or 128)
constexpr int BK = 64;    // keys per tile (bf16)
constexpr int BK32 = 64;  // keys per tile (fp32)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// Where one call's tensors live: element pointers at (batch 0, head 0, row 0)
// and element strides. q, k and v share their strides (true of both the
// packed and the (B, H, S, hd) layouts).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  const float* bias;  // (B, S) fp32, read only where the kernel has a bias
  long long in_b, in_h, in_r;
  long long out_b, out_h, out_r;
  int S;
  float scale;
};

// the max to subtract before exp: 0 while the running max is still -inf
__device__ __forceinline__ float finite_or_zero(float m) { return m == -INFINITY ? 0.f : m; }

// ---------------------------------------------------------------------------
// cp.async tile loads, shared by both bodies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes (rows past the sequence end)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0+ROWS) of one head's q, k or v -> shared memory, zero past S;
// rows padded by one 16-byte chunk
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, int row0,
                                                int S, long long row_stride) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int LD = HD + EPC;
  constexpr int CPR = HD / EPC;  // chunks per row
  const int c = (threadIdx.x % CPR) * EPC;
#pragma unroll
  for (int r = threadIdx.x / CPR; r < ROWS; r += NTHREADS / CPR) {
    const bool valid = row0 + r < S;
    cp_async16(dst + r * LD + c, src + (valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, register-resident scores and output

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 2^-inf = +0
__device__ __forceinline__ float fast_exp2(float x) {
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

// MT: 16-row m-tiles per warp, so a block holds 64 * MT queries
template <int HD, bool BIAS, int MT>
struct Bf16Geometry {
  static constexpr int ROWS = 64 * MT;
  static constexpr int LD = HD + 8;  // padded rows: conflict-free ldmatrix
  static constexpr size_t kTiles =
      sizeof(bf16) * (size_t)(ROWS + 4 * BK) * LD;  // Q, two stages of (K, V)
  static constexpr size_t kBytes = kTiles + (BIAS ? sizeof(float) * 2 * BK : 0);
};

// the bias of keys [k0, k0+64) -> shared memory (zero past S; masked anyway)
__device__ __forceinline__ void load_bias_async(float* dst, const float* __restrict__ row,
                                                int k0, int S) {
  if (threadIdx.x < BK) {
    const bool valid = k0 + (int)threadIdx.x < S;
    cp_async4(dst + threadIdx.x, row + (valid ? k0 + threadIdx.x : 0), valid);
  }
}

// One 64-key tile for one warp: S = Q K^T, the online softmax, O += P V.
// TAIL: the tile holds only `kv` < 64 valid keys, so the mask applies; V rows
// past S are zero in shared memory, so their zero probabilities add zeros.
template <int HD, bool BIAS, int MT, bool TAIL>
__device__ __forceinline__ void attend_tile(const bf16* Kt, const bf16* Vt, const float* Bt,
                                            int kv, float scale, int lane,
                                            const uint32_t (&qa)[MT][HD / 16][4],
                                            float (&o)[MT][HD / 8][4], float (&m)[MT][2],
                                            float (&l)[MT][2]) {
  constexpr int LD = HD + 8;
  const int tig = lane & 3;  // fragment column pair
  // The softmax runs in base 2: exp(x - max) = 2^(x * c2 - max * c2), one FMA
  // per score. Without a bias x is the raw score and c2 folds the scale in;
  // with one, x = scale * score + bias comes first and c2 is log2(e).
  const float c2 = BIAS ? LOG2E : scale * LOG2E;

  // raw scores of this warp's 16 * MT rows x 64 keys (8 n-tiles of 8 keys);
  // each K fragment read serves every m-tile
  float s[MT][BK / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int jn = 0; jn < BK / 16; ++jn) {
      uint32_t kfrag[4];
      ldmatrix_x4(kfrag, Kt + (16 * jn + (lane & 7) + (lane >> 4) * 8) * LD + 16 * kk +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jn], qa[mt][kk], kfrag[0], kfrag[1]);
        mma_bf16(s[mt][2 * jn + 1], qa[mt][kk], kfrag[2], kfrag[3]);
      }
    }
  }

  // online softmax in base 2, one m-tile after the other; P in bf16,
  // re-packed from the score fragments into A fragments of P.V
  uint32_t pa[MT][BK / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx_lo = -INFINITY, mx_hi = -INFINITY;  // rows g and g + 8
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float2 kb;  // the biases of this thread's two keys of the fragment
      if (BIAS) kb = *reinterpret_cast<const float2*>(Bt + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (BIAS) {
          const float b = e ? kb.y : kb.x;
          s[mt][j][e] = fmaf(s[mt][j][e], scale, b);
          s[mt][j][2 + e] = fmaf(s[mt][j][2 + e], scale, b);
        }
        if (TAIL && 8 * j + 2 * tig + e >= kv) s[mt][j][e] = s[mt][j][2 + e] = -INFINITY;
        mx_lo = fmaxf(mx_lo, s[mt][j][e]);
        mx_hi = fmaxf(mx_hi, s[mt][j][2 + e]);
      }
    }
    // the running max in base-2 units (c2 > 0, so the max commutes with it)
    const float m_lo = fmaxf(m[mt][0], quad_max(mx_lo) * c2);
    const float m_hi = fmaxf(m[mt][1], quad_max(mx_hi) * c2);
    const float sub_lo = finite_or_zero(m_lo), sub_hi = finite_or_zero(m_hi);
    const float alpha_lo = fast_exp2(m[mt][0] - sub_lo);  // 0 while nothing was finite before
    const float alpha_hi = fast_exp2(m[mt][1] - sub_hi);
    m[mt][0] = m_lo;
    m[mt][1] = m_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sub = e < 2 ? sub_lo : sub_hi;
        p[e] = fast_exp2(fmaf(s[mt][j][e], c2, -sub));
      }
      const uint32_t lo = pack_bf16(p[0], p[1]);
      const uint32_t hi = pack_bf16(p[2], p[3]);
      sum_lo += p[0] + p[1];  // the fp32 values, not the rounded ones
      sum_hi += p[2] + p[3];
      pa[mt][j >> 1][(j & 1) * 2] = lo;
      pa[mt][j >> 1][(j & 1) * 2 + 1] = hi;
    }
    l[mt][0] = l[mt][0] * alpha_lo + sum_lo;
    l[mt][1] = l[mt][1] * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[mt][n][0] *= alpha_lo;
      o[mt][n][1] *= alpha_lo;
      o[mt][n][2] *= alpha_hi;
      o[mt][n][3] *= alpha_hi;
    }
  }

  // O += P V (V read transposed by ldmatrix); each V fragment read serves every m-tile
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t vfrag[4];
      ldmatrix_x4_trans(vfrag, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   16 * nn + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * nn], pa[mt][kk], vfrag[0], vfrag[1]);
        mma_bf16(o[mt][2 * nn + 1], pa[mt][kk], vfrag[2], vfrag[3]);
      }
    }
  }
}

// One block: queries [q0, q0 + 64 * MT) of head blockIdx.y of item blockIdx.z.
template <int HD, bool BIAS, int MT>
__device__ __forceinline__ void attention_bf16_block(const Args<bf16>& a, int q0,
                                                     unsigned char* smem) {
  using G = Bf16Geometry<HD, BIAS, MT>;
  constexpr int LD = G::LD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + G::ROWS * LD;  // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  float* Bs = reinterpret_cast<float*>(smem + G::kTiles);  // [2][BK], with a bias only

  const int S = a.S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = q0 + warp * 16 * MT;  // this warp's first query row
  const long long in_off = b * a.in_b + h * a.in_h;
  const bf16* qb = a.q + in_off;
  const bf16* kb_ = a.k + in_off;
  const bf16* vb_ = a.v + in_off;
  const float* brow = BIAS ? a.bias + (long long)b * S : nullptr;
  const int n_tiles = (S + BK - 1) / BK;
  // a warp whose rows all lie past S takes part in the loads and barriers only
  const bool active = wrow0 < S;

  load_tile_async<bf16, HD, G::ROWS>(Qs, qb, q0, S, a.in_r);
  load_tile_async<bf16, HD, BK>(Ks, kb_, 0, S, a.in_r);
  load_tile_async<bf16, HD, BK>(Vs, vb_, 0, S, a.in_r);
  if (BIAS) load_bias_async(Bs, brow, 0, S);
  cp_async_commit();

  uint32_t qa[MT][HD / 16][4];
  float o[MT][HD / 8][4];
  float m[MT][2], l[MT][2];  // running max of rows g and g + 8; this thread's share of the sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread; and tile t - 1 is consumed
    if (t + 1 < n_tiles) {  // refill the stage of tile t - 1 with tile t + 1
      const int st = (t + 1) & 1;
      load_tile_async<bf16, HD, BK>(Ks + st * BK * LD, kb_, (t + 1) * BK, S, a.in_r);
      load_tile_async<bf16, HD, BK>(Vs + st * BK * LD, vb_, (t + 1) * BK, S, a.in_r);
      if (BIAS) load_bias_async(Bs + st * BK, brow, (t + 1) * BK, S);
    }
    cp_async_commit();

    if (active) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldmatrix_x4(qa[mt][kk], Qs + ((warp * MT + mt) * 16 + (lane & 15)) * LD + 16 * kk +
                                        (lane >> 4) * 8);
      }
      const int stage = t & 1;
      const bf16* Kt = Ks + stage * BK * LD;
      const bf16* Vt = Vs + stage * BK * LD;
      const float* Bt = Bs + stage * BK;
      const int kv = S - t * BK;  // valid keys from this tile on
      if (kv >= BK)
        attend_tile<HD, BIAS, MT, false>(Kt, Vt, Bt, BK, a.scale, lane, qa, o, m, l);
      else
        attend_tile<HD, BIAS, MT, true>(Kt, Vt, Bt, kv, a.scale, lane, qa, o, m, l);
    }
  }
  if (!active) return;

  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  bf16* dst = a.o + b * a.out_b + h * a.out_h + 2 * tig;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // full row sums across the quad that shares each row
    const float l_lo = quad_sum(l[mt][0]), l_hi = quad_sum(l[mt][1]);
    const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;  // no finite score: zeros
    const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
    const int row_lo = wrow0 + 16 * mt + g;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (row_lo < S)
        *reinterpret_cast<uint32_t*>(dst + row_lo * a.out_r + 8 * n) =
            pack_bf16(o[mt][n][0] * inv_lo, o[mt][n][1] * inv_lo);
      if (row_hi < S)
        *reinterpret_cast<uint32_t*>(dst + row_hi * a.out_r + 8 * n) =
            pack_bf16(o[mt][n][2] * inv_hi, o[mt][n][3] * inv_hi);
    }
  }
}

// Whether the last block of a grid of 128-query blocks is a 64-query one: a
// ragged rest of at most 64 rows (433 = 3 * 128 + 49, 289 = 2 * 128 + 33)
// then costs half a block's time; a longer rest (577 = 4 * 128 + 65) stays
// one 128-query block.
__host__ __device__ constexpr bool narrow_last_block(int S) {
  return S % 128 > 0 && S % 128 <= 64;
}

template <int HD, bool BIAS, int MT>
__global__ void __launch_bounds__(NTHREADS, MT == 2 ? 2 : 1)
    attention_bf16_kernel(const Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (MT == 2 && narrow_last_block(a.S) && blockIdx.x == gridDim.x - 1)
    attention_bf16_block<HD, BIAS, 1>(a, blockIdx.x * 128, smem);
  else
    attention_bf16_block<HD, BIAS, MT>(a, blockIdx.x * 64 * MT, smem);
}

// ---------------------------------------------------------------------------
// fp32 (parity mode): register-tiled FMAs, full fp32 (no TF32, no tensor cores)
//
// One block owns 64 queries and walks the 64-key tiles of a cp.async ring.
// The 128 threads tile the 64 x 64 scores 16 x 8: thread (ty, tx) owns rows
// 16 * warp + ty % 4 + 4 * i (i < 4) and keys tx + 8 * j (j < 8), so a warp
// owns 16 contiguous rows and the 8 lanes that share a row are neighbours.
// Q, K and V rows are padded to HD + 4 floats: the float4 reads of 8
// consecutive rows at one d hit distinct banks. Per 4 steps of d a thread
// makes 12 float4 loads for 128 FMAs; an FMA that reads both operands from
// shared memory needs 2 loads, and an SM serves one warp-wide load per clock.
// P goes to shared memory once per tile (its rows are written and read by
// the same warp, so a __syncwarp orders them); O stays in registers for the
// whole key loop, each thread owning its 4 rows x HD / 8 columns.

template <int HD>
struct Fp32Geometry {
  static constexpr int LD = HD + 4;     // Q, K, V rows
  static constexpr int LDP = BK32 + 8;  // probabilities
  static constexpr int VW = HD >= 32 ? 4 : 2;  // floats per V load; a thread's columns are
  static constexpr int NV = HD / 8 / VW;       // VW * tx + 8 * VW * c .. + VW, c < NV
  static constexpr size_t kQ = sizeof(float) * BQ * LD;
  static constexpr size_t kKV = sizeof(float) * 2 * BK32 * LD;  // two stages
  static constexpr size_t kBytes = kQ + 2 * kKV + sizeof(float) * BQ * LDP;
};

template <int HD, bool BIAS>
__global__ void __launch_bounds__(NTHREADS, 2) attention_fp32_kernel(const Args<float> a) {
  using G = Fp32Geometry<HD>;
  constexpr int LD = G::LD, LDP = G::LDP, VW = G::VW, NV = G::NV;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;         // [2][BK32][LD]
  float* Vs = Ks + 2 * BK32 * LD;   // [2][BK32][LD]
  float* Ps = Vs + 2 * BK32 * LD;   // [BQ][LDP]

  const int S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int tx = threadIdx.x % 8;         // key group: keys tx + 8 * j
  const int row0 = 16 * warp + (threadIdx.x / 8) % 4;  // rows row0 + 4 * i
  const long long in_off = b * a.in_b + h * a.in_h;
  const float* kb_ = a.k + in_off;
  const float* vb_ = a.v + in_off;
  const float* brow = BIAS ? a.bias + (long long)b * S : nullptr;
  const int n_tiles = (S + BK32 - 1) / BK32;
  // a warp whose rows all lie past S takes part in the loads and barriers only
  const bool active = q0 + 16 * warp < S;

  load_tile_async<float, HD, BQ>(Qs, a.q + in_off, q0, S, a.in_r);
  load_tile_async<float, HD, BK32>(Ks, kb_, 0, S, a.in_r);
  load_tile_async<float, HD, BK32>(Vs, vb_, 0, S, a.in_r);
  cp_async_commit();

  float o[4][NV][VW];
  float m_run[4], l_run[4];  // running max; this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e) o[i][c][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread; and tile t - 1 is consumed
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile_async<float, HD, BK32>(Ks + st * BK32 * LD, kb_, (t + 1) * BK32, S, a.in_r);
      load_tile_async<float, HD, BK32>(Vs + st * BK32 * LD, vb_, (t + 1) * BK32, S, a.in_r);
    }
    cp_async_commit();
    if (!active) continue;

    const float* Kt = Ks + (t & 1) * BK32 * LD;
    const float* Vt = Vs + (t & 1) * BK32 * LD;
    const int k0 = t * BK32;
    const int kv = min(BK32, S - k0);  // valid keys of this tile
    float kbias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      kbias[j] = BIAS && tx + 8 * j < kv ? __ldg(brow + k0 + tx + 8 * j) : 0.f;

    // S = Q K^T: 4 rows x 8 keys per thread, 4 steps of d per round of loads
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = *reinterpret_cast<const float4*>(Qs + (row0 + 4 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 k = *reinterpret_cast<const float4*>(Kt + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(q[i].x, k.x, s[i][j]);
          s[i][j] = fmaf(q[i].y, k.y, s[i][j]);
          s[i][j] = fmaf(q[i].z, k.z, s[i][j]);
          s[i][j] = fmaf(q[i].w, k.w, s[i][j]);
        }
      }
    }

    // online softmax per row, reduced over the 8 lanes that share it; P -> shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = tx + 8 * j < kv ? s[i][j] * a.scale + kbias[j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float sub = finite_or_zero(m_new);
      const float alpha = expf(m_run[i] - sub);  // 0 while nothing was finite before
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - sub);
        sum += p;
        Ps[(row0 + 4 * i) * LDP + tx + 8 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int e = 0; e < VW; ++e) o[i][c][e] *= alpha;
    }
    __syncwarp();

    // O += P V: 4 rows x HD / 8 columns per thread, 4 keys per round of P loads; keys past
    // kv have zero probability and (past S) zero-filled V rows
    for (int k4 = 0; k4 < kv; k4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t4 = *reinterpret_cast<const float4*>(Ps + (row0 + 4 * i) * LDP + k4);
        p[i][0] = t4.x;
        p[i][1] = t4.y;
        p[i][2] = t4.z;
        p[i][3] = t4.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float v[VW];
          const float* vp = Vt + (k4 + kk) * LD + VW * tx + 8 * VW * c;
          if constexpr (VW == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vp);
            v[0] = t4.x;
            v[1] = t4.y;
            v[2] = t4.z;
            v[3] = t4.w;
          } else {
            const float2 t2 = *reinterpret_cast<const float2*>(vp);
            v[0] = t2.x;
            v[1] = t2.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VW; ++e) o[i][c][e] = fmaf(p[i][kk], v[e], o[i][c][e]);
        }
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + row0 + 4 * i;
    if (row >= S) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no finite score: zeros
    float* dst = a.o + b * a.out_b + h * a.out_h + row * a.out_r + VW * tx;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(dst + 8 * VW * c) =
            make_float4(o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv, o[i][c][3] * inv);
      else
        *reinterpret_cast<float2*>(dst + 8 * VW * c) =
            make_float2(o[i][c][0] * inv, o[i][c][1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------

// The tensors of one call, as untyped pointers and element strides.
struct Layout {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;
  long long in_b, in_h, in_r, out_b, out_h, out_r;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int rows, const Layout& L, int B, int S, int H,
                   float scale, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const Args<T> a{static_cast<const T*>(L.q), static_cast<const T*>(L.k),
                  static_cast<const T*>(L.v), static_cast<T*>(L.o), L.bias, L.in_b, L.in_h,
                  L.in_r, L.out_b, L.out_h, L.out_r, S, scale};
  const dim3 grid((S + rows - 1) / rows, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Whether a bf16 hd = 64 call takes 128-query blocks (32 rows per warp): only
// if they fill every SM's two block slots; a smaller grid spreads wider over
// the card in 64-query blocks. A function of the shape alone, never of the layout.
bool wide_blocks(int B, int S, int H, int sm_count) {
  return (long long)B * H * ((S + 127) / 128) >= 2LL * sm_count;
}

template <int HD, bool BIAS>
cudaError_t launch_hd(bool is_bf16, const Layout& L, int B, int S, int H, float scale,
                      int sm_count, cudaStream_t stream) {
  if (!is_bf16)
    return launch<float>(attention_fp32_kernel<HD, BIAS>, Fp32Geometry<HD>::kBytes, BQ, L, B, S,
                         H, scale, stream);
  if constexpr (HD == 64) {
    if (wide_blocks(B, S, H, sm_count))
      return launch<bf16>(attention_bf16_kernel<HD, BIAS, 2>, Bf16Geometry<HD, BIAS, 2>::kBytes,
                          128, L, B, S, H, scale, stream);
  }
  return launch<bf16>(attention_bf16_kernel<HD, BIAS, 1>, Bf16Geometry<HD, BIAS, 1>::kBytes, 64,
                      L, B, S, H, scale, stream);
}

template <bool BIAS>
int dispatch(const Layout& L, int B, int S, int H, int hd, int is_bf16, float scale,
             int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int sms = 0;  // asked per launch: the runtime answers from its cache, and no state is kept here
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: e = launch_hd<16, BIAS>(is_bf16, L, B, S, H, scale, sms, st); break;
    case 32: e = launch_hd<32, BIAS>(is_bf16, L, B, S, H, scale, sms, st); break;
    case 64: e = launch_hd<64, BIAS>(is_bf16, L, B, S, H, scale, sms, st); break;
    case 128: e = launch_hd<128, BIAS>(is_bf16, L, B, S, H, scale, sms, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// packed head-contiguous qkv (B, S, 3*H*hd) -> out (B, S, H*hd)
Layout packed_layout(const void* qkv, const float* bias, void* out, int S, int H, int hd,
                     int is_bf16) {
  const size_t es = is_bf16 ? sizeof(bf16) : sizeof(float);
  const long long D = (long long)H * hd;
  const char* base = static_cast<const char*>(qkv);
  return Layout{base, base + hd * es, base + 2 * hd * es, out, bias,
                S * 3 * D, 3LL * hd, 3 * D, S * D, hd, D};
}

}  // namespace

// K1. qkv: (B, S, 3*H*hd) contiguous, 16-byte aligned; out: (B, S, H*hd).
// is_bf16 selects bf16 (1) or fp32 (0). Returns a cudaError_t code.
extern "C" int attention_packed_forward(const void* qkv, void* out, int B, int S, int H,
                                        int hd, int is_bf16, float scale, int device,
                                        void* stream) {
  return dispatch<false>(packed_layout(qkv, nullptr, out, S, H, hd, is_bf16), B, S, H, hd,
                         is_bf16, scale, device, stream);
}

// K3. As K1, plus bias: (B, S) fp32 contiguous, added to the scaled scores per key.
extern "C" int attention_packed_bias_forward(const void* qkv, const void* bias, void* out,
                                             int B, int S, int H, int hd, int is_bf16,
                                             float scale, int device, void* stream) {
  return dispatch<true>(
      packed_layout(qkv, static_cast<const float*>(bias), out, S, H, hd, is_bf16), B, S, H,
      hd, is_bf16, scale, device, stream);
}

// K4. q, k, v, out: (B, H, S, hd) contiguous, 16-byte aligned, one dtype.
extern "C" int attention_bhsd_forward(const void* q, const void* k, const void* v, void* out,
                                      int B, int S, int H, int hd, int is_bf16, float scale,
                                      int device, void* stream) {
  const long long hs = (long long)S * hd;
  const Layout L{q, k, v, out, nullptr, H * hs, hs, hd, H * hs, hs, hd};
  return dispatch<false>(L, B, S, H, hd, is_bf16, scale, device, stream);
}
