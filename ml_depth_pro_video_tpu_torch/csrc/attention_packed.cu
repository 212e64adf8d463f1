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
// Design: one block per (64-query tile, head, batch item), 4 warps, each
// warp owning 16 query rows; the block loops over 64-key tiles with an
// fp32 online softmax, so any S works and no score leaves the SM. Ragged
// query and key tiles are zero-filled on load and masked in the softmax.
// The running max is guarded so that a key tile (or a whole row) whose
// scores are all -inf -- a -inf bias -- gives 0, not exp(-inf - -inf) = NaN;
// a row with no finite score at all writes zeros.
// - bf16 (the production path): FlashAttention-2 style on the tensor cores.
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the scores, the
//   probabilities and the output accumulator kept in registers (the score
//   accumulator fragment is re-packed as the A operand of P.V); K, V (and
//   the bias slice) tiles are double-buffered in shared memory with
//   cp.async and read with ldmatrix (V transposed on the fly).
// - fp32 (parity mode): the same tiling with plain fp32 FMAs in shared
//   memory, so it keeps full fp32 accuracy (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the max to subtract before exp: 0 while the running max is still -inf
__device__ __forceinline__ float finite_or_zero(float m) { return m == -INFINITY ? 0.f : m; }

// ---------------------------------------------------------------------------
// bf16: tensor cores, register-resident scores and output

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

template <int HD, bool BIAS>
struct Bf16Geometry {
  static constexpr int LD = HD + 8;  // padded rows: conflict-free ldmatrix
  static constexpr size_t kTiles = sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD;  // Q, 2x(K, V)
  static constexpr size_t kBytes = kTiles + (BIAS ? sizeof(float) * 2 * BK : 0);
};

// rows [row0, row0+64) of one head's q, k or v -> shared memory
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int S, long long row_stride) {
  constexpr int LD = Bf16Geometry<HD, false>::LD;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = row0 + r < S;
    cp_async16(dst + r * LD + c, src + (valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// the bias of keys [k0, k0+64) -> shared memory (zero past S; masked anyway)
__device__ __forceinline__ void load_bias_async(float* dst, const float* __restrict__ row,
                                                int k0, int S) {
  if (threadIdx.x < BK) {
    const bool valid = k0 + (int)threadIdx.x < S;
    cp_async4(dst + threadIdx.x, row + (valid ? k0 + threadIdx.x : 0), valid);
  }
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(NTHREADS) attention_bf16_kernel(const Args<bf16> a) {
  using G = Bf16Geometry<HD, BIAS>;
  constexpr int LD = G::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]
  float* Bs = reinterpret_cast<float*>(smem + G::kTiles);  // [2][BK], with a bias only

  const int S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const long long in_off = b * a.in_b + h * a.in_h;
  const bf16* qb = a.q + in_off;
  const bf16* kb_ = a.k + in_off;
  const bf16* vb_ = a.v + in_off;
  const float* brow = BIAS ? a.bias + (long long)b * S : nullptr;
  const float sl2 = a.scale * LOG2E;  // softmax in base 2

  load_tile_async<HD>(Qs, qb, q0, S, a.in_r);
  load_tile_async<HD>(Ks, kb_, 0, S, a.in_r);
  load_tile_async<HD>(Vs, vb_, 0, S, a.in_r);
  if (BIAS) load_bias_async(Bs, brow, 0, S);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums

  const int n_tiles = (S + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next K/V (and bias) tile into the other stage
      load_tile_async<HD>(Ks + (stage ^ 1) * BK * LD, kb_, (t + 1) * BK, S, a.in_r);
      load_tile_async<HD>(Vs + (stage ^ 1) * BK * LD, vb_, (t + 1) * BK, S, a.in_r);
      if (BIAS) load_bias_async(Bs + (stage ^ 1) * BK, brow, (t + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;
    const float* Bt = Bs + stage * BK;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < BK / 16; ++jn) {
        uint32_t kfrag[4];
        ldmatrix_x4(kfrag, Kt + (16 * jn + (lane & 7) + (lane >> 4) * 8) * LD + 16 * kk +
                               ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jn], qa[kk], kfrag[0], kfrag[1]);
        mma_bf16(s[2 * jn + 1], qa[kk], kfrag[2], kfrag[3]);
      }
    }

    // online softmax (base 2): scale, add the key's bias, mask keys >= S
    const int k0 = t * BK;
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tig + e;
        const bool ok = k0 + col < S;
        const float kbias = BIAS ? Bt[col] * LOG2E : 0.f;
        s[j][e] = ok ? fmaf(s[j][e], sl2, kbias) : -INFINITY;
        s[j][2 + e] = ok ? fmaf(s[j][2 + e], sl2, kbias) : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float sub_lo = finite_or_zero(mx_lo), sub_hi = finite_or_zero(mx_hi);
    const float alpha_lo = exp2f(m_lo - sub_lo);  // 0 while nothing was finite before
    const float alpha_hi = exp2f(m_hi - sub_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // P in bf16, re-packed from the score fragments into A fragments of P.V;
    // the row sums add the rounded values that P.V actually uses
    uint32_t pa[BK / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t lo = pack_bf16(exp2f(s[j][0] - sub_lo), exp2f(s[j][1] - sub_lo));
      const uint32_t hi = pack_bf16(exp2f(s[j][2] - sub_hi), exp2f(s[j][3] - sub_hi));
      const float2 flo = unpack_bf16(lo), fhi = unpack_bf16(hi);
      sum_lo += flo.x + flo.y;
      sum_hi += fhi.x + fhi.y;
      pa[j >> 1][(j & 1) * 2] = lo;
      pa[j >> 1][(j & 1) * 2 + 1] = hi;
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha_lo;
      o[n][1] *= alpha_lo;
      o[n][2] *= alpha_hi;
      o[n][3] *= alpha_hi;
    }

    // O += P V (V read transposed by ldmatrix)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t vfrag[4];
        ldmatrix_x4_trans(vfrag, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     16 * nn + (lane >> 4) * 8);
        mma_bf16(o[2 * nn], pa[kk], vfrag[0], vfrag[1]);
        mma_bf16(o[2 * nn + 1], pa[kk], vfrag[2], vfrag[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // full row sums across the quad that shares each row
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;  // no finite score: zeros
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  bf16* dst = a.o + b * a.out_b + h * a.out_h + 2 * tig;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (row_lo < S)
      *reinterpret_cast<uint32_t*>(dst + row_lo * a.out_r + 8 * n) =
          pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<uint32_t*>(dst + row_hi * a.out_r + 8 * n) =
          pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}

// ---------------------------------------------------------------------------
// fp32 (parity mode): plain FMAs through shared memory

template <int HD>
struct Fp32Geometry {
  static constexpr int LD = HD + 1;   // Q, K, V rows: conflict-free column reads
  static constexpr int LDS = BK + 4;  // scores / probabilities
  static constexpr int LDO = HD + 4;  // output accumulator
  static constexpr size_t kK = align128(sizeof(float) * BQ * LD);
  static constexpr size_t kV = kK + align128(sizeof(float) * BK * LD);
  static constexpr size_t kS = kV + align128(sizeof(float) * BK * LD);
  static constexpr size_t kO = kS + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kBytes = kO + align128(sizeof(float) * BQ * LDO);
};

// rows [row0, row0+64) of one head's q, k or v, zero past S
template <int HD>
__device__ __forceinline__ void load_tile_fp32(float* dst, const float* __restrict__ src,
                                               int row0, int S, long long row_stride) {
  constexpr int LD = Fp32Geometry<HD>::LD;
  constexpr int CPR = HD / 4;
  for (int i = threadIdx.x; i < 64 * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    float* d = dst + r * LD + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(NTHREADS) attention_fp32_kernel(const Args<float> a) {
  using G = Fp32Geometry<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + G::kK);
  float* Vs = reinterpret_cast<float*>(smem + G::kV);
  float* Ss = reinterpret_cast<float*>(smem + G::kS);
  float* Os = reinterpret_cast<float*>(smem + G::kO);

  const int S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long in_off = b * a.in_b + h * a.in_h;
  const float* brow = BIAS ? a.bias + (long long)b * S : nullptr;

  load_tile_fp32<HD>(Qs, a.q + in_off, q0, S, a.in_r);
  for (int i = threadIdx.x; i < BQ * G::LDO; i += NTHREADS) Os[i] = 0.f;

  // running softmax max and sum of this warp's 16 rows (same in every lane)
  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  const int row0 = warp * 16;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's K/V fully consumed
    load_tile_fp32<HD>(Ks, a.k + in_off, k0, S, a.in_r);
    load_tile_fp32<HD>(Vs, a.v + in_off, k0, S, a.in_r);
    __syncthreads();

    for (int r = row0; r < row0 + 16; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) acc = fmaf(Qs[r * G::LD + d], Ks[c * G::LD + d], acc);
        Ss[r * G::LDS + c] = acc;
      }
    }
    __syncwarp();
    const bool ok0 = k0 + lane < S, ok1 = k0 + lane + 32 < S;
    const float bias0 = BIAS && ok0 ? __ldg(brow + k0 + lane) : 0.f;
    const float bias1 = BIAS && ok1 ? __ldg(brow + k0 + lane + 32) : 0.f;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float s0 = ok0 ? Ss[r * G::LDS + lane] * a.scale + bias0 : -INFINITY;
      const float s1 = ok1 ? Ss[r * G::LDS + lane + 32] * a.scale + bias1 : -INFINITY;
      const float m_new = fmaxf(m_run[rr], warp_max(fmaxf(s0, s1)));
      const float sub = finite_or_zero(m_new);
      const float alpha = expf(m_run[rr] - sub);  // 0 while nothing was finite before
      const float p0 = expf(s0 - sub);
      const float p1 = expf(s1 - sub);
      m_run[rr] = m_new;
      l_run[rr] = l_run[rr] * alpha + warp_sum(p0 + p1);
      Ss[r * G::LDS + lane] = p0;
      Ss[r * G::LDS + lane + 32] = p1;
      for (int c = lane; c < HD; c += 32) Os[r * G::LDO + c] *= alpha;
    }
    __syncwarp();
    for (int r = row0; r < row0 + 16; ++r) {
      for (int c = lane; c < HD; c += 32) {
        float acc = Os[r * G::LDO + c];
#pragma unroll 16
        for (int k = 0; k < BK; ++k) acc = fmaf(Ss[r * G::LDS + k], Vs[k * G::LD + c], acc);
        Os[r * G::LDO + c] = acc;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int q = q0 + row0 + rr;
    if (q >= S) continue;
    const float inv = l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f;  // no finite score: zeros
    float* dst = a.o + b * a.out_b + h * a.out_h + q * a.out_r;
    for (int c = lane; c < HD; c += 32) dst[c] = Os[(row0 + rr) * G::LDO + c] * inv;
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
cudaError_t launch(Kernel kernel, size_t smem, const Layout& L, int B, int S, int H,
                   float scale, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const Args<T> a{static_cast<const T*>(L.q), static_cast<const T*>(L.k),
                  static_cast<const T*>(L.v), static_cast<T*>(L.o), L.bias, L.in_b, L.in_h,
                  L.in_r, L.out_b, L.out_h, L.out_r, S, scale};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, bool BIAS>
cudaError_t launch_hd(bool is_bf16, const Layout& L, int B, int S, int H, float scale,
                      cudaStream_t stream) {
  if (is_bf16)
    return launch<bf16>(attention_bf16_kernel<HD, BIAS>, Bf16Geometry<HD, BIAS>::kBytes, L, B,
                        S, H, scale, stream);
  return launch<float>(attention_fp32_kernel<HD, BIAS>, Fp32Geometry<HD>::kBytes, L, B, S, H,
                       scale, stream);
}

template <bool BIAS>
int dispatch(const Layout& L, int B, int S, int H, int hd, int is_bf16, float scale,
             int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: e = launch_hd<16, BIAS>(is_bf16, L, B, S, H, scale, st); break;
    case 32: e = launch_hd<32, BIAS>(is_bf16, L, B, S, H, scale, st); break;
    case 64: e = launch_hd<64, BIAS>(is_bf16, L, B, S, H, scale, st); break;
    case 128: e = launch_hd<128, BIAS>(is_bf16, L, B, S, H, scale, st); break;
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
