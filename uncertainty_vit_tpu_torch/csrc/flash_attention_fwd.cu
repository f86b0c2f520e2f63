// Fused multi-head attention forward over packed qkv, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (uncertainty_vit_tpu/ops/
// flash_attention.py:188-241), reached through `_fwd_impl` (:441-506) from
// `fused_qkv_attention` (:1369). Per (image, head):
//   s   = scale * q k^T (f32 accumulation) + bias[h]
//   e   = exp(s - rowmax)            exact mode
//       = exp(s)                     bounded mode (BOUNDED_SCORES, :74-78)
//   e   = e * keep * 1/(1 - rate)    with dropout (`_dropout_mask`, :156-162,
//                                    applied at :233-234), after the row sum
//   out = (e @ v) * (1 / rowsum(e))  stored in the head's columns of [B, N, C]
//   lse = log rowsum(exp(s))         optional, f32 [B, H, N]: of the
//                                    undropped softmax
// with an optional q/v bias added to the q and v slabs in the input dtype
// (`_qv_biased`, :182-185). e is rounded to the input dtype before the
// product with v, as the TPU kernel does.
//
// What bounds it on an H100: at ViT-B/16 224 (B=128, N=197, H=12, D=64) one
// call does 4*B*H*N^2*D = 15.3 GFLOP and must move at least the qkv input
// (116 MB bf16) and the output (39 MB): ~47 us of HBM traffic at 3.35 TB/s
// against ~15 us of bf16 tensor-core work and ~60M exponentials, so the
// floor is memory. The unfused version also writes and rereads the
// [B, H, N, N] f32 scores and probabilities (238 MB each), which is what
// this kernel removes.
//
// Design (the TPU's head-group and batch-block budgeting has no meaning
// here): one block of 4 warps per (64-row q tile, head, image), each warp
// owning 16 q rows; k/v stream through shared memory in 64-row tiles with
// an online softmax (running row max and sum in f32), so no score leaves
// the SM and each image's k/v is read from HBM once and from L2 by the
// other q tiles. N need not be a tile multiple: tail k/v rows are
// zero-filled and their columns get e = 0 (the -inf of the max-subtracted
// form); tail q rows are computed and never stored.
//   bf16: tensor cores through mma.sync m16n8k16 fed by ldmatrix. The q
//     fragments, the scores and the output accumulator stay in registers:
//     the C fragment of q k^T is, packed to bf16, the A fragment of e v.
//     k/v tiles are double-buffered with cp.async so the next tile loads
//     while this one is multiplied. Rows of 144 B keep ldmatrix free of
//     bank conflicts.
//   f32: plain FMA loops over shared-memory tiles, so that f32 stays f32
//     (no TF32); scores and the output go through per-warp f32 tiles.
// Dropout: the TPU seeds its generator per program (:202), so its mask
// follows its batch block and head group, and its backward must tile alike
// (:426-438). Here the keep bit of entry (image, head, row, column) is a
// function of the seed and that position alone (csrc/philox.cuh), so this
// kernel's k/v tiling, the backward's two phases and the plain PyTorch
// version all draw one mask. Each tile's e is multiplied by the scaled keep
// mask after it has entered the running row sum, never before. In bf16 a
// thread and its neighbour four lanes on share two 2 x 2 blocks of the mask,
// compute one each and exchange halves: one Philox call per four entries.
// At B=1024 that is still 119M calls, ~6 G integer operations beside
// 0.12 TFLOP of tensor-core work, so dropout is bounded by the integer
// pipes, not by memory. The dropout path is a separate instantiation
// (kDrop): with rate 0 the kernel is the same code as without the feature.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head dim (ViT-B and ViT-L)
constexpr int kTile = 64;     // q rows per block and k/v rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;  // q rows per warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Leading dimension (elements) of the shared-memory tiles: bf16 rows of
// 144 B keep 16-byte stores and make the 8 rows an ldmatrix reads fall in
// distinct banks; f32 rows of 65 words keep the FMA loops' column reads
// free of bank conflicts.
template <typename T> struct Ld;
template <> struct Ld<bf16> { static constexpr int v = kD + 8; };
template <> struct Ld<float> { static constexpr int v = kD + 1; };
constexpr int kLdS = kD + 4;  // per-warp f32 score/output tiles (f32 kernel)

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// Adds the section's bias row to 16 bytes of one slab row, in the input
// dtype (`_qv_biased`).
template <typename T>
__device__ __forceinline__ void add_qv_bias(T* e, const float* qvb_row) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = from_f32<T>(to_f32(e[j]) + to_f32(from_f32<T>(qvb_row[j])));
}

// Copy rows [row0, row0 + kTile) of one head's q, k or v slab into shared
// memory with plain loads, zero-filling rows >= n and adding the section's
// bias row when given.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* qkv, const float* qvb_row,
                                          int b, int n, int c3, int col0, int row0) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = kD / kVec;
  constexpr int ld = Ld<T>::v;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int row = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&u);
    if (row < n) {
      u = *reinterpret_cast<const uint4*>(qkv + (size_t(b) * n + row) * c3 + col0 + c);
      if (qvb_row != nullptr) add_qv_bias(e, qvb_row + c);
    }
    T* d = dst + r * ld + c;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(d) = u;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = e[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, register-resident scores and output
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global → shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr size_t kSmemBf16 = size_t(5) * kTile * Ld<bf16>::v * sizeof(bf16);

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_bf16(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ qv_bias, bf16* __restrict__ out,
                   float* __restrict__ lse, int n, int num_heads, float scale, int bounded,
                   const long long* __restrict__ seed, uint32_t threshold, float inv_keep) {
  constexpr int ld = Ld<bf16>::v;
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kTile][ld]
  bf16* ks = qs + kTileElems;                // [2][kTile][ld]
  bf16* vs = ks + 2 * kTileElems;            // [2][kTile][ld]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const int c3 = 3 * c;
  const int hc = h * kD;
  const float* qvb_v = qv_bias ? qv_bias + 2 * c + hc : nullptr;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(seed);
  const uint32_t bh = uint32_t(b) * num_heads + h;

  // k/v tile rows [k0, k0 + kTile) → stage, 8 chunks of 16 B per row
  auto load_kv = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const int row = k0 + r;
      const bool ok = row < n;
      const bf16* src = qkv + (size_t(b) * n + (ok ? row : 0)) * c3 + hc + ch;
      const int off = stage * kTileElems + r * ld + ch;
      cp_async16(smem_u32(ks + off), src + c, ok ? 16 : 0);
      cp_async16(smem_u32(vs + off), src + 2 * c, ok ? 16 : 0);
    }
  };

  load_kv(0, 0);
  cp_async_commit();
  load_tile<bf16>(qs, qkv, qv_bias ? qv_bias + hc : nullptr, b, n, c3, hc, q0);
  __syncthreads();

  // q fragments (A operand) for the 4 k-steps of D = 64
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int row = warp * kRows + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(smem_u32(qs + row * ld + kk * 16 + (lane >> 4) * 8), qf[kk]);
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l_r[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const float sl2 = scale * kLog2e;
  const int rows[2] = {q0 + warp * kRows + g, q0 + warp * kRows + g + 8};
  const float* bias_h = bias ? bias + size_t(h) * n * n : nullptr;
  const int n_tiles = (n + kTile - 1) / kTile;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    const int k0 = j * kTile;
    if (j + 1 < n_tiles) {
      load_kv(stage ^ 1, k0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (qvb_v != nullptr) {  // each thread biases the v chunks it copied
      for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
        const int r = i >> 3, ch = (i & 7) * 8;
        if (k0 + r < n) add_qv_bias(vs + stage * kTileElems + r * ld + ch, qvb_v + ch);
      }
    }
    __syncthreads();
    const bf16* kst = ks + stage * kTileElems;
    const bf16* vst = vs + stage * kTileElems;

    // s = q k^T for this warp's 16 rows × 64 keys: 8 key blocks of 8
    float s[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < kD / 32; ++kp) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(kst + (nb * 8 + (lane & 7)) * ld + kp * 32 + (lane >> 3) * 8), kb);
        mma_bf16(s[nb], qf[2 * kp], kb[0], kb[1]);
        mma_bf16(s[nb], qf[2 * kp + 1], kb[2], kb[3]);
      }
    }

    // scale, bias, mask (log2 units); fragment element (nb, e) is row
    // rows[e >> 1], key k0 + nb*8 + 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        float v = s[nb][e] * sl2;
        if (bias_h != nullptr && key < n && row < n) {
          v = fmaf(bias_h[size_t(row) * n + key], kLog2e, v);
        }
        v = key < n ? v : -INFINITY;
        s[nb][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float sub[2] = {0.0f, 0.0f};
    if (!bounded) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        const float alpha = exp2f(m_r[i] - m_new);  // 0 on the first tile
        m_r[i] = m_new;
        sub[i] = m_new;
        l_r[i] *= alpha;
#pragma unroll
        for (int db = 0; db < kD / 8; ++db) {
          o[db][2 * i] *= alpha;
          o[db][2 * i + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - sub[e >> 1]);  // masked: exp2(-inf) = 0
        s[nb][e] = p;
        l_r[e >> 1] += p;
      }
    }
    if constexpr (kDrop) {  // after the row sum: the lse is the undropped softmax's
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
        uint32_t bits[4];
        philox::fragment_bits<false>(pkey, bh, rows[0], k0 + nb * 8 + 2 * t, bits);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= philox::keep_scale(bits[e], threshold, inv_keep);
      }
    }

    // o += e v: the C fragments of two key blocks are the A fragment of
    // one 16-key step
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_u32(vst + key * ld + dp * 16 + (lane >> 4) * 8), vb);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rows[i];
    if (row >= n) continue;
    const float inv = 1.0f / l;
    bf16* dst = out + (size_t(b) * n + row) * c + hc + 2 * t;
#pragma unroll
    for (int db = 0; db < kD / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[db][2 * i] * inv, o[db][2 * i + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      // log Σ exp(s) = m - log(1 / Σ exp(s - m)); m = 0 when bounded
      lse[(size_t(b) * num_heads + h) * n + row] = (bounded ? 0.0f : m_r[i] * kLn2) - logf(inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA loops, per-warp f32 score and output tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kLdF = Ld<float>::v;
constexpr size_t kSmemF32 =
    size_t(kWarps) * 2 * kRows * kLdS * sizeof(float) +
    size_t(3 * kTile + kWarps * kRows) * kLdF * sizeof(float);

// s[kRows][kTile] = q_w[kRows][kD] . k[kTile][kD]^T for this warp's rows.
__device__ __forceinline__ void warp_qk_f32(float* s, const float* qw, const float* ks) {
  const int lane = threadIdx.x & 31;
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int d = 0; d < kD; ++d) {
    const float k0 = ks[lane * kLdF + d], k1 = ks[(lane + 32) * kLdF + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float q = qw[r * kLdF + d];
      acc[r][0] = fmaf(q, k0, acc[r][0]);
      acc[r][1] = fmaf(q, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    s[r * kLdS + lane] = acc[r][0];
    s[r * kLdS + lane + 32] = acc[r][1];
  }
}

// o[kRows][kD] += p[kRows][kTile] . v[kTile][kD] for this warp's rows.
__device__ __forceinline__ void warp_pv_f32(float* o, const float* p, const float* vs) {
  const int lane = threadIdx.x & 31;
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int j = 0; j < kTile; ++j) {
    const float v0 = vs[j * kLdF + lane], v1 = vs[j * kLdF + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pr = p[r * kLdF + j];
      acc[r][0] = fmaf(pr, v0, acc[r][0]);
      acc[r][1] = fmaf(pr, v1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    o[r * kLdS + lane] += acc[r][0];
    o[r * kLdS + lane + 32] += acc[r][1];
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                  const float* __restrict__ qv_bias, float* __restrict__ out,
                  float* __restrict__ lse, int n, int num_heads, float scale, int bounded,
                  const long long* __restrict__ seed, uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = num_heads * kD;
  const int c3 = 3 * c;
  const int hc = h * kD;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(seed);
  const uint32_t bh = uint32_t(b) * num_heads + h;

  float* s_w = reinterpret_cast<float*>(smem) + warp * 2 * kRows * kLdS;
  float* o_w = s_w + kRows * kLdS;
  float* qs = reinterpret_cast<float*>(smem) + kWarps * 2 * kRows * kLdS;
  float* ks = qs + kTile * kLdF;
  float* vs = ks + kTile * kLdF;
  float* p_w = vs + kTile * kLdF + warp * kRows * kLdF;
  const float* q_w = qs + warp * kRows * kLdF;

  load_tile<float>(qs, qkv, qv_bias ? qv_bias + hc : nullptr, b, n, c3, hc, q0);
  for (int i = lane; i < kRows * kLdS; i += 32) o_w[i] = 0.0f;

  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  const float* bias_h = bias ? bias + size_t(h) * n * n : nullptr;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<float>(ks, qkv, nullptr, b, n, c3, c + hc, k0);
    load_tile<float>(vs, qkv, qv_bias ? qv_bias + 2 * c + hc : nullptr, b, n, c3, 2 * c + hc, k0);
    __syncthreads();

    warp_qk_f32(s_w, q_w, ks);
    __syncwarp();

    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    const bool v0 = c0 < n, v1 = c1 < n;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
      float s0 = s_w[r * kLdS + lane] * scale;
      float s1 = s_w[r * kLdS + lane + 32] * scale;
      if (bias_h != nullptr && row < n) {
        if (v0) s0 += bias_h[size_t(row) * n + c0];
        if (v1) s1 += bias_h[size_t(row) * n + c1];
      }
      float e0, e1;
      if (bounded) {
        e0 = v0 ? expf(s0) : 0.0f;
        e1 = v1 ? expf(s1) : 0.0f;
        l[r] += warp_sum(e0 + e1);
      } else {
        const float mt = warp_max(fmaxf(v0 ? s0 : -INFINITY, v1 ? s1 : -INFINITY));
        const float m_new = fmaxf(m[r], mt);
        const float alpha = expf(m[r] - m_new);  // 0 on the first tile
        e0 = v0 ? expf(s0 - m_new) : 0.0f;
        e1 = v1 ? expf(s1 - m_new) : 0.0f;
        l[r] = l[r] * alpha + warp_sum(e0 + e1);
        m[r] = m_new;
        o_w[r * kLdS + lane] *= alpha;
        o_w[r * kLdS + lane + 32] *= alpha;
      }
      if constexpr (kDrop) {  // after the row sum
        e0 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c0), threshold, inv_keep);
        e1 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c1), threshold, inv_keep);
      }
      p_w[r * kLdF + lane] = e0;
      p_w[r * kLdF + lane + 32] = e1;
    }
    __syncwarp();
    warp_pv_f32(o_w, p_w, vs);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row < n) {
      const float inv = 1.0f / l[r];
      float* dst = out + (size_t(b) * n + row) * c + hc;
      dst[lane] = o_w[r * kLdS + lane] * inv;
      dst[lane + 32] = o_w[r * kLdS + lane + 32] * inv;
      if (lse != nullptr && lane == 0) {
        lse[(size_t(b) * num_heads + h) * n + row] = (bounded ? 0.0f : m[r]) - logf(inv);
      }
    }
  }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* qkv, const float* bias,
                   const float* qv_bias, void* out, float* lse, int batch, int n,
                   int num_heads, float scale, int bounded, const long long* seed,
                   uint32_t threshold, float inv_keep, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), bias, qv_bias,
                                           static_cast<T*>(out), lse, n, num_heads, scale,
                                           bounded, seed, threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. bias ([H, N, N] f32), qv_bias ([3, C] f32) and
// lse ([B, H, N] f32) may be null. seed (one int64 in device memory) null
// means no dropout; otherwise threshold = min(int(rate * 2^32), 2^32 - 1)
// and inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
int uvit_flash_attention_fwd(const void* qkv, const void* bias, const void* qv_bias,
                             void* out, void* lse, const void* seed, int batch, int n,
                             int num_heads, int dtype, float scale, int bounded,
                             unsigned int threshold, float inv_keep, void* stream) {
  const float* b = static_cast<const float*>(bias);
  const float* qvb = static_cast<const float*>(qv_bias);
  float* l = static_cast<float*>(lse);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = sd != nullptr;
  if (dtype == 0) {
    return drop ? launch<bf16>(attention_fwd_bf16<true>, kSmemBf16, qkv, b, qvb, out, l, batch, n,
                               num_heads, scale, bounded, sd, threshold, inv_keep, st)
                : launch<bf16>(attention_fwd_bf16<false>, kSmemBf16, qkv, b, qvb, out, l, batch,
                               n, num_heads, scale, bounded, sd, threshold, inv_keep, st);
  }
  if (dtype == 1) {
    return drop ? launch<float>(attention_fwd_f32<true>, kSmemF32, qkv, b, qvb, out, l, batch, n,
                                num_heads, scale, bounded, sd, threshold, inv_keep, st)
                : launch<float>(attention_fwd_f32<false>, kSmemF32, qkv, b, qvb, out, l, batch,
                                n, num_heads, scale, bounded, sd, threshold, inv_keep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
