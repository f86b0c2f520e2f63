// Fused multi-head attention backward over packed qkv, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (uncertainty_vit_tpu/ops/
// flash_attention.py:244-326), reached through `_bwd_impl` (:509-600) from
// the custom VJP of `fused_qkv_attention` (:1415-1424). Per (image, head),
// from the forward's row log-sum-exp and the output cotangent g:
//   p   = exp(scale * q k^T + bias[h] - lse)   (no max or row-sum recompute)
//   dv  = p^T g                               (p rounded to the input dtype)
//   t   = (g v^T) * p,  c = rowsum(t),  ds = t - p * c
//   dq  = ds_c k * scale,  dk = ds_c^T q * scale   (ds_c: ds in the input dtype)
//   dbias[h] += ds                             (f32, summed over the batch)
// With attention dropout the forward's keep mask is replayed (:298-301):
// p_d = p * keep * 1/(1 - rate) takes p's place in dv and in t, while ds
// keeps the undropped p in p * c.
// q and v carry the optional q/v bias, added in the input dtype as the
// forward adds it. dq|dk|dv are written packed into [B, N, 3C] in the input
// dtype (the TPU kernel's `single_out` layout, :255-262).
//
// What bounds it on an H100: at the ViT-B/16 224 train shape (B=160, N=197,
// H=12, D=64, bf16) the call must read qkv (145 MB) and g (48 MB) and write
// dqkv (145 MB): ~340 MB, ~0.10 ms of HBM traffic at 3.35 TB/s. The five
// products the math needs are ~48 GFLOP, ~0.05 ms of bf16 tensor-core time
// at 989 TFLOP/s; this design recomputes the scores and g v^T three times
// and runs nine products (~86 GFLOP, ~0.09 ms at peak, more at the rate
// mma.sync reaches), plus 3 x 75M exponentials, 37M 8-byte f32 atomics into
// dbias and 3 x 75M bias reads from L2. So the floor is memory, and this
// kernel is bounded by its recomputation, the bias traffic and the
// register-limited occupancy, not by HBM.
//
// Design: one block of 16 warps per (head, image); N <= 256, so two of the
// four [N, 64] slabs fit in shared memory at once and every row of p is
// whole inside the block, which the softmax vjp's row sum c needs. 16 warps
// cap the registers at 128 (a few spills); measured faster than 8 warps at
// 172 registers, which left one 8-warp block per SM.
//   phase 1 (query-major; K and V resident): each warp owns 16 query rows.
//     Pass A over the keys computes c; pass B recomputes p and ds, adds ds
//     into dbias and accumulates dq = ds k in registers.
//   phase 2 (key-major; Q and G resident, c kept from phase 1): each warp
//     owns 16 key rows and accumulates dv = p^T g and dk = ds^T q over all
//     queries in registers, recomputing p and ds transposed.
// No sum crosses blocks except dbias. The TPU accumulates it by revisiting
// one VMEM block over a sequential inner batch axis; Hopper blocks run in no
// order, so each block adds its image's ds into a zeroed f32 buffer with
// atomicAdd. The order of those adds changes from run to run, so the bits
// of dbias do too (f32 sums over the batch in another order; dqkv is
// deterministic).
//   bf16: mma.sync m16n8k16 fed by ldmatrix, as in the forward kernel; the
//     C fragment of a 16-key product, packed to bf16, is the A fragment of
//     the next product, so p and ds never leave registers.
//   f32: FMA loops, one warp per row, so f32 stays f32 (no TF32).
// The bias is read in column pairs (8-byte loads) from a copy with an even
// row pitch, and from a transposed copy in phase 2, so both phases read
// along rows; dbias takes the ds pairs as 8-byte atomics.
// Tail rows (N = 197 or 50 is no multiple of 16) are zero-filled in shared
// memory, so 0 * garbage cannot make NaN, and their p is forced to 0.
// Dropout replay: the TPU reseeds its generator per program, so forward and
// backward must share a batch block to see one mask (:426-438). Here pass A,
// pass B and the key-major phase 2 each tile the scores their own way, and
// the forward kernel a fourth, so the keep bit of (image, head, row, column)
// is a function of the seed and that position alone (csrc/philox.cuh); every
// pass recomputes it where it recomputes p. A thread pair shares each 2 x 2
// block of the mask in the query-major and in the key-major fragment alike
// (philox::fragment_bits), so each pass pays one Philox call per four
// entries: three passes, ~3 x 18.6M calls at B=160, integer work of the
// order of the kernel's tensor-core time. The replay is a separate
// instantiation (kDrop), so the rate-0 kernel keeps its registers and time.

#include <type_traits>

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxN = 256;    // the wrapper raises above this
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;     // rows a warp owns at a time (bf16) = mma M

// Copy rows [row0, row0 + rows) of one head's slab (column col0 of the
// packed [B, N, cols] tensor) into shared memory rows of `ld` elements,
// zero-filling rows >= n and adding the bias row (in T) when given.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, const float* bias_row,
                                          int b, int n, int cols, int col0, int row0, int rows,
                                          int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kD / kVec;
  for (int i = tid; i < rows * kPerRow; i += nthreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int row = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&u);
    if (row < n) {
      u = *reinterpret_cast<const uint4*>(src + (size_t(b) * n + row) * cols + col0 + c);
      if (bias_row != nullptr) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          e[j] = from_f32<T>(to_f32(e[j]) + to_f32(from_f32<T>(bias_row[c + j])));
      }
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
// bf16: mma.sync m16n8k16, register-resident p, ds and accumulators
// ---------------------------------------------------------------------------

// Stores a warp's 16 x 64 f32 accumulator, times `mul`, as bf16 into the
// packed [B, N, 3C] rows row0 + g and row0 + g + 8 at column col0.
__device__ __forceinline__ void store_rows_bf16(bf16* out, const float (&acc)[kD / 8][4], float mul,
                                                int b, int n, int c3, int col0, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
    bf16* dst = out + (size_t(b) * n + row) * c3 + col0 + 2 * t;
#pragma unroll
    for (int db = 0; db < kD / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * i] * mul, acc[db][2 * i + 1] * mul);
    }
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_bf16(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const float* __restrict__ bias_t, const float* __restrict__ qv_bias,
                   const float* __restrict__ lse, const bf16* __restrict__ gout,
                   bf16* __restrict__ dqkv, float* __restrict__ dbias, int n, int ldb,
                   int num_heads, float scale, const long long* __restrict__ seed,
                   uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_pad = (n + kRows - 1) / kRows * kRows;
  bf16* ms = reinterpret_cast<bf16*>(smem);  // [n_pad][kLd]: K, then Q
  bf16* ns = ms + n_pad * kLd;               // [n_pad][kLd]: V, then G
  bf16* stage = ns + n_pad * kLd;            // per warp [2][kRows][kLd]
  float* lse_s = reinterpret_cast<float*>(stage + kWarps * 2 * kRows * kLd);  // [n_pad], log2 units
  float* c_s = lse_s + n_pad;                                                 // [n_pad]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = num_heads * kD;
  const int c3 = 3 * c;
  const int hc = h * kD;
  const float* qvb_q = qv_bias ? qv_bias + hc : nullptr;
  const float* qvb_v = qv_bias ? qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = bias ? bias + size_t(h) * n * ldb : nullptr;
  const float* bias_th = bias_t ? bias_t + size_t(h) * n * ldb : nullptr;
  float* dbias_h = dbias ? dbias + size_t(h) * n * ldb : nullptr;
  const float sl2 = scale * kLog2e;
  bf16* xs = stage + warp * 2 * kRows * kLd;  // this warp's own rows: Q, then K
  bf16* ys = xs + kRows * kLd;                 // and G, then V
  const int n_blocks = n_pad / kRows;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(seed);
  const uint32_t bh = uint32_t(b) * num_heads + h;
  // pd = p * keep * 1/(1 - rate) for a 16 x 16 fragment pair whose first
  // fragment row is a_lo and first column c0 (query-major), or whose rows
  // are keys and columns queries (kTransposed)
  auto dropped = [&](auto transposed, float (&pd)[2][4], const float (&p)[2][4], int a_lo,
                     int c0) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t bits[4];
      philox::fragment_bits<decltype(transposed)::value>(pkey, bh, a_lo, c0 + nb * 8 + 2 * t,
                                                         bits);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pd[nb][e] = p[nb][e] * philox::keep_scale(bits[e], threshold, inv_keep);
      }
    }
  };

  // Bias pairs of the 16 x 16 tile at (r0, c0) of b ([n][ldb], ldb even):
  // bv[nb][i] holds columns c0 + nb*8 + 2t, +1 of row r0 + g + 8i, 0 where
  // the pair starts outside the n x n bias.
  auto load_bias = [&](float2 (&bv)[2][2], const float* bm, int r0, int c0) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i, col = c0 + nb * 8 + 2 * t;
        bv[nb][i] = (bm != nullptr && r < n && col < n)
                        ? *reinterpret_cast<const float2*>(bm + size_t(r) * ldb + col)
                        : make_float2(0.0f, 0.0f);
      }
    }
  };
  auto bias_at = [](const float2 (&bv)[2][2], int nb, int e) {
    const float2 v = bv[nb][e >> 1];
    return (e & 1) ? v.y : v.x;
  };

  load_rows<bf16>(ms, kLd, qkv, nullptr, b, n, c3, c + hc, 0, n_pad, threadIdx.x, kThreads);
  load_rows<bf16>(ns, kLd, qkv, qvb_v, b, n, c3, 2 * c + hc, 0, n_pad, threadIdx.x, kThreads);
  for (int i = threadIdx.x; i < n_pad; i += kThreads) {
    lse_s[i] = i < n ? lse[(size_t(b) * num_heads + h) * n + i] * kLog2e : 0.0f;
  }
  __syncthreads();

  // ---- phase 1: query rows; K in ms, V in ns ----
  for (int rb = warp; rb < n_blocks; rb += kWarps) {
    const int r0 = rb * kRows;
    load_rows<bf16>(xs, kLd, qkv, qvb_q, b, n, c3, hc, r0, kRows, lane, 32);
    load_rows<bf16>(ys, kLd, gout, nullptr, b, n, c, hc, r0, kRows, lane, 32);
    __syncwarp();
    uint32_t qf[kD / 16][4], gf[kD / 16][4];
    load_a_frags(xs, qf);
    load_a_frags(ys, gf);
    __syncwarp();
    const int rows[2] = {r0 + g, r0 + g + 8};
    const float lrow[2] = {lse_s[rows[0]], lse_s[rows[1]]};

    // fragment element (nb, e) is row rows[e >> 1], key k0 + nb*8 + 2t + (e & 1)
    auto probs = [&](float (&s)[2][4], const float2 (&bv)[2][2], int k0) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nb * 8 + 2 * t + (e & 1);
          const int row = rows[e >> 1];
          const float v = fmaf(bias_at(bv, nb, e), kLog2e, s[nb][e] * sl2) - lrow[e >> 1];
          s[nb][e] = (key < n && row < n) ? exp2f(v) : 0.0f;
        }
      }
    };

    float csum[2] = {0.0f, 0.0f};
    float2 bcur[2][2];
    for (int k0 = 0; k0 < n_pad; k0 += kRows) {  // pass A: c = rowsum(p * (g v^T))
      load_bias(bcur, bias_h, r0, k0);
      float s[2][4], dp[2][4];
      mma_abt(s, qf, ms, k0);
      mma_abt(dp, gf, ns, k0);
      probs(s, bcur, k0);
      if constexpr (kDrop) dropped(std::false_type{}, s, s, rows[0], k0);  // t = dp * p_d
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) csum[e >> 1] += s[nb][e] * dp[nb][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      csum[i] += __shfl_xor_sync(0xffffffffu, csum[i], 1);
      csum[i] += __shfl_xor_sync(0xffffffffu, csum[i], 2);
      if (t == 0) c_s[rows[i]] = csum[i];
    }

    float dq[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;
    for (int k0 = 0; k0 < n_pad; k0 += kRows) {  // pass B: ds, dbias, dq
      load_bias(bcur, bias_h, r0, k0);
      float s[2][4], dp[2][4];
      mma_abt(s, qf, ms, k0);
      mma_abt(dp, gf, ns, k0);
      probs(s, bcur, k0);
      float pd[2][4];
      if constexpr (kDrop) dropped(std::false_type{}, pd, s, rows[0], k0);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kDrop) {  // ds = p_d * dp - p * c
            dp[nb][e] = pd[nb][e] * dp[nb][e] - s[nb][e] * csum[e >> 1];
          } else {
            dp[nb][e] = s[nb][e] * (dp[nb][e] - csum[e >> 1]);
          }
        }
        // ds of columns 2t, 2t+1 in one 8-byte atomic; a pair starting at
        // n - 1 adds 0 into the padding column
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + nb * 8 + 2 * t;
          if (dbias_h != nullptr && key < n && rows[i] < n) {
            atomicAdd(reinterpret_cast<float2*>(dbias_h + size_t(rows[i]) * ldb + key),
                      make_float2(dp[nb][2 * i], dp[nb][2 * i + 1]));
          }
        }
      }
      mma_ab(dq, dp, ms, k0);
    }
    store_rows_bf16(dqkv, dq, scale, b, n, c3, hc, r0);
  }
  __syncthreads();

  // ---- phase 2: key rows; Q in ms, G in ns ----
  load_rows<bf16>(ms, kLd, qkv, qvb_q, b, n, c3, hc, 0, n_pad, threadIdx.x, kThreads);
  load_rows<bf16>(ns, kLd, gout, nullptr, b, n, c, hc, 0, n_pad, threadIdx.x, kThreads);
  __syncthreads();
  for (int kb = warp; kb < n_blocks; kb += kWarps) {
    const int j0 = kb * kRows;
    load_rows<bf16>(xs, kLd, qkv, nullptr, b, n, c3, c + hc, j0, kRows, lane, 32);
    load_rows<bf16>(ys, kLd, qkv, qvb_v, b, n, c3, 2 * c + hc, j0, kRows, lane, 32);
    __syncwarp();
    uint32_t kf[kD / 16][4], vf[kD / 16][4];
    load_a_frags(xs, kf);
    load_a_frags(ys, vf);
    __syncwarp();
    const int keys[2] = {j0 + g, j0 + g + 8};
    float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.0f;
      dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.0f;
    }
    float2 bcur[2][2];
    for (int q0 = 0; q0 < n_pad; q0 += kRows) {
      // transposed tiles: element (nb, e) is key keys[e >> 1], query q0 + nb*8 + 2t + (e & 1);
      // its bias is bias_t[key][query]
      load_bias(bcur, bias_th, j0, q0);
      float s[2][4], dp[2][4];
      mma_abt(s, kf, ms, q0);
      mma_abt(dp, vf, ns, q0);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = q0 + nb * 8 + 2 * t + (e & 1);
          const int key = keys[e >> 1];
          const float v = fmaf(bias_at(bcur, nb, e), kLog2e, s[nb][e] * sl2) - lse_s[qr];
          const float p = (key < n && qr < n) ? exp2f(v) : 0.0f;
          s[nb][e] = p;
          if constexpr (!kDrop) dp[nb][e] = p * (dp[nb][e] - c_s[qr]);
        }
      }
      if constexpr (kDrop) {  // dv takes p_d; ds = p_d * dp - p * c
        float pd[2][4];
        dropped(std::true_type{}, pd, s, keys[0], q0);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = q0 + nb * 8 + 2 * t + (e & 1);
            dp[nb][e] = pd[nb][e] * dp[nb][e] - s[nb][e] * c_s[qr];
            s[nb][e] = pd[nb][e];
          }
        }
      }
      mma_ab(dv, s, ns, q0);
      mma_ab(dk, dp, ms, q0);
    }
    store_rows_bf16(dqkv, dk, scale, b, n, c3, c + hc, j0);
    store_rows_bf16(dqkv, dv, 1.0f, b, n, c3, 2 * c + hc, j0);
  }
}

size_t smem_bf16(int n) {
  const int n_pad = (n + kRows - 1) / kRows * kRows;
  return size_t(2) * n_pad * kLd * sizeof(bf16) + size_t(kWarps) * 2 * kRows * kLd * sizeof(bf16) +
         size_t(2) * n_pad * sizeof(float);
}

// ---------------------------------------------------------------------------
// f32: FMA loops, one warp per row
// ---------------------------------------------------------------------------

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                  const float* __restrict__ bias_t, const float* __restrict__ qv_bias,
                  const float* __restrict__ lse, const float* __restrict__ gout,
                  float* __restrict__ dqkv, float* __restrict__ dbias, int n, int ldb,
                  int num_heads, float scale, const long long* __restrict__ seed,
                  uint32_t threshold, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);  // [n][kLdF]: K, then Q
  float* ns = ms + n * kLdF;                   // [n][kLdF]: V, then G
  float* lse_s = ns + n * kLdF;                // [n]
  float* c_s = lse_s + n;                      // [n]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xr = c_s + n + warp * (2 * kD + 2 * n);  // this warp's own two rows
  float* yr = xr + kD;
  float* pw = yr + kD;  // [n]: p of the row
  float* dw = pw + n;   // [n]: ds of the row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = num_heads * kD;
  const int c3 = 3 * c;
  const int hc = h * kD;
  const float* qvb_q = qv_bias ? qv_bias + hc : nullptr;
  const float* qvb_v = qv_bias ? qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = bias ? bias + size_t(h) * n * ldb : nullptr;
  const float* bias_th = bias_t ? bias_t + size_t(h) * n * ldb : nullptr;
  float* dbias_h = dbias ? dbias + size_t(h) * n * ldb : nullptr;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(seed);
  const uint32_t bh = uint32_t(b) * num_heads + h;
  auto keep_at = [&](int row, int col) {
    return philox::keep_scale(philox::attention_bits(pkey, bh, row, col), threshold, inv_keep);
  };

  auto row_of = [&](const float* src, int cols, int col0, int row, const float* qvb, float* dst) {
    const float* p = src + (size_t(b) * n + row) * cols + col0;
    for (int d = lane; d < kD; d += 32) dst[d] = p[d] + (qvb ? qvb[d] : 0.0f);
  };
  auto dot_rows = [&](const float* m, int j, const float* x) {
    float acc = 0.0f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc = fmaf(x[d], m[j * kLdF + d], acc);
    return acc;
  };

  load_rows<float>(ms, kLdF, qkv, nullptr, b, n, c3, c + hc, 0, n, threadIdx.x, kThreads);
  load_rows<float>(ns, kLdF, qkv, qvb_v, b, n, c3, 2 * c + hc, 0, n, threadIdx.x, kThreads);
  for (int i = threadIdx.x; i < n; i += kThreads) lse_s[i] = lse[(size_t(b) * num_heads + h) * n + i];
  __syncthreads();

  // phase 1: query row i against all keys
  for (int i = warp; i < n; i += kWarps) {
    row_of(qkv, c3, hc, i, qvb_q, xr);
    row_of(gout, c, hc, i, nullptr, yr);
    __syncwarp();
    float csum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      float s = dot_rows(ms, j, xr) * scale;
      if (bias_h != nullptr) s += bias_h[size_t(i) * ldb + j];
      const float p = expf(s - lse_s[i]);
      float dp = dot_rows(ns, j, yr);
      pw[j] = p;
      if constexpr (kDrop) {  // dw holds t = dp * p_d
        dp *= p * keep_at(i, j);
        csum += dp;
      } else {
        csum += p * dp;
      }
      dw[j] = dp;
    }
    csum = warp_sum(csum);
    if (lane == 0) c_s[i] = csum;
    for (int j = lane; j < n; j += 32) {
      const float ds = kDrop ? dw[j] - pw[j] * csum : pw[j] * (dw[j] - csum);
      dw[j] = ds;
      if (dbias_h != nullptr) atomicAdd(dbias_h + size_t(i) * ldb + j, ds);
    }
    __syncwarp();
    float* dst = dqkv + (size_t(b) * n + i) * c3 + hc;
    for (int d = lane; d < kD; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc = fmaf(dw[j], ms[j * kLdF + d], acc);
      dst[d] = acc * scale;
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 2: key row j against all queries
  load_rows<float>(ms, kLdF, qkv, qvb_q, b, n, c3, hc, 0, n, threadIdx.x, kThreads);
  load_rows<float>(ns, kLdF, gout, nullptr, b, n, c, hc, 0, n, threadIdx.x, kThreads);
  __syncthreads();
  for (int j = warp; j < n; j += kWarps) {
    row_of(qkv, c3, c + hc, j, nullptr, xr);
    row_of(qkv, c3, 2 * c + hc, j, qvb_v, yr);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      float s = dot_rows(ms, i, xr) * scale;
      if (bias_th != nullptr) s += bias_th[size_t(j) * ldb + i];
      const float p = expf(s - lse_s[i]);
      if constexpr (kDrop) {  // dv takes p_d; ds = p_d * dp - p * c
        const float pd = p * keep_at(i, j);
        pw[i] = pd;
        dw[i] = pd * dot_rows(ns, i, yr) - p * c_s[i];
      } else {
        pw[i] = p;
        dw[i] = p * (dot_rows(ns, i, yr) - c_s[i]);
      }
    }
    __syncwarp();
    float* dst = dqkv + (size_t(b) * n + j) * c3 + hc;
    for (int d = lane; d < kD; d += 32) {
      float ak = 0.0f, av = 0.0f;
      for (int i = 0; i < n; ++i) {
        ak = fmaf(dw[i], ms[i * kLdF + d], ak);
        av = fmaf(pw[i], ns[i * kLdF + d], av);
      }
      dst[c + d] = ak * scale;
      dst[2 * c + d] = av;
    }
    __syncwarp();
  }
}

size_t smem_f32(int n) {
  return (size_t(2) * n * kLdF + size_t(2) * n + size_t(kWarps) * (2 * kD + 2 * n)) *
         sizeof(float);
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* qkv, const float* bias,
                   const float* bias_t, const float* qv_bias, const float* lse, const void* g,
                   void* dqkv, float* dbias, int batch, int n, int ldb, int num_heads,
                   float scale, const long long* seed, uint32_t threshold, float inv_keep,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(num_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), bias, bias_t, qv_bias,
                                           lse, static_cast<const T*>(g),
                                           static_cast<T*>(dqkv), dbias, n, ldb, num_heads,
                                           scale, seed, threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. qkv and dqkv [B, N, 3C], g [B, N, C] in that
// dtype; lse [B, H, N] f32; qv_bias ([3, C] f32) may be null. bias and its
// transpose (bias_t[h][key][query]) are [H, N, ldb] f32 with an even pitch
// ldb >= N, zero in the padding; both null without a bias. dbias ([H, N,
// ldb] f32, zeroed by the caller) may be null and is then not computed.
// seed (one int64 in device memory, the forward's) null means no dropout;
// otherwise threshold and inv_keep are the forward's. Returns the launch's
// cudaError_t.
int uvit_flash_attention_bwd(const void* qkv, const void* bias, const void* bias_t,
                             const void* qv_bias, const void* lse, const void* g, void* dqkv,
                             void* dbias, const void* seed, int batch, int n, int ldb,
                             int num_heads, int dtype, float scale, unsigned int threshold,
                             float inv_keep, void* stream) {
  if (n < 1 || n > kMaxN || ldb < n || ldb % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* bs = static_cast<const float*>(bias);
  const float* bst = static_cast<const float*>(bias_t);
  const float* qvb = static_cast<const float*>(qv_bias);
  const float* l = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  const bool drop = sd != nullptr;
  if (dtype == 0) {
    return drop ? launch<bf16>(attention_bwd_bf16<true>, smem_bf16(n), qkv, bs, bst, qvb, l, g,
                               dqkv, db, batch, n, ldb, num_heads, scale, sd, threshold, inv_keep,
                               st)
                : launch<bf16>(attention_bwd_bf16<false>, smem_bf16(n), qkv, bs, bst, qvb, l, g,
                               dqkv, db, batch, n, ldb, num_heads, scale, sd, threshold, inv_keep,
                               st);
  }
  if (dtype == 1) {
    return drop ? launch<float>(attention_bwd_f32<true>, smem_f32(n), qkv, bs, bst, qvb, l, g,
                                dqkv, db, batch, n, ldb, num_heads, scale, sd, threshold,
                                inv_keep, st)
                : launch<float>(attention_bwd_f32<false>, smem_f32(n), qkv, bs, bst, qvb, l, g,
                                dqkv, db, batch, n, ldb, num_heads, scale, sd, threshold,
                                inv_keep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
