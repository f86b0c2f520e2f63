// Streaming multi-head attention forward for large N, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stream_fwd_kernel` (uncertainty_vit_tpu/ops/
// flash_attention.py:668-716), reached through `_stream_fwd_impl` (:922-964)
// from `fused_qkv_attention` (:1369) when `_route` (:1361-1366) picks the
// streaming route (N = 1025 at ViT-L/16 512) (K3), and through
// `_cross_fwd_impl` (:1136-1176) from `cross_qkv_attention` (:1253) (K5),
// the local computation of sequence-parallel attention: the Nq query rows of
// one shard against all Nk gathered keys. Per (image, head) it computes what
// the fused forward computes, over Nq query rows and Nk keys (Nq = Nk = N for
// packed qkv):
//   s   = scale * q k^T (f32 accumulation) + bias[h]
//   e   = exp(s - rowmax)            exact mode
//       = exp(s)                     bounded mode (BOUNDED_SCORES)
//   e   = e * keep * 1/(1 - rate)    with dropout, after the row sum
//   out = (e @ v) * (1 / rowsum(e))
//   lse = log rowsum(exp(s))         optional, f32 [B, H, Nq], of the
//                                    undropped softmax
// with an optional q/v bias added to q and v in the input dtype, and e
// rounded to the input dtype before the product with v.
//
// What bounds it on an H100: at ViT-L/16 512 (B=16, N=1025, H=16, D=64,
// bf16) one call does 4*B*H*N^2*D = 69 GFLOP, ~0.070 ms of tensor-core time
// at 989 TFLOP/s, against 101 MB of qkv, 34 MB of output and 67 MB of bias:
// ~0.060 ms at 3.35 TB/s. So the floor is the tensor cores, and what this
// design must keep off the memory system is the bias: 67 MB of f32, more than
// the 50 MB L2, that every image needs in full.
//
// Design (the TPU's head groups, its q-tile plan and its per-tile seeds have
// no meaning here). The TPU holds whole rows: a q tile against resident k/v,
// one exact softmax. A 64-row q tile against 1025 keys does not fit
// a block's registers, so k/v stream through shared memory in 64-row tiles
// with a running row max and sum in f32 (bounded mode: no max), as in the
// fused forward, whose inner loop this kernel shares. What differs:
//   - Block order (attention_common.cuh). The fused forward's grid is (q
//     tile, head, image), q tile fastest: every image walks all 67 MB of bias
//     before the next begins, so at batch 16 the bias is read from device
//     memory sixteen times. Here the order is (q tile, image, head): the 17 q
//     tiles of one (image, head) run together and share its k/v in L2, and
//     the 16 images of a head follow each other and share the head's 4.2 MB
//     of bias there. Measured on an H100 at B=16 this order took 0.70 ms,
//     (image, q tile, head) 0.72 and the fused forward's order 0.80.
//   - The q tile is 64 rows: 4 warps of 16 rows each. A 128-row tile would
//     re-read a head's k/v (262 KB) half as often, but measured it lost (1.13
//     ms against 0.70): at 138 registers only one 8-warp block fits an SM.
//   - q, k, v and the output are read and written through separate base
//     pointers and row pitches; the packed [B, N, 3C] layout is one choice
//     of pointers.
//   - N = 577 and 1025 are 1 mod 64: the last q tile holds one valid row and
//     the last k/v tile one valid column. Tail rows are zero-filled in shared
//     memory and never read from device memory, tail columns get e = 0, and
//     rows beyond Nq are never stored: query rows are tested against Nq and
//     keys against Nk. (In the bf16 kernel, skipping the warps whose rows all
//     lie beyond Nq cost more than it saved: the branch around the unrolled
//     tile loop slowed every block.)
//   bf16: mma.sync m16n8k16 fed by ldmatrix; q fragments, scores and the
//     output accumulator in registers; k/v tiles double-buffered by cp.async.
//   f32: FMA loops over shared-memory tiles (no TF32), 64-row q tiles.
// What is left on the table: the bias is still read with scalar 4-byte loads
// whose latency the warps wait out (0.70 ms with the bias, 0.32 ms without).
// Dropout: the keep bit of (image * H + head, row, column) from
// csrc/philox.cuh, a function of the seed and the position alone, so this
// kernel, the streaming backward's two kernels and the plain PyTorch version
// draw one mask. A separate instantiation (kDrop).

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTileK = 64;  // k/v rows per tile
constexpr int kWarpsQ = 4;  // bf16: warps per block, 16 query rows each

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, register-resident scores and output
// ---------------------------------------------------------------------------

constexpr size_t kSmemBf16 = size_t(kWarpsQ * 16 + 4 * kTileK) * kLd * sizeof(bf16);

template <bool kDrop>
__global__ void __launch_bounds__(kWarpsQ * 32)
stream_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ldq, int ldkv, const float* __restrict__ bias,
                const float* __restrict__ qv_bias, bf16* __restrict__ out, int ldo,
                float* __restrict__ lse, int nq, int nk, int num_heads, float scale,
                int bounded, const long long* __restrict__ seed, uint32_t threshold,
                float inv_keep) {
  constexpr int kThreads = kWarpsQ * 32;
  constexpr int kTileQ = kWarpsQ * 16;
  constexpr int kTileElems = kTileK * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kTileQ][kLd]
  bf16* ks = qs + kTileQ * kLd;              // [2][kTileK][kLd]
  bf16* vs = ks + 2 * kTileElems;            // [2][kTileK][kLd]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  int b, qt, h;
  block_coords(b, qt, h);
  const int q0 = qt * kTileQ;
  const int c = num_heads * kD;
  const int hc = h * kD;
  const float* qvb_v = qv_bias ? qv_bias + 2 * c + hc : nullptr;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(seed);
  const uint32_t bh = uint32_t(b) * num_heads + h;

  // k/v tile rows [k0, k0 + kTileK) -> stage, 8 chunks of 16 B per row
  auto load_kv = [&](int stage, int k0) {
    for (int i = threadIdx.x; i < kTileK * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const int row = k0 + r;
      const bool ok = row < nk;
      const size_t at = (size_t(b) * nk + (ok ? row : 0)) * ldkv + hc + ch;
      const int off = stage * kTileElems + r * kLd + ch;
      cp_async16(smem_u32(ks + off), k + at, ok ? 16 : 0);
      cp_async16(smem_u32(vs + off), v + at, ok ? 16 : 0);
    }
  };

  load_kv(0, 0);
  cp_async_commit();
  load_slab_rows<bf16>(qs, kLd, q + size_t(b) * nq * ldq + hc, ldq,
                       qv_bias ? qv_bias + hc : nullptr, nq, q0, kTileQ, threadIdx.x, kThreads);
  __syncthreads();

  // q fragments (A operand) for the 4 k-steps of D = 64
  uint32_t qf[kD / 16][4];
  load_a_frags(qs + warp * 16 * kLd, qf);

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l_r[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const float sl2 = scale * kLog2e;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* bias_h = bias ? bias + size_t(h) * nq * nk : nullptr;
  const int n_tiles = (nk + kTileK - 1) / kTileK;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    const int k0 = j * kTileK;
    if (j + 1 < n_tiles) {
      load_kv(stage ^ 1, k0 + kTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (qvb_v != nullptr) {  // each thread biases the v chunks it copied
      for (int i = threadIdx.x; i < kTileK * 8; i += kThreads) {
        const int r = i >> 3, ch = (i & 7) * 8;
        if (k0 + r < nk) add_qv_bias(vs + stage * kTileElems + r * kLd + ch, qvb_v + ch);
      }
    }
    __syncthreads();
    const bf16* kst = ks + stage * kTileElems;
    const bf16* vst = vs + stage * kTileElems;

    // s = q k^T for this warp's 16 rows x 64 keys: 8 key blocks of 8
    float s[kTileK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < kD / 32; ++kp) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(kst + (nb * 8 + (lane & 7)) * kLd + kp * 32 + (lane >> 3) * 8), kb);
        mma_bf16(s[nb], qf[2 * kp], kb[0], kb[1]);
        mma_bf16(s[nb], qf[2 * kp + 1], kb[2], kb[3]);
      }
    }

    // scale, bias, mask (log2 units); fragment element (nb, e) is row
    // rows[e >> 1], key k0 + nb*8 + 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        float sv = s[nb][e] * sl2;
        if (bias_h != nullptr && key < nk && row < nq) {
          sv = fmaf(bias_h[size_t(row) * nk + key], kLog2e, sv);
        }
        sv = key < nk ? sv : -INFINITY;
        s[nb][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
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
    for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - sub[e >> 1]);  // masked: exp2(-inf) = 0
        s[nb][e] = p;
        l_r[e >> 1] += p;
      }
    }
    if constexpr (kDrop) {  // after the row sum: the lse is the undropped softmax's
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
        uint32_t bits[4];
        philox::fragment_bits<false>(pkey, bh, rows[0], k0 + nb * 8 + 2 * t, bits);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= philox::keep_scale(bits[e], threshold, inv_keep);
      }
    }

    // o += e v: the C fragments of two key blocks are the A fragment of
    // one 16-key step
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_u32(vst + key * kLd + dp * 16 + (lane >> 4) * 8), vb);
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
    if (row >= nq) continue;
    const float inv = 1.0f / l;
    bf16* dst = out + (size_t(b) * nq + row) * ldo + hc + 2 * t;
#pragma unroll
    for (int db = 0; db < kD / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[db][2 * i] * inv, o[db][2 * i + 1] * inv);
    }
    if (lse != nullptr && t == 0) {
      // log sum exp(s) = m - log(1 / sum exp(s - m)); m = 0 when bounded
      lse[(size_t(b) * num_heads + h) * nq + row] = (bounded ? 0.0f : m_r[i] * kLn2) - logf(inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA loops, per-warp f32 score and output tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kWarpsF = 4;
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kTileQF = kWarpsF * kRowsF;
constexpr size_t kSmemF32 = (size_t(kWarpsF) * 3 * kRowsF * kLdS +
                             size_t(kTileQF + 2 * kTileK) * kLdF) * sizeof(float);

struct FwdArgs {
  const void *q, *k, *v;   // each at column 0 of head 0 in row 0 of image 0
  void* out;
  int ldq, ldkv, ldo;      // row pitches, elements
  const float* bias;       // [H, Nq, Nk] or null
  const float* qv_bias;    // [3, C] or null
  float* lse;              // [B, H, Nq] or null
  const long long* seed;
  int nq, nk, num_heads, bounded;
  float scale, inv_keep;
  uint32_t threshold;
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreadsF) stream_fwd_f32(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, qt, h;
  block_coords(b, qt, h);
  const int q0 = qt * kTileQF;
  const int nq = a.nq, nk = a.nk;
  const int c = a.num_heads * kD;
  const int hc = h * kD;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * nq * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * nk * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * nk * a.ldkv + hc;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(a.seed);
  const uint32_t bh = uint32_t(b) * a.num_heads + h;

  float* s_w = reinterpret_cast<float*>(smem) + warp * 3 * kRowsF * kLdS;  // scores
  float* p_w = s_w + kRowsF * kLdS;                                        // probabilities
  float* o_w = p_w + kRowsF * kLdS;                                        // output
  float* qs = reinterpret_cast<float*>(smem) + kWarpsF * 3 * kRowsF * kLdS;
  float* ks = qs + kTileQF * kLdF;
  float* vs = ks + kTileK * kLdF;
  const float* q_w = qs + warp * kRowsF * kLdF;

  load_slab_rows<float>(qs, kLdF, q_img, a.ldq, a.qv_bias ? a.qv_bias + hc : nullptr, nq, q0,
                        kTileQF, threadIdx.x, kThreadsF);
  for (int i = lane; i < kRowsF * kLdS; i += 32) o_w[i] = 0.0f;

  const bool active = q0 + warp * kRowsF < nq;
  float m[kRowsF], l[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  const float* bias_h = a.bias ? a.bias + size_t(h) * nq * nk : nullptr;

  for (int k0 = 0; k0 < nk; k0 += kTileK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_slab_rows<float>(ks, kLdF, k_img, a.ldkv, nullptr, nk, k0, kTileK, threadIdx.x, kThreadsF);
    load_slab_rows<float>(vs, kLdF, v_img, a.ldkv, a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr,
                          nk, k0, kTileK, threadIdx.x, kThreadsF);
    __syncthreads();
    if (!active) continue;

    warp_abt_f32(s_w, q_w, ks);
    __syncwarp();

    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    const bool v0 = c0 < nk, v1 = c1 < nk;
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const int row = q0 + warp * kRowsF + r;
      float s0 = s_w[r * kLdS + lane] * a.scale;
      float s1 = s_w[r * kLdS + lane + 32] * a.scale;
      if (bias_h != nullptr && row < nq) {
        if (v0) s0 += bias_h[size_t(row) * nk + c0];
        if (v1) s1 += bias_h[size_t(row) * nk + c1];
      }
      float e0, e1;
      if (a.bounded) {
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
        e0 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c0), a.threshold,
                                 a.inv_keep);
        e1 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c1), a.threshold,
                                 a.inv_keep);
      }
      p_w[r * kLdS + lane] = e0;
      p_w[r * kLdS + lane + 32] = e1;
    }
    __syncwarp();
    warp_ab_f32(o_w, p_w, vs);
    __syncwarp();
  }

  if (!active) return;
  float* out_img = static_cast<float*>(a.out) + size_t(b) * nq * a.ldo + hc;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = q0 + warp * kRowsF + r;
    if (row < nq) {
      const float inv = 1.0f / l[r];
      float* dst = out_img + size_t(row) * a.ldo;
      dst[lane] = o_w[r * kLdS + lane] * inv;
      dst[lane + 32] = o_w[r * kLdS + lane + 32] * inv;
      if (a.lse != nullptr && lane == 0) {
        a.lse[(size_t(b) * a.num_heads + h) * nq + row] = (a.bounded ? 0.0f : m[r]) - logf(inv);
      }
    }
  }
}

template <bool kDrop>
cudaError_t launch_bf16(const FwdArgs& a, int batch, cudaStream_t stream) {
  auto kernel = stream_fwd_bf16<kDrop>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBf16));
  if (err != cudaSuccess) return err;
  const dim3 grid = block_grid(batch, (a.nq + kWarpsQ * 16 - 1) / (kWarpsQ * 16), a.num_heads);
  kernel<<<grid, kWarpsQ * 32, kSmemBf16, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      a.ldq, a.ldkv, a.bias, a.qv_bias, static_cast<bf16*>(a.out), a.ldo, a.lse, a.nq, a.nk,
      a.num_heads, a.scale, a.bounded, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_f32(const FwdArgs& a, int batch, cudaStream_t stream) {
  auto kernel = stream_fwd_f32<kDrop>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemF32));
  if (err != cudaSuccess) return err;
  kernel<<<block_grid(batch, (a.nq + kTileQF - 1) / kTileQF, a.num_heads), kThreadsF, kSmemF32,
           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. q, k, v point at column 0 of head 0 in row 0 of
// image 0; rows lie ldq (q) and ldkv (k, v) elements apart, and an image is nq
// consecutive rows of q and nk of k and v; out likewise with ldo and nq. For
// packed qkv [B, N, 3C]: q = qkv, k = qkv + C, v = qkv + 2C, ldq = ldkv = 3C,
// nq = nk = N; for q [B, Nq, C] and packed kv [B, Nk, 2C]: k = kv, v = kv + C,
// ldq = C, ldkv = 2C. bias ([H, Nq, Nk] f32), qv_bias ([3, C] f32) and lse
// ([B, H, Nq] f32) may be null. seed (one int64 in
// device memory) null means no dropout; otherwise threshold = min(int(rate * 2^32),
// 2^32 - 1) and inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
int uvit_flash_attention_stream_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* qv_bias, void* out, void* lse,
                                    const void* seed, long long ldq, long long ldkv,
                                    long long ldo, int batch, int nq, int nk, int num_heads,
                                    int dtype, float scale, int bounded, unsigned int threshold,
                                    float inv_keep, void* stream) {
  if (batch < 1 || batch > 65535 || nq < 1 || nk < 1 || (nq + 63) / 64 > 65535 || num_heads < 1 ||
      num_heads > 65535 || ldq > 0x7fffffffLL || ldkv > 0x7fffffffLL || ldo > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a;
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.ldq = static_cast<int>(ldq), a.ldkv = static_cast<int>(ldkv), a.ldo = static_cast<int>(ldo);
  a.bias = static_cast<const float*>(bias);
  a.qv_bias = static_cast<const float*>(qv_bias);
  a.lse = static_cast<float*>(lse);
  a.seed = static_cast<const long long*>(seed);
  a.nq = nq, a.nk = nk, a.num_heads = num_heads, a.bounded = bounded;
  a.scale = scale, a.inv_keep = inv_keep, a.threshold = threshold;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = a.seed != nullptr;
  if (dtype == 0) return drop ? launch_bf16<true>(a, batch, st) : launch_bf16<false>(a, batch, st);
  if (dtype == 1) return drop ? launch_f32<true>(a, batch, st) : launch_f32<false>(a, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
