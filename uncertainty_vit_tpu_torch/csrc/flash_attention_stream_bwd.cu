// Split streaming multi-head attention backward for large N, for Hopper
// (sm_90a): two kernels behind one entry point.
//
// Replaces the TPU kernels `_stream_bwd_dq_kernel` and
// `_stream_bwd_dkv_kernel` (uncertainty_vit_tpu/ops/flash_attention.py
// :744-790 and :793-852; tile algebra `_stream_recompute_tile` :719-741),
// reached through `_stream_bwd_impl` (:967-1039) from the custom VJP of
// `fused_qkv_attention` when `_route` picks the streaming route (N = 1025 at
// ViT-L/16 512). Per (image, head), from the forward's row log-sum-exp and
// the output cotangent g:
//   p   = exp(scale * q k^T + bias[h] - lse)   (no max or row-sum recompute)
//   p_d = p * keep * 1/(1 - rate)              (the forward's mask replayed;
//                                               p_d = p without dropout)
//   t   = (g v^T) * p_d,  c = rowsum(t),  ds = t - p * c
//   dq  = ds_c k * scale                       kernel 1 (ds_c: ds in the input dtype)
//   dbias[h] += ds                             kernel 1 (f32, summed over the batch)
//   dk  = ds_c^T q * scale,  dv = p_d^T g      kernel 2 (summed over all query
//                                               rows in f32, rounded once)
// q and v carry the optional q/v bias, added in the input dtype.
//
// What bounds it on an H100: at the ViT-L/16 512 train shape (B=8, N=1025,
// H=16, D=64, bf16) the five products the math needs are 10*B*H*N^2*D =
// 86 GFLOP, ~0.087 ms of tensor-core time at 989 TFLOP/s, against ~250 MB of
// qkv, g, dqkv, bias and dbias, ~0.075 ms at 3.35 TB/s: the floor is the
// tensor cores. This design runs ten products (the scores and g v^T are
// recomputed in pass A, pass B and kernel 2), 3 x 134M exponentials, 67M
// 8-byte f32 atomics into dbias and three walks of the 67 MB bias, so it is
// bounded by its recomputation and by the atomics, not by device memory.
//
// Design. What the TPU gets free and the card does not:
//   - The row sum c crosses the two kernels. On the TPU both kernels hold
//     whole rows and each recomputes c. Here kernel 2 is key-major: a block
//     owns 128 keys and streams the queries, never sees a whole row, and
//     cannot form c. So kernel 1 (query-major: a block owns 128 query rows of
//     one (image, head), each warp 16 of them, and streams k/v in 64-row
//     tiles, twice: pass A for c, pass B for ds, dq and dbias) writes c =
//     rowsum(t), in f32 as the TPU kernels compute it, to a [B, H, N] buffer
//     that kernel 2 reads beside the lse.
//   - dbias sums over the batch and blocks run in no order: each block adds
//     its ds pairs into a zeroed [H, N, ldb] f32 buffer with 8-byte atomics,
//     as the fused backward does. Measured on an H100 at B=8 the atomics,
//     the buffer's memset and its unpadding copy cost 0.21 ms of 1.56; the
//     alternative, a block that owns a (head, q tile, k tile) and loops over
//     the batch with ds in registers, would make dq the sum that crosses
//     blocks and was not built. The bits of dbias vary from run to run; dq,
//     dk and dv do not.
//   - Block order (attention_common.cuh): (tile, image, head), so the tiles
//     of one (image, head) share the slabs they stream and the images of one
//     head share its bias in L2, and the adds to one dbias strip stay within
//     a head; measured 1.56 ms against 1.62 with the image fastest and 1.93
//     in the fused forward's order.
//   - dk and dv accumulate over all query tiles in f32 registers and are
//     rounded once at the store (:845-852, :1032-1033).
//   - Ragged tails feed sums here (:815-839): N = 577 and 1025 are 1 mod 64.
//     Rows >= N of q, k, v and g are zero-filled in shared memory and never
//     read from device memory, and p is forced to 0 outside N x N, so nothing
//     behind a tensor's end reaches dk += ds^T q or dv += p_d^T g.
//   - q, k, v, g and dq, dk, dv go through separate base pointers and row
//     pitches, as the TPU kernels read q, k and v through separate refs
//     (:1046-1052); the packed [B, N, 3C] layout is one choice of pointers.
//   bf16: mma.sync m16n8k16 fed by ldmatrix; the streamed tiles are
//     double-buffered by cp.async; p and ds stay in registers (the C fragment
//     of a 16-column product, packed, is the A fragment of the next). 8 warps
//     at 128 registers, two blocks per SM.
//   f32: FMA loops over shared-memory tiles (no TF32), 64-row tiles.
// The bias is read in column pairs from a copy with an even row pitch ldb,
// and in kernel 2 from a transposed copy, so both kernels read along rows.
// The mask replay is philox::fragment_bits, query-major in kernel 1 and
// key-major in kernel 2, in separate instantiations (kDrop).

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTile = 64;              // rows of a streamed tile
constexpr int kWarpsB = 8;             // bf16: warps per block, 16 rows each
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kOwnB = kWarpsB * 16;    // rows a bf16 block owns
constexpr int kWarpsF = 4;             // f32
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kOwnF = kWarpsF * kRowsF;

struct BwdArgs {
  const void *q, *k, *v, *g;  // each at column 0 of head 0 in row 0 of image 0
  void *dq, *dk, *dv;
  long long ldq, ldkv, ldg, lddq, lddkv;  // row pitches, elements
  const float* bias;     // [H, N, ldb] or null
  const float* bias_t;   // its transpose, [H, N(key), ldb], or null
  const float* qv_bias;  // [3, C] or null
  const float* lse;      // [B, H, N]
  float* c;              // [B, H, N]: written by kernel 1, read by kernel 2
  float* dbias;          // [H, N, ldb], zeroed by the caller, or null
  const long long* seed;
  int n, ldb, num_heads;
  float scale, inv_keep;
  uint32_t threshold;
};

// Bias pairs of the 16 x 16 tile at (r0, c0) of bm ([n][ldb], ldb even):
// bv[nb][i] holds columns c0 + nb*8 + 2t, +1 of row r0 + g + 8i, 0 where the
// pair starts outside the n x n bias.
__device__ __forceinline__ void load_bias(float2 (&bv)[2][2], const float* bm, int n, int ldb,
                                          int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i, col = c0 + nb * 8 + 2 * t;
      bv[nb][i] = (bm != nullptr && r < n && col < n)
                      ? __ldg(reinterpret_cast<const float2*>(bm + size_t(r) * ldb + col))
                      : make_float2(0.0f, 0.0f);
    }
  }
}
__device__ __forceinline__ float bias_at(const float2 (&bv)[2][2], int nb, int e) {
  const float2 v = bv[nb][e >> 1];
  return (e & 1) ? v.y : v.x;
}

// pd = p * keep * 1/(1 - rate) for a 16 x 16 fragment pair whose first
// fragment row is a_lo and first column c0 (query-major), or whose rows are
// keys and columns queries (kTransposed).
template <bool kTransposed>
__device__ __forceinline__ void dropped(float (&pd)[2][4], const float (&p)[2][4],
                                        philox::Key key, uint32_t bh, int a_lo, int c0,
                                        uint32_t threshold, float inv_keep) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    uint32_t bits[4];
    philox::fragment_bits<kTransposed>(key, bh, a_lo, c0 + nb * 8 + 2 * t, bits);
#pragma unroll
    for (int e = 0; e < 4; ++e) pd[nb][e] = p[nb][e] * philox::keep_scale(bits[e], threshold, inv_keep);
  }
}

// Stores a warp's 16 x 64 f32 accumulator, times `mul`, as bf16 into rows
// row0 + g and row0 + g + 8 of one head's slab (`dst` at the head's first
// column in row 0 of the image, rows `ld` elements apart).
__device__ __forceinline__ void store_rows_bf16(bf16* dst, size_t ld, const float (&acc)[kD / 8][4],
                                                float mul, int n, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
    bf16* d = dst + size_t(row) * ld + 2 * t;
#pragma unroll
    for (int db = 0; db < kD / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(d + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * i] * mul, acc[db][2 * i + 1] * mul);
    }
  }
}

// A warp's 16 x 64 f32 tile (rows of kLdS words), times `mul`, into rows
// [row0, row0 + 16) of one head's f32 slab.
__device__ __forceinline__ void store_rows_f32(float* dst, size_t ld, const float* tile, float mul,
                                               int n, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    dst[size_t(row) * ld + lane] = tile[r * kLdS + lane] * mul;
    dst[size_t(row) * ld + lane + 32] = tile[r * kLdS + lane + 32] * mul;
  }
}

constexpr size_t kSmemB = size_t(4 * kTile + kWarpsB * 2 * 16) * kLd * sizeof(bf16);
constexpr size_t kSmemDkvB = kSmemB + size_t(4 * kTile) * sizeof(float);

// ---------------------------------------------------------------------------
// kernel 1, bf16: c, dq, dbias. Query-major; k/v streamed twice.
// ---------------------------------------------------------------------------

template <bool kDrop>
__global__ void __launch_bounds__(kThreadsB, 2) stream_bwd_dq_bf16(const BwdArgs a) {
  constexpr int kTileElems = kTile * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kTile][kLd]
  bf16* vs = ks + 2 * kTileElems;            // [2][kTile][kLd]
  bf16* stage_w = vs + 2 * kTileElems;       // per warp [2][16][kLd]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int b, tile, h;
  block_coords(b, tile, h);
  const int n = a.n, ldb = a.ldb;
  const int c = a.num_heads * kD;
  const int hc = h * kD;
  const int r0 = tile * kOwnB + warp * 16;  // this warp's first query row
  // a warp whose 16 rows all lie beyond N only helps with the copies (with
  // 128-row tiles at N = 1025 that is a ninth of all warps)
  const bool active = r0 < n;
  const bf16* q_img = static_cast<const bf16*>(a.q) + size_t(b) * n * a.ldq + hc;
  const bf16* k_img = static_cast<const bf16*>(a.k) + size_t(b) * n * a.ldkv + hc;
  const bf16* v_img = static_cast<const bf16*>(a.v) + size_t(b) * n * a.ldkv + hc;
  const bf16* g_img = static_cast<const bf16*>(a.g) + size_t(b) * n * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = a.bias ? a.bias + size_t(h) * n * ldb : nullptr;
  float* dbias_h = a.dbias ? a.dbias + size_t(h) * n * ldb : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * n;
  const float sl2 = a.scale * kLog2e;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(a.seed);
  const uint32_t bh = uint32_t(b) * a.num_heads + h;

  auto load_kv = [&](int stage, int k0) {
    cp_async_tile64(ks + stage * kTileElems, k_img, a.ldkv, n, k0, threadIdx.x, kThreadsB);
    cp_async_tile64(vs + stage * kTileElems, v_img, a.ldkv, n, k0, threadIdx.x, kThreadsB);
  };
  load_kv(0, 0);
  cp_async_commit();

  // this warp's 16 query rows of q (+ q bias) and g, as A fragments
  bf16* xs = stage_w + warp * 2 * 16 * kLd;
  bf16* ys = xs + 16 * kLd;
  load_slab_rows<bf16>(xs, kLd, q_img, a.ldq, qvb_q, n, r0, 16, lane, 32);
  load_slab_rows<bf16>(ys, kLd, g_img, a.ldg, nullptr, n, r0, 16, lane, 32);
  __syncwarp();
  uint32_t qf[kD / 16][4], gf[kD / 16][4];
  load_a_frags(xs, qf);
  load_a_frags(ys, gf);
  const int rows[2] = {r0 + g, r0 + g + 8};
  float lrow[2];  // log2 units
#pragma unroll
  for (int i = 0; i < 2; ++i) lrow[i] = rows[i] < n ? a.lse[bhn + rows[i]] * kLog2e : 0.0f;

  float csum[2] = {0.0f, 0.0f};
  float dq[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int it = 0; it < 2 * n_tiles; ++it) {  // pass A over the tiles, then pass B
    const bool pass_b = it >= n_tiles;
    const int stage = it & 1;
    const int k0 = (pass_b ? it - n_tiles : it) * kTile;
    if (it + 1 < 2 * n_tiles) {
      const int next = it + 1 >= n_tiles ? it + 1 - n_tiles : it + 1;
      load_kv(stage ^ 1, next * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // each thread biases the v chunks it copied
    if (qvb_v != nullptr) bias_tile64(vs + stage * kTileElems, qvb_v, n, k0, threadIdx.x, kThreadsB);
    __syncthreads();
    const bf16* kst = ks + stage * kTileElems;
    const bf16* vst = vs + stage * kTileElems;

    if (active) {
      if (it == n_tiles) {  // pass A is done: c = rowsum(t), kept for pass B and kernel 2
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          csum[i] += __shfl_xor_sync(0xffffffffu, csum[i], 1);
          csum[i] += __shfl_xor_sync(0xffffffffu, csum[i], 2);
          if (t == 0 && rows[i] < n) a.c[bhn + rows[i]] = csum[i];
        }
      }
#pragma unroll 1
      for (int kc = 0; kc < kTile / 16; ++kc) {
        const int k16 = k0 + kc * 16;
        float2 bcur[2][2];
        load_bias(bcur, bias_h, n, ldb, r0, k16);
        float s[2][4], dp[2][4];
        mma_abt(s, qf, kst, kc * 16);
        mma_abt(dp, gf, vst, kc * 16);
        // fragment element (nb, e) is row rows[e >> 1], key k16 + nb*8 + 2t + (e & 1)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k16 + nb * 8 + 2 * t + (e & 1);
            const float v = fmaf(bias_at(bcur, nb, e), kLog2e, s[nb][e] * sl2) - lrow[e >> 1];
            s[nb][e] = (key < n && rows[e >> 1] < n) ? exp2f(v) : 0.0f;
          }
        }
        if (!pass_b) {  // c += rowsum(p_d * (g v^T))
          if constexpr (kDrop) dropped<false>(s, s, pkey, bh, rows[0], k16, a.threshold, a.inv_keep);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) csum[e >> 1] += s[nb][e] * dp[nb][e];
        } else {
          float pd[2][4];
          if constexpr (kDrop) dropped<false>(pd, s, pkey, bh, rows[0], k16, a.threshold, a.inv_keep);
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
              const int key = k16 + nb * 8 + 2 * t;
              if (dbias_h != nullptr && key < n && rows[i] < n) {
                atomicAdd(reinterpret_cast<float2*>(dbias_h + size_t(rows[i]) * ldb + key),
                          make_float2(dp[nb][2 * i], dp[nb][2 * i + 1]));
              }
            }
          }
          mma_ab(dq, dp, kst, kc * 16);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (active) {
    store_rows_bf16(static_cast<bf16*>(a.dq) + size_t(b) * n * a.lddq + hc, a.lddq, dq, a.scale, n,
                    r0);
  }
}

// ---------------------------------------------------------------------------
// kernel 2, bf16: dk, dv. Key-major; q/g streamed once, c and lse read.
// ---------------------------------------------------------------------------

template <bool kDrop>
__global__ void __launch_bounds__(kThreadsB, 2) stream_bwd_dkv_bf16(const BwdArgs a) {
  constexpr int kTileElems = kTile * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [2][kTile][kLd]
  bf16* gs = qs + 2 * kTileElems;            // [2][kTile][kLd]
  bf16* stage_w = gs + 2 * kTileElems;       // per warp [2][16][kLd]
  float* lse_s = reinterpret_cast<float*>(stage_w + kWarpsB * 2 * 16 * kLd);  // [2][kTile], log2
  float* c_s = lse_s + 2 * kTile;                                             // [2][kTile]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int b, tile, h;
  block_coords(b, tile, h);
  const int n = a.n, ldb = a.ldb;
  const int c = a.num_heads * kD;
  const int hc = h * kD;
  const int j0 = tile * kOwnB + warp * 16;  // this warp's first key row
  const bool active = j0 < n;
  const bf16* q_img = static_cast<const bf16*>(a.q) + size_t(b) * n * a.ldq + hc;
  const bf16* k_img = static_cast<const bf16*>(a.k) + size_t(b) * n * a.ldkv + hc;
  const bf16* v_img = static_cast<const bf16*>(a.v) + size_t(b) * n * a.ldkv + hc;
  const bf16* g_img = static_cast<const bf16*>(a.g) + size_t(b) * n * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_th = a.bias_t ? a.bias_t + size_t(h) * n * ldb : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * n;
  const float sl2 = a.scale * kLog2e;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(a.seed);
  const uint32_t bh = uint32_t(b) * a.num_heads + h;

  // q and g rows [q0, q0 + kTile) by cp.async, their lse and c by plain loads
  auto load_qg = [&](int stage, int q0) {
    cp_async_tile64(qs + stage * kTileElems, q_img, a.ldq, n, q0, threadIdx.x, kThreadsB);
    cp_async_tile64(gs + stage * kTileElems, g_img, a.ldg, n, q0, threadIdx.x, kThreadsB);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[stage * kTile + threadIdx.x] = row < n ? a.lse[bhn + row] * kLog2e : 0.0f;
      c_s[stage * kTile + threadIdx.x] = row < n ? a.c[bhn + row] : 0.0f;
    }
  };
  load_qg(0, 0);
  cp_async_commit();

  // this warp's 16 key rows of k and v (+ v bias), as A fragments
  bf16* xs = stage_w + warp * 2 * 16 * kLd;
  bf16* ys = xs + 16 * kLd;
  load_slab_rows<bf16>(xs, kLd, k_img, a.ldkv, nullptr, n, j0, 16, lane, 32);
  load_slab_rows<bf16>(ys, kLd, v_img, a.ldkv, qvb_v, n, j0, 16, lane, 32);
  __syncwarp();
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  load_a_frags(xs, kf);
  load_a_frags(ys, vf);
  const int keys[2] = {j0 + g, j0 + g + 8};

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.0f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.0f;
  }

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int q0 = it * kTile;
    if (it + 1 < n_tiles) {
      load_qg(stage ^ 1, q0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // each thread biases the q chunks it copied
    if (qvb_q != nullptr) bias_tile64(qs + stage * kTileElems, qvb_q, n, q0, threadIdx.x, kThreadsB);
    __syncthreads();
    const bf16* qst = qs + stage * kTileElems;
    const bf16* gst = gs + stage * kTileElems;
    const float* lse_t = lse_s + stage * kTile;
    const float* c_t = c_s + stage * kTile;

    if (active) {
#pragma unroll 1
      for (int qc = 0; qc < kTile / 16; ++qc) {
        const int q16 = q0 + qc * 16;
        // transposed tiles: element (nb, e) is key keys[e >> 1], query
        // q16 + nb*8 + 2t + (e & 1); its bias is bias_t[key][query]
        float2 bcur[2][2];
        load_bias(bcur, bias_th, n, ldb, j0, q16);
        float s[2][4], dp[2][4];
        mma_abt(s, kf, qst, qc * 16);
        mma_abt(dp, vf, gst, qc * 16);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = qc * 16 + nb * 8 + 2 * t + (e & 1);  // query within the tile
            const float v = fmaf(bias_at(bcur, nb, e), kLog2e, s[nb][e] * sl2) - lse_t[ql];
            const float p = (keys[e >> 1] < n && q0 + ql < n) ? exp2f(v) : 0.0f;
            s[nb][e] = p;
            if constexpr (!kDrop) dp[nb][e] = p * (dp[nb][e] - c_t[ql]);
          }
        }
        if constexpr (kDrop) {  // dv takes p_d; ds = p_d * dp - p * c
          float pd[2][4];
          dropped<true>(pd, s, pkey, bh, keys[0], q16, a.threshold, a.inv_keep);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = qc * 16 + nb * 8 + 2 * t + (e & 1);
              dp[nb][e] = pd[nb][e] * dp[nb][e] - s[nb][e] * c_t[ql];
              s[nb][e] = pd[nb][e];
            }
          }
        }
        mma_ab(dv, s, gst, qc * 16);
        mma_ab(dk, dp, qst, qc * 16);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (active) {  // the f32 sums over all query rows, rounded once
    store_rows_bf16(static_cast<bf16*>(a.dk) + size_t(b) * n * a.lddkv + hc, a.lddkv, dk, a.scale,
                    n, j0);
    store_rows_bf16(static_cast<bf16*>(a.dv) + size_t(b) * n * a.lddkv + hc, a.lddkv, dv, 1.0f, n,
                    j0);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA loops over 64-row shared-memory tiles; a warp owns 16 rows
// ---------------------------------------------------------------------------

constexpr size_t kSmemDqF = (size_t(kWarpsF) * 3 * kRowsF * kLdS +
                             size_t(2 * kOwnF + 2 * kTile) * kLdF) * sizeof(float);
constexpr size_t kSmemDkvF = (size_t(kWarpsF) * 4 * kRowsF * kLdS +
                              size_t(2 * kOwnF + 2 * kTile) * kLdF + 2 * kTile) * sizeof(float);

template <bool kDrop>
__global__ void __launch_bounds__(kThreadsF) stream_bwd_dq_f32(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, tile, h;
  block_coords(b, tile, h);
  const int n = a.n, ldb = a.ldb;
  const int c = a.num_heads * kD;
  const int hc = h * kD;
  const int q0 = tile * kOwnF;
  const int r0 = q0 + warp * kRowsF;
  const bool active = r0 < n;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * n * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * n * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * n * a.ldkv + hc;
  const float* g_img = static_cast<const float*>(a.g) + size_t(b) * n * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = a.bias ? a.bias + size_t(h) * n * ldb : nullptr;
  float* dbias_h = a.dbias ? a.dbias + size_t(h) * n * ldb : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * n;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(a.seed);
  const uint32_t bh = uint32_t(b) * a.num_heads + h;

  float* s_w = reinterpret_cast<float*>(smem) + warp * 3 * kRowsF * kLdS;  // scores, then ds
  float* dp_w = s_w + kRowsF * kLdS;                                       // g v^T
  float* o_w = dp_w + kRowsF * kLdS;                                       // dq
  float* qs = reinterpret_cast<float*>(smem) + kWarpsF * 3 * kRowsF * kLdS;
  float* gs = qs + kOwnF * kLdF;
  float* ks = gs + kOwnF * kLdF;
  float* vs = ks + kTile * kLdF;
  const float* q_w = qs + warp * kRowsF * kLdF;
  const float* g_w = gs + warp * kRowsF * kLdF;

  load_slab_rows<float>(qs, kLdF, q_img, a.ldq, qvb_q, n, q0, kOwnF, threadIdx.x, kThreadsF);
  load_slab_rows<float>(gs, kLdF, g_img, a.ldg, nullptr, n, q0, kOwnF, threadIdx.x, kThreadsF);
  for (int i = lane; i < kRowsF * kLdS; i += 32) o_w[i] = 0.0f;

  float lrow[kRowsF], csum[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    lrow[r] = r0 + r < n ? a.lse[bhn + r0 + r] : 0.0f;
    csum[r] = 0.0f;  // pass A: this lane's share; pass B: the row's c
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < n; k0 += kTile) {
      __syncthreads();  // every warp is done with the previous k/v tile
      load_slab_rows<float>(ks, kLdF, k_img, a.ldkv, nullptr, n, k0, kTile, threadIdx.x, kThreadsF);
      load_slab_rows<float>(vs, kLdF, v_img, a.ldkv, qvb_v, n, k0, kTile, threadIdx.x, kThreadsF);
      __syncthreads();
      if (!active) continue;

      warp_abt_f32(s_w, q_w, ks);
      warp_abt_f32(dp_w, g_w, vs);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        const int row = r0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          const int col = k0 + j;
          const bool valid = row < n && col < n;
          float s = s_w[r * kLdS + j] * a.scale;
          if (bias_h != nullptr && valid) s += bias_h[size_t(row) * ldb + col];
          const float p = valid ? expf(s - lrow[r]) : 0.0f;
          float pd = p;
          if constexpr (kDrop) {
            pd *= philox::keep_scale(philox::attention_bits(pkey, bh, row, col), a.threshold,
                                     a.inv_keep);
          }
          const float tt = pd * dp_w[r * kLdS + j];  // t = (g v^T) * p_d
          if (pass == 0) {
            csum[r] += tt;
          } else {
            const float ds = tt - p * csum[r];
            s_w[r * kLdS + j] = ds;
            if (dbias_h != nullptr && valid) atomicAdd(dbias_h + size_t(row) * ldb + col, ds);
          }
        }
      }
      if (pass == 1) {
        __syncwarp();
        warp_ab_f32(o_w, s_w, ks);
      }
      __syncwarp();
    }
    if (pass == 0 && active) {
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        csum[r] = warp_sum(csum[r]);
        if (lane == 0 && r0 + r < n) a.c[bhn + r0 + r] = csum[r];
      }
    }
  }
  if (active) {
    store_rows_f32(static_cast<float*>(a.dq) + size_t(b) * n * a.lddq + hc, a.lddq, o_w, a.scale,
                   n, r0);
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreadsF) stream_bwd_dkv_f32(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, tile, h;
  block_coords(b, tile, h);
  const int n = a.n, ldb = a.ldb;
  const int c = a.num_heads * kD;
  const int hc = h * kD;
  const int jb = tile * kOwnF;
  const int j0 = jb + warp * kRowsF;  // this warp's first key row
  const bool active = j0 < n;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * n * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * n * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * n * a.ldkv + hc;
  const float* g_img = static_cast<const float*>(a.g) + size_t(b) * n * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_th = a.bias_t ? a.bias_t + size_t(h) * n * ldb : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * n;
  philox::Key pkey{0u, 0u};
  if constexpr (kDrop) pkey = philox::load_key(a.seed);
  const uint32_t bh = uint32_t(b) * a.num_heads + h;

  float* s_w = reinterpret_cast<float*>(smem) + warp * 4 * kRowsF * kLdS;  // p_d^T
  float* dp_w = s_w + kRowsF * kLdS;                                       // v g^T, then ds^T
  float* dk_w = dp_w + kRowsF * kLdS;
  float* dv_w = dk_w + kRowsF * kLdS;
  float* ks = reinterpret_cast<float*>(smem) + kWarpsF * 4 * kRowsF * kLdS;
  float* vs = ks + kOwnF * kLdF;
  float* qs = vs + kOwnF * kLdF;
  float* gs = qs + kTile * kLdF;
  float* lse_s = gs + kTile * kLdF;  // [kTile]
  float* c_s = lse_s + kTile;        // [kTile]
  const float* k_w = ks + warp * kRowsF * kLdF;
  const float* v_w = vs + warp * kRowsF * kLdF;

  load_slab_rows<float>(ks, kLdF, k_img, a.ldkv, nullptr, n, jb, kOwnF, threadIdx.x, kThreadsF);
  load_slab_rows<float>(vs, kLdF, v_img, a.ldkv, qvb_v, n, jb, kOwnF, threadIdx.x, kThreadsF);
  for (int i = lane; i < 2 * kRowsF * kLdS; i += 32) dk_w[i] = 0.0f;  // dk_w and dv_w

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous q/g tile
    load_slab_rows<float>(qs, kLdF, q_img, a.ldq, qvb_q, n, q0, kTile, threadIdx.x, kThreadsF);
    load_slab_rows<float>(gs, kLdF, g_img, a.ldg, nullptr, n, q0, kTile, threadIdx.x, kThreadsF);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? a.lse[bhn + row] : 0.0f;
      c_s[threadIdx.x] = row < n ? a.c[bhn + row] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    warp_abt_f32(s_w, k_w, qs);   // [key][query]
    warp_abt_f32(dp_w, v_w, gs);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const int key = j0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        const int query = q0 + i;
        const bool valid = key < n && query < n;
        float s = s_w[r * kLdS + i] * a.scale;
        if (bias_th != nullptr && valid) s += bias_th[size_t(key) * ldb + query];
        const float p = valid ? expf(s - lse_s[i]) : 0.0f;
        float pd = p;
        if constexpr (kDrop) {
          pd *= philox::keep_scale(philox::attention_bits(pkey, bh, query, key), a.threshold,
                                   a.inv_keep);
        }
        s_w[r * kLdS + i] = pd;
        dp_w[r * kLdS + i] = pd * dp_w[r * kLdS + i] - p * c_s[i];
      }
    }
    __syncwarp();
    warp_ab_f32(dv_w, s_w, gs);
    warp_ab_f32(dk_w, dp_w, qs);
    __syncwarp();
  }
  if (active) {
    store_rows_f32(static_cast<float*>(a.dk) + size_t(b) * n * a.lddkv + hc, a.lddkv, dk_w,
                   a.scale, n, j0);
    store_rows_f32(static_cast<float*>(a.dv) + size_t(b) * n * a.lddkv + hc, a.lddkv, dv_w, 1.0f,
                   n, j0);
  }
}

// Kernel 1 then kernel 2 on one stream.
template <typename K1, typename K2>
cudaError_t launch(K1 dq_kernel, K2 dkv_kernel, int threads, int own, size_t smem_dq,
                   size_t smem_dkv, const BwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return err;
  const dim3 grid = block_grid(batch, (a.n + own - 1) / own, a.num_heads);
  dq_kernel<<<grid, threads, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, threads, smem_dkv, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. q, k, v, g and dq, dk, dv point at column 0 of
// head 0 in row 0 of image 0; rows lie ldq, ldkv (k and v), ldg, lddq, lddkv
// (dk and dv) elements apart and an image is n consecutive rows. For packed
// qkv and dqkv [B, N, 3C]: k = qkv + C, v = qkv + 2C, all pitches 3C; g is
// [B, N, C]. lse [B, H, N] f32 from the forward; c [B, H, N] f32 scratch (the
// row sums kernel 1 hands to kernel 2). bias and its transpose
// (bias_t[h][key][query]) are [H, N, ldb] f32 with an even pitch ldb >= N,
// zero in the padding; both null without a bias. dbias ([H, N, ldb] f32,
// zeroed by the caller) may be null and is then not computed. qv_bias ([3, C]
// f32) may be null. seed (one int64 in device memory, the forward's) null
// means no dropout; otherwise threshold and inv_keep are the forward's.
// Returns the first failing launch's cudaError_t.
int uvit_flash_attention_stream_bwd(const void* q, const void* k, const void* v, const void* g,
                                    const void* bias, const void* bias_t, const void* qv_bias,
                                    const void* lse, void* c, void* dq, void* dk, void* dv,
                                    void* dbias, const void* seed, long long ldq, long long ldkv,
                                    long long ldg, long long lddq, long long lddkv, int batch,
                                    int n, int ldb, int num_heads, int dtype,
                                    float scale, unsigned int threshold, float inv_keep,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || ldb < n || ldb % 2 != 0 || num_heads < 1 ||
      num_heads > 65535 || (n + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  a.q = q, a.k = k, a.v = v, a.g = g;
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.ldq = ldq, a.ldkv = ldkv, a.ldg = ldg, a.lddq = lddq, a.lddkv = lddkv;
  a.bias = static_cast<const float*>(bias);
  a.bias_t = static_cast<const float*>(bias_t);
  a.qv_bias = static_cast<const float*>(qv_bias);
  a.lse = static_cast<const float*>(lse);
  a.c = static_cast<float*>(c);
  a.dbias = static_cast<float*>(dbias);
  a.seed = static_cast<const long long*>(seed);
  a.n = n, a.ldb = ldb, a.num_heads = num_heads;
  a.scale = scale, a.inv_keep = inv_keep, a.threshold = threshold;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = a.seed != nullptr;
  if (dtype == 0) {
    return drop ? launch(stream_bwd_dq_bf16<true>, stream_bwd_dkv_bf16<true>, kThreadsB, kOwnB,
                         kSmemB, kSmemDkvB, a, batch, st)
                : launch(stream_bwd_dq_bf16<false>, stream_bwd_dkv_bf16<false>, kThreadsB, kOwnB,
                         kSmemB, kSmemDkvB, a, batch, st);
  }
  if (dtype == 1) {
    return drop ? launch(stream_bwd_dq_f32<true>, stream_bwd_dkv_f32<true>, kThreadsF, kOwnF,
                         kSmemDqF, kSmemDkvF, a, batch, st)
                : launch(stream_bwd_dq_f32<false>, stream_bwd_dkv_f32<false>, kThreadsF, kOwnF,
                         kSmemDqF, kSmemDkvF, a, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
