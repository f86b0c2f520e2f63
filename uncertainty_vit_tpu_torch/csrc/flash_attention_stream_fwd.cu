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
// What bounds it on an H100 (80GB HBM3, 700 W): at ViT-L/16 512 (B=16,
// N=1025, H=16, D=64, bf16) one call does 4*B*H*N^2*D = 69 GFLOP, ~0.070 ms
// of tensor-core time at 989 TFLOP/s, against 101 MB of qkv, 34 MB of
// output and 67 MB of bias: ~0.060 ms at 3.35 TB/s. So the floor is the
// tensor cores. Short of it sit the softmax's instructions between the two
// products and the bias: 67 MB of f32, more than the 50 MB L2, that every
// image needs in full, 1.07 GB through L2 at B=16.
//
// Design (the TPU's head groups, its q-tile plan and its per-tile seeds have
// no meaning here). The TPU holds whole rows: a q tile against resident k/v,
// one exact softmax. Here k/v stream through shared memory in 64-row tiles
// with a running row max and sum in f32 (bounded mode: no max).
//   bf16 (sm_90a): one producer warpgroup and one consumer warpgroup of 64
//     query rows a block, two blocks an SM. The producer's first thread
//     loads the q tile and each k/v tile by TMA (per-image 3-D tensor maps,
//     64-row boxes in the 128-byte swizzle: rows past Nq or Nk of an image
//     arrive as zeros, never the next image's), and all its 128 threads copy
//     the f32 bias tile of (q tile, k tile) beside them with 4-byte cp.async
//     (the bias rows lie 4100 bytes apart at N = 1025: neither a 16-byte
//     copy nor TMA can read them as they stand), arriving on the stage's
//     mbarrier when it lands; a two-stage ring. The consumer runs s = q k^T
//     as four wgmma m64n64k16 from shared memory, the softmax on the
//     accumulator in registers (the bias read in fragment order from a
//     72-word pitch, conflict-free; 2^x on the special-function unit; keys
//     past Nk masked in the last tile only), then o += p v with p packed to
//     bf16 in registers as wgmma's A operand and v read through the
//     descriptor's transpose. Measured on an H100 80GB HBM3 at 700 W, B=16
//     (tools/torch_port_stream_ab.py): 0.330 ms against 0.700 for the
//     earlier mma.sync kernel, 0.231 without a bias. Not kept: two consumer
//     warpgroups (128-row tiles, one block an SM) 0.402; a three-stage ring
//     0.331 (no gain); the bias by TMA from a 16-byte-pitched copy 0.352
//     against 0.331 (see PERF.md).
//   - Block order (attention_common.cuh): (q tile, image, head), so the q
//     tiles of one (image, head) share its k/v in L2 and the images of one
//     head share its 4.2 MB of bias there.
//   - q, k, v and the output are read and written through separate base
//     pointers and row pitches; the packed [B, N, 3C] layout is one choice
//     of pointers. The q/v bias, when given, is added in bf16 in shared
//     memory: to the q tile by the consumer, once; to each v tile by the
//     producer warpgroup, which has TMA land it on a barrier of its own and
//     hands the stage over after the add. (The models add the bias in the
//     qkv projection and pass none.)
//   - N = 577 and 1025 are 1 mod 64: the last q tile holds one valid row and
//     the last k/v tile one valid column. Rows beyond Nq are computed on
//     zeros (and stale bias words) and never stored; keys beyond Nk get
//     e = 0.
//   f32: FMA loops over shared-memory tiles (no TF32), 64-row q tiles.
// Head widths (a template parameter D, picked at launch): every multiple of
// 16 from 32 to 128 (attention_common.cuh:with_head_dim); 64 is ViT-B's and
// ViT-L's, 80 ViT-H/16's (16 heads, N = 197). A tile is HeadTile<D>'s boxes
// (hopper_common.cuh): s = q k^T is D / 16 k16 steps, o += p v one wgmma
// m64nD a step across the boxes (the accumulator D / 2 f32 a thread). A
// stage is 2 * 128 D + 18,432 bytes: two blocks an SM fit up to D = 112, one
// at D = 128 (FwdSmem::kBlocks; the launch bounds follow it). At D = 80 and
// ViT-H's eval shape (B=128, N=197, H=16, bf16, a bias) the call moves 261
// MB, ~0.078 ms at 3.35 TB/s, and does 25.4 GFLOP, ~0.026 ms: the bytes
// bound it; at a preset's width C = H D neither the operations (4 B H N^2 D)
// nor the bytes but the bias's H N^2 depend on D.
// Dropout: the keep bit of (image * H + head, row, column) from
// csrc/philox.cuh, a function of the seed and the position alone, so this
// kernel, the streaming backward's two kernels and the plain PyTorch version
// draw one mask; on a data axis the image is the unsharded one of the call's
// batch fold (attention_common.cuh: BatchFold), mapped once a block. A wgmma
// m64n64 accumulator gives each thread the pairs an mma.sync m16n8 tile
// does, so philox::fragment_bits serves unchanged. A separate instantiation
// (kDrop).

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTileK = 64;  // k/v rows per tile

// ---------------------------------------------------------------------------
// bf16: one producer warpgroup (TMA for q and the k/v tiles, 4-byte cp.async
// for the bias tiles) and one consumer warpgroup of 64 query rows (wgmma for
// both products, the softmax in registers)
// ---------------------------------------------------------------------------

constexpr int kStages = 2;            // k/v/bias ring depth
constexpr int kLdBias = kTileK + 8;   // f32 bias tile row: float2 reads conflict-free
constexpr uint32_t kBiasBytes = 64 * kLdBias * sizeof(float);
// Shared memory of head width D: the q tile, then the ring of stages (k, v,
// bias), then the barriers full[], empty[], landed[], q. A stage is 36 KiB
// at D = 64, 38 KiB at D = 80, 50 KiB at D = 128.
template <int D>
struct FwdSmem {
  static constexpr uint32_t kTileBytes = HeadTile<D>::kBytes;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + kBiasBytes;
  static_assert(kStageBytes % 1024 == 0, "a stage must keep the next one 1024-byte aligned");
  static constexpr uint32_t kRingOff = kTileBytes;
  static constexpr uint32_t kBarOff = kRingOff + kStages * kStageBytes;
  static constexpr size_t kBytes =
      kBarOff + (3 * kStages + 1) * sizeof(uint64_t) + 1024;  // + alignment
  static_assert(kBytes <= kSmemBlockMax, "the forward's shared memory exceeds a block's");
  static constexpr int kBlocks = blocks_per_sm(kBytes);  // blocks an SM holds
};
constexpr int kThreadsBf16 = 2 * 128;

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsBf16, FwdSmem<D>::kBlocks)
stream_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                const float* __restrict__ qv_bias, bf16* __restrict__ out, int ldo,
                float* __restrict__ lse, int nq, int nk, int num_heads, float scale, int bounded,
                const long long* __restrict__ seed, uint32_t threshold, float inv_keep,
                const BatchFold fold) {
  using T = HeadTile<D>;
  using S = FwdSmem<D>;
  constexpr uint32_t kTileBytes = S::kTileBytes, kStageBytes = S::kStageBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;  // with a q/v bias: a k/v pair in, the bias not yet added
  uint64_t* q_full = landed + kStages;

  int b, qt, h;
  block_coords(b, qt, h);
  const int q0 = qt * 64;
  const int hc = h * D;
  const float* bias_h = bias ? bias + size_t(h) * nq * nk : nullptr;
  const int n_tiles = (nk + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the expect_tx arrival (with a q/v bias: the hand-over's arrival),
      // and with a bias one cp.async arrival from each producer thread
      mbar_init(&full[s], bias_h != nullptr ? 129 : 1);
      mbar_init(&empty[s], 128);
      mbar_init(&landed[s], 1);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer
    const int ptid = threadIdx.x - 128;
    const float* qvb_v = qv_bias != nullptr ? qv_bias + 2 * num_heads * D + hc : nullptr;
    if (ptid == 0) {
      mbar_arrive_expect_tx(q_full, kTileBytes);
      tma_load_head<D>(smem, &tm_q, q_full, hc, q0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      unsigned char* st = smem + S::kRingOff + s * kStageBytes;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      if (ptid == 0) {
        // with a q/v bias the pair lands for the hand-over first
        uint64_t* bar = qvb_v != nullptr ? &landed[s] : &full[s];
        mbar_arrive_expect_tx(bar, 2 * kTileBytes);
        tma_load_head<D>(st, &tm_k, bar, hc, j * kTileK, b);
        tma_load_head<D>(st + kTileBytes, &tm_v, bar, hc, j * kTileK, b);
      }
      if (bias_h != nullptr) {
        cp_async_bias_tile(reinterpret_cast<float*>(st + 2 * kTileBytes), kLdBias, bias_h, nq, nk,
                           q0, 64, j * kTileK, ptid, 128);
        mbar_arrive_cp_async(&full[s]);
      }
      if (qvb_v != nullptr) {
        hand_over_biased<D>(st + kTileBytes, &landed[s], (j / kStages) & 1, &full[s], qvb_v,
                            ptid);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // consumer warpgroup: query rows q0 + [0, 64)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(seed);
    bh = fold.image(b) * num_heads + h;
  }
  const int r_local = warp * 16 + g;  // this thread's first row in the q tile
  const int rows[2] = {q0 + r_local, q0 + r_local + 8};
  const uint64_t dq = T::desc(smem);

  float o[D / 2];  // the output accumulator: 64 rows x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l_r[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const float sl2 = scale * kLog2e;
  mbar_wait(q_full, 0);
  if (qv_bias != nullptr) {  // the q/v bias's q row, in bf16 in shared memory
    T::add_qv_bias(smem, qv_bias + hc, threadIdx.x);
    fence_proxy_async();
    named_barrier(2, 128);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = j * kTileK;
    unsigned char* st = smem + S::kRingOff + s * kStageBytes;
    mbar_wait(&full[s], (j / kStages) & 1);

    // s = q k^T (64 rows x 64 keys), D / 16 steps of 16 deep
    float sc[32];
    const uint64_t dk = T::desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(sc, T::k_step(dq, kk), T::k_step(dk, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    wgmma_hold(sc);

    // scale and bias (log2 units); element 4 nb + e is row rows[e >> 1], key
    // k0 + nb*8 + 2t + (e & 1). The bias tile holds stale words outside
    // Nq x Nk: keys past Nk are masked here (in the last tile only), rows
    // past Nq are never stored.
    const float* bst =
        reinterpret_cast<const float*>(st + 2 * kTileBytes) + r_local * kLdBias + 2 * t;
    if (bias_h != nullptr) {
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bv = *reinterpret_cast<const float2*>(bst + i * 8 * kLdBias + nb * 8);
          sc[4 * nb + 2 * i] = fmaf(bv.x, kLog2e, sc[4 * nb + 2 * i] * sl2);
          sc[4 * nb + 2 * i + 1] = fmaf(bv.y, kLog2e, sc[4 * nb + 2 * i + 1] * sl2);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= sl2;
    }
    if (k0 + kTileK > nk) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (k0 + (e >> 2) * 8 + 2 * t + (e & 1) >= nk) sc[e] = -INFINITY;
      }
    }
    float sub[2] = {0.0f, 0.0f};
    if (!bounded) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        const float alpha = exp2_approx(m_r[i] - m_new);  // 0 on the first tile
        m_r[i] = m_new;
        sub[i] = m_new;
        l_r[i] *= alpha;
#pragma unroll
        for (int db = 0; db < D / 8; ++db) {
          o[4 * db + 2 * i] *= alpha;
          o[4 * db + 2 * i + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = exp2_approx(sc[e] - sub[(e >> 1) & 1]);  // masked: 2^-inf = 0
      sc[e] = p;
      l_r[(e >> 1) & 1] += p;
    }
    if constexpr (kDrop) {  // after the row sum: the lse is the undropped softmax's
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
        uint32_t bits[4];
        philox::fragment_bits<false>(pkey, bh, rows[0], k0 + nb * 8 + 2 * t, bits);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * nb + e] *= philox::keep_scale(bits[e], threshold, inv_keep);
        }
      }
    }

    // o += p v: the accumulator's 8-key blocks 2kk and 2kk + 1, packed, are
    // the A operand of step kk; v is read MN-major (m64nD)
    const uint64_t dv = T::desc(st + kTileBytes);
    uint32_t pa[kTileK / 16][4];
    pack_a(pa, sc);
    wgmma_hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) wgmma_rs<1>(o, pa[kk], T::mn_step(dv, kk));
    wgmma_commit();
    wgmma_wait_all();
    wgmma_hold(o);
    wgmma_hold(pa);
    mbar_arrive(&empty[s]);  // the consumer is done with stage s
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
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[4 * db + 2 * i] * inv, o[4 * db + 2 * i + 1] * inv);
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
template <int D>
constexpr size_t kSmemF32 = (size_t(kWarpsF) * 3 * kRowsF * kLdS<D> +
                             size_t(kTileQF + 2 * kTileK) * kLdF<D>) * sizeof(float);
static_assert(kSmemF32<kHeadDimMax> <= kSmemBlockMax, "the f32 forward's tiles exceed a block's");

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
  BatchFold fold;          // the images' keys of the dropout mask
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF) stream_fwd_f32(const FwdArgs a) {
  constexpr int ldS = kLdS<D>, ldF = kLdF<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, qt, h;
  block_coords(b, qt, h);
  const int q0 = qt * kTileQF;
  const int nq = a.nq, nk = a.nk;
  const int c = a.num_heads * D;
  const int hc = h * D;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * nq * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * nk * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * nk * a.ldkv + hc;
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(a.seed);
    bh = a.fold.image(b) * a.num_heads + h;
  }

  float* s_w = reinterpret_cast<float*>(smem) + warp * 3 * kRowsF * ldS;  // scores
  float* p_w = s_w + kRowsF * ldS;                                         // probabilities
  float* o_w = p_w + kRowsF * ldS;                                         // output
  float* qs = reinterpret_cast<float*>(smem) + kWarpsF * 3 * kRowsF * ldS;
  float* ks = qs + kTileQF * ldF;
  float* vs = ks + kTileK * ldF;
  const float* q_w = qs + warp * kRowsF * ldF;

  load_slab_rows<D, float>(qs, ldF, q_img, a.ldq, a.qv_bias ? a.qv_bias + hc : nullptr, nq, q0,
                           kTileQF, threadIdx.x, kThreadsF);
  for (int i = lane; i < kRowsF * ldS; i += 32) o_w[i] = 0.0f;

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
    load_slab_rows<D, float>(ks, ldF, k_img, a.ldkv, nullptr, nk, k0, kTileK, threadIdx.x,
                             kThreadsF);
    load_slab_rows<D, float>(vs, ldF, v_img, a.ldkv, a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr,
                             nk, k0, kTileK, threadIdx.x, kThreadsF);
    __syncthreads();
    if (!active) continue;

    warp_abt_f32<D>(s_w, q_w, ks);
    __syncwarp();

    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    const bool v0 = c0 < nk, v1 = c1 < nk;
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const int row = q0 + warp * kRowsF + r;
      float s0 = s_w[r * ldS + lane] * a.scale;
      float s1 = s_w[r * ldS + lane + 32] * a.scale;
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
#pragma unroll
        for (int i = 0; i < kColsF<D>; ++i) {
          if (own_col<D>(lane, i)) o_w[r * ldS + lane + 32 * i] *= alpha;
        }
      }
      if constexpr (kDrop) {  // after the row sum
        e0 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c0), a.threshold,
                                 a.inv_keep);
        e1 *= philox::keep_scale(philox::attention_bits(pkey, bh, row, c1), a.threshold,
                                 a.inv_keep);
      }
      p_w[r * ldS + lane] = e0;
      p_w[r * ldS + lane + 32] = e1;
    }
    __syncwarp();
    warp_ab_f32<D>(o_w, p_w, vs);
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
#pragma unroll
      for (int i = 0; i < kColsF<D>; ++i) {
        if (own_col<D>(lane, i)) dst[lane + 32 * i] = o_w[r * ldS + lane + 32 * i] * inv;
      }
      if (a.lse != nullptr && lane == 0) {
        a.lse[(size_t(b) * a.num_heads + h) * nq + row] = (a.bounded ? 0.0f : m[r]) - logf(inv);
      }
    }
  }
}

template <int D, bool kDrop>
cudaError_t launch_bf16(const FwdArgs& a, int batch, cudaStream_t stream) {
  const int c = a.num_heads * D;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!head_map<D>(&tm_q, a.q, c, a.ldq, a.nq, batch) ||
      !head_map<D>(&tm_k, a.k, c, a.ldkv, a.nk, batch) ||
      !head_map<D>(&tm_v, a.v, c, a.ldkv, a.nk, batch)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = stream_fwd_bf16<D, kDrop>;
  constexpr size_t smem = FwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = block_grid(batch, (a.nq + 63) / 64, a.num_heads);
  kernel<<<grid, kThreadsBf16, smem, stream>>>(
      tm_q, tm_k, tm_v, a.bias, a.qv_bias, static_cast<bf16*>(a.out), a.ldo, a.lse, a.nq, a.nk,
      a.num_heads, a.scale, a.bounded, a.seed, a.threshold, a.inv_keep, a.fold);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_f32(const FwdArgs& a, int batch, cudaStream_t stream) {
  auto kernel = stream_fwd_f32<D, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemF32<D>));
  if (err != cudaSuccess) return err;
  kernel<<<block_grid(batch, (a.nq + kTileQF - 1) / kTileQF, a.num_heads), kThreadsF,
           kSmemF32<D>, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation of head width D, dtype (0 bf16, 1 f32) and dropout.
template <int D>
cudaError_t launch(const FwdArgs& a, int batch, int dtype, cudaStream_t stream) {
  const bool drop = a.seed != nullptr;
  if (dtype == 0) {
    return drop ? launch_bf16<D, true>(a, batch, stream) : launch_bf16<D, false>(a, batch, stream);
  }
  if (dtype == 1) {
    return drop ? launch_f32<D, true>(a, batch, stream) : launch_f32<D, false>(a, batch, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32; head_dim a multiple of 16 from 32 to 128 (C =
// num_heads * head_dim; with_head_dim). q, k, v point at column 0 of head 0
// in row 0 of image 0; rows lie ldq (q) and ldkv (k, v) elements apart, and an image is nq
// consecutive rows of q and nk of k and v; out likewise with ldo and nq. For
// packed qkv [B, N, 3C]: q = qkv, k = qkv + C, v = qkv + 2C, ldq = ldkv = 3C,
// nq = nk = N; for q [B, Nq, C] and packed kv [B, Nk, 2C]: k = kv, v = kv + C,
// ldq = C, ldkv = 2C. bias ([H, Nq, Nk] f32), qv_bias ([3, C] f32) and lse
// ([B, H, Nq] f32) may be null. seed (one int64 in
// device memory) null means no dropout; otherwise threshold = min(int(rate * 2^32),
// 2^32 - 1) and inv_keep = 1 / (1 - rate), and (fold_per, fold_total, fold_off)
// is the batch fold of the mask's images (BatchFold; (batch, batch, 0) for
// none). Returns the launch's cudaError_t.
int uvit_flash_attention_stream_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* qv_bias, void* out, void* lse,
                                    const void* seed, long long ldq, long long ldkv,
                                    long long ldo, int batch, int nq, int nk, int num_heads,
                                    int head_dim, int dtype, int fold_per, int fold_total,
                                    int fold_off, float scale, int bounded,
                                    unsigned int threshold, float inv_keep, void* stream) {
  if (batch < 1 || batch > 65535 || nq < 1 || nk < 1 || (nq + 63) / 64 > 65535 || num_heads < 1 ||
      num_heads > 65535 || ldq > 0x7fffffffLL || ldkv > 0x7fffffffLL || ldo > 0x7fffffffLL ||
      !fold_ok(batch, fold_per, fold_total, fold_off, num_heads)) {
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
  a.fold = BatchFold{fold_per, fold_total, fold_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_head_dim(
      head_dim, [&](auto d) { return launch<decltype(d)::value>(a, batch, dtype, st); }));
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
