// Split streaming multi-head attention backward for large N, for Hopper
// (sm_90a): two kernels behind one entry point.
//
// Replaces the TPU kernels `_stream_bwd_dq_kernel` and
// `_stream_bwd_dkv_kernel` (uncertainty_vit_tpu/ops/flash_attention.py
// :744-790 and :793-852; tile algebra `_stream_recompute_tile` :719-741),
// reached through `_stream_bwd_impl` (:967-1039) from the custom VJP of
// `fused_qkv_attention` when `_route` picks the streaming route (N = 1025 at
// ViT-L/16 512) (K4), and through `_cross_bwd_impl` (:1179-1250, the same two
// bodies) from the custom VJP of `cross_qkv_attention` (K5): Nq query rows of
// one sequence-parallel shard against all Nk gathered keys (Nq = Nk = N for
// packed qkv). Per (image, head), from the forward's row log-sum-exp, its
// output o and the output cotangent g:
//   p   = exp(scale * q k^T + bias[h] - lse)   (no max or row-sum recompute)
//   p_d = p * keep * 1/(1 - rate)              (the forward's mask replayed;
//                                               p_d = p without dropout)
//   c   = rowsum(p_d * (g v^T)) = g . o        (o = p_d v: no pass over the keys)
//   ds  = p_d * (g v^T) - p * c
//   dq  = ds_c k * scale                       kernel 1 (ds_c: ds in the input dtype)
//   dbias[h] += ds                             kernel 1 (f32, summed over the batch)
//   dk  = ds_c^T q * scale,  dv = p_d^T g      kernel 2 (summed over all query
//                                               rows in f32, rounded once)
// q and v carry the optional q/v bias, added in the input dtype (in the
// bf16 kernels in shared memory: to the resident tiles by the consumers,
// to each streamed tile by the producer warpgroup before it hands the
// stage over). The TPU kernels recompute c from whole rows; c from o is the
// same function (FlashAttention-2's arrangement), formed in f32 from o as
// the forward rounded it.
//
// What bounds it on an H100 (80GB HBM3, 700 W): at the ViT-L/16 512 train
// shape (B=8, N=1025, H=16, D=64, bf16) the five products the math needs are
// 10*B*H*N^2*D = 86 GFLOP, ~0.087 ms of tensor-core time at 989 TFLOP/s,
// against ~250 MB of qkv, g, o, dqkv, bias and dbias, ~0.075 ms at 3.35
// TB/s: the floor is the tensor cores. This design runs seven products (s and
// g v^T in both kernels), 2 x 134M exponentials, 34M 16-byte f32 atomics
// into dbias and two walks of the 67 MB bias through L2 per image.
//
// Design. What the TPU gets free and the card does not:
//   - The row sum c crosses the two kernels. On the TPU both kernels hold
//     whole rows and each recomputes c. Here kernel 2 is key-major: a block
//     owns 128 keys and streams the queries, never sees a whole row. Kernel 1
//     (query-major: a block owns 128 query rows of one (image, head) and
//     streams k/v in 64-row tiles, once) forms c = g . o for its rows before
//     its first tile, uses it for ds, and writes it to a [B, H, Nq] buffer
//     that kernel 2 reads beside the lse. The earlier mma.sync kernel 1
//     streamed k/v twice (a pass for c, a pass for ds): ten products where
//     seven do.
//   - dbias sums over the batch and blocks run in no order: each block adds
//     its ds into a zeroed [H, Nq, ldb] f32 buffer, four columns in one
//     16-byte atomic after a shuffle between neighbouring threads (measured
//     0.728 ms for K4 against 0.763 with 8-byte atomics of pairs). The bits
//     of dbias vary from run to run; dq, dk and dv do not.
//   - Block order (attention_common.cuh): (tile, image, head), so the tiles
//     of one (image, head) share the slabs they stream and the images of one
//     head share its bias in L2, and the adds to one dbias strip stay within
//     a head.
//   - dk and dv accumulate over all query tiles in f32 registers and are
//     rounded once at the store (:845-852, :1032-1033).
//   - Ragged tails feed sums here (:815-839): N = 577 and 1025 are 1 mod 64.
//     Rows >= Nq of q and g and >= Nk of k and v arrive as zeros from TMA
//     (per-image tensor maps), and p is forced to 0 outside Nq x Nk in a tile
//     on the edge, so nothing behind a tensor's end reaches dk += ds^T q or
//     dv += p_d^T g.
//   - q, k, v, g, o and dq, dk, dv go through separate base pointers and row
//     pitches, as the TPU kernels read q, k and v through separate refs
//     (:1046-1052); the packed [B, N, 3C] layout is one choice of pointers.
//   bf16 (sm_90a): one producer warpgroup and two consumer warpgroups of 64
//     rows a block, one block an SM, a three-stage ring. The producer's
//     first thread loads the resident tiles (kernel 1: q and g; kernel 2: k
//     and v) and each streamed tile (k/v; q/g) by TMA; its 128 threads copy
//     the f32 bias tile beside them with 4-byte cp.async (the bias rows lie
//     4100 bytes apart at N = 1025) and, in kernel 2, the tile's lse and c.
//     Every product is wgmma m64n64k16: kernel 1 s = q k^T and dp = g v^T
//     from shared memory, dq += ds k with ds packed to bf16 in registers as
//     the A operand and k read through the transpose; kernel 2 s^T = k q^T
//     and dp^T = v g^T, then dv += p_d^T g and dk += ds^T q, p_d^T and ds^T
//     in registers. Kernel 2 reads its bias tile transposed, from shared
//     memory (a column per fragment row, pitch 132 words: conflict-free):
//     no transposed copy of the bias exists. Measured on an H100 80GB HBM3
//     at 700 W, B=8 (tools/torch_port_stream_ab.py): 0.73 ms against 1.56
//     for the earlier mma.sync pair.
//     Not kept: a two-stage ring (0.75 against 0.73), the bias by TMA from a
//     16-byte-pitched copy (0.89 against 0.78; see PERF.md); the q/v bias
//     added by the consumers between the products, or in a copy of qkv
//     made by the caller (see PERF.md).
//   f32: FMA loops over shared-memory tiles (no TF32), 64-row tiles; kernel
//     1 still forms c by a pass over the keys and does not read o.
// Head widths (a template parameter D, picked at launch): every multiple of
// 16 from 32 to 128 (attention_common.cuh:with_head_dim), the tiles of
// HeadTile<D> (hopper_common.cuh). s and dp are D / 16 k16 steps, and dq +=
// ds k, dv += p_d^T g and dk += ds^T q are wgmma m64nD (k, g and q read
// MN-major across the tile's boxes); an accumulator is D / 2 f32 a thread.
// Kernel 1 holds one (dq); kernel 2 two (dk, dv), which with s, dp and their
// packed copies outgrow a thread's 168 registers (three warpgroups an SM)
// above D = 80 (at 80 it spills a few words; PERF.md). So above 80 kernel 2
// splits (DkvPlan): a block owns 64 keys, and its two consumer warpgroups
// take the same keys, one forming s and summing dv (two products a tile),
// the other forming s and dp and summing dk (three), where one warpgroup of
// a block of 128 keys ran four. The ring is three stages deep where
// the shared memory takes it and two where it does not (kernel 1 at D >= 96;
// BwdSmem). At D = 80 and ViT-H's train shape (B=32, N=197, H=16, bf16, a
// bias) the work is 10 B H N^2 D = 15.9 GFLOP, ~0.016 ms, against 118 MB,
// ~0.035 ms: the bytes bound it.
// The mask replay is philox::fragment_bits, query-major in kernel 1 and
// key-major in kernel 2, in separate instantiations (kDrop), each keyed on
// the image the forward keyed (the call's BatchFold, mapped once a block).

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kTile = 64;              // rows of a streamed tile
// f32: warps a block of head width D (a warp owns kRowsF rows): four, or two
// where four warps' tiles exceed a block's shared memory (D >= 112)
template <int D>
constexpr size_t smem_dq_f32(int warps) {
  const int own = warps * kRowsF;
  return (size_t(warps) * 3 * kRowsF * kLdS<D> + size_t(2 * own + 2 * kTile) * kLdF<D>) *
         sizeof(float);
}
template <int D>
constexpr size_t smem_dkv_f32(int warps) {
  const int own = warps * kRowsF;
  return (size_t(warps) * 4 * kRowsF * kLdS<D> + size_t(2 * own + 2 * kTile) * kLdF<D> +
          2 * kTile) * sizeof(float);
}
template <int D>
constexpr int kWarpsF =
    smem_dkv_f32<D>(4) <= kSmemBlockMax && smem_dq_f32<D>(4) <= kSmemBlockMax ? 4 : 2;
template <int D>
constexpr int kThreadsF = kWarpsF<D> * 32;
template <int D>
constexpr int kOwnF = kWarpsF<D> * kRowsF;

struct BwdArgs {
  const void *q, *k, *v, *g, *o;  // each at column 0 of head 0 in row 0 of image 0
  void *dq, *dk, *dv;
  long long ldq, ldkv, ldg, ldo, lddq, lddkv;  // row pitches, elements
  const float* bias;     // [H, Nq, Nk] or null
  const float* qv_bias;  // [3, C] or null
  const float* lse;      // [B, H, Nq]
  float* c;              // [B, H, Nq]: written by kernel 1, read by kernel 2
  float* dbias;          // [H, Nq, ldb] (ldb a multiple of 4), zeroed by the caller, or null
  const long long* seed;
  int nq, nk, ldb, num_heads;
  float scale, inv_keep;
  uint32_t threshold;
  BatchFold fold;        // the images' keys of the dropout mask, the forward's
};

// Stores a warp's 16 x D f32 accumulator, times `mul`, as bf16 into rows
// row0 + g and row0 + g + 8 of one head's slab (`dst` at the head's first
// column in row 0 of the image, rows `ld` elements apart).
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, size_t ld, const float (&acc)[D / 8][4],
                                                float mul, int n, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
    bf16* d = dst + size_t(row) * ld + 2 * t;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(d + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * i] * mul, acc[db][2 * i + 1] * mul);
    }
  }
}

// A warp's 16 x D f32 tile (rows of kLdS<D> words), times `mul`, into rows
// [row0, row0 + 16) of one head's f32 slab.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, size_t ld, const float* tile, float mul,
                                               int n, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < kColsF<D>; ++i) {
      if (own_col<D>(lane, i)) {
        dst[size_t(row) * ld + lane + 32 * i] = tile[r * kLdS<D> + lane + 32 * i] * mul;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: one producer warpgroup (TMA for the resident and the streamed tiles,
// 4-byte cp.async for the bias, lse and c tiles) and kWg consumer
// warpgroups of 64 rows each (wgmma for every product, p and ds in
// registers)
// ---------------------------------------------------------------------------

constexpr int kWg = 2;                // consumer warpgroups
constexpr int kThreadsW = (kWg + 1) * 128;
// kernel 1's bias tile: [64 kWg query rows][64 keys], pitch 72 words (float2
// reads in fragment order conflict-free)
constexpr int kLdBiasQ = kTile + 8;
constexpr uint32_t kRound = 1024;
constexpr uint32_t round_up(uint32_t x) { return (x + kRound - 1) / kRound * kRound; }

// Kernel 2's plan at head width D. Up to D = 80 a block owns 64 kWg keys and
// consumer warpgroup w sums both dk and dv of its 64; above (kSplit) a block
// owns 64 keys, warpgroup 0 sums their dv and warpgroup 1 their dk. Its bias
// tile is [64 query rows][kKeys keys], pitch kKeys + 4 words, read
// transposed (a column per fragment row: the 2t * pitch + g offsets of a
// warp hit 32 distinct banks).
template <int D>
struct DkvPlan {
  static constexpr bool kSplit = D > 80;
  static constexpr int kKeys = kSplit ? 64 : 64 * kWg;  // keys a block owns
  static constexpr int kResident = kKeys / 64;           // resident k (and v) tiles
  static constexpr int kLdBias = kKeys + 4;
};

// Shared memory of head width D: the resident tiles (kernel 1: q, g of 64 kWg
// query rows; kernel 2: k, v of its keys), then the ring of stages (a
// streamed pair of tiles, the bias tile and in kernel 2 the tile's lse and
// c), then the barriers; three stages where they fit a block, else two. At
// D = 80 kernel 1 takes 209 KiB, kernel 2 203 KiB; at 128 (two stages in
// kernel 1) 201 and 184.
template <int D>
struct BwdSmem {
  static constexpr uint32_t kTileBytes = HeadTile<D>::kBytes;
  static constexpr uint32_t kResidentDq = 2 * kWg * kTileBytes;
  static constexpr uint32_t kResidentDkv = 2 * DkvPlan<D>::kResident * kTileBytes;
  static constexpr uint32_t kStageDq =
      round_up(2 * kTileBytes + 64 * kWg * kLdBiasQ * sizeof(float));
  static constexpr uint32_t kStageDkv =
      round_up(2 * kTileBytes + (64 * DkvPlan<D>::kLdBias + 2 * 64) * sizeof(float));  // + lse, c
  static constexpr size_t bytes(uint32_t resident, uint32_t stage, int stages) {
    return resident + stages * stage + (3 * stages + 1) * sizeof(uint64_t) + 1024;
  }
  static constexpr int stages(uint32_t resident, uint32_t stage) {
    return bytes(resident, stage, 3) <= kSmemBlockMax ? 3 : 2;
  }
  static constexpr int kStagesDq = stages(kResidentDq, kStageDq);
  static constexpr int kStagesDkv = stages(kResidentDkv, kStageDkv);
  static constexpr size_t kBytesDq = bytes(kResidentDq, kStageDq, kStagesDq);
  static constexpr size_t kBytesDkv = bytes(kResidentDkv, kStageDkv, kStagesDkv);
  static_assert(kBytesDq <= kSmemBlockMax && kBytesDkv <= kSmemBlockMax,
                "the backward's shared memory exceeds a block's");
};

// The block's barriers after its tiles: full[], empty[], landed[] (with a
// q/v bias: a streamed pair in, the bias not yet added) and one for the
// resident tiles; the base rounded up to 1024 bytes for the swizzled tiles.
struct Ring {
  unsigned char* smem;
  uint64_t *full, *empty, *landed, *resident;
};
template <int kStages>
__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw, uint32_t resident,
                                          uint32_t stage, uint32_t full_count) {
  Ring r;
  r.smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  r.full = reinterpret_cast<uint64_t*>(r.smem + resident + kStages * stage);
  r.empty = r.full + kStages;
  r.landed = r.empty + kStages;
  r.resident = r.landed + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], full_count);
      mbar_init(&r.empty[s], kWg * 128);
      mbar_init(&r.landed[s], 1);
    }
    mbar_init(r.resident, 1);
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// Stores a warpgroup accumulator (its warp's 16 rows of D), times `mul`,
// as bf16 rows row0 + g and row0 + g + 8 (row0: the warp's first row).
template <int D>
__device__ __forceinline__ void store_acc_bf16(bf16* dst, size_t ld, const float (&acc)[D / 2],
                                               float mul, int n, int row0) {
  store_rows_bf16<D>(dst, ld, reinterpret_cast<const float(&)[D / 8][4]>(acc), mul, n, row0);
}

// ---------------------------------------------------------------------------
// kernel 1, bf16: c, dq, dbias. Query-major; k/v streamed once.
// ---------------------------------------------------------------------------

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsW, 1)
stream_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_g, const BwdArgs a) {
  using T = HeadTile<D>;
  using S = BwdSmem<D>;
  constexpr uint32_t kTileBytes = S::kTileBytes, kResidentBytes = S::kResidentDq;
  constexpr uint32_t kStageDq = S::kStageDq;
  constexpr int kStages = S::kStagesDq;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const float* bias_h = a.bias ? a.bias + size_t(blockIdx.z) * a.nq * a.nk : nullptr;
  const Ring ring =
      ring_init<kStages>(smem_raw, kResidentBytes, kStageDq, bias_h != nullptr ? 129 : 1);
  unsigned char* smem = ring.smem;  // q tiles [kWg], g tiles [kWg], then the ring
  const int wg = threadIdx.x >> 7;
  int b, tile, h;
  block_coords(b, tile, h);
  const int nq = a.nq, nk = a.nk;
  const int hc = h * D;
  const int q0 = tile * 64 * kWg;
  const int n_tiles = (nk + kTile - 1) / kTile;

  if (wg == kWg) {  // producer
    const int ptid = threadIdx.x - kWg * 128;
    const float* qvb_v = a.qv_bias != nullptr ? a.qv_bias + 2 * a.num_heads * D + hc : nullptr;
    if (ptid == 0) {
      mbar_arrive_expect_tx(ring.resident, kResidentBytes);
      for (int w = 0; w < kWg; ++w) {
        tma_load_head<D>(smem + w * kTileBytes, &tm_q, ring.resident, hc, q0 + 64 * w, b);
        tma_load_head<D>(smem + (kWg + w) * kTileBytes, &tm_g, ring.resident, hc, q0 + 64 * w, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      unsigned char* st = smem + kResidentBytes + s * kStageDq;
      mbar_wait(&ring.empty[s], ((j / kStages) & 1) ^ 1);
      if (ptid == 0) {
        // with a q/v bias the pair lands for the hand-over first
        uint64_t* bar = qvb_v != nullptr ? &ring.landed[s] : &ring.full[s];
        mbar_arrive_expect_tx(bar, 2 * kTileBytes);
        tma_load_head<D>(st, &tm_k, bar, hc, j * kTile, b);
        tma_load_head<D>(st + kTileBytes, &tm_v, bar, hc, j * kTile, b);
      }
      if (bias_h != nullptr) {
        cp_async_bias_tile(reinterpret_cast<float*>(st + 2 * kTileBytes), kLdBiasQ, bias_h, nq, nk,
                           q0, 64 * kWg, j * kTile, ptid, 128);
        mbar_arrive_cp_async(&ring.full[s]);
      }
      if (qvb_v != nullptr) {
        hand_over_biased<D>(st + kTileBytes, &ring.landed[s], (j / kStages) & 1, &ring.full[s],
                            qvb_v, ptid);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_local = wg * 64 + warp * 16 + g;
  const int rows[2] = {q0 + r_local, q0 + r_local + 8};
  const size_t bhn = (size_t(b) * a.num_heads + h) * nq;
  float* dbias_h = a.dbias ? a.dbias + size_t(h) * nq * a.ldb : nullptr;
  const float sl2 = a.scale * kLog2e;
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(a.seed);
    bh = a.fold.image(b) * a.num_heads + h;  // the forward's key of this image
  }

  // lse (log2 units) and c = rowsum(p_d * (g v^T)) = g . out (out = p_d v)
  // of this thread's two rows: the four threads of a row sum D / 4 columns
  // each in f32, in 16-byte chunks of 8 (at D = 64 chunks 2t and 2t + 1, at
  // every other width chunks t, t + 4, ... below D / 8: at D = 80 t, t + 4
  // and, for t < 2, t + 8)
  float lrow[2], csum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    float part = 0.0f;
    lrow[i] = 0.0f;
    if (row < nq) {
      lrow[i] = a.lse[bhn + row] * kLog2e;
      const size_t img_row = size_t(b) * nq + row;
      // this thread's first chunk and the step to its next ones
      constexpr int kFirst = D == 64 ? 2 : 1, kStep = D == 64 ? 1 : 4;
      const bf16* grow = static_cast<const bf16*>(a.g) + img_row * a.ldg + hc + 8 * kFirst * t;
      const bf16* orow = static_cast<const bf16*>(a.o) + img_row * a.ldo + hc + 8 * kFirst * t;
#pragma unroll
      for (int ch = 0; ch < (D + 31) / 32; ++ch) {
        if (D != 64 && t + kStep * ch >= D / 8) break;
        const uint4 gu = *reinterpret_cast<const uint4*>(grow + 8 * kStep * ch);
        const uint4 ou = *reinterpret_cast<const uint4*>(orow + 8 * kStep * ch);
        const bf16* ge = reinterpret_cast<const bf16*>(&gu);
        const bf16* oe = reinterpret_cast<const bf16*>(&ou);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(to_f32(ge[e]), to_f32(oe[e]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    csum[i] = part;
    if (t == 0 && row < nq) a.c[bhn + row] = part;
  }

  const uint64_t d_q = T::desc(smem + wg * kTileBytes);
  const uint64_t d_g = T::desc(smem + (kWg + wg) * kTileBytes);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  mbar_wait(ring.resident, 0);
  if (a.qv_bias != nullptr) {  // the q/v bias's q row, in bf16, on this warpgroup's q tile
    T::add_qv_bias(smem + wg * kTileBytes, a.qv_bias + hc, threadIdx.x & 127);
    fence_proxy_async();
    named_barrier(2 + wg, 128);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = j * kTile;
    unsigned char* st = smem + kResidentBytes + s * kStageDq;
    mbar_wait(&ring.full[s], (j / kStages) & 1);
    const uint64_t d_k = T::desc(st);
    const uint64_t d_v = T::desc(st + kTileBytes);

    // s = q k^T and dp = g v^T (64 rows x 64 keys each)
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(sc, T::k_step(d_q, kk), T::k_step(d_k, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(dp, T::k_step(d_g, kk), T::k_step(d_v, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    wgmma_hold(sc);
    wgmma_hold(dp);

    // p = exp(s + bias - lse); element 4 nb + e is row rows[e >> 1], key
    // k0 + nb*8 + 2t + (e & 1). The bias tile holds stale words outside
    // Nq x Nk: p is zeroed there (only a tile on the edge has such entries).
    const float* bst =
        reinterpret_cast<const float*>(st + 2 * kTileBytes) + r_local * kLdBiasQ + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float2 bv = make_float2(0.0f, 0.0f);
        if (bias_h != nullptr) {
          bv = *reinterpret_cast<const float2*>(bst + i * 8 * kLdBiasQ + nb * 8);
        }
        sc[4 * nb + 2 * i] = exp2_approx(fmaf(bv.x, kLog2e, sc[4 * nb + 2 * i] * sl2) - lrow[i]);
        sc[4 * nb + 2 * i + 1] =
            exp2_approx(fmaf(bv.y, kLog2e, sc[4 * nb + 2 * i + 1] * sl2) - lrow[i]);
      }
    }
    const bool edge = k0 + kTile > nk || q0 + 64 * kWg > nq;
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (k0 + (e >> 2) * 8 + 2 * t + (e & 1) >= nk || rows[(e >> 1) & 1] >= nq) sc[e] = 0.0f;
      }
    }
    // ds = p_d dp - p c (p_d = p without dropout), and its batch sum into dbias
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      uint32_t bits[4];
      if constexpr (kDrop) {
        philox::fragment_bits<false>(pkey, bh, rows[0], k0 + nb * 8 + 2 * t, bits);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[4 * nb + e];
        if constexpr (kDrop) {
          const float pd = p * philox::keep_scale(bits[e], a.threshold, a.inv_keep);
          dp[4 * nb + e] = pd * dp[4 * nb + e] - p * csum[e >> 1];
        } else {
          dp[4 * nb + e] = p * (dp[4 * nb + e] - csum[e >> 1]);
        }
      }
      // ds into dbias, four columns in one 16-byte atomic: a thread of even
      // t takes its neighbour's pair of row g beside its own (columns 2t ..
      // 2t + 3), one of odd t its neighbour's pair of row g + 8 (2t - 2 ..
      // 2t + 1). A group running past Nk adds 0 into the padding columns.
      if (dbias_h != nullptr) {
        const bool odd = t & 1;
        const float send0 = odd ? dp[4 * nb] : dp[4 * nb + 2];
        const float send1 = odd ? dp[4 * nb + 1] : dp[4 * nb + 3];
        const float recv0 = __shfl_xor_sync(0xffffffffu, send0, 1);
        const float recv1 = __shfl_xor_sync(0xffffffffu, send1, 1);
        const int row = rows[odd ? 1 : 0];
        const int key = k0 + nb * 8 + 2 * (t & 2);
        const float4 v = odd ? make_float4(recv0, recv1, dp[4 * nb + 2], dp[4 * nb + 3])
                             : make_float4(dp[4 * nb], dp[4 * nb + 1], recv0, recv1);
        if (!edge || (key < nk && row < nq)) {
          atomicAdd(reinterpret_cast<float4*>(dbias_h + size_t(row) * a.ldb + key), v);
        }
      }
    }

    // dq += ds k (ds rounded to bf16; k read MN-major, m64nD)
    uint32_t da[kTile / 16][4];
    pack_a(da, dp);
    wgmma_hold(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs<1>(dq, da[kk], T::mn_step(d_k, kk));
    wgmma_commit();
    wgmma_wait_all();
    wgmma_hold(dq);
    wgmma_hold(da);
    mbar_arrive(&ring.empty[s]);
  }
  store_acc_bf16<D>(static_cast<bf16*>(a.dq) + size_t(b) * nq * a.lddq + hc, a.lddq, dq, a.scale,
                    nq, q0 + wg * 64 + warp * 16);
}

// ---------------------------------------------------------------------------
// kernel 2, bf16: dk, dv. Key-major; q/g streamed once, c and lse read.
// ---------------------------------------------------------------------------

// A consumer warpgroup of kernel 2 (number `wg`, meeting its threads at named
// barrier 2 + wg) on the block's 64 keys kw (keys jb + 64 kw + [0, 64)):
// from each streamed q/g tile it sums dk (kDk) and / or dv (kDv) and stores
// them at the end. Whichever sums dk reads v, and adds the q/v bias's v row
// to the resident v tile.
template <int D, bool kDrop, bool kDk, bool kDv>
__device__ __forceinline__ void dkv_consume(const BwdArgs& a, const Ring& ring, int b, int h,
                                            int jb, int kw, int wg, bool has_bias) {
  using T = HeadTile<D>;
  using S = BwdSmem<D>;
  using P = DkvPlan<D>;
  constexpr uint32_t kTileBytes = S::kTileBytes, kResidentBytes = S::kResidentDkv;
  constexpr uint32_t kStageDkv = S::kStageDkv;
  constexpr int kStages = S::kStagesDkv;
  constexpr uint32_t kBiasOff = 2 * kTileBytes;
  constexpr uint32_t kLseOff = kBiasOff + 64 * P::kLdBias * sizeof(float);
  unsigned char* smem = ring.smem;
  const int nq = a.nq, nk = a.nk;
  const int hc = h * D;
  const int n_tiles = (nq + kTile - 1) / kTile;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_local = kw * 64 + warp * 16 + g;
  const int keys[2] = {jb + k_local, jb + k_local + 8};
  const float sl2 = a.scale * kLog2e;
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(a.seed);
    bh = a.fold.image(b) * a.num_heads + h;  // the forward's key of this image
  }

  const uint64_t d_k = T::desc(smem + kw * kTileBytes);
  const uint64_t d_v = T::desc(smem + (P::kResident + kw) * kTileBytes);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (kDk) dk[i] = 0.0f;
    if constexpr (kDv) dv[i] = 0.0f;
  }
  mbar_wait(ring.resident, 0);
  if constexpr (kDk) {
    if (a.qv_bias != nullptr) {  // the q/v bias's v row, in bf16, on this warpgroup's v tile
      T::add_qv_bias(smem + (P::kResident + kw) * kTileBytes,
                     a.qv_bias + 2 * a.num_heads * D + hc, threadIdx.x & 127);
      fence_proxy_async();
      named_barrier(2 + wg, 128);
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int q0 = j * kTile;
    unsigned char* st = smem + kResidentBytes + s * kStageDkv;
    mbar_wait(&ring.full[s], (j / kStages) & 1);
    const uint64_t d_qt = T::desc(st);
    const uint64_t d_gt = T::desc(st + kTileBytes);

    // s^T = k q^T and dp^T = v g^T (64 keys x 64 queries each)
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(sc, T::k_step(d_k, kk), T::k_step(d_qt, kk), kk > 0);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<0>(dp, T::k_step(d_v, kk), T::k_step(d_gt, kk), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    wgmma_hold(sc);
    if constexpr (kDk) wgmma_hold(dp);

    // p = exp(s + bias - lse): element 4 nb + e is key keys[e >> 1], query
    // q0 + nb*8 + 2t + (e & 1); its bias is bias[query][key], a column of the
    // tile. The bias tile holds stale words outside Nq x Nk: p is zeroed
    // there (only a tile on the edge has such entries).
    const float* bst = reinterpret_cast<const float*>(st + kBiasOff) + k_local;
    const float* lse_t = reinterpret_cast<const float*>(st + kLseOff);
    const float* c_t = lse_t + 64;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int ql = (e >> 2) * 8 + 2 * t + (e & 1);  // query within the tile
      const float bv = has_bias ? bst[ql * P::kLdBias + ((e >> 1) & 1) * 8] : 0.0f;
      sc[e] = exp2_approx(fmaf(bv, kLog2e, sc[e] * sl2) - lse_t[ql] * kLog2e);
    }
    if (q0 + kTile > nq || jb + P::kKeys > nk) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (q0 + (e >> 2) * 8 + 2 * t + (e & 1) >= nq || keys[(e >> 1) & 1] >= nk) sc[e] = 0.0f;
      }
    }
    // ds = p_d dp - p c; dv takes p_d (p without dropout)
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      uint32_t bits[4];
      if constexpr (kDrop) {
        philox::fragment_bits<true>(pkey, bh, keys[0], q0 + nb * 8 + 2 * t, bits);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c_q = c_t[nb * 8 + 2 * t + (e & 1)];  // read only where dk is summed
        const float p = sc[4 * nb + e];
        if constexpr (kDrop) {
          const float pd = p * philox::keep_scale(bits[e], a.threshold, a.inv_keep);
          if constexpr (kDk) dp[4 * nb + e] = pd * dp[4 * nb + e] - p * c_q;
          sc[4 * nb + e] = pd;
        } else if constexpr (kDk) {
          dp[4 * nb + e] = p * (dp[4 * nb + e] - c_q);
        }
      }
    }

    // dv += p_d^T g and dk += ds^T q (p_d and ds rounded to bf16; g and q
    // read MN-major, m64nD)
    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
    if constexpr (kDv) pack_a(pa, sc);
    if constexpr (kDk) pack_a(da, dp);
    if constexpr (kDv) wgmma_hold(dv);
    if constexpr (kDk) wgmma_hold(dk);
    wgmma_fence();
    if constexpr (kDv) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs<1>(dv, pa[kk], T::mn_step(d_gt, kk));
    }
    if constexpr (kDk) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) wgmma_rs<1>(dk, da[kk], T::mn_step(d_qt, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (kDv) {
      wgmma_hold(dv);
      wgmma_hold(pa);
    }
    if constexpr (kDk) {
      wgmma_hold(dk);
      wgmma_hold(da);
    }
    mbar_arrive(&ring.empty[s]);
  }
  // the f32 sums over all query rows, rounded once
  const int row0 = jb + kw * 64 + warp * 16;
  if constexpr (kDk) {
    store_acc_bf16<D>(static_cast<bf16*>(a.dk) + size_t(b) * nk * a.lddkv + hc, a.lddkv, dk,
                      a.scale, nk, row0);
  }
  if constexpr (kDv) {
    store_acc_bf16<D>(static_cast<bf16*>(a.dv) + size_t(b) * nk * a.lddkv + hc, a.lddkv, dv, 1.0f,
                      nk, row0);
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsW, 1)
stream_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g, const BwdArgs a) {
  using S = BwdSmem<D>;
  using P = DkvPlan<D>;
  constexpr uint32_t kTileBytes = S::kTileBytes, kResidentBytes = S::kResidentDkv;
  constexpr uint32_t kStageDkv = S::kStageDkv;
  constexpr int kStages = S::kStagesDkv;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // every producer thread arrives once a stage: its lse / c and bias copies
  const Ring ring = ring_init<kStages>(smem_raw, kResidentBytes, kStageDkv, 129);
  unsigned char* smem = ring.smem;  // k tiles [kResident], v tiles [kResident], then the ring
  const int wg = threadIdx.x >> 7;
  int b, tile, h;
  block_coords(b, tile, h);
  const int nq = a.nq, nk = a.nk;
  const int hc = h * D;
  const int jb = tile * P::kKeys;  // the block's first key
  const int n_tiles = (nq + kTile - 1) / kTile;
  const float* bias_h = a.bias ? a.bias + size_t(h) * nq * nk : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * nq;
  constexpr uint32_t kBiasOff = 2 * kTileBytes;
  constexpr uint32_t kLseOff = kBiasOff + 64 * P::kLdBias * sizeof(float);

  if (wg == kWg) {  // producer
    const int ptid = threadIdx.x - kWg * 128;
    const float* qvb_q = a.qv_bias != nullptr ? a.qv_bias + hc : nullptr;
    if (ptid == 0) {
      mbar_arrive_expect_tx(ring.resident, kResidentBytes);
      for (int w = 0; w < P::kResident; ++w) {
        tma_load_head<D>(smem + w * kTileBytes, &tm_k, ring.resident, hc, jb + 64 * w, b);
        tma_load_head<D>(smem + (P::kResident + w) * kTileBytes, &tm_v, ring.resident, hc,
                         jb + 64 * w, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int q0 = j * kTile;
      unsigned char* st = smem + kResidentBytes + s * kStageDkv;
      mbar_wait(&ring.empty[s], ((j / kStages) & 1) ^ 1);
      if (ptid == 0) {
        // with a q/v bias the pair lands for the hand-over first
        uint64_t* bar = qvb_q != nullptr ? &ring.landed[s] : &ring.full[s];
        mbar_arrive_expect_tx(bar, 2 * kTileBytes);
        tma_load_head<D>(st, &tm_q, bar, hc, q0, b);
        tma_load_head<D>(st + kTileBytes, &tm_g, bar, hc, q0, b);
      }
      if (bias_h != nullptr) {
#pragma unroll
        for (int w = 0; w < P::kResident; ++w) {
          cp_async_bias_tile(reinterpret_cast<float*>(st + kBiasOff) + 64 * w, P::kLdBias, bias_h,
                             nq, nk, q0, 64, jb + 64 * w, ptid, 128);
        }
      }
      {  // lse (threads 0-63) and c (64-127) of the tile's rows, zero past Nq
        const int r = ptid & 63, row = q0 + r;
        const bool ok = row < nq;
        const float* src = (ptid < 64 ? a.lse : a.c) + bhn + (ok ? row : 0);
        cp_async4(smem_u32(reinterpret_cast<float*>(st + kLseOff) + ptid), src, ok ? 4 : 0);
      }
      mbar_arrive_cp_async(&ring.full[s]);
      if (qvb_q != nullptr) {
        hand_over_biased<D>(st, &ring.landed[s], (j / kStages) & 1, &ring.full[s], qvb_q, ptid);
      }
    }
    cp_async_wait<0>();
    return;
  }

  if constexpr (P::kSplit) {  // both warpgroups on the block's 64 keys: dv, then dk
    if (wg == 0) {
      dkv_consume<D, kDrop, false, true>(a, ring, b, h, jb, 0, wg, bias_h != nullptr);
    } else {
      dkv_consume<D, kDrop, true, false>(a, ring, b, h, jb, 0, wg, bias_h != nullptr);
    }
  } else {  // warpgroup wg: keys jb + 64 wg + [0, 64)
    dkv_consume<D, kDrop, true, true>(a, ring, b, h, jb, wg, wg, bias_h != nullptr);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA loops over 64-row shared-memory tiles; a warp owns 16 rows
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t kSmemDqF = smem_dq_f32<D>(kWarpsF<D>);
template <int D>
constexpr size_t kSmemDkvF = smem_dkv_f32<D>(kWarpsF<D>);
static_assert(kSmemDqF<kHeadDimMax> <= kSmemBlockMax && kSmemDkvF<kHeadDimMax> <= kSmemBlockMax,
              "the f32 backward's tiles exceed a block's shared memory");

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF<D>) stream_bwd_dq_f32(const BwdArgs a) {
  constexpr int ldS = kLdS<D>, ldF = kLdF<D>;
  constexpr int kWarps = kWarpsF<D>, kThreads = kThreadsF<D>, kOwn = kOwnF<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, tile, h;
  block_coords(b, tile, h);
  const int nq = a.nq, nk = a.nk, ldb = a.ldb;
  const int c = a.num_heads * D;
  const int hc = h * D;
  const int q0 = tile * kOwn;
  const int r0 = q0 + warp * kRowsF;
  const bool active = r0 < nq;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * nq * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * nk * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * nk * a.ldkv + hc;
  const float* g_img = static_cast<const float*>(a.g) + size_t(b) * nq * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = a.bias ? a.bias + size_t(h) * nq * nk : nullptr;
  float* dbias_h = a.dbias ? a.dbias + size_t(h) * nq * ldb : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * nq;
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(a.seed);
    bh = a.fold.image(b) * a.num_heads + h;  // the forward's key of this image
  }

  float* s_w = reinterpret_cast<float*>(smem) + warp * 3 * kRowsF * ldS;  // scores, then ds
  float* dp_w = s_w + kRowsF * ldS;                                        // g v^T
  float* o_w = dp_w + kRowsF * ldS;                                        // dq
  float* qs = reinterpret_cast<float*>(smem) + kWarps * 3 * kRowsF * ldS;
  float* gs = qs + kOwn * ldF;
  float* ks = gs + kOwn * ldF;
  float* vs = ks + kTile * ldF;
  const float* q_w = qs + warp * kRowsF * ldF;
  const float* g_w = gs + warp * kRowsF * ldF;

  load_slab_rows<D, float>(qs, ldF, q_img, a.ldq, qvb_q, nq, q0, kOwn, threadIdx.x, kThreads);
  load_slab_rows<D, float>(gs, ldF, g_img, a.ldg, nullptr, nq, q0, kOwn, threadIdx.x, kThreads);
  for (int i = lane; i < kRowsF * ldS; i += 32) o_w[i] = 0.0f;

  float lrow[kRowsF], csum[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    lrow[r] = r0 + r < nq ? a.lse[bhn + r0 + r] : 0.0f;
    csum[r] = 0.0f;  // pass A: this lane's share; pass B: the row's c
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < nk; k0 += kTile) {
      __syncthreads();  // every warp is done with the previous k/v tile
      load_slab_rows<D, float>(ks, ldF, k_img, a.ldkv, nullptr, nk, k0, kTile, threadIdx.x,
                               kThreads);
      load_slab_rows<D, float>(vs, ldF, v_img, a.ldkv, qvb_v, nk, k0, kTile, threadIdx.x,
                               kThreads);
      __syncthreads();
      if (!active) continue;

      warp_abt_f32<D>(s_w, q_w, ks);
      warp_abt_f32<D>(dp_w, g_w, vs);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        const int row = r0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          const int col = k0 + j;
          const bool valid = row < nq && col < nk;
          float s = s_w[r * ldS + j] * a.scale;
          if (bias_h != nullptr && valid) s += bias_h[size_t(row) * nk + col];
          const float p = valid ? expf(s - lrow[r]) : 0.0f;
          float pd = p;
          if constexpr (kDrop) {
            pd *= philox::keep_scale(philox::attention_bits(pkey, bh, row, col), a.threshold,
                                     a.inv_keep);
          }
          const float tt = pd * dp_w[r * ldS + j];  // t = (g v^T) * p_d
          if (pass == 0) {
            csum[r] += tt;
          } else {
            const float ds = tt - p * csum[r];
            s_w[r * ldS + j] = ds;
            if (dbias_h != nullptr && valid) atomicAdd(dbias_h + size_t(row) * ldb + col, ds);
          }
        }
      }
      if (pass == 1) {
        __syncwarp();
        warp_ab_f32<D>(o_w, s_w, ks);
      }
      __syncwarp();
    }
    if (pass == 0 && active) {
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        csum[r] = warp_sum(csum[r]);
        if (lane == 0 && r0 + r < nq) a.c[bhn + r0 + r] = csum[r];
      }
    }
  }
  if (active) {
    store_rows_f32<D>(static_cast<float*>(a.dq) + size_t(b) * nq * a.lddq + hc, a.lddq, o_w,
                      a.scale, nq, r0);
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF<D>) stream_bwd_dkv_f32(const BwdArgs a) {
  constexpr int ldS = kLdS<D>, ldF = kLdF<D>;
  constexpr int kWarps = kWarpsF<D>, kThreads = kThreadsF<D>, kOwn = kOwnF<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, tile, h;
  block_coords(b, tile, h);
  const int nq = a.nq, nk = a.nk;
  const int c = a.num_heads * D;
  const int hc = h * D;
  const int jb = tile * kOwn;
  const int j0 = jb + warp * kRowsF;  // this warp's first key row
  const bool active = j0 < nk;
  const float* q_img = static_cast<const float*>(a.q) + size_t(b) * nq * a.ldq + hc;
  const float* k_img = static_cast<const float*>(a.k) + size_t(b) * nk * a.ldkv + hc;
  const float* v_img = static_cast<const float*>(a.v) + size_t(b) * nk * a.ldkv + hc;
  const float* g_img = static_cast<const float*>(a.g) + size_t(b) * nq * a.ldg + hc;
  const float* qvb_q = a.qv_bias ? a.qv_bias + hc : nullptr;
  const float* qvb_v = a.qv_bias ? a.qv_bias + 2 * c + hc : nullptr;
  const float* bias_h = a.bias ? a.bias + size_t(h) * nq * nk : nullptr;
  const size_t bhn = (size_t(b) * a.num_heads + h) * nq;
  philox::Key pkey{0u, 0u};
  uint32_t bh = 0;
  if constexpr (kDrop) {
    pkey = philox::load_key(a.seed);
    bh = a.fold.image(b) * a.num_heads + h;  // the forward's key of this image
  }

  float* s_w = reinterpret_cast<float*>(smem) + warp * 4 * kRowsF * ldS;  // p_d^T
  float* dp_w = s_w + kRowsF * ldS;                                        // v g^T, then ds^T
  float* dk_w = dp_w + kRowsF * ldS;
  float* dv_w = dk_w + kRowsF * ldS;
  float* ks = reinterpret_cast<float*>(smem) + kWarps * 4 * kRowsF * ldS;
  float* vs = ks + kOwn * ldF;
  float* qs = vs + kOwn * ldF;
  float* gs = qs + kTile * ldF;
  float* lse_s = gs + kTile * ldF;  // [kTile]
  float* c_s = lse_s + kTile;       // [kTile]
  const float* k_w = ks + warp * kRowsF * ldF;
  const float* v_w = vs + warp * kRowsF * ldF;

  load_slab_rows<D, float>(ks, ldF, k_img, a.ldkv, nullptr, nk, jb, kOwn, threadIdx.x, kThreads);
  load_slab_rows<D, float>(vs, ldF, v_img, a.ldkv, qvb_v, nk, jb, kOwn, threadIdx.x, kThreads);
  for (int i = lane; i < 2 * kRowsF * ldS; i += 32) dk_w[i] = 0.0f;  // dk_w and dv_w

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous q/g tile
    load_slab_rows<D, float>(qs, ldF, q_img, a.ldq, qvb_q, nq, q0, kTile, threadIdx.x, kThreads);
    load_slab_rows<D, float>(gs, ldF, g_img, a.ldg, nullptr, nq, q0, kTile, threadIdx.x, kThreads);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < nq ? a.lse[bhn + row] : 0.0f;
      c_s[threadIdx.x] = row < nq ? a.c[bhn + row] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    warp_abt_f32<D>(s_w, k_w, qs);   // [key][query]
    warp_abt_f32<D>(dp_w, v_w, gs);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const int key = j0 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = lane + 32 * half;
        const int query = q0 + i;
        const bool valid = key < nk && query < nq;
        float s = s_w[r * ldS + i] * a.scale;
        if (bias_h != nullptr && valid) s += bias_h[size_t(query) * nk + key];
        const float p = valid ? expf(s - lse_s[i]) : 0.0f;
        float pd = p;
        if constexpr (kDrop) {
          pd *= philox::keep_scale(philox::attention_bits(pkey, bh, query, key), a.threshold,
                                   a.inv_keep);
        }
        s_w[r * ldS + i] = pd;
        dp_w[r * ldS + i] = pd * dp_w[r * ldS + i] - p * c_s[i];
      }
    }
    __syncwarp();
    warp_ab_f32<D>(dv_w, s_w, gs);
    warp_ab_f32<D>(dk_w, dp_w, qs);
    __syncwarp();
  }
  if (active) {
    store_rows_f32<D>(static_cast<float*>(a.dk) + size_t(b) * nk * a.lddkv + hc, a.lddkv, dk_w,
                      a.scale, nk, j0);
    store_rows_f32<D>(static_cast<float*>(a.dv) + size_t(b) * nk * a.lddkv + hc, a.lddkv, dv_w,
                      1.0f, nk, j0);
  }
}

// Kernel 1 (blocks over the Nq query rows, `own_dq` a block) then kernel 2
// (over the Nk keys, `own_dkv` a block) on one stream, with the kernels'
// arguments `args...`.
template <typename K1, typename K2, typename... Args>
cudaError_t launch_pair(K1 dq_kernel, K2 dkv_kernel, int threads, int own_dq, int own_dkv,
                        size_t smem_dq, size_t smem_dkv, const BwdArgs& a, int batch,
                        cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return err;
  dq_kernel<<<block_grid(batch, (a.nq + own_dq - 1) / own_dq, a.num_heads), threads, smem_dq,
              stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<block_grid(batch, (a.nk + own_dkv - 1) / own_dkv, a.num_heads), threads,
               smem_dkv, stream>>>(args...);
  return cudaGetLastError();
}

// The bf16 pair: the tensor maps of q, k, v and g (per image, 64-row
// boxes of HeadTile<D>), then kernel 1 over the Nq query rows, 64 kWg a
// block, and kernel 2 over the Nk keys, DkvPlan<D>::kKeys a block.
template <int D, bool kDrop>
cudaError_t launch_bf16(const BwdArgs& a, int batch, cudaStream_t stream) {
  const int c = a.num_heads * D;
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  if (!head_map<D>(&tm_q, a.q, c, a.ldq, a.nq, batch) ||
      !head_map<D>(&tm_k, a.k, c, a.ldkv, a.nk, batch) ||
      !head_map<D>(&tm_v, a.v, c, a.ldkv, a.nk, batch) ||
      !head_map<D>(&tm_g, a.g, c, a.ldg, a.nq, batch)) {
    return cudaErrorInvalidValue;
  }
  using S = BwdSmem<D>;
  return launch_pair(stream_bwd_dq_bf16<D, kDrop>, stream_bwd_dkv_bf16<D, kDrop>, kThreadsW,
                     64 * kWg, DkvPlan<D>::kKeys, S::kBytesDq, S::kBytesDkv, a, batch, stream,
                     tm_q, tm_k, tm_v, tm_g, a);
}

template <int D, bool kDrop>
cudaError_t launch_f32(const BwdArgs& a, int batch, cudaStream_t stream) {
  return launch_pair(stream_bwd_dq_f32<D, kDrop>, stream_bwd_dkv_f32<D, kDrop>, kThreadsF<D>,
                     kOwnF<D>, kOwnF<D>, kSmemDqF<D>, kSmemDkvF<D>, a, batch, stream, a);
}

// The instantiation of head width D, dtype (0 bf16, 1 f32) and dropout.
template <int D>
cudaError_t launch(const BwdArgs& a, int batch, int dtype, cudaStream_t stream) {
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
// num_heads * head_dim; with_head_dim).
// q, k, v, g, o and dq, dk, dv point at column 0 of head 0 in row 0 of
// image 0; rows lie ldq, ldkv (k and v), ldg, ldo,
// lddq, lddkv (dk and dv) elements apart, and an image is nq consecutive rows
// of q, g, o and dq and nk of k, v, dk and dv. For packed qkv and dqkv
// [B, N, 3C]: k = qkv + C, v = qkv + 2C, all pitches 3C, nq = nk = N; g and o
// (the forward's output) are [B, N, C]. For q and dq [B, Nq, C] and packed kv
// and dkv [B, Nk, 2C]: ldq = lddq = C, ldkv = lddkv = 2C. lse [B, H, Nq] f32
// from the forward; c [B, H, Nq] f32 scratch (the row sums kernel 1 forms
// from g and o and hands to kernel 2; the f32 kernel 1 forms them by a pass
// over the keys and does not read o). bias is [H, Nq, Nk] f32 or null.
// dbias ([H, Nq, ldb] f32 with a pitch ldb >= Nk, a multiple of 4, zeroed by the
// caller) may be null and is then not computed. qv_bias ([3, C] f32) may be
// null. seed (one int64 in device memory, the forward's) null means no
// dropout; otherwise threshold, inv_keep and the batch fold (fold_per,
// fold_total, fold_off) are the forward's. Returns the first failing launch's
// cudaError_t.
int uvit_flash_attention_stream_bwd(const void* q, const void* k, const void* v, const void* g,
                                    const void* o, const void* bias, const void* qv_bias,
                                    const void* lse, void* c, void* dq, void* dk, void* dv,
                                    void* dbias, const void* seed, long long ldq, long long ldkv,
                                    long long ldg, long long ldo, long long lddq, long long lddkv,
                                    int batch, int nq, int nk, int ldb, int num_heads,
                                    int head_dim, int dtype, int fold_per, int fold_total,
                                    int fold_off, float scale, unsigned int threshold,
                                    float inv_keep, void* stream) {
  if (batch < 1 || batch > 65535 || nq < 1 || nk < 1 || ldb < nk || ldb % 4 != 0 ||
      num_heads < 1 || num_heads > 65535 || (nq + 63) / 64 > 65535 || (nk + 63) / 64 > 65535 ||
      !fold_ok(batch, fold_per, fold_total, fold_off, num_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  a.q = q, a.k = k, a.v = v, a.g = g, a.o = o;
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.ldq = ldq, a.ldkv = ldkv, a.ldg = ldg, a.ldo = ldo, a.lddq = lddq, a.lddkv = lddkv;
  a.bias = static_cast<const float*>(bias);
  a.qv_bias = static_cast<const float*>(qv_bias);
  a.lse = static_cast<const float*>(lse);
  a.c = static_cast<float*>(c);
  a.dbias = static_cast<float*>(dbias);
  a.seed = static_cast<const long long*>(seed);
  a.nq = nq, a.nk = nk, a.ldb = ldb, a.num_heads = num_heads;
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
