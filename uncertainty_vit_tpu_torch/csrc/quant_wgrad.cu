// Int8 weight gradient (K7), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wgrad_kernel` (uncertainty_vit_tpu/ops/quant.py:
// 216-246), reached through `_wgrad` (:249-287): for x [M, K] and the
// upstream gradient g [M, N] (bf16 or f32) and the reciprocals of their
// column scales (taken outside, :258-259),
//   xq[m, k] = round-half-even(x[m, k] * inv_x[k])
//   gq[m, n] = floor(g[m, n] * inv_g[n] + u(seed, m, n))
//   acc[n, k] = sum_m gq[m, n] * xq[m, k]          (raw int32, exact)
// saturated to [-128, 127]; rows behind M count as zeros (:231-237). The
// column scales factor out of the token sum and are applied outside (:287).
// The result is laid out [N, K], as a torch weight's gradient lies; the
// wrapper hands out its transposed view. The uniforms are those of
// csrc/philox.cuh's rounding stream: a function of (seed, m, n) only, m the
// unsharded row under a row window (quant_common.cuh: RowWindow: a seq
// shard's rows of a data rank's images); the pad
// rows draw nothing.
// |acc| <= 127 * 127 * M stays below 2^31 for M <= 133,152: the wrapper
// stops at 131,072.
//
// What bounds it on an H100: at the ViT-B/16 224 trunk shapes (M = 31,520,
// bf16) qkv is 111.5 GOP (0.056 ms at the int8 peak) and 201 MB (0.060 ms),
// fc1 and fc2 148.7 GOP (0.075 ms) and 251 MB; proj 37.2 GOP and 99 MB
// (0.030 ms, bytes).
//
// Design: two kernels behind one call. The contraction runs over the
// tokens, which are contiguous in neither x nor g, and 8-bit wgmma takes
// both operands only K-major (the contraction contiguous: it has no
// transposed operand for 8-bit types). A block that quantized its own
// operand tiles would draw the rounding bits of g anew for every 256
// columns of x, far more than the product itself costs. So
//   1. `quantize_transpose_kernel` reads a [64 tokens x 64 columns] tile,
//      quantizes each entry once, turns the tile in registers and shared
//      memory (words of 4 tokens; byte stores met eight to a bank) and
//      writes int8 copies xq [K, M'] and gq [N, M'] with the tokens
//      contiguous (M' = M rounded up to 128, the tail zeros): one byte
//      written and read back per entry, against two or four read;
//   2. `wgrad_s8_kernel` is then a plain int8 product acc[N, K] = gq . xq^T
//      on the s8 product core of quant_common.cuh: 128 x 256 tiles of acc in
//      clusters of two (two gq row tiles sharing one xq row tile,
//      multicast), TMA-fed wgmma m64n256k32, 128 tokens a stage. acc has 18
//      to 72 such tiles at ViT-B, too few for 132 SMs, so the tokens are
//      split over persistent clusters as `launch` says, and each adds its
//      partial sums into acc with int32 atomics, a warp's 16 rows 32 columns
//      at a time through shared memory so that each atomic instruction
//      covers a whole 128-byte row segment: exact and free of order, so two
//      runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;              // tile edge of the quantize-transpose kernel
constexpr int kQWords = kQT / 4 + 1;  // its shared row (one column's tokens), 32-bit words

__device__ __forceinline__ void load4(const bf16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}

// src [m, c] -> dst int8 [c, m_pad], entry (row, col) scaled by inv[col] and
// rounded to nearest (kSR false) or stochastically from the seed. A thread
// quantizes 4 tokens x 4 columns of the block's 64 x 64 tile and turns them
// in registers: each of its columns' 4 tokens is one 32-bit word of the
// transposed tile, whose rows (one column's 64 tokens) lie 17 words apart,
// so that the warp's word stores and loads meet at most two to a bank. The
// stochastic rounding draws the bits of each token's unsharded row under
// `win`, located once per block and stepped a token at a time.
template <typename T, bool kSR>
__global__ void __launch_bounds__(kThreads)
quantize_transpose_kernel(const T* __restrict__ src, const float* __restrict__ inv,
                          const long long* __restrict__ seed, int8_t* __restrict__ dst, int m,
                          int m_pad, int c, RowWindow win) {
  __shared__ uint32_t tile[kQT * kQWords];
  const int c0 = blockIdx.x * kQT, m0 = blockIdx.y * kQT;
  const int tid = threadIdx.x;
  const int cq = (tid & 15) * 4;  // this thread's four columns of the tile
  const int tq = (tid >> 4) * 4;  // and four tokens
  float iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) iv[j] = inv[c0 + cq + j];
  philox::Key key{0u, 0u};
  int2 at = make_int2(0, 0);
  if (kSR) {
    key = philox::load_key(seed);
    at = win.locate(m0);
    win.step(at, tq);
  }
  int q[4][4] = {};  // [token][column]
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = m0 + tq + p;
    if (row < m) {
      float f[4];
      load4(src + size_t(row) * c + c0 + cq, f);
      if (kSR) {
        const uint4 w = philox::quant_words(key, uint32_t(win.unsharded(at)),
                                            uint32_t((c0 + cq) >> 2));
        q[p][0] = quant_sr(f[0], iv[0], philox::uniform24(w.x));
        q[p][1] = quant_sr(f[1], iv[1], philox::uniform24(w.y));
        q[p][2] = quant_sr(f[2], iv[2], philox::uniform24(w.z));
        q[p][3] = quant_sr(f[3], iv[3], philox::uniform24(w.w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) q[p][j] = quant_rn(f[j], iv[j]);
      }
    }
    if (kSR) win.step(at, 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tile[(cq + j) * kQWords + tq / 4] = pack_s8x4(q[0][j], q[1][j], q[2][j], q[3][j]);
  }
  __syncthreads();
  const int col = tid >> 2, w0 = (tid & 3) * 4;  // a quarter of one column's tokens
  const uint32_t* from = tile + col * kQWords + w0;
  *reinterpret_cast<uint4*>(dst + size_t(c0 + col) * m_pad + m0 + 4 * w0) =
      make_uint4(from[0], from[1], from[2], from[3]);
}

// acc [n, k] += gq [n, m_pad] . xq [k, m_pad]^T, persistent over the work
// items (token split, pair of 128 x 256 tiles: two gq row tiles against one
// xq row tile), the split slowest, one item a cluster at a time.
__global__ void __launch_bounds__(kGemmThreads, 1)
wgrad_s8_kernel(const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_x, int* __restrict__ acc, int n, int k,
                int chunks, int split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const S8Ring ring = s8_ring(smem_raw);
  const uint32_t rank = cluster_rank();
  const int tiles_k = (k + kTileB - 1) / kTileB;
  const int pairs = cluster_rows(n / kTileA) * tiles_k, items = pairs * split;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int it = 0;

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int i = cluster; i < items; i += clusters) {
        const int p = i % pairs, s = i / pairs;
        const int r0 = (p / tiles_k * kCluster + rank) * kTileA;
        for (int c = s * chunks / split; c < (s + 1) * chunks / split; ++c, ++it) {
          s8_load(ring, it, &map_g, &map_x, c * kDepth, r0, p % tiles_k * kTileB, rank);
        }
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    unsigned char* stage = ring.epi + warp * kEpiBytes;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    for (int i = cluster; i < items; i += clusters) {
      const int p = i % pairs, s = i / pairs;
      s8_mma(d, ring, it, (s + 1) * chunks / split - s * chunks / split, wg);
      // this warp's 16 rows, 32 columns at a time through its staging area,
      // then one atomic add a lane: a whole 128-byte row segment per warp
      const int w0 = (p / tiles_k * kCluster + rank) * kTileA + wg * 64 + (warp & 3) * 16;
#pragma unroll
      for (int cc = 0; cc < kTileB / 32; ++cc) {
        const int c0 = p % tiles_k * kTileB + cc * 32;
        if (c0 < k && w0 < n) {  // k and n are multiples of 128: all inside or all outside
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              *reinterpret_cast<int2*>(stage + (g + 8 * h) * kPitch4 + (8 * jj + 2 * tq) * 4) =
                  make_int2(d[4 * (4 * cc + jj) + 2 * h], d[4 * (4 * cc + jj) + 2 * h + 1]);
            }
          }
          __syncwarp();
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            atomicAdd(acc + size_t(w0 + r) * k + c0 + lane,
                      *reinterpret_cast<const int*>(stage + r * kPitch4 + lane * 4));
          }
          __syncwarp();
        }
      }
    }
  }
  cluster_sync();  // no block leaves while its peer may still signal its barriers
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* inv_x, const float* inv_g,
                   const long long* seed, int8_t* xq, int8_t* gq, int* acc, int m, int m_pad,
                   int k, int n, RowWindow win, cudaStream_t stream) {
  const dim3 grid_x(k / kQT, m_pad / kQT), grid_g(n / kQT, m_pad / kQT);
  quantize_transpose_kernel<T, false><<<grid_x, kThreads, 0, stream>>>(
      static_cast<const T*>(x), inv_x, nullptr, xq, m, m_pad, k, win);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_transpose_kernel<T, true><<<grid_g, kThreads, 0, stream>>>(
      static_cast<const T*>(g), inv_g, seed, gq, m, m_pad, n, win);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap map_g, map_x;
  if (!s8_map(&map_g, gq, m_pad, n, kTileA) || !s8_map(&map_x, xq, m_pad, k, kTileB / 2)) {
    return cudaErrorInvalidValue;
  }
  static int resident[kMaxDevices] = {};
  const int most = resident_clusters(wgrad_s8_kernel, resident);
  // The tokens of every tile pair are split S ways, and the clusters take
  // the (split, pair) items in waves, the split slowest, so that the blocks
  // in flight read the same tokens (a stream-K share-out, one block an SM
  // taking an equal run of the (tile, chunk) sequence, lost up to 10% to L2
  // misses on an H100). A wave lasts an item's chunks and ends with every
  // block adding its 128 x 256 sums with atomics, which cost about kFlush
  // chunks while all blocks add at once (fitted to the sweep of
  // tools/torch_port_wgrad_split.py on an H100).
  constexpr int kFlush = 12;
  const int chunks = m_pad / kDepth;
  const int pairs = cluster_rows(n / kTileA) * ((k + kTileB - 1) / kTileB);
  int split = 1;
  long best = 0;
  for (int s = 1; s <= chunks && s <= 32; ++s) {
    const long cost = long((pairs * s + most - 1) / most) * ((chunks + s - 1) / s + kFlush);
    if (s == 1 || cost < best) best = cost, split = s;
  }
#ifdef UVIT_WGRAD_SPLIT  // a fixed split: tools/torch_port_wgrad_split.py times one build per value
  split = UVIT_WGRAD_SPLIT < chunks ? UVIT_WGRAD_SPLIT : chunks;
#endif
  const int items = pairs * split;
  err = launch_clusters(wgrad_s8_kernel, items < most ? items : most, stream, map_g, map_x, acc,
                        n, k, chunks, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, k] and g [m, n] (dtype: 0 = bf16, 1 = f32), contiguous and 16-byte
// aligned; inv_x f32 [k], inv_g f32 [n]; seed one int64 in device memory; xq
// int8 [k, m_pad] and gq int8 [n, m_pad] scratch (m_pad = m rounded up to
// 128); acc int32 [n, k], zeroed by the caller. k and n are multiples of 128.
// (win_rows, win_start, win_n, win_image0): the row window of g's rounding
// bits, (m, 0, m, 0) for none. Returns the launches' cudaError_t.
int uvit_quant_wgrad(const void* x, const void* g, const void* inv_x, const void* inv_g,
                     const void* seed, void* xq, void* gq, void* acc, int m, int m_pad, int k,
                     int n, int dtype, int win_rows, int win_start, int win_n,
                     int win_image0, void* stream) {
  if (m <= 0 || m_pad < m || m_pad % kDepth != 0 || k <= 0 || n <= 0 || k % 128 != 0 ||
      n % 128 != 0 || seed == nullptr ||
      !window_ok(m, win_rows, win_start, win_n, win_image0))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowWindow win{win_rows, win_start, win_n, win_image0};
  const float* ix = static_cast<const float*>(inv_x);
  const float* ig = static_cast<const float*>(inv_g);
  const long long* sd = static_cast<const long long*>(seed);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  int8_t* gq8 = static_cast<int8_t*>(gq);
  int* out = static_cast<int*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(x, g, ix, ig, sd, xq8, gq8, out, m, m_pad, k, n, win, st);
  if (dtype == 1) return launch<float>(x, g, ix, ig, sd, xq8, gq8, out, m, m_pad, k, n, win, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
