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
// csrc/philox.cuh's rounding stream: a function of (seed, m, n) only.
// |acc| <= 127 * 127 * M stays below 2^31 for M <= 133,152: the wrapper
// stops at 131,072.
//
// What bounds it on an H100: at the ViT-B/16 224 trunk shapes (M = 31,520,
// bf16) qkv is 111.5 GOP (0.056 ms at the int8 peak) and 201 MB (0.060 ms),
// fc1 and fc2 148.7 GOP (0.075 ms) and 251 MB; proj 37.2 GOP and 99 MB
// (0.030 ms, bytes).
//
// Design: two kernels behind one call. The contraction runs over the
// tokens, which are contiguous in neither x nor g, and mma.sync wants both
// int8 operands with the contraction contiguous (ldmatrix.trans moves 16-bit
// units, not bytes). A block that quantized its own operand tiles would draw
// the rounding bits of g anew for every 128 columns of x (K / 128 = 6 to 24
// times at some 25 integer operations an entry), far more than the product
// itself costs. So
//   1. `quantize_transpose_kernel` reads a [64 tokens x 64 columns] tile,
//      quantizes each entry once, turns the tile in shared memory and writes
//      int8 copies xq [K, M'] and gq [N, M'] with the tokens contiguous (M'
//      = M rounded up to 128, the tail zeros): one byte written and read back
//      per entry, against two or four read;
//   2. `wgrad_mm_kernel` is then a plain int8 product acc[N, K] = gq . xq^T:
//      [128 x 128] tiles, [128 x 128] operand tiles (whole 128-byte lines
//      of every row) through a ring of three cp.async stages with one
//      barrier per chunk, eight warps 2 x 4 with 64 x 32 each, the mma.sync
//      m16n8k32 operands straight from shared memory by ldmatrix. dw has at
//      most 18 x 6 tiles, too few for 132 SMs, so the tokens are split over
//      blockIdx.z and each block adds its share with int32 atomics: exact
//      and free of order, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;              // tile edge of the quantize-transpose kernel
constexpr int kQPitch = kQT + 16;    // its shared row (tokens), bytes
constexpr int kTile = 128;           // output tile edge of the product
constexpr int kChunk = 128;          // tokens per stage
constexpr int kPitch = kChunk + 16;  // operand tile row, bytes
constexpr int kOperand = kTile * kPitch;
constexpr int kStage = 2 * kOperand;
constexpr int kStages = 3;

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
// rounded to nearest (kSR false) or stochastically from the seed.
template <typename T, bool kSR>
__global__ void __launch_bounds__(kThreads)
quantize_transpose_kernel(const T* __restrict__ src, const float* __restrict__ inv,
                          const long long* __restrict__ seed, int8_t* __restrict__ dst, int m,
                          int m_pad, int c) {
  __shared__ __align__(16) int8_t tile[kQT * kQPitch];
  const int c0 = blockIdx.x * kQT, m0 = blockIdx.y * kQT;
  const int tid = threadIdx.x;
  const int cq = (tid & 15) * 4;  // this thread's four columns of the tile
  float iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) iv[j] = inv[c0 + cq + j];
  philox::Key key{0u, 0u};
  if (kSR) key = philox::load_key(seed);
#pragma unroll
  for (int p = 0; p < kQT / 16; ++p) {
    const int r = p * 16 + (tid >> 4);
    const int row = m0 + r;
    int q[4] = {0, 0, 0, 0};
    if (row < m) {
      float f[4];
      load4(src + size_t(row) * c + c0 + cq, f);
      if (kSR) {
        const uint4 w = philox::quant_words(key, uint32_t(row), uint32_t((c0 + cq) >> 2));
        q[0] = quant_sr(f[0], iv[0], philox::uniform24(w.x));
        q[1] = quant_sr(f[1], iv[1], philox::uniform24(w.y));
        q[2] = quant_sr(f[2], iv[2], philox::uniform24(w.z));
        q[3] = quant_sr(f[3], iv[3], philox::uniform24(w.w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = quant_rn(f[j], iv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[(cq + j) * kQPitch + r] = static_cast<int8_t>(q[j]);
  }
  __syncthreads();
  const int col = tid >> 2, seg = (tid & 3) * 16;
  *reinterpret_cast<uint4*>(dst + size_t(c0 + col) * m_pad + m0 + seg) =
      *reinterpret_cast<const uint4*>(tile + col * kQPitch + seg);
}

// One chunk of tokens of both operand tiles into a stage.
__device__ __forceinline__ void load_chunk(int8_t* stage, const int8_t* a, const int8_t* b,
                                           int m_pad, int chunk, int tid) {
  for (int i = tid; i < 2 * kTile * (kChunk / 16); i += kThreads) {
    constexpr int kSegs = kChunk / 16;
    const int which = i / (kTile * kSegs), r = (i / kSegs) % kTile, seg = (i % kSegs) * 16;
    const int8_t* src = (which ? b : a) + size_t(r) * m_pad + size_t(chunk) * kChunk + seg;
    cp_async16(smem_u32(stage + which * kOperand + r * kPitch + seg), src);
  }
}

// out[ra, rb] += a [ra, m_pad] . b [rb, m_pad]^T over this block's chunks.
__global__ void __launch_bounds__(kThreads)
wgrad_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int* __restrict__ out,
                int m_pad, int rb, int chunks_per_split) {
  extern __shared__ __align__(16) int8_t stages[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int a0 = blockIdx.y * kTile, b0 = blockIdx.x * kTile;
  const int nchunks = m_pad / kChunk;
  const int begin = blockIdx.z * chunks_per_split;
  const int end = min(nchunks, begin + chunks_per_split);
  if (begin >= end) return;
  const int8_t* at = a + size_t(a0) * m_pad;
  const int8_t* bt = b + size_t(b0) * m_pad;

  constexpr int kMI = 4, kNI = 4;  // a warp's 64 x 32
  const int wa = (warp >> 2) * 64, wb = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  // a group is committed per chunk, empty where there is none, so that the
  // count of groups in flight is the same for every chunk
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (begin + p < end) load_chunk(stages + p * kStage, at, bt, m_pad, begin + p, tid);
    cp_async_commit();
  }
  for (int ch = begin, s = 0; ch < end; ++ch, s = s + 1 == kStages ? 0 : s + 1) {
    cp_async_wait<kStages - 2>();  // all but the newest groups: chunk `ch` has landed
    // chunk `ch` is there for every warp, and every warp is done with chunk
    // `ch - 1`, whose stage is loaded next
    __syncthreads();
    if (ch + kStages - 1 < end)
      load_chunk(stages + (s >= 1 ? s - 1 : kStages - 1) * kStage, at, bt, m_pad,
                 ch + kStages - 1, tid);
    cp_async_commit();
    const int8_t* as = stages + s * kStage;
    const int8_t* bs = as + kOperand;
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      uint32_t af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) load_a_frag(as, kPitch, wa + mi * 16, ks * 32, af[mi]);
#pragma unroll
      for (int ni = 0; ni < kNI; ni += 2) {
        uint32_t bf[4];
        load_b_frags(bs, kPitch, wb + ni * 8, ks * 32, bf);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma_s8(acc[mi][ni], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][ni + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = a0 + wa + mi * 16 + g + 8 * (e >> 1);
        const int col = b0 + wb + ni * 8 + 2 * t + (e & 1);
        atomicAdd(out + size_t(row) * rb + col, acc[mi][ni][e]);
      }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* inv_x, const float* inv_g,
                   const long long* seed, int8_t* xq, int8_t* gq, int* acc, int m, int m_pad,
                   int k, int n, cudaStream_t stream) {
  const dim3 grid_x(k / kQT, m_pad / kQT), grid_g(n / kQT, m_pad / kQT);
  quantize_transpose_kernel<T, false><<<grid_x, kThreads, 0, stream>>>(
      static_cast<const T*>(x), inv_x, nullptr, xq, m, m_pad, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_transpose_kernel<T, true><<<grid_g, kThreads, 0, stream>>>(
      static_cast<const T*>(g), inv_g, seed, gq, m, m_pad, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // Two blocks stand on an SM, and the blocks run in waves of that many. The
  // tokens are split so that the last wave ends soonest: every wave lasts a
  // block's share of the chunks, and every split adds a tile's 16,384
  // atomics, which cost about 1/80 of a chunk's time (fitted to the sweep of
  // tools/torch_port_wgrad_split.py on an H100; a split above 32 never won).
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = (n / kTile) * (k / kTile), nchunks = m_pad / kChunk, slots = 2 * sms;
  int split = 1;
  long best = 0;
  for (int s = 1; s <= nchunks && s <= 32; ++s) {
    const long waves = (long(tiles) * s + slots - 1) / slots;
    const long cost = waves * ((nchunks + s - 1) / s) * 80 + long(s) * tiles;
    if (s == 1 || cost < best) best = cost, split = s;
  }
#ifdef UVIT_WGRAD_SPLIT  // a fixed split: tools/torch_port_wgrad_split.py times one build per value
  split = UVIT_WGRAD_SPLIT < nchunks ? UVIT_WGRAD_SPLIT : nchunks;
#endif
  const int per_split = (nchunks + split - 1) / split;
  split = (nchunks + per_split - 1) / per_split;
  constexpr int kSmem = kStages * kStage;
  err = cudaFuncSetAttribute(wgrad_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  wgrad_mm_kernel<<<dim3(k / kTile, n / kTile, split), kThreads, kSmem, stream>>>(
      gq, xq, acc, m_pad, k, per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, k] and g [m, n] (dtype: 0 = bf16, 1 = f32), contiguous and 16-byte
// aligned; inv_x f32 [k], inv_g f32 [n]; seed one int64 in device memory; xq
// int8 [k, m_pad] and gq int8 [n, m_pad] scratch (m_pad = m rounded up to
// 128); acc int32 [n, k], zeroed by the caller. k and n are multiples of 128.
// Returns the launches' cudaError_t.
int uvit_quant_wgrad(const void* x, const void* g, const void* inv_x, const void* inv_g,
                     const void* seed, void* xq, void* gq, void* acc, int m, int m_pad, int k,
                     int n, int dtype, void* stream) {
  if (m <= 0 || m_pad < m || m_pad % kChunk != 0 || k <= 0 || n <= 0 || k % 128 != 0 ||
      n % 128 != 0 || seed == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ix = static_cast<const float*>(inv_x);
  const float* ig = static_cast<const float*>(inv_g);
  const long long* sd = static_cast<const long long*>(seed);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  int8_t* gq8 = static_cast<int8_t*>(gq);
  int* out = static_cast<int*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(x, g, ix, ig, sd, xq8, gq8, out, m, m_pad, k, n, st);
  if (dtype == 1) return launch<float>(x, g, ix, ig, sd, xq8, gq8, out, m, m_pad, k, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
