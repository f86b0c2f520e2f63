// Quantizing int8 matmul (K6), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (uncertainty_vit_tpu/ops/quant.py:
// 128-141, with `_quantize_rows_tile` :116-125), reached through `_qmm`
// (:144-177): the forward and the dgrad matmul of `int8_dense`. For x [M, K]
// (bf16 or f32), wq [K, N] int8 with column scales ws [N], bias [N] or none:
//   amax_r  = max_k |x[r, k]|, inv_r = 127 / max(amax_r, 1e-30)
//   xq[r,k] = round-half-even(x[r, k] * inv_r)              (forward)
//           = floor(x[r, k] * inv_r + u(seed, r, k))        (dgrad, on g)
//   y[r, c] = float(sum_k xq[r, k] * wq[k, c]) * (amax_r / 127) * ws[c] (+ bias[c])
// saturated to [-128, 127] where floor(. + u) reaches 128, the sum exact in
// int32, the products and the bias add in f32 in this order, one rounding to
// the output type. The uniforms are those of csrc/philox.cuh's rounding
// stream: a function of (seed, r, k), never of the tile.
//
// What bounds it on an H100: at the ViT-B/16 224 trunk shapes (M = 31,520
// tokens at batch 160, bf16 in and out) qkv is 111.5 GOP and 195 MB, fc1 and
// fc2 148.7 GOP and 245 MB: about the same time by operations at the int8
// peak (0.056, 0.075 ms) and by bytes (0.058, 0.073 ms); proj (37.2 GOP,
// 97 MB) is bound by bytes (0.029 ms). The int8 copy of x that this design
// writes and reads back adds 2 M K bytes (0.015 ms at qkv).
//
// Design: two kernels behind one call.
//   1. `quantize_rows_kernel` (memory-bound): a warp per row reads the row
//      once into registers (3, 6 or 12 16-byte vectors a lane, as the row
//      needs, up to K = 3072 in bf16; the rest of a wider row is read again,
//      from L1/L2), takes its absolute maximum, and writes the row's int8
//      copy xq [M, K] and its scale amax / 127 [M] into scratch the wrapper
//      allocates. The rows are quantized once, whatever the output's width.
//      Registers held for nothing cost blocks an SM: 12 vectors at K = 768
//      took 0.041 ms against 3's 0.027 on an H100.
//   2. `qmm_s8_kernel`: the s8 product core of quant_common.cuh over xq and
//      the weight's int8 copy as it lies ([N, K], the contraction
//      contiguous: both operands K-major, which 8-bit wgmma requires), 128 x
//      256 output tiles, TMA-fed wgmma m64n256k32 from a four-stage ring,
//      the depth streamed, so K has no limit of its own. Blocks run in
//      clusters of two (two row tiles that share one column tile's weight
//      rows, multicast) and are persistent (one an SM): the clusters walk
//      the (row pair, column tile) grid with the column tile fastest, so
//      that the blocks in flight share a few bands of xq rows and the whole
//      weight in L2. The producer warp copies each tile's column scales,
//      bias and row scales into shared memory and runs on into the next
//      tile's stages while the consumers dequantize this one's accumulator:
//      float(acc) * row scale * ws (+ bias), one rounding, a warp's 16 rows
//      a 128-byte chunk of columns at a time through shared memory, so that
//      each store writes whole 128-byte row segments. The product runs at
//      about nine tenths of the int8 peak; the epilogue does not overlap it
//      and takes some 40% of a tile at K = 768 (stored from the fragments,
//      16 bytes a row, it took longer than the product; its factors read
//      from global memory with 128 accumulator registers live, a third
//      longer). Rows past M are masked; TMA brings them, and columns past N,
//      as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "quant_common.cuh"

namespace {

constexpr int kRowThreads = 256;  // a warp per row
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

template <typename T>
__device__ __forceinline__ float vec_amax(const uint4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
  float a = 0.0f;
#pragma unroll
  for (int j = 0; j < Vec16<T>::kN; ++j) a = fmaxf(a, fabsf(to_f32(e[j])));
  return a;
}

// 16 bytes of row `row` from column c on, quantized into dst.
template <typename T, bool kSR>
__device__ __forceinline__ void quantize_vec(const uint4& v, int8_t* dst, float inv,
                                             philox::Key key, int row, int c) {
  constexpr int kVec = Vec16<T>::kN;
  const T* e = reinterpret_cast<const T*>(&v);
  uint32_t w[kVec / 4];
#pragma unroll
  for (int j = 0; j < kVec; j += 4) {
    int q[4];
    if constexpr (kSR) {
      const uint4 u = philox::quant_words(key, uint32_t(row), uint32_t((c + j) >> 2));
      q[0] = quant_sr(to_f32(e[j + 0]), inv, philox::uniform24(u.x));
      q[1] = quant_sr(to_f32(e[j + 1]), inv, philox::uniform24(u.y));
      q[2] = quant_sr(to_f32(e[j + 2]), inv, philox::uniform24(u.z));
      q[3] = quant_sr(to_f32(e[j + 3]), inv, philox::uniform24(u.w));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = quant_rn(to_f32(e[j + i]), inv);
    }
    w[j / 4] = pack_s8x4(q[0], q[1], q[2], q[3]);
  }
  if constexpr (kVec == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// x [m, k] -> xq int8 [m, k] and row_scale f32 [m] (= amax / 127). A lane
// keeps kHeld 16-byte vectors of its row in registers, no more than the row
// needs: registers held for nothing cost blocks an SM, and loads in flight.
template <typename T, bool kSR, int kHeld>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const T* __restrict__ x, const long long* __restrict__ seed,
                     int8_t* __restrict__ xq, float* __restrict__ row_scale, int m, int k) {
  constexpr int kVec = Vec16<T>::kN;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* src = x + size_t(row) * k;
  int8_t* dst = xq + size_t(row) * k;
  // every load of the held part is in flight at once: the pass is bound by
  // latency unless a lane keeps several 16-byte loads outstanding
  uint4 v[kHeld];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < k) {
      v[i] = *reinterpret_cast<const uint4*>(src + c);
      amax = fmaxf(amax, vec_amax<T>(v[i]));
    }
  }
  for (int c = (kHeld * 32 + lane) * kVec; c < k; c += 32 * kVec) {
    amax = fmaxf(amax, vec_amax<T>(*reinterpret_cast<const uint4*>(src + c)));
  }
  amax = warp_max(amax);
  const float inv = __fdiv_rn(127.0f, fmaxf(amax, 1e-30f));
  if (lane == 0) row_scale[row] = __fmul_rn(amax, kInv127);
  philox::Key key{0u, 0u};
  if constexpr (kSR) key = philox::load_key(seed);
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < k) quantize_vec<T, kSR>(v[i], dst + c, inv, key, row, c);
  }
  for (int c = (kHeld * 32 + lane) * kVec; c < k; c += 32 * kVec) {
    quantize_vec<T, kSR>(*reinterpret_cast<const uint4*>(src + c), dst + c, inv, key, row, c);
  }
}

// y [m, n] = dequant(xq [m, k] . wq [n, k]^T) (+ bias), persistent over
// pairs of 128 x 256 output tiles (two row tiles, one column tile), one pair
// a cluster.
template <bool kF32Out>
__global__ void __launch_bounds__(kGemmThreads, 1)
qmm_s8_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const float* __restrict__ row_scale, const float* __restrict__ ws,
              const float* __restrict__ bias, void* __restrict__ y, int m, int k, int n) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const S8Ring ring = s8_ring(smem_raw);
  const uint32_t rank = cluster_rank();
  const int tiles_n = (n + kTileB - 1) / kTileB;
  const int pairs = cluster_rows((m + kTileA - 1) / kTileA) * tiles_n;
  const int chunks = k / kDepth;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int it = 0;

  if (warp == kConsumerWarps) {  // the producer
    for (int p = cluster, q = 0; p < pairs; p += clusters, ++q) {
      // the whole warp copies the tile's dequantizing factors, its lane 0
      // then has TMA bring the tile's stages
      const int r0 = (p / tiles_n * kCluster + rank) * kTileA, c0 = p % tiles_n * kTileB;
      float* sc = ring.scales + (q & 1) * kScaleFloats;
      mbar_wait(&ring.sc_empty[q & 1], ((q >> 1) & 1) ^ 1);
      for (int i = lane; i < kTileB; i += 32) {
        sc[i] = c0 + i < n ? ws[c0 + i] : 0.0f;
        sc[kTileB + i] = c0 + i < n && bias != nullptr ? bias[c0 + i] : 0.0f;
      }
      for (int i = lane; i < kTileA; i += 32) {
        sc[2 * kTileB + i] = r0 + i < m ? row_scale[r0 + i] : 0.0f;
      }
      mbar_arrive(&ring.sc_full[q & 1]);
      if (lane == 0) {
        for (int c = 0; c < chunks; ++c, ++it) {
          s8_load(ring, it, &map_x, &map_w, c * kDepth, r0, c0, rank);
        }
      }
      __syncwarp();
    }
  } else {
    constexpr int kE = kF32Out ? 4 : 2;  // bytes of an output value
    constexpr int kPitch = kF32Out ? kPitch4 : kPitch2;
    constexpr int kCols = 128 / kE;  // columns of a staged chunk
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    unsigned char* stage = ring.epi + warp * kEpiBytes;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int p = cluster, q = 0; p < pairs; p += clusters, ++q) {
      s8_mma(acc, ring, it, chunks, wg);
      // this warp's 16 rows, dequantized a chunk of columns at a time into
      // its staging area, then stored a whole 128-byte row segment per 8 lanes
      const int r_in = wg * 64 + (warp & 3) * 16;  // the warp's first row in the tile
      const int w0 = (p / tiles_n * kCluster + rank) * kTileA + r_in;
      const float* sc_tile = ring.scales + (q & 1) * kScaleFloats;
      mbar_wait(&ring.sc_full[q & 1], (q >> 1) & 1);
      float sa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) sa[h] = sc_tile[2 * kTileB + r_in + g + 8 * h];
#pragma unroll
      for (int cc = 0; cc < kTileB / kCols; ++cc) {
        const int c0 = p % tiles_n * kTileB + cc * kCols;
        if (c0 < n) {  // n is a multiple of 128: a chunk lies wholly inside or outside
#pragma unroll
          for (int jj = 0; jj < kCols / 8; ++jj) {
            const int j = cc * (kCols / 8) + jj;
            const int col = cc * kCols + 8 * jj + 2 * tq;  // in the tile
            const float2 sc = *reinterpret_cast<const float2*>(sc_tile + col);
            const float2 bc = *reinterpret_cast<const float2*>(sc_tile + kTileB + col);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sa[h]), sc.x);
              float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sa[h]), sc.y);
              if (bias != nullptr) v0 = __fadd_rn(v0, bc.x), v1 = __fadd_rn(v1, bc.y);
              unsigned char* at = stage + (g + 8 * h) * kPitch + (8 * jj + 2 * tq) * kE;
              if constexpr (kF32Out) {
                *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(v0, v1);
              }
            }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * i + (lane >> 3);
            const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kPitch + (lane & 7) * 16);
            if (w0 + r < m) {
              *reinterpret_cast<uint4*>(static_cast<unsigned char*>(y) +
                                        (size_t(w0 + r) * n + c0) * kE + (lane & 7) * 16) = v;
            }
          }
          __syncwarp();
        }
      }
      if (lane == 0) mbar_arrive(&ring.sc_empty[q & 1]);
    }
  }
  cluster_sync();  // no block leaves while its peer may still signal its barriers
}

template <typename T, int kHeld>
cudaError_t quantize_rows_held(const void* x, const long long* seed, int8_t* xq, float* row_scale,
                               int m, int k, cudaStream_t stream) {
  const int blocks = (m + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (seed != nullptr) {
    quantize_rows_kernel<T, true, kHeld><<<blocks, kRowThreads, 0, stream>>>(
        static_cast<const T*>(x), seed, xq, row_scale, m, k);
  } else {
    quantize_rows_kernel<T, false, kHeld><<<blocks, kRowThreads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, xq, row_scale, m, k);
  }
  return cudaGetLastError();
}

// Rows of up to 768 (bf16) or 384 (f32) entries held in 3 vectors a lane,
// twice that in 6, and 12 for every wider row (the rest read twice).
template <typename T>
cudaError_t quantize_rows(const void* x, const long long* seed, int8_t* xq, float* row_scale,
                          int m, int k, cudaStream_t stream) {
  constexpr int kLane = 32 * Vec16<T>::kN;  // entries a warp's vector covers
  if (k <= 3 * kLane) return quantize_rows_held<T, 3>(x, seed, xq, row_scale, m, k, stream);
  if (k <= 6 * kLane) return quantize_rows_held<T, 6>(x, seed, xq, row_scale, m, k, stream);
  return quantize_rows_held<T, 12>(x, seed, xq, row_scale, m, k, stream);
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* ws, const float* bias,
                   const long long* seed, void* y, int8_t* xq, float* row_scale, int m, int k,
                   int n, int y_is_f32, cudaStream_t stream) {
  cudaError_t err = quantize_rows<T>(x, seed, xq, row_scale, m, k, stream);
  if (err != cudaSuccess) return err;

  CUtensorMap map_x, map_w;
  if (!s8_map(&map_x, xq, k, m, kTileA) || !s8_map(&map_w, wq, k, n, kTileB / 2)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = y_is_f32 ? qmm_s8_kernel<true> : qmm_s8_kernel<false>;
  static int resident[2][kMaxDevices] = {};
  const int most = resident_clusters(kernel, resident[y_is_f32 ? 1 : 0]);
  const int pairs = cluster_rows((m + kTileA - 1) / kTileA) * ((n + kTileB - 1) / kTileB);
  err = launch_clusters(kernel, pairs < most ? pairs : most, stream, map_x, map_w, row_scale,
                        ws, bias, y, m, k, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, k] (x_dtype: 0 = bf16, 1 = f32), contiguous and 16-byte aligned; wq
// int8 [n, k] (the contraction contiguous), 16-byte aligned; ws f32 [n];
// bias f32 [n] or null; seed one int64 in device memory when sr, else
// unused; y [m, n] (y_dtype likewise); xq int8 [m, k] (16-byte aligned) and
// row_scale f32 [m] scratch. k and n are multiples of 128. Returns the
// launches' cudaError_t.
int uvit_quant_fwd(const void* x, const void* wq, const void* ws, const void* bias,
                   const void* seed, void* y, void* xq, void* row_scale, int m, int k, int n,
                   int x_dtype, int y_dtype, int sr, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 128 != 0 || n % 128 != 0 || (sr && seed == nullptr) ||
      y_dtype < 0 || y_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  const long long* sd = sr ? static_cast<const long long*>(seed) : nullptr;
  int8_t* q = static_cast<int8_t*>(xq);
  float* rs = static_cast<float*>(row_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch<bf16>(x, w, s, b, sd, y, q, rs, m, k, n, y_dtype, st);
  if (x_dtype == 1) return launch<float>(x, w, s, b, sd, y, q, rs, m, k, n, y_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
