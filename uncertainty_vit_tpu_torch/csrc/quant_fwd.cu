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
// 97 MB) is bound by bytes (0.029 ms).
//
// Design. A row's scale needs the whole row before its first value can be
// quantized, and quantizing costs some eight instructions an entry (about
// thirty with the rounding bits), against 1/32 of a tensor-core instruction
// an entry and 128 output columns. So a block quantizes its rows ONCE: it
// owns BM whole rows of x (64 up to K = 3072, 32 up to 6272), keeps them as
// int8 in shared memory (a warp per BM / 8 rows, all
// of them in flight together: one pass for the maxima, a second, served by
// the caches, that quantizes) and then walks over ALL output columns, 128 at
// a time, streaming [128 x 128] weight tiles (whole 128-byte lines of every
// row; [128 x 64] where the deeper tile does not fit beside the rows, at
// K = 3072) through a ring of three cp.async stages with one barrier per
// tile. The weight is stored with the contraction contiguous ([N, K], a
// torch weight as it lies), so the mma.sync m16n8k32 operands come straight
// from shared memory by ldmatrix; row pitches of 16 bytes over K and over
// the tile's depth keep those loads free of bank conflicts. Eight warps
// split the tile 2 x 4 (1 x 8 below 64 rows). Rows behind M are zeros in
// shared memory and are never written. The product runs at about a sixth of
// the card's int8 peak; wgmma, TMA and persistence are a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;             // output columns per tile
constexpr int kPad = 16;             // behind a resident row of K bytes and a weight tile's row
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;     // 227 KB
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

template <int BM>
struct Tiling {
  static constexpr int kWarpsM = BM >= 64 ? 2 : 1;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;
  static constexpr int kWN = kBN / kWarpsN;
  static constexpr int kMI = kWM / 16;
  static constexpr int kNI = kWN / 8;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// BM resident rows, kStages weight tiles [128 x bk bytes], BM row scales.
inline size_t smem_bytes(int bm, int k, int bk) {
  return size_t(bm) * (k + kPad) + size_t(kStages) * kBN * (bk + kPad) +
         size_t(bm) * sizeof(float);
}

// The walk over the weight's [128 x BK] tiles: column tile `nt`, contraction
// chunk `kc`, the chunk fastest.
struct TileWalk {
  int nt, kc;
  __device__ __forceinline__ void next(int kchunks) {
    if (++kc == kchunks) kc = 0, ++nt;
  }
};

// One tile of the [N, K] weight into a stage.
template <int BK>
__device__ __forceinline__ void load_w_tile(int8_t* stage, const int8_t* wq, int k, TileWalk at,
                                            int tid) {
  constexpr int kSegs = BK / 16;
  const int8_t* src = wq + size_t(at.nt) * kBN * k + at.kc * BK;
  for (int i = tid; i < kBN * kSegs; i += kThreads) {
    const int r = i / kSegs, seg = (i % kSegs) * 16;
    cp_async16(smem_u32(stage + r * (BK + kPad) + seg), src + size_t(r) * k + seg);
  }
}

template <typename T, int BM, int BK>
__global__ void __launch_bounds__(kThreads)
quant_fwd_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    const long long* __restrict__ seed, void* __restrict__ y, int m, int k, int n,
                    int y_is_f32) {
  using TL = Tiling<BM>;
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kWPitch = BK + kPad, kWTile = kBN * kWPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = k + kPad;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  int8_t* wt = xq + size_t(BM) * pitch;
  float* row_scale = reinterpret_cast<float*>(wt + kStages * kWTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int kchunks = k / BK, total = kchunks * (n / kBN);

  // the first weight tiles travel while the rows are quantized (a group is
  // committed per tile, empty where there is none, so that the count of
  // groups in flight is the same for every tile)
  TileWalk loading{0, 0};
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < total) load_w_tile<BK>(wt + p * kWTile, wq, k, loading, tid);
    cp_async_commit();
    loading.next(kchunks);
  }

  // ---- phase 1: BM whole rows of x -> int8 in shared memory. A warp owns
  // BM / 8 neighbouring rows and walks them together, so that a lane has one
  // 16-byte load of every row in flight at once: the pass is bound by
  // latency, not by bytes. Rows behind M read the last row and store zeros.
  constexpr int kRows = BM / kWarps;
  const bool sr = seed != nullptr;
  philox::Key key{0u, 0u};
  if (sr) key = philox::load_key(seed);
  const int r0 = warp * kRows;
  const T* src[kRows];
  float amax[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    src[i] = x + size_t(min(row0 + r0 + i, m - 1)) * k;
    amax[i] = 0.0f;
  }
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    uint4 v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = *reinterpret_cast<const uint4*>(src[i] + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) amax[i] = fmaxf(amax[i], fabsf(to_f32(e[j])));
    }
  }
  float inv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    amax[i] = warp_max(amax[i]);
    const bool valid = row0 + r0 + i < m;
    inv[i] = valid ? __fdiv_rn(127.0f, fmaxf(amax[i], 1e-30f)) : 0.0f;
    if (lane == 0) row_scale[r0 + i] = valid ? __fmul_rn(amax[i], kInv127) : 0.0f;
  }
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    uint4 v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = *reinterpret_cast<const uint4*>(src[i] + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
      const int row = row0 + r0 + i;
      int q[kVec];
      if (row >= m) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) q[j] = 0;
      } else if (sr) {
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const uint4 w = philox::quant_words(key, uint32_t(row), uint32_t((c + j) >> 2));
          q[j + 0] = quant_sr(to_f32(e[j + 0]), inv[i], philox::uniform24(w.x));
          q[j + 1] = quant_sr(to_f32(e[j + 1]), inv[i], philox::uniform24(w.y));
          q[j + 2] = quant_sr(to_f32(e[j + 2]), inv[i], philox::uniform24(w.z));
          q[j + 3] = quant_sr(to_f32(e[j + 3]), inv[i], philox::uniform24(w.w));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) q[j] = quant_rn(to_f32(e[j]), inv[i]);
      }
      int8_t* dst = xq + size_t(r0 + i) * pitch + c;
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<uint32_t*>(dst + j) = pack_s8x4(q[j], q[j + 1], q[j + 2], q[j + 3]);
    }
  }

  // ---- phase 2: all output columns, 128 at a time
  const int wm = (warp / TL::kWarpsN) * TL::kWM;
  const int wn = (warp % TL::kWarpsN) * TL::kWN;
  const int g = lane >> 2, t = lane & 3;
  int acc[TL::kMI][TL::kNI][4];
#pragma unroll
  for (int mi = 0; mi < TL::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::kNI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  TileWalk at{0, 0};
  for (int it = 0, stage = 0; it < total; ++it, stage = stage + 1 == kStages ? 0 : stage + 1) {
    cp_async_wait<kStages - 2>();  // all but the newest groups: tile `it` has landed
    // tile `it` is there for every warp (the first time, the rows too), and
    // every warp is done with tile `it - 1`, whose stage is loaded next
    __syncthreads();
    if (it + kStages - 1 < total) {
      load_w_tile<BK>(wt + (stage >= 1 ? stage - 1 : kStages - 1) * kWTile, wq, k, loading, tid);
      loading.next(kchunks);
    }
    cp_async_commit();
    const int8_t* wtile = wt + stage * kWTile;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[TL::kMI][4];
#pragma unroll
      for (int mi = 0; mi < TL::kMI; ++mi)
        load_a_frag(xq, pitch, wm + mi * 16, at.kc * BK + ks * 32, a[mi]);
#pragma unroll
      for (int ni = 0; ni < TL::kNI; ni += 2) {
        uint32_t b[4];
        load_b_frags(wtile, kWPitch, wn + ni * 8, ks * 32, b);
#pragma unroll
        for (int mi = 0; mi < TL::kMI; ++mi) {
          mma_s8(acc[mi][ni], a[mi], b[0], b[1]);
          mma_s8(acc[mi][ni + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (at.kc == kchunks - 1) {
      // epilogue of this column tile: dequantize, bias, one rounding, store
      const int col0 = at.nt * kBN + wn + 2 * t;
#pragma unroll
      for (int ni = 0; ni < TL::kNI; ++ni) {
        const int col = col0 + ni * 8;
        const float s0 = ws[col], s1 = ws[col + 1];
        float b0 = 0.0f, b1 = 0.0f;
        if (bias != nullptr) b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int mi = 0; mi < TL::kMI; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm + mi * 16 + g + 8 * half;
            const int row = row0 + r;
            if (row < m) {
              const float sa = row_scale[r];
              float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half]), sa), s0);
              float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), sa), s1);
              if (bias != nullptr) v0 = __fadd_rn(v0, b0), v1 = __fadd_rn(v1, b1);
              const size_t at = size_t(row) * n + col;
              if (y_is_f32) {
                *reinterpret_cast<float2*>(static_cast<float*>(y) + at) = make_float2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + at) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
            acc[mi][ni][2 * half] = acc[mi][ni][2 * half + 1] = 0;
          }
        }
      }
    }
    at.next(kchunks);
  }
}

template <typename T, int BM, int BK>
cudaError_t launch(const void* x, const int8_t* wq, const float* ws, const float* bias,
                   const long long* seed, void* y, int m, int k, int n, int y_is_f32,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, k, BK);
  auto kernel = quant_fwd_kernel<T, BM, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((m + BM - 1) / BM), kThreads, smem, stream>>>(
      static_cast<const T*>(x), wq, ws, bias, seed, y, m, k, n, y_is_f32);
  return cudaGetLastError();
}

template <typename T, int BM, typename... Args>
cudaError_t launch_depth(bool deep, Args... args) {
  return deep ? launch<T, BM, 128>(args...) : launch<T, BM, 64>(args...);
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* wq, const float* ws, const float* bias,
                     const long long* seed, void* y, int m, int k, int n, int y_is_f32,
                     cudaStream_t stream) {
  // the most rows whose int8 copy fits beside the weight stages, then the
  // deeper weight tile where that fits too
  const int bm = smem_bytes(64, k, 64) <= size_t(kMaxSmem) ? 64 : 32;
  if (smem_bytes(bm, k, 64) > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  const bool deep = smem_bytes(bm, k, 128) <= size_t(kMaxSmem);
  if (bm == 64)
    return launch_depth<T, 64>(deep, x, wq, ws, bias, seed, y, m, k, n, y_is_f32, stream);
  return launch_depth<T, 32>(deep, x, wq, ws, bias, seed, y, m, k, n, y_is_f32, stream);
}

}  // namespace

extern "C" {

// x [m, k] (x_dtype: 0 = bf16, 1 = f32), contiguous and 16-byte aligned; wq
// int8 [n, k] (the contraction contiguous); ws f32 [n]; bias f32 [n] or
// null; seed one int64 in device memory when sr, else unused; y [m, n]
// (y_dtype likewise). k and n are multiples of 128. Returns the launch's
// cudaError_t.
int uvit_quant_fwd(const void* x, const void* wq, const void* ws, const void* bias,
                      const void* seed, void* y, int m, int k, int n, int x_dtype, int y_dtype,
                      int sr, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 128 != 0 || n % 128 != 0 || (sr && seed == nullptr) ||
      y_dtype < 0 || y_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  const long long* sd = sr ? static_cast<const long long*>(seed) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch<bf16>(x, w, s, b, sd, y, m, k, n, y_dtype, st);
  if (x_dtype == 1) return dispatch<float>(x, w, s, b, sd, y, m, k, n, y_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
