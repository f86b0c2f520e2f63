// Device code shared by the streaming attention kernels (the forward, and
// the backward's two kernels): type conversions, warp reductions, the q/v
// bias add, cp.async of a bias tile and of single words, and the FMA
// kernels' f32 tile products. Everything here is inlined into its caller;
// nothing is launched from this file. The bf16 kernels' Hopper pieces (TMA,
// mbarriers, wgmma) are in hopper_common.cuh.
//
// The head width D is a template parameter of every kernel: every multiple
// of 16 from 32 to 128 is built (kHeadDimMin .. kHeadDimMax: ViT-B and ViT-L
// are 64, ViT-H 80), and the entry points pick one at launch
// (with_head_dim).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// The head widths the kernels are built for: kHeadDimMin, + kHeadDimStep, ...,
// kHeadDimMax (ops/flash_attention.py:KERNEL_HEAD_DIMS states the same rule,
// and a CPU test reads it here). A wgmma step is 16 deep, so D % 16 == 0.
constexpr int kHeadDimMin = 32, kHeadDimMax = 128, kHeadDimStep = 16;

// fn(std::integral_constant<int, D>{}) for the built width D == head_dim;
// cudaErrorInvalidValue for any other width.
template <int D = kHeadDimMin, typename Fn>
cudaError_t with_head_dim(int head_dim, Fn&& fn) {
  if constexpr (D > kHeadDimMax) {
    return cudaErrorInvalidValue;
  } else {
    if (head_dim == D) return fn(std::integral_constant<int, D>{});
    return with_head_dim<D + kHeadDimStep>(head_dim, fn);
  }
}

// The bytes of shared memory a block may take on an H100 (227 KiB), and an
// SM's (228 KiB, of which the runtime reserves 1 KiB a block).
constexpr size_t kSmemBlockMax = 232448, kSmemSm = 233472, kSmemReserved = 1024;
// How many blocks of `bytes` of dynamic shared memory an SM holds (at most 2).
constexpr int blocks_per_sm(size_t bytes) {
  return 2 * (bytes + kSmemReserved) <= kSmemSm ? 2 : 1;
}

// f32 shared-memory row of one head: an odd number of words (D + 1), so
// column reads are conflict-free.
template <int D>
constexpr int kLdF = D + 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte async copy global → shared (for f32 rows whose pitch is no
// multiple of 16 bytes); src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + rows) of one head's slab (D columns) into
// shared-memory rows of `ld` elements with plain 16-byte loads, zero-filling
// rows >= n and adding the section's q/v bias row (in T) when given. `src` points at the head's
// first column in row 0 of the image; rows lie `ld_src` elements apart, so a
// packed [N, 3C] tensor and a separate [N, C] one are read alike.
template <int D, typename T>
__device__ __forceinline__ void load_slab_rows(T* dst, int ld, const T* src, size_t ld_src,
                                               const float* bias_row, int n, int row0, int rows,
                                               int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < rows * kPerRow; i += nthreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const int row = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&u);
    if (row < n) {
      u = *reinterpret_cast<const uint4*>(src + size_t(row) * ld_src + c);
      if (bias_row != nullptr) add_qv_bias(e, bias_row + c);
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

// Rows [r0, r0 + rows) x columns [c0, c0 + 64) of one head's f32 bias
// (`bias_h` [nr][nc], pitch nc) into a shared tile of `ld` words per row
// with 4-byte cp.async (the model's bias rows lie 4 * N bytes apart, N odd:
// no wider copy can read them as they stand). Thread `tid` of `nthreads` (a
// multiple of 64) copies column tid % 64 of every (nthreads / 64)-th row, so
// a warp copies 32 neighbouring columns of one row, and its addresses only
// step. Entries outside nr x nc are neither read nor written: the tile keeps
// whatever it held there, and every reader masks those rows and columns.
__device__ __forceinline__ void cp_async_bias_tile(float* dst, int ld, const float* bias_h, int nr,
                                                   int nc, int r0, int rows, int c0, int tid,
                                                   int nthreads) {
  const int col = tid & 63, step = nthreads >> 6;
  if (c0 + col >= nc) return;
  const int r_end = min(rows, nr - r0);
  const float* src = bias_h + size_t(r0 + (tid >> 6)) * nc + c0 + col;
  uint32_t d = smem_u32(dst + (tid >> 6) * ld + col);
  const size_t src_step = size_t(step) * nc;
  const uint32_t dst_step = uint32_t(step * ld) * sizeof(float);
#pragma unroll 4
  for (int r = tid >> 6; r < r_end; r += step) {
    cp_async4(d, src, 4);
    src += src_step;
    d += dst_step;
  }
}

// Per-warp f32 tiles of the FMA kernels: a warp owns kRowsF rows; its score
// and accumulator tiles have rows of kLdS<D> words (64 keys or D columns,
// the wider of the two, + 4).
constexpr int kRowsF = 16;
template <int D>
constexpr int kLdS = (D > 64 ? D : 64) + 4;
// The output columns a lane owns in a D-wide f32 tile: lane + 32 i for i <
// kColsF<D> (where 32 does not divide D, the last only for lanes below
// 16).
template <int D>
constexpr int kColsF = (D + 31) / 32;
template <int D>
__device__ __forceinline__ bool own_col(int lane, int i) {
  return D % 32 == 0 || lane + 32 * i < D;
}

// s[kRowsF][64] = a_w[kRowsF][D] . m[64][D]^T (rows of kLdF<D> words); lane
// owns columns lane and lane + 32.
template <int D>
__device__ __forceinline__ void warp_abt_f32(float* s, const float* aw, const float* m) {
  constexpr int ld = kLdF<D>;
  const int lane = threadIdx.x & 31;
  float acc[kRowsF][2];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float m0 = m[lane * ld + d], m1 = m[(lane + 32) * ld + d];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const float a = aw[r * ld + d];
      acc[r][0] = fmaf(a, m0, acc[r][0]);
      acc[r][1] = fmaf(a, m1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    s[r * kLdS<D> + lane] = acc[r][0];
    s[r * kLdS<D> + lane + 32] = acc[r][1];
  }
}

// o[kRowsF][D] += x[kRowsF][64] . m[64][D]; x and o have rows of kLdS<D>
// words, m of kLdF<D>; lane owns output columns lane + 32 i (own_col).
template <int D>
__device__ __forceinline__ void warp_ab_f32(float* o, const float* x, const float* m) {
  constexpr int kCols = kColsF<D>;
  const int lane = threadIdx.x & 31;
  float acc[kRowsF][kCols];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[r][i] = 0.0f;
  for (int j = 0; j < 64; ++j) {
    float mj[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      mj[i] = own_col<D>(lane, i) ? m[j * kLdF<D> + lane + 32 * i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const float xr = x[r * kLdS<D> + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] = fmaf(xr, mj[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (own_col<D>(lane, i)) o[r * kLdS<D> + lane + 32 * i] += acc[r][i];
}

// The streaming kernels' block order: the tile is the fastest block index,
// then the image, then the head. Blocks that run together share what they
// read through L2: the tiles of one (image, head) share its k/v (or q/g), and
// all images of one head follow each other and share the head's bias (4.2 MB
// at N=1025), so the bias is read from device memory once per call.
__device__ __forceinline__ void block_coords(int& b, int& tile, int& h) {
  tile = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
}
inline dim3 block_grid(int batch, int tiles, int heads) { return dim3(tiles, batch, heads); }

// A batch fold (data parallelism): the call's images are a data rank's rows
// [off, off + per) of each fold of `total` images of the batch whose dropout
// mask is drawn (the folded MC-dropout batch tiles the global batch), so its
// image b keys the mask as image (b / per) * total + off + b % per. A block
// maps its image once, on the uniform datapath; (B, B, 0) is the identity.
struct BatchFold {
  int per, total, off;
  __device__ __forceinline__ uint32_t image(int b) const {
    const int f = b / per;
    return uint32_t(f) * uint32_t(total) + uint32_t(off + (b - f * per));
  }
};

// Whether (per, total, off) folds a batch of `batch` images whose keys
// (image * num_heads + head) fit the 32-bit counter word.
inline bool fold_ok(int batch, int per, int total, int off, int num_heads) {
  return per >= 1 && batch % per == 0 && off >= 0 && off <= total - per &&
         (long long)(batch / per) * total * num_heads <= 0xffffffffLL;
}

}  // namespace
