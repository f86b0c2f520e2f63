// Fused inverted dropout with in-kernel random bits, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (uncertainty_vit_tpu/ops/dropout.py:
// 43-51), reached through `fused_dropout` (:78-104): the dropout of the
// MC-dropout evaluation at the attention-projection and MLP-fc2 sites
// (uncertainty_vit_tpu/models/layers.py:66-77). Per element i of x:
//   bits = philox(seed, i)                       (csrc/philox.cuh)
//   y[i] = bits >= threshold ? x[i] * 1/(1 - rate) : 0
// with the product taken in f32 and rounded once to the output type, as the
// TPU kernel does (:49-51). Forward only, as in the reference (:18-20).
//
// What bounds it on an H100: bytes. At the MC-dropout shape of ViT-B/16 224
// (K=8 samples of batch 128 folded: x is [1024 * 197, 768] bf16, 155M
// elements) the call reads 310 MB and writes 310 MB: 0.185 ms at 3.35 TB/s.
// The bits are 38.7M Philox calls, ~2 G integer operations, ~0.03 ms of the
// card's integer rate, so a kernel that moves 16 bytes per thread per access
// and keeps enough of them in flight stays on the memory bound. A mask drawn
// outside the kernel would add a third pass over a tensor of the same size.
//
// Design: no state, no order. One thread per 16 bytes of x (8 bf16 or 4 f32
// elements, so two or one Philox calls per thread), one load and one store
// of 16 bytes each; a pointer that is not 16-byte aligned or the ragged end
// of the tensor goes element by element. The mask is keyed on the element's
// flat index, not on the block: any grid, vector width or split of the
// tensor draws the same mask (the TPU reseeds per program, so its mask
// follows its row blocks, :44).
//
// A row window (sequence parallelism): x is [G, rows, C], rows [start,
// start + rows) of a sequence of n tokens, and element (g, r, c) takes the
// bits of the unsharded flat index (g * n + start + r) * C + c, so a rank's
// mask is the unsharded run's over its rows. Each slab g of rows * C
// elements maps onto one contiguous range of unsharded indices starting at
// g * n * C + start * C, so the grid's y (and z) dimensions walk the slabs
// and the index map costs no division: a block's 64-bit multiply-add and a
// thread's 32-bit offset. The flat call is the same kernel over one slab.
// Where C is a multiple of the vector width (8 bf16 / 4 f32) a 16-byte chunk
// never crosses a row and a slab starts a Philox group, so the vector path
// stays; other windows go element by element.
//
// A batch fold (data parallelism): a data rank holds rows [off, off + b) of
// each fold of B rows of the unsharded batch (the MC-dropout batch tiles the
// global batch K times: local group g = k * b + i is unsharded k * B + off +
// i). The slab index g then maps to (g / b) * B + off + g % b before the
// window's map: one division a block, on the uniform datapath. Without a
// data axis b = B = groups and off = 0, the identity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

template <typename T>
__device__ __forceinline__ T drop_one(T x, uint32_t bits, uint32_t threshold, float inv_keep) {
  return bits >= threshold ? from_f32<T>(to_f32(x) * inv_keep) : from_f32<T>(0.0f);
}

// Element (g, j) of x [groups, slab] takes the bits of the unsharded flat
// index G * stride + base + j, G = (g / fold_b) * fold_B + fold_off +
// g % fold_b (the batch fold; the identity without one); the grid's y and z
// dimensions walk the slabs
// (g = z * gridDim.y + y), its x dimension a slab's blocks of kThreads * kVec
// elements. The flat call is one slab (groups = 1, stride = base = 0). All
// 64-bit index arithmetic is per block (the uniform datapath); a thread adds
// its 32-bit offset. kVector: 16-byte accesses, so base, stride are multiples
// of 4 (a chunk starts a Philox group) and, with more than one slab, slab is
// a whole number of 16-byte chunks; a chunk that runs past the end of its
// slab goes element by element. Eight blocks an SM hold 32 registers a
// thread (the whole register file, 2048 threads): the 16-byte path then
// spills 36 bytes a thread (to L1), and is still ~4% faster than at nvcc's
// own choice, 40 registers, six blocks an SM.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads, 8)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long groups, long long slab,
               long long stride, long long base, long long fold_b, long long fold_B,
               long long fold_off, const long long* __restrict__ seed, uint32_t threshold,
               float inv_keep) {
  constexpr int kVec = kVector ? 16 / int(sizeof(T)) : 4;  // elements per thread
  constexpr int kBlock = kThreads * kVec;
  const long long g = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long first = (long long)blockIdx.x * kBlock;  // the block's first element
  if (g >= groups) return;
  const int count = int(min((long long)kBlock, slab - first));  // the block's elements
  const int j = int(threadIdx.x) * kVec;
  if (j >= count) return;
  const philox::Key key = philox::load_key(seed);
  const T* xb = x + (g * slab + first);
  T* yb = y + (g * slab + first);
  // the unsharded slab of this one (the batch fold), and the unsharded index
  // of the block's first element
  const long long ug = (g / fold_b) * fold_B + fold_off + g % fold_b;
  const unsigned long long u0 = (unsigned long long)(ug * stride + base + first);
  if (kVector && j + kVec <= count) {  // u0 % 4 == 0: j / 4 counts Philox groups
    uint4 u = *reinterpret_cast<const uint4*>(xb + j);
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const uint4 w = philox::dropout_words(key, (u0 >> 2) + (j >> 2) + q);
      e[4 * q + 0] = drop_one(e[4 * q + 0], w.x, threshold, inv_keep);
      e[4 * q + 1] = drop_one(e[4 * q + 1], w.y, threshold, inv_keep);
      e[4 * q + 2] = drop_one(e[4 * q + 2], w.z, threshold, inv_keep);
      e[4 * q + 3] = drop_one(e[4 * q + 3], w.w, threshold, inv_keep);
    }
    // one 16-byte store: written as `*(uint4*)p = u`, nvcc splits it into
    // four 4-byte stores here, ~10% of the call
    __stwb(reinterpret_cast<uint4*>(yb + j), u);
    return;
  }
  // i0 may fall inside a Philox group: a new call where one starts
  const unsigned long long i0 = u0 + j;
  uint4 w = philox::dropout_words(key, i0 >> 2);
  for (int k = 0; k < kVec && j + k < count; ++k) {
    const unsigned long long i = i0 + k;
    if (k > 0 && (i & 3) == 0) w = philox::dropout_words(key, i >> 2);
    yb[j + k] = drop_one(xb[j + k], word_of(w, int(i & 3)), threshold, inv_keep);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long groups, long long slab, long long stride,
                   long long base, long long fold_b, long long fold_B, long long fold_off,
                   const long long* seed, uint32_t threshold, float inv_keep,
                   cudaStream_t stream) {
  const int vec = 16 / int(sizeof(T));
  const bool vector = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 && stride % 4 == 0 &&
                      base % 4 == 0 && (groups == 1 || slab % vec == 0);
  const int per = vector ? vec : 4;
  const long long blocks = ((slab + per - 1) / per + kThreads - 1) / kThreads;
  const long long ys = groups < 65535 ? groups : 65535, zs = (groups + ys - 1) / ys;
  if (blocks > 0x7fffffffLL || zs > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)ys, (unsigned)zs);
  const T* xs = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  if (vector) {
    dropout_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xs, yo, groups, slab, stride, base, fold_b, fold_B, fold_off, seed, threshold, inv_keep);
  } else {
    dropout_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xs, yo, groups, slab, stride, base, fold_b, fold_B, fold_off, seed, threshold, inv_keep);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. x and y hold groups * slab contiguous
// elements; element (g, j) takes the bits of flat index G * stride + base +
// j with G = (g / fold_b) * fold_B + fold_off + g % fold_b: the flat call is
// (1, numel, 0, 0) with the fold (1, 1, 0), a row window of x [G, rows, C]
// over a sequence of n tokens from row start is (G, rows * C, n * C,
// start * C), and a data rank's rows [off, off + b) of each fold of B rows
// are the fold (b, B, off) (the identity fold is (G, G, 0)).
// seed is one int64 in device memory; threshold = min(int(rate * 2^32),
// 2^32 - 1); inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
int uvit_dropout(const void* x, void* y, long long groups, long long slab, long long stride,
                 long long base, long long fold_b, long long fold_B, long long fold_off,
                 const void* seed, int dtype, unsigned int threshold, float inv_keep,
                 void* stream) {
  if (groups <= 0 || slab <= 0 || stride < 0 || base < 0 ||
      ((groups > 1 || fold_B > 1) && stride < slab) || fold_b <= 0 || fold_B < fold_b ||
      fold_off < 0 || fold_off > fold_B - fold_b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<bf16>(x, y, groups, slab, stride, base, fold_b, fold_B, fold_off, sd,
                        threshold, inv_keep, st);
  }
  if (dtype == 1) {
    return launch<float>(x, y, groups, slab, stride, base, fold_b, fold_B, fold_off, sd,
                         threshold, inv_keep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
