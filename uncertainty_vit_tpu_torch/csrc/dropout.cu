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

// kVector: 16-byte accesses over the whole chunks, the tail element by
// element; otherwise every element on its own.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long numel,
               const long long* __restrict__ seed, uint32_t threshold, float inv_keep) {
  constexpr int kVec = kVector ? 16 / int(sizeof(T)) : 4;  // elements per thread
  const philox::Key key = philox::load_key(seed);
  const long long chunk = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i0 = chunk * kVec;
  if (i0 >= numel) return;
  if (kVector && i0 + kVec <= numel) {
    uint4 u = *reinterpret_cast<const uint4*>(x + i0);
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const uint4 w = philox::dropout_words(key, (unsigned long long)(i0 >> 2) + q);
      e[4 * q + 0] = drop_one(e[4 * q + 0], w.x, threshold, inv_keep);
      e[4 * q + 1] = drop_one(e[4 * q + 1], w.y, threshold, inv_keep);
      e[4 * q + 2] = drop_one(e[4 * q + 2], w.z, threshold, inv_keep);
      e[4 * q + 3] = drop_one(e[4 * q + 3], w.w, threshold, inv_keep);
    }
    *reinterpret_cast<uint4*>(y + i0) = u;
    return;
  }
  // kVec is a multiple of 4, so i0 starts a Philox group
  for (int j = 0; j < kVec && i0 + j < numel; j += 4) {
    const uint4 w = philox::dropout_words(key, (unsigned long long)((i0 + j) >> 2));
    for (int k = 0; k < 4 && i0 + j + k < numel; ++k) {
      y[i0 + j + k] = drop_one(x[i0 + j + k], word_of(w, k), threshold, inv_keep);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long numel, const long long* seed,
                   uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int vec = aligned ? 16 / int(sizeof(T)) : 4;
  const long long chunks = (numel + vec - 1) / vec;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (aligned) {
    dropout_kernel<T, true><<<dim3((unsigned)blocks), kThreads, 0, stream>>>(
        xs, ys, numel, seed, threshold, inv_keep);
  } else {
    dropout_kernel<T, false><<<dim3((unsigned)blocks), kThreads, 0, stream>>>(
        xs, ys, numel, seed, threshold, inv_keep);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. x and y hold numel contiguous elements; seed is
// one int64 in device memory; threshold = min(int(rate * 2^32), 2^32 - 1);
// inv_keep = 1 / (1 - rate). Returns the launch's cudaError_t.
int uvit_dropout(const void* x, void* y, long long numel, const void* seed, int dtype,
                 unsigned int threshold, float inv_keep, void* stream) {
  if (numel <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long* sd = static_cast<const long long*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(x, y, numel, sd, threshold, inv_keep, st);
  if (dtype == 1) return launch<float>(x, y, numel, sd, threshold, inv_keep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* uvit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
