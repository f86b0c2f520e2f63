// Device code shared by the two int8 kernels (the quantizing matmul and the
// wgrad): type conversions, the two roundings to int8, cp.async and the
// mma.sync m16n8k32 wrapper on int8. Everything here is inlined into its
// caller; nothing is launched from this file.
//
// Fragment layout of mma.sync m16n8k32 on s8 (lane = 4 * g + t), in bytes the
// layout of m16n8k16 on 16-bit types:
//   A (16 x 32, row):  a0 = row g,     bytes 4t .. 4t + 3      a1 = row g + 8, same bytes
//                      a2 = row g,     bytes 16 + 4t .. + 3    a3 = row g + 8, same bytes
//   B (32 x 8, col):   b0 = column g,  k = 4t .. 4t + 3        b1 = column g,  k = 16 + 4t .. + 3
//   C (16 x 8, s32):   c0, c1 = row g, columns 2t, 2t + 1      c2, c3 = row g + 8, same columns
// so with both operands stored with the contraction contiguous every
// register is one aligned 32-bit word of shared memory, and one ldmatrix.x4
// (four 8-row x 16-byte blocks) fills a whole A fragment, or the B fragments
// of two neighbouring 8-column blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment of rows [row0, row0 + 16), bytes [k0, k0 + 32) of a tile
// with rows of `pitch` bytes (a multiple of 16): lane l names row (l & 7) +
// 8 * ((l >> 3) & 1) at byte 16 * (l >> 4), so the four blocks land in a0..a3.
__device__ __forceinline__ void load_a_frag(const int8_t* tile, int pitch, int row0, int k0,
                                            uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_u32(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 +
                   (lane >> 4) * 16), a);
}

// The B fragments of the 8-column blocks at n0 and n0 + 8, bytes [k0, k0 +
// 32), of a tile stored [column][contraction]: b[0], b[1] belong to n0, b[2],
// b[3] to n0 + 8. Lane l names column (l & 7) + 8 * (l >> 4) at byte
// 16 * ((l >> 3) & 1).
__device__ __forceinline__ void load_b_frags(const int8_t* tile, int pitch, int n0, int k0,
                                             uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
                   ((lane >> 3) & 1) * 16), b);
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate (it wraps,
// it does not saturate: the callers bound their sums).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A float that holds an integer or lies beyond the int8 range -> int8,
// saturated to [-128, 127] (x * 127 / amax can pass 127 by an ulp, and
// floor(. + u) then reaches 128; the plain version clamps alike).
__device__ __forceinline__ int sat_s8(float r) {
  return __float2int_rn(fminf(fmaxf(r, -128.0f), 127.0f));
}

// Round to nearest, half to even (jnp.round, torch.round), of x * inv.
__device__ __forceinline__ int quant_rn(float x, float inv) {
  return sat_s8(rintf(__fmul_rn(x, inv)));
}

// floor(x * inv + u): product and sum rounded separately (no fused
// multiply-add), as the plain version's two tensor operations are.
__device__ __forceinline__ int quant_sr(float x, float inv, float u) {
  return sat_s8(floorf(__fadd_rn(__fmul_rn(x, inv), u)));
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8) | ((uint32_t(c) & 0xffu) << 16) |
         (uint32_t(d) << 24);
}

// Elements in 16 bytes of T.
template <typename T> struct Vec16 { static constexpr int kN = 16 / int(sizeof(T)); };

}  // namespace
