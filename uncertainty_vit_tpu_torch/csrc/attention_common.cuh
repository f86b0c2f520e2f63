// Device code shared by the four attention kernels (the fused forward and
// backward, the streaming forward and the split streaming backward): type
// conversions, warp reductions, the q/v bias add, cp.async (and the
// streaming kernels' 4-byte copy of a bias tile), ldmatrix and mma.sync
// m16n8k16 wrappers, the 16-row fragment products that keep p and ds in
// registers, and the FMA kernels' f32 tile products. Everything here is
// inlined into its caller; nothing is launched from this file. The streaming
// kernels' Hopper pieces (TMA, mbarriers, wgmma) are in hopper_common.cuh.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + t): an accumulator
// holds rows g and g + 8, columns 2t and 2t + 1 of each 8-column block, so
// element (nb, e) of a float[.][4] tile is row g + 8 * (e >> 1), column
// nb * 8 + 2t + (e & 1). Two neighbouring 8-column blocks, packed to bf16,
// are the A operand of the next product's 16-deep step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head dim (ViT-B and ViT-L)
constexpr int kLd = kD + 8;   // bf16 smem row: 144 B, ldmatrix conflict-free, 16-byte stores
constexpr int kLdF = kD + 1;  // f32 smem row: 65 words, column reads conflict-free
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

// 16-byte async copy global → shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// 4-byte async copy global → shared (for f32 rows whose pitch is no
// multiple of 16 bytes); src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
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
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (16 rows x 64) of a warp's staged rows, for the 4 k-steps.
__device__ __forceinline__ void load_a_frags(const bf16* rows, uint32_t (&f)[kD / 16][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(smem_u32(rows + r * kLd + kk * 16 + (lane >> 4) * 8), f[kk]);
  }
}

// s[2][4] = a (16 x 64) . m[row0 .. row0 + 16)^T: two 8-column blocks.
__device__ __forceinline__ void mma_abt(float (&s)[2][4], const uint32_t (&a)[kD / 16][4],
                                        const bf16* m, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
    for (int kp = 0; kp < kD / 32; ++kp) {
      uint32_t kb[4];
      ldsm_x4(smem_u32(m + (row0 + nb * 8 + (lane & 7)) * kLd + kp * 32 + (lane >> 3) * 8), kb);
      mma_bf16(s[nb], a[2 * kp], kb[0], kb[1]);
      mma_bf16(s[nb], a[2 * kp + 1], kb[2], kb[3]);
    }
  }
}

// acc (16 x 64) += x (16 x 16, the packed C fragments) . m[row0 .. row0 + 16)
__device__ __forceinline__ void mma_ab(float (&acc)[kD / 8][4], const float (&x)[2][4],
                                       const bf16* m, int row0) {
  const int lane = threadIdx.x & 31;
  const uint32_t pa[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                          pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t vb[4];
    const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4_trans(smem_u32(m + r * kLd + dp * 16 + (lane >> 4) * 8), vb);
    mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
    mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
  }
}

// Copy rows [row0, row0 + rows) of one head's slab into shared-memory rows of
// `ld` elements with plain 16-byte loads, zero-filling rows >= n and adding
// the section's q/v bias row (in T) when given. `src` points at the head's
// first column in row 0 of the image; rows lie `ld_src` elements apart, so a
// packed [N, 3C] tensor and a separate [N, C] one are read alike.
template <typename T>
__device__ __forceinline__ void load_slab_rows(T* dst, int ld, const T* src, size_t ld_src,
                                               const float* bias_row, int n, int row0, int rows,
                                               int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kD / kVec;
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
// and accumulator tiles have rows of kLdS words.
constexpr int kRowsF = 16;
constexpr int kLdS = kD + 4;

// s[kRowsF][64] = a_w[kRowsF][kD] . m[64][kD]^T (rows of kLdF words); lane
// owns columns lane and lane + 32.
__device__ __forceinline__ void warp_abt_f32(float* s, const float* aw, const float* m) {
  const int lane = threadIdx.x & 31;
  float acc[kRowsF][2];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int d = 0; d < kD; ++d) {
    const float m0 = m[lane * kLdF + d], m1 = m[(lane + 32) * kLdF + d];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const float a = aw[r * kLdF + d];
      acc[r][0] = fmaf(a, m0, acc[r][0]);
      acc[r][1] = fmaf(a, m1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    s[r * kLdS + lane] = acc[r][0];
    s[r * kLdS + lane + 32] = acc[r][1];
  }
}

// o[kRowsF][kD] += x[kRowsF][64] . m[64][kD]; x has rows of kLdS words, m of
// kLdF; lane owns output columns lane and lane + 32.
__device__ __forceinline__ void warp_ab_f32(float* o, const float* x, const float* m) {
  const int lane = threadIdx.x & 31;
  float acc[kRowsF][2];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int j = 0; j < 64; ++j) {
    const float m0 = m[j * kLdF + lane], m1 = m[j * kLdF + lane + 32];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const float xr = x[r * kLdS + j];
      acc[r][0] = fmaf(xr, m0, acc[r][0]);
      acc[r][1] = fmaf(xr, m1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    o[r * kLdS + lane] += acc[r][0];
    o[r * kLdS + lane + 32] += acc[r][1];
  }
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

}  // namespace
