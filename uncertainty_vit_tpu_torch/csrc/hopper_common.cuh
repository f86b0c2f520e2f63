// Hopper (sm_90a) building blocks of the streaming attention kernels: TMA
// tensor maps and loads, mbarriers, named barriers and the async-proxy
// fence, the q/v bias added to a swizzled tile, warpgroup matrix products
// (wgmma) on shared-memory tiles, and HeadTile<D>, the layout of one head's
// 64-row tile at each head width. Everything here is inlined into its
// caller; nothing is launched from this file.
//
// A tile is 64 rows of one head's D bf16 columns (every D % 16 == 0 from 32
// to 128), written by TMA as kBoxes boxes of 64 rows x W columns side by
// side, all of one width W:
//   - W = 64 where 64 divides D (D = 64: one box, 128: two), in
//     CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes, 16-byte chunk c of row
//     r at chunk c ^ (r % 8), 8 rows one 1024-byte swizzle atom;
//   - else W = 32 where 32 divides D (32: one box, 96: three), in
//     CU_TENSOR_MAP_SWIZZLE_64B: rows of 64 bytes, chunk c (0-3) of row r at
//     c ^ ((r / 2) % 4), 8 rows one 512-byte atom;
//   - else W = 16 (48: three boxes, 80: five, 112: seven), in
//     CU_TENSOR_MAP_SWIZZLE_32B: rows of 32 bytes, chunk c (0 or 1) of row r
//     at c ^ ((r / 4) % 2), 8 rows one 256-byte atom.
// In each the chunk's place is c ^ ((row bytes * r / 128) % (chunks a row)):
// the TMA's swizzle of a W-column box, which a box exactly one swizzle wide
// takes. One wgmma descriptor of that swizzle (SBO: 8 rows, one atom, between
// 8-row groups; LBO: one box between the boxes) reads the tile both ways:
//   - K-major (the D contiguous elements are the product's depth: q or k in
//     s = q k^T): step kk of 16 deep lies in box kk / (W / 16), 32 * (kk %
//     (W / 16)) bytes into its rows; LBO is not used (a step never crosses a
//     box);
//   - MN-major (the D contiguous elements are the output's columns: v in o
//     += p v): step kk starts 16 rows, 16 * 2W * kk bytes, into every box,
//     and one wgmma m64nD takes the D columns of all boxes, box j at LBO * j.
// D = 64 and 80 keep the layouts of their first kernels (one 128-byte box;
// five 32-byte ones) bit for bit; the rule takes the widest swizzle that
// divides D, so a tile's boxes are as few as they can be.
// The accumulator of wgmma m64nN gives warp w of the warpgroup rows 16w + g
// and 16w + g + 8 (lane = 4g + t), columns 8n + 2t and 8n + 2t + 1 in
// d[4n .. 4n + 3], as an mma.sync m16n8 tile does; two neighbouring
// 8-column blocks, packed to bf16, are the register A operand of the next
// product's 16-deep step.

#pragma once

#include "attention_common.cuh"  // bf16, pack_bf16
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library links against the runtime alone.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The tensor map of one section of a token tensor: `base` at column 0 of
// head 0 in row 0 of image 0, `width` bf16 columns of it (C = H * D), rows
// `ld` elements apart, `n` rows an image, `batch` images; a box of 64 rows
// by `box_cols` columns in `swizzle` (HeadTile<D>). Rows past n of an image
// lie outside the map's second dimension and arrive as zeros: a tile never
// reads the next image.
inline bool token_map(CUtensorMap* map, const void* base, int width, long long ld, int n,
                      int batch, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 || (ld * 2) % 16 != 0) {
    return false;
  }
  const cuuint64_t dims[3] = {cuuint64_t(width), cuuint64_t(n), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 2, cuuint64_t(ld) * 2 * cuuint64_t(n)};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialized barriers visible to the async proxy (TMA); the
// caller then synchronizes the block.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival, made when every cp.async this thread issued before it has
// landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Waits until the phase of the given parity has completed (parity 1 on a
// fresh barrier passes at once: the phase before its first).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box at (column c0, row r0, image img) of `map` into `dst` (aligned to
// its swizzle's atom), completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int r0, int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(r0), "r"(img)
      : "memory");
}

// A barrier over `count` threads (a multiple of 32) of the block that meet
// at `id` (1 to 15; 0 is __syncthreads's).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's earlier writes to shared memory before the async
// proxy's later accesses (wgmma's operand reads, TMA's writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Eight bias columns, rounded to bf16 as `_qv_biased` rounds them and
// packed in pairs.
struct QvBiasChunk {
  uint32_t bf2[4];
};
__device__ __forceinline__ QvBiasChunk qv_bias_pack(const float* b) {
  QvBiasChunk c;
#pragma unroll
  for (int j = 0; j < 4; ++j) c.bf2[j] = pack_bf16(b[2 * j], b[2 * j + 1]);
  return c;
}

// Adds 8 packed bias columns to one 16-byte chunk of bf16 in shared memory,
// in place: each sum in f32, rounded once to bf16 (`add_qv_bias`).
__device__ __forceinline__ void add_qv_bias_to_chunk(unsigned char* p, const QvBiasChunk& c) {
  uint4* chunk = reinterpret_cast<uint4*>(p);
  uint4 u = *chunk;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t hi_mask = 0xFFFF0000u;
    w[j] = pack_bf16(__uint_as_float(w[j] << 16) + __uint_as_float(c.bf2[j] << 16),
                     __uint_as_float(w[j] & hi_mask) + __uint_as_float(c.bf2[j] & hi_mask));
  }
  *chunk = u;
}

// Adds one head's bias row (D f32 columns) to a tile of kBoxes boxes of 64
// rows x kBoxCols columns in their swizzle (HeadTile), in place. Thread
// `tid` of 128 takes physical chunk tid % P of rows tid / P, tid / P + 128 /
// P, ... of every box (P chunks a row, 64 P / 128 of them a thread a box);
// 128 / P rows is a multiple of 8, so each of those holds the same logical
// chunk and one packed bias chunk a box serves them all. The caller then
// calls fence_proxy_async and meets every thread that reads the tile at a
// barrier before a wgmma reads it.
template <int kBoxCols, int kBoxes>
__device__ __forceinline__ void add_qv_bias_boxes(unsigned char* tile, const float* bias_row,
                                                  int tid) {
  constexpr int kChunks = kBoxCols / 8, kRowBytes = 2 * kBoxCols;
  constexpr int kPerThread = 64 * kChunks / 128;
  // shifts and masks (P is a power of 2, tid is not negative)
  const unsigned row = unsigned(tid) / kChunks;
  const int chunk = int((unsigned(tid) % kChunks) ^ ((row * kRowBytes >> 7) & (kChunks - 1)));
#pragma unroll
  for (int box = 0; box < kBoxes; ++box) {
    const QvBiasChunk c = qv_bias_pack(bias_row + kBoxCols * box + 8 * chunk);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      add_qv_bias_to_chunk(tile + 64 * kRowBytes * box + 16 * (tid + 128 * k), c);
    }
  }
}

// 2^x by the special function unit alone (one instruction; subnormal
// results flush to 0, 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// The descriptor of a tile at `p` in the swizzle of `kRowBytes`-byte rows
// (32, 64 or 128; `p` aligned to its 8-row atom): SBO one atom between 8-row
// groups, LBO `lbo` bytes between boxes (16 where a tile is one box; only
// MN-major reads across boxes use it).
template <uint32_t kRowBytes>
__device__ __forceinline__ uint64_t desc_swizzled(const void* p, uint32_t lbo) {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128, "no such swizzle");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFFull) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(8 * kRowBytes >> 4) << 32) | (kLayout << 62);
}
// The descriptor of a one-box tile in the 128-byte swizzle (1024-byte
// aligned row groups, SBO 1024 bytes; LBO unused).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) { return desc_swizzled<128>(p, 16); }
// The same descriptor `bytes` further on (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins the accumulator's registers at this point of the program, so that
// no read or write of them moves across the wgmma issue or wait around it.
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A operands, which wgmma reads after its issue: they
// stay live, in place, until the wait.
__device__ __forceinline__ void wgmma_hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// An accumulator (64 rows x 64) as the register A operands of the next
// product's four 16-deep steps: its 8-column blocks 2kk and 2kk + 1, packed
// to bf16, are step kk (rows g and g + 8, depth 2t, 2t + 1 and 2t + 8, 2t + 9).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A B, A and B both read from shared
// memory through their descriptors (A K-major); kTransB = 0 reads B K-major
// (B^T's rows contiguous: d = A . M^T for M [64][K] in shared memory), 1
// MN-major (d = A . M for M [K][64]).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// d (64 x N, f32) += A B with A (64 x 16 bf16) in registers, in the
// m16n8k16 A-fragment layout per warp (rows 16 * warp + g, + 8 of the
// warpgroup's 64), and B 16 deep by N columns read from shared memory;
// kTransB as for wgmma_ss. One overload per N = D of the head widths built
// (N / 2 accumulator registers a thread), all from UVIT_WGMMA_RS: the
// accumulators are operands %0 .. %(N/2 - 1), A's four words, B's
// descriptor, the scale-d predicate's word and kTransB the next seven.
#define UVIT_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define UVIT_REGS8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define UVIT_REGS8_1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define UVIT_REGS8_2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define UVIT_REGS8_3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define UVIT_REGS8_4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define UVIT_REGS8_5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define UVIT_REGS8_6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define UVIT_REGS8_7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define UVIT_REGS16 UVIT_REGS8_0 UVIT_REGS8_1
#define UVIT_REGS24 UVIT_REGS16 UVIT_REGS8_2
#define UVIT_REGS32 UVIT_REGS24 UVIT_REGS8_3
#define UVIT_REGS40 UVIT_REGS32 UVIT_REGS8_4
#define UVIT_REGS48 UVIT_REGS40 UVIT_REGS8_5
#define UVIT_REGS56 UVIT_REGS48 UVIT_REGS8_6
#define UVIT_REGS64 UVIT_REGS56 UVIT_REGS8_7
#define UVIT_OPS16 UVIT_ACC8(0), UVIT_ACC8(8)
#define UVIT_OPS24 UVIT_OPS16, UVIT_ACC8(16)
#define UVIT_OPS32 UVIT_OPS24, UVIT_ACC8(24)
#define UVIT_OPS40 UVIT_OPS32, UVIT_ACC8(32)
#define UVIT_OPS48 UVIT_OPS40, UVIT_ACC8(40)
#define UVIT_OPS56 UVIT_OPS48, UVIT_ACC8(48)
#define UVIT_OPS64 UVIT_OPS56, UVIT_ACC8(56)
#define UVIT_WGMMA_RS(N, REGS, OPS, A0, A1, A2, A3, DESC, SCALE, TRANS)                        \
  template <int kTransB>                                                                      \
  __device__ __forceinline__ void wgmma_rs(float(&d)[N / 2], const uint32_t(&a)[4],           \
                                           uint64_t desc_b) {                                 \
    asm volatile(                                                                             \
        "{\n"                                                                                 \
        ".reg .pred p;\n"                                                                     \
        "setp.ne.b32 p, %" #SCALE ", 0;\n"                                                    \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "                           \
        "{" REGS "}, "                                                                        \
        "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1, %" #TRANS ";\n"        \
        "}\n"                                                                                 \
        : OPS                                                                                 \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));      \
  }
UVIT_WGMMA_RS(32, UVIT_REGS16, UVIT_OPS16, 16, 17, 18, 19, 20, 21, 22)
UVIT_WGMMA_RS(48, UVIT_REGS24, UVIT_OPS24, 24, 25, 26, 27, 28, 29, 30)
UVIT_WGMMA_RS(64, UVIT_REGS32, UVIT_OPS32, 32, 33, 34, 35, 36, 37, 38)
UVIT_WGMMA_RS(80, UVIT_REGS40, UVIT_OPS40, 40, 41, 42, 43, 44, 45, 46)
UVIT_WGMMA_RS(96, UVIT_REGS48, UVIT_OPS48, 48, 49, 50, 51, 52, 53, 54)
UVIT_WGMMA_RS(112, UVIT_REGS56, UVIT_OPS56, 56, 57, 58, 59, 60, 61, 62)
UVIT_WGMMA_RS(128, UVIT_REGS64, UVIT_OPS64, 64, 65, 66, 67, 68, 69, 70)
#undef UVIT_WGMMA_RS
#undef UVIT_ACC8
#undef UVIT_REGS8_0
#undef UVIT_REGS8_1
#undef UVIT_REGS8_2
#undef UVIT_REGS8_3
#undef UVIT_REGS8_4
#undef UVIT_REGS8_5
#undef UVIT_REGS8_6
#undef UVIT_REGS8_7
#undef UVIT_REGS16
#undef UVIT_REGS24
#undef UVIT_REGS32
#undef UVIT_REGS40
#undef UVIT_REGS48
#undef UVIT_REGS56
#undef UVIT_REGS64
#undef UVIT_OPS16
#undef UVIT_OPS24
#undef UVIT_OPS32
#undef UVIT_OPS40
#undef UVIT_OPS48
#undef UVIT_OPS56
#undef UVIT_OPS64

// ---------------------------------------------------------------------------
// HeadTile<D>: one head's 64-row tile at head width D (see the top of this
// file): its TMA boxes, its bytes, its wgmma descriptors and its q/v bias add
// ---------------------------------------------------------------------------

template <int D>
struct HeadTile {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head widths 32, 48, ..., 128");
  // the widest swizzle whose box width divides D (the top of this file)
  static constexpr int kBoxCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kStepsPerBox = kBoxCols / 16;  // 16-deep K-major steps in a box
  static constexpr uint32_t kRowBytes = kBoxCols * sizeof(bf16);
  static constexpr uint32_t kBoxBytes = 64 * kRowBytes, kBytes = kBoxes * kBoxBytes;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kBoxCols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : kBoxCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  __device__ static uint64_t desc(const void* tile) {
    return desc_swizzled<kRowBytes>(tile, kBoxes > 1 ? kBoxBytes : 16);
  }
  __device__ static uint64_t k_step(uint64_t desc, int kk) {
    return desc_add(desc, (kk / kStepsPerBox) * kBoxBytes + (kk % kStepsPerBox) * 32);
  }
  __device__ static uint64_t mn_step(uint64_t desc, int kk) {
    return desc_add(desc, 16 * kRowBytes * kk);
  }
  __device__ static void add_qv_bias(unsigned char* tile, const float* bias_row, int tid) {
    add_qv_bias_boxes<kBoxCols, kBoxes>(tile, bias_row, tid);
  }
};

// The tensor map of one section of a token tensor in HeadTile<D>'s boxes.
template <int D>
inline bool head_map(CUtensorMap* map, const void* base, int width, long long ld, int n,
                     int batch) {
  return token_map(map, base, width, ld, n, batch, HeadTile<D>::kBoxCols, HeadTile<D>::kSwizzle);
}

// One head's tile (columns c0 .. c0 + D, rows r0 .. r0 + 64 of image img)
// into `dst` (1024-byte aligned), box by box, completing on `bar`.
template <int D>
__device__ __forceinline__ void tma_load_head(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int r0, int img) {
#pragma unroll
  for (int box = 0; box < HeadTile<D>::kBoxes; ++box) {
    tma_load_tile(dst + box * HeadTile<D>::kBoxBytes, map, bar, c0 + box * HeadTile<D>::kBoxCols,
                  r0, img);
  }
}

// A producer warpgroup's hand-over of a streamed tile that takes the q/v
// bias, right after it issued the tile's loads: waits until TMA has landed
// the tile (on `landed`, in the phase of `parity`), adds the bias row in
// place with all 128 producer threads (`ptid`), orders the writes before
// the consumers' wgmma, meets the other producer threads at named barrier
// 1 (the producer's; consumer warpgroup w meets its own at 2 + w) and makes
// the stage's one arrival on `full` that is not a cp.async one. The
// consumers only wait on `full`.
template <int D>
__device__ __forceinline__ void hand_over_biased(unsigned char* tile, uint64_t* landed,
                                                 uint32_t parity, uint64_t* full,
                                                 const float* bias_row, int ptid) {
  mbar_wait(landed, parity);
  HeadTile<D>::add_qv_bias(tile, bias_row, ptid);
  fence_proxy_async();
  named_barrier(1, 128);
  if (ptid == 0) mbar_arrive(full);
}

}  // namespace
