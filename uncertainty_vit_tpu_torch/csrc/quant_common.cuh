// Device and host code shared by the two int8 kernels (the quantizing
// matmul K6 and the wgrad K7): the two roundings to int8, and the s8 product
// core both run on Hopper (sm_90a). Everything here is inlined into its
// caller; nothing is launched from this file. The TMA, mbarrier and wgmma
// pieces that the attention kernels use too are in hopper_common.cuh.
//
// The product core: C (s32) = A . B^T for A [rows, depth] and B [rows,
// depth] int8, both with the depth contiguous (K-major: 8-bit wgmma has no
// transposed operand). A block computes 128 rows of A against 256 rows of B,
// and the depth streams through a ring of kStages stages of 128 bytes each
// (one 128-byte swizzle row: four k32 steps). Blocks run in clusters of two
// whose tiles share their B rows: each block's producer warp (its last) has
// TMA bring its own A box and one half of the B box, multicast to both
// blocks (int8 2-D tensor maps in the 128-byte swizzle; rows past the tensor
// arrive as zeros), onto the stage's `full` barrier, so that every B byte
// crosses from L2 once for two blocks: 32 KB a stage a block instead of
// 48 (kCluster = 1 gives the same kernels without multicast, and the same
// bits: 0-5% slower a call on an H100, K7 4-5% at three of four trunk
// shapes). Two consumer warpgroups, 64 rows of A each, run wgmma.mma_async
// m64n256k32 s32.s8.s8 from shared memory, keep one stage's group in flight
// and release the stage before it on the `empty` barriers of both blocks
// (one arrival per consumer warp), since both producers write into it. The
// accumulator of a warpgroup is 64 x 256 s32: thread (warp w of the
// warpgroup, lane 4g + t) holds rows 16w + g and 16w + g + 8, columns 8j +
// 2t and 8j + 2t + 1 in d[4j .. 4j + 3], as an mma.sync m16n8 tile does: 128
// of the 168 registers a thread gets. (Warpgroups on 64-row tiles of their
// own, taking the tensor cores in turn so that one's epilogue overlaps the
// other's products, won 10% at K = 768 and lost 12-15% at K >= 2304 on an
// H100, with 1.5 times the operand bytes a product: not kept.)

#pragma once

#include "hopper_common.cuh"  // bf16, to_f32, warp_max; TMA, mbarriers, wgmma descriptors
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// rounding to int8
// ---------------------------------------------------------------------------

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

// A row window: the matrix holds rows [start, start + rows) of each of its
// M / rows sequences of n tokens (a seq shard's trunk), and those sequences
// are images image0, image0 + 1, ... of the unsharded batch (a data rank's
// shard of the global batch), so its row b * rows + r draws the rounding
// bits of the unsharded row (image0 + b) * n + start + r. (rows, start, n,
// image0) = (M, 0, M, 0) is every row's own. A block locates its first row
// once (one division) and steps from there, so a thread never divides.
struct RowWindow {
  int rows, start, n, image0;
  // (image, row of the shard) of matrix row `row`
  __device__ __forceinline__ int2 locate(int row) const {
    const int b = row / rows;
    return make_int2(b, row - b * rows);
  }
  // `at` moved on by t >= 0 rows
  __device__ __forceinline__ void step(int2& at, int t) const {
    at.y += t;
    while (at.y >= rows) at.y -= rows, ++at.x;
  }
  // the unsharded row at `at`
  __device__ __forceinline__ int unsharded(int2 at) const {
    return (image0 + at.x) * n + start + at.y;
  }
};

// Whether (rows, start, n, image0) lays out m matrix rows whose unsharded
// rows stay below 2^31.
inline bool window_ok(int m, int rows, int start, int n, int image0) {
  return rows >= 1 && m % rows == 0 && start >= 0 && start <= n - rows && image0 >= 0 &&
         (long long)(image0 + m / rows) * n <= 0x7fffffffLL;
}

// Elements in 16 bytes of T.
template <typename T> struct Vec16 { static constexpr int kN = 16 / int(sizeof(T)); };

// ---------------------------------------------------------------------------
// the s8 product core
// ---------------------------------------------------------------------------

constexpr int kDepth = 128;  // depth (bytes) of a stage: one 128-byte swizzle row
constexpr int kTileA = 128;  // rows of A in a tile: two consumer warpgroups of 64
constexpr int kTileB = 256;  // rows of B in a tile: the wgmma's N
constexpr int kStages = 4;
constexpr uint32_t kABytes = kTileA * kDepth;
constexpr uint32_t kHalfBBytes = kTileB / 2 * kDepth;  // what each block of a pair brings
constexpr uint32_t kStageBytes = kABytes + 2 * kHalfBBytes;  // 48 KB
constexpr int kCluster = 2;
constexpr int kConsumerWarps = 8;
constexpr int kGemmThreads = 32 * kConsumerWarps + 32;  // + the producer warp
// A consumer warp's staging area for its part of the epilogue: 16 rows of
// 128 bytes (64 bf16 or 32 four-byte values), 144 or 160 bytes apart.
constexpr int kPitch2 = 144, kPitch4 = 160;  // fragment writes free of bank conflicts
constexpr uint32_t kEpiBytes = 16 * kPitch4;
// A tile's dequantizing factors (K6): its columns' scales and bias, its
// rows' scales; two buffers.
constexpr int kScaleFloats = 2 * kTileB + kTileA;
constexpr size_t kGemmSmem = kStages * kStageBytes + kConsumerWarps * kEpiBytes +
                             2 * kScaleFloats * sizeof(float) +
                             (2 * kStages + 4) * sizeof(uint64_t) + 1024;

// The tensor map of an int8 matrix [rows, cols] (row-major, cols a multiple
// of 16, `base` 16-byte aligned): boxes of 128 columns by `box_rows` rows in
// the 128-byte swizzle. Rows and columns past the matrix arrive as zeros.
inline bool s8_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 || cols % 16 != 0) {
    return false;
  }
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols)};
  const cuuint32_t box[2] = {cuuint32_t(kDepth), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The box at (column c0, row r0) of a 2-D `map` into `dst` (1024-byte
// aligned), completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// The same box into `dst` of every block of the cluster in `mask`, completing
// its bytes on the barrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int r0,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask), "r"(c0), "r"(r0)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster meets here.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// One arrival on the barrier at `bar`'s offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the s32 accumulator's registers here (see wgmma_hold).
__device__ __forceinline__ void wgmma_hold(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256, s32) = (scale_d ? d : 0) + A B^T over 32 of depth, A (64
// rows) and B (256 rows) read K-major from shared memory through their
// descriptors. The sums wrap in int32; the callers bound them.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The ring of operand stages in dynamic shared memory, its barriers, the
// consumer warps' staging areas, and the two buffers of dequantizing
// factors with theirs.
struct S8Ring {
  unsigned char* tiles;  // 1024-byte aligned
  unsigned char* epi;    // kConsumerWarps x kEpiBytes
  float* scales;         // 2 x kScaleFloats
  uint64_t* full;        // a stage's boxes have landed
  uint64_t* empty;       // every consumer warp of the cluster is done with a stage
  uint64_t* sc_full;     // a buffer of factors is written (the producer warp's 32 lanes)
  uint64_t* sc_empty;    // every consumer warp of the block is done with a buffer
  __device__ __forceinline__ unsigned char* a(int s) const { return tiles + s * kStageBytes; }
  __device__ __forceinline__ unsigned char* b(int s) const {
    return tiles + s * kStageBytes + kABytes;
  }
};

// Lays the ring out in `smem_raw` (kGemmSmem bytes) and initializes its
// barriers; every thread of both blocks of the cluster calls it.
__device__ __forceinline__ S8Ring s8_ring(unsigned char* smem_raw) {
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* epi = base + kStages * kStageBytes;
  float* scales = reinterpret_cast<float*>(epi + kConsumerWarps * kEpiBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(scales + 2 * kScaleFloats);
  const S8Ring ring{base, epi, scales, bars, bars + kStages, bars + 2 * kStages,
                    bars + 2 * kStages + 2};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kCluster * kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ring.sc_full[b], 32);
      mbar_init(&ring.sc_empty[b], kConsumerWarps);
    }
    mbar_fence_init();
  }
  cluster_sync();  // the peer's barriers are ready before anything reaches them
  return ring;
}

// The producer's load of the ring's `it`-th stage, once the consumers of
// both blocks have released it: depth [d0, d0 + 128) of this block's A rows
// [a0, a0 + 128), and of the pair's B rows [b0, b0 + 256), of which this
// block (cluster rank `rank`) brings half to both.
__device__ __forceinline__ void s8_load(const S8Ring& ring, int it, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int d0, int a0, int b0,
                                        uint32_t rank) {
  const int s = it % kStages;
  mbar_wait(&ring.empty[s], ((it / kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&ring.full[s], kStageBytes);
  tma_load_2d(ring.a(s), map_a, &ring.full[s], d0, a0);
  for (uint32_t h = rank; h < 2; h += kCluster) {
    void* dst = ring.b(s) + h * kHalfBBytes;
    const int r0 = b0 + int(h) * (kTileB / 2);
    if constexpr (kCluster == 1) {
      tma_load_2d(dst, map_b, &ring.full[s], d0, r0);
    } else {
      tma_load_2d_multicast(dst, map_b, &ring.full[s], d0, r0, (1u << kCluster) - 1);
    }
  }
}

// Consumer warpgroup `wg`: d = its 64 rows of A times B^T over the `count`
// stages from the ring's `it`-th on (it advances past them). Returns with
// every one of them released and d complete in registers.
__device__ __forceinline__ void s8_mma(int (&d)[128], const S8Ring& ring, int& it, int count,
                                       int wg) {
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = 0;
  wgmma_hold(d);
  for (int i = 0; i < count; ++i, ++it) {
    const int s = it % kStages;
    mbar_wait(&ring.full[s], (it / kStages) & 1);
    const uint64_t da = desc_sw128(ring.a(s) + wg * 64 * kDepth);
    const uint64_t db = desc_sw128(ring.b(s));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 32; ++kk) {
      wgmma_s8_n256(d, desc_add(da, 32 * kk), desc_add(db, 32 * kk), (i | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one has been read
    if (i > 0 && leader) {
      for (uint32_t r = 0; r < kCluster; ++r) mbar_arrive_remote(&ring.empty[prev], r);
    }
    prev = s;
  }
  wgmma_wait<0>();
  wgmma_hold(d);
  if (leader) {
    for (uint32_t r = 0; r < kCluster; ++r) mbar_arrive_remote(&ring.empty[prev], r);
  }
}

// Cluster tiles of a grid of `tiles` row tiles: the clusters' row tiles
// share one column tile, each block taking the row tile of its rank.
__host__ __device__ constexpr int cluster_rows(int tiles) {
  return (tiles + kCluster - 1) / kCluster;
}

// A launch of `clusters` clusters of kCluster blocks of kGemmThreads threads
// and kGemmSmem bytes of shared memory; `attr` holds its cluster shape. The
// kernel's limit on dynamic shared memory is raised first.
template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), int clusters, cudaStream_t stream,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * kCluster);
  cfg->blockDim = dim3(kGemmThreads);
  cfg->dynamicSmemBytes = kGemmSmem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kGemmSmem));
}

// Launches `kernel` over `clusters` clusters.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int clusters, cudaStream_t stream,
                            Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = cluster_config(kernel, clusters, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr int kMaxDevices = 64;

// The most clusters of `kernel` that stand at once on the current device,
// counted once per device into `cache` (zeros until then).
template <typename... Params>
int resident_clusters(void (*kernel)(Params...), int (&cache)[kMaxDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int most = 0;
  if (cluster_config(kernel, 1, nullptr, &attr, &cfg) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&most, kernel, &cfg) != cudaSuccess || most < 1) {
    return 1;
  }
  if (dev < kMaxDevices) cache[dev] = most;
  return most;
}

}  // namespace
