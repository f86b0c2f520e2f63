// Counter-based random bits for the in-kernel dropout masks and the
// stochastic rounding of the int8 kernels, for Hopper.
//
// Replaces the TPU core's hardware generator as the three dropout kernels
// use it: `pltpu.prng_seed` / `pltpu.prng_random_bits` in `_dropout_mask`
// (uncertainty_vit_tpu/ops/flash_attention.py:156-162, seeded per program at
// :202 and :271) and in `_kernel` of the fused dropout
// (uncertainty_vit_tpu/ops/dropout.py:43-51). The thresholding is theirs:
//   keep = bits >= min(int(rate * 2^32), 2^32 - 1), kept values * 1/(1 - rate).
//
// The TPU seeds its generator once per program, so its mask depends on the
// kernel's tiling, and the attention forward and backward must agree on
// their batch block to replay a mask (:426-438). Blocks on Hopper run in no
// order and the three attention passes that need one mask (the forward, the
// backward's query-major phase and its key-major phase) tile the scores in
// three different ways. So here a mask entry is a pure function of the seed
// and of the entry's POSITION, never of the block, warp or thread that asks
// for it: Philox4x32-10 (Salmon et al., SC'11), keyed on the 64-bit seed,
// with the position as its 128-bit counter. One call yields four words:
//   dropout:   counter (i >> 2 low, i >> 2 high, 0, kStreamDropout), word
//              i & 3, for the flat element index i;
//   attention: counter (col >> 1, row >> 1, image * H + head,
//              kStreamAttention), word 2 * (row & 1) + (col & 1): one call
//              covers a 2 x 2 block of the (query row, key column) mask, the
//              shape that both the query-major and the key-major mma.sync
//              accumulator fragments hold in one thread pair.
//   rounding:  entry (row, col) of an [M, N] matrix takes counter
//              (col >> 2, row, 0, kStreamQuant), word col & 3: one call covers
//              four neighbouring columns of one row, what a thread that
//              quantizes 8 or 16 bytes of a row holds. The uniform is the top
//              24 bits times 2^-24, in [0, 1), as `_sr_uniform`
//              (uncertainty_vit_tpu/ops/quant.py:94-99) makes it from the TPU's
//              generator, which is seeded per program (:130-132, :221-223).
// The same function in plain PyTorch, exact to the bit, is
// uncertainty_vit_tpu_torch/ops/philox.py; each kernel's plain version draws
// its mask there.
//
// What it costs on an H100: ten rounds of two 32 x 32 -> 64-bit multiplies
// and a few xors and adds, ~50 integer instructions for four words. The
// attention forward at B=1024, N=197, H=12 draws 477M entries: 119M calls at
// the least, ~6 G integer operations, of the order of the kernel's whole
// rate-0 time. The bits cost no memory traffic at all, which is the point:
// a mask tensor would be read and written in device memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr uint32_t kStreamDropout = 0u, kStreamAttention = 1u, kStreamQuant = 2u;

struct Key {
  uint32_t k0, k1;
};

// The key of a seed held in device memory (one int64): low word, high word.
__device__ __forceinline__ Key load_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return Key{static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)};
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                               Key key) {
  uint32_t k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// 1/(1 - rate) where the entry is kept, else 0.
__device__ __forceinline__ float keep_scale(uint32_t bits, uint32_t threshold, float inv_keep) {
  return bits >= threshold ? inv_keep : 0.0f;
}

// The four words of flat elements 4 * group .. 4 * group + 3 (dropout).
__device__ __forceinline__ uint4 dropout_words(Key key, unsigned long long group) {
  return philox4x32_10(static_cast<uint32_t>(group), static_cast<uint32_t>(group >> 32), 0u,
                       kStreamDropout, key);
}

// The four words of entries (row, 4 * group .. 4 * group + 3) of a matrix
// (stochastic rounding).
__device__ __forceinline__ uint4 quant_words(Key key, uint32_t row, uint32_t group) {
  return philox4x32_10(group, row, 0u, kStreamQuant, key);
}

// The [0, 1) uniform of 32 random bits: the top 24 times 2^-24, exact in f32.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f);
}

// The 2 x 2 block of the attention mask that holds (row, col): x = (even
// row, even col), y = (even row, odd col), z = (odd row, even col), w = (odd
// row, odd col). bh = image * num_heads + head.
__device__ __forceinline__ uint4 attention_block(Key key, uint32_t bh, int row, int col) {
  return philox4x32_10(static_cast<uint32_t>(col) >> 1, static_cast<uint32_t>(row) >> 1, bh,
                       kStreamAttention, key);
}

// The bits of one attention mask entry (a whole call for one word: for the
// f32 kernels, whose lanes do not hold 2 x 2 blocks).
__device__ __forceinline__ uint32_t attention_bits(Key key, uint32_t bh, int row, int col) {
  const uint4 w = attention_block(key, bh, row, col);
  return (row & 1) ? ((col & 1) ? w.w : w.z) : ((col & 1) ? w.y : w.x);
}

// The bits of the four mask entries one thread holds in an mma.sync m16n8
// accumulator fragment: bits[2 * i + j] belongs to fragment row a_lo + 8 * i
// and fragment column b_lo + j, where a_lo = (even base) + lane / 4 and
// b_lo = (even base) + 2 * (lane % 4). kTransposed = false: fragment rows
// are mask rows (queries) and fragment columns mask columns (keys), the
// query-major layout; true: fragment rows are keys and fragment columns
// queries, the key-major layout of the backward's second phase. Either way
// the thread and its neighbour four lanes on hold complementary halves of
// the same two 2 x 2 blocks, so each computes one block and they exchange
// halves: one Philox call per four entries, none wasted. Every lane of the
// warp must call this together.
template <bool kTransposed>
__device__ __forceinline__ void fragment_bits(Key key, uint32_t bh, int a_lo, int b_lo,
                                              uint32_t (&bits)[4]) {
  const bool odd = a_lo & 1;
  const int a = odd ? a_lo + 8 : a_lo;  // the block this lane computes
  const uint4 w = kTransposed ? attention_block(key, bh, b_lo, a) : attention_block(key, bh, a, b_lo);
  // words of this lane's own parity of `a`, at fragment columns b_lo, b_lo + 1
  uint32_t mine0, mine1, send0, send1;
  if (kTransposed) {  // word = 2 * (query & 1) + (key & 1); a is the key
    mine0 = odd ? w.y : w.x;
    mine1 = odd ? w.w : w.z;
    send0 = odd ? w.x : w.y;
    send1 = odd ? w.z : w.w;
  } else {  // a is the query
    mine0 = odd ? w.z : w.x;
    mine1 = odd ? w.w : w.y;
    send0 = odd ? w.x : w.z;
    send1 = odd ? w.y : w.w;
  }
  const uint32_t recv0 = __shfl_xor_sync(0xffffffffu, send0, 4);
  const uint32_t recv1 = __shfl_xor_sync(0xffffffffu, send1, 4);
  bits[0] = odd ? recv0 : mine0;
  bits[1] = odd ? recv1 : mine1;
  bits[2] = odd ? mine0 : recv0;
  bits[3] = odd ? mine1 : recv1;
}

}  // namespace philox
