// GF(2^8) matrix-apply core shared by the two Reed-Solomon kernels.
//
// A (rows, d) coefficient matrix arrives as its product table: for each
// coefficient c = M[i][j] the 256 bytes gf_mul(c, x), x = 0..255, laid out
// tab[(i * d + j) * 256 + x].  For RS(10,4) that is 4 * 10 * 256 = 10 KiB,
// which lives in shared memory for the whole block.  One output word is
//   out[i] = XOR_j tab_ij[x_j]     (byte-wise lookups on packed words),
// so the kernels do four shared-memory lookups per (row, input, word) and
// no arithmetic besides XOR.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace swgf {

// Output rows one launch computes; the wrappers split larger matrices.
constexpr int kMaxRows = 16;
// Dynamic shared memory a block may take on Hopper (227 KiB).
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t mul_word(const uint8_t* t, uint32_t x) {
  return static_cast<uint32_t>(t[x & 0xFFu]) |
         (static_cast<uint32_t>(t[(x >> 8) & 0xFFu]) << 8) |
         (static_cast<uint32_t>(t[(x >> 16) & 0xFFu]) << 16) |
         (static_cast<uint32_t>(t[x >> 24]) << 24);
}

__device__ __forceinline__ uint8_t mul_word(const uint8_t* t, uint8_t x) {
  return t[x];
}

// Copy `nwords` 32-bit words (both pointers 4-aligned) with the whole
// block, typically from device to shared memory.
__device__ __forceinline__ void block_copy_words(uint32_t* dst,
                                                 const uint32_t* src,
                                                 int nwords) {
  for (int k = threadIdx.x; k < nwords; k += blockDim.x) dst[k] = src[k];
}

}  // namespace swgf
