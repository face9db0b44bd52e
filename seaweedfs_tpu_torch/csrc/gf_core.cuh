// GF(2^8) and CRC32C table core shared by the two Reed-Solomon kernels.
//
// Replaces the byte-per-coefficient product tables of the first port
// (4 shared-memory byte lookups per output row, input row and 4-byte word,
// each into one coefficient's 256-byte table: a 2-way bank conflict on
// almost every warp lookup).  On Hopper a warp's shared-memory lookup
// costs one wavefront per distinct bank word it touches, so what bounds a
// table kernel is the count of wavefronts, not of bytes.  This core makes
// every lookup one wavefront and does one lookup pair per input byte for
// all output rows together:
//
//  * Row-packed nibble tables.  For input row j and a group g of four
//    output rows, word n of table (j, g, h) packs the four products
//      M[4g + q][j] * (n << 4h)      in byte q,  n = 0..15, h = 0 (low), 1
//    so one input byte x contributes T(j,g,0)[x & 15] ^ T(j,g,1)[x >> 4]
//    to all four rows at once.  A 16-word table lies on 16 distinct banks,
//    so any warp lookup into it is a single wavefront.  Tables are laid
//    out tab[((j * G + g) * 2 + h) * 16 + n], G = ceil(p / 4) groups: 128
//    bytes per (input row, group), 1.25 KiB for RS(10,4).
//  * Accumulators hold one packed word per byte position of an input
//    word; __byte_perm turns the 4x4 byte block into four row words.
//  * The same nibble form serves any GF(2)-linear map of a 32-bit word:
//    f(x) = XOR_k N_k[nibble k of x] with 8 tables of 16 words.  The CRC
//    step over one 4-byte word is f = Adv_4 (state ^ word), and the
//    fold of sub-segment or tile partials uses f = Adv_n.  2 conflict-free
//    lookups per byte instead of slicing-by-4's 1 lookup into 256-word
//    tables with random multi-way bank conflicts.
//  * A lookup's index is 4 * nibble, taken from a pre-shifted, masked
//    word by one PRMT; the kernels put their tables at offsets the
//    compiler knows, so the lookup itself is one LDS [reg + imm].
//
// The host builds every table (ops/rs_cuda.py); tests/test_torch_ops.py
// holds the tables and a numpy emulation of these steps against the JAX
// package.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace swgf {

// Output rows one launch computes; the wrappers split larger matrices.
constexpr int kMaxRows = 16;
// Dynamic shared memory a block may take on Hopper (227 KiB).
constexpr size_t kMaxSmem = 232448;
// Words of one row group's tables for one input row (2 halves x 16).
constexpr int kGroupWords = 32;
// Words of one nibble-form 32-bit linear map (8 nibbles x 16).
constexpr int kMapWords = 128;

__device__ __forceinline__ uint32_t lds_at(const uint32_t* base,
                                           uint32_t byte_off) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(base) + byte_off);
}

// Byte e of x, zero-extended: one PRMT.  With x holding 4 * nibble in
// every byte, that is the byte offset of a 16-word table entry; tables at
// offsets the compiler knows then cost one LDS [reg + imm] per lookup.
// (A shift and a mask instead measured 20% slower in K2.)
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int e) {
  return __byte_perm(x, 0u, 0x4440u | static_cast<uint32_t>(e));
}

// acc[e][g] ^= packed products of byte e of v with the (j, g) tables;
// t points at input row j's tables (G groups of kGroupWords words).
template <int G>
__device__ __forceinline__ void gf_mac(const uint32_t* t, uint32_t v,
                                       uint32_t (&acc)[4][G]) {
  // 4 * nibble in every byte: the byte offset of a 16-word table entry
  const uint32_t lo = (v << 2) & 0x3C3C3C3Cu;
  const uint32_t hi = (v >> 2) & 0x3C3C3C3Cu;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t il = byte_of(lo, e);
    const uint32_t ih = byte_of(hi, e);
#pragma unroll
    for (int g = 0; g < G; ++g)
      acc[e][g] ^= lds_at(t + g * kGroupWords, il) ^
                   lds_at(t + g * kGroupWords + 16, ih);
  }
}

// Row words from the byte-position accumulators: row 4g + q's word has
// byte e = byte q of acc[e][g].
template <int G>
__device__ __forceinline__ void gf_rows(const uint32_t (&acc)[4][G],
                                        uint32_t (&row)[4 * G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t t0 = __byte_perm(acc[0][g], acc[1][g], 0x5140);
    const uint32_t t1 = __byte_perm(acc[2][g], acc[3][g], 0x5140);
    const uint32_t t2 = __byte_perm(acc[0][g], acc[1][g], 0x7362);
    const uint32_t t3 = __byte_perm(acc[2][g], acc[3][g], 0x7362);
    row[4 * g + 0] = __byte_perm(t0, t1, 0x5410);
    row[4 * g + 1] = __byte_perm(t0, t1, 0x7632);
    row[4 * g + 2] = __byte_perm(t2, t3, 0x5410);
    row[4 * g + 3] = __byte_perm(t2, t3, 0x7632);
  }
}

// f(x) for a GF(2)-linear map f in nibble form: m[k * 16 + n] = f(n << 4k).
__device__ __forceinline__ uint32_t nib_apply(const uint32_t* m, uint32_t x) {
  const uint32_t lo = (x << 2) & 0x3C3C3C3Cu;  // even nibbles, as offsets
  const uint32_t hi = (x >> 2) & 0x3C3C3C3Cu;  // odd nibbles
  uint32_t r = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r ^= lds_at(m + (2 * e) * 16, byte_of(lo, e)) ^
         lds_at(m + (2 * e + 1) * 16, byte_of(hi, e));
  return r;
}

// Blocks of a kernel resident on the current device at once, cached by
// the caller per kernel (one `Resident` per launch template instance) so
// a launch makes no query.  Raises the kernel's shared-memory limit first
// when it needs more than 48 KiB.
struct Resident {
  int dev = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                            Resident* cache) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || (cur == cache->dev && smem == cache->smem))
    return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, cur);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  cache->blocks = sms * (per_sm > 0 ? per_sm : 1);
  cache->smem = smem;
  cache->dev = cur;
  return cudaSuccess;
}

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned); `valid` false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the newest committed group is in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `nwords` 32-bit words (both pointers 4-aligned) with the whole
// block, typically from device to shared memory.
__device__ __forceinline__ void block_copy_words(uint32_t* dst,
                                                 const uint32_t* src,
                                                 int nwords) {
  for (int k = threadIdx.x; k < nwords; k += blockDim.x) dst[k] = src[k];
}

}  // namespace swgf
