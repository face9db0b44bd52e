// K1, gf_apply: out (rows, L) = M (rows, d) x X (d, L) over GF(2^8).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_apply_kernel
// (reached through _apply_pallas and apply_matrix_pallas), which bit-sliced
// each tile and ran a GF(2) bit-matmul on the MXU.
//
// Bound on this card: bytes.  Each output byte costs d table lookups, so a
// (1, 10) x (10, 1 MiB) reconstruct moves 11 MiB against ~10 M lookups,
// far below the shared-memory lookup rate; HBM traffic (d + rows) * L is
// the floor.  Design: the product tables sit in shared memory, each thread
// owns one 4-byte column word (one byte when L or a pointer is not
// 4-aligned) of every output row, reads each input word from device memory
// once and keeps the rows' accumulators in registers.  A grid-stride loop
// lets a bounded grid cover any L, and the ragged tail is masked by the
// loop bound.
#include "gf_core.cuh"

namespace {

template <typename W>
__global__ void gf_apply_kernel(const uint8_t* __restrict__ tab_g, int rows,
                                int d, const W* __restrict__ x,
                                long long n, W* __restrict__ out) {
  extern __shared__ uint32_t smem_words[];
  uint8_t* tab = reinterpret_cast<uint8_t*>(smem_words);
  swgf::block_copy_words(smem_words,
                         reinterpret_cast<const uint32_t*>(tab_g),
                         rows * d * 64);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < n; w += stride) {
    W acc[swgf::kMaxRows];
#pragma unroll
    for (int i = 0; i < swgf::kMaxRows; ++i) acc[i] = 0;
    for (int j = 0; j < d; ++j) {
      const W v = x[j * n + w];
#pragma unroll
      for (int i = 0; i < swgf::kMaxRows; ++i)
        if (i < rows) acc[i] ^= swgf::mul_word(tab + (i * d + j) * 256, v);
    }
#pragma unroll
    for (int i = 0; i < swgf::kMaxRows; ++i)
      if (i < rows) out[i * n + w] = acc[i];
  }
}

template <typename W>
cudaError_t launch(const void* tab, int rows, int d, const void* x,
                   long long n, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * d * 256;
  cudaError_t err = cudaFuncSetAttribute(
      gf_apply_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  gf_apply_kernel<W><<<static_cast<int>(blocks), threads, smem, stream>>>(
      static_cast<const uint8_t*>(tab), rows, d, static_cast<const W*>(x), n,
      static_cast<W*>(out));
  return cudaGetLastError();
}

}  // namespace

// tab: (rows, d, 256) product table on the device; x: (d, L) contiguous
// bytes; out: (rows, L) contiguous bytes.  Returns a cudaError_t.
extern "C" int sw_gf_apply(const void* tab, int rows, int d, const void* x,
                           long long length, void* out, void* stream) {
  if (rows < 1 || rows > swgf::kMaxRows || d < 1 || length < 1 ||
      static_cast<size_t>(rows) * d * 256 > swgf::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool words = length % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (words) return static_cast<int>(
      launch<uint32_t>(tab, rows, d, x, length / 4, out, s));
  return static_cast<int>(launch<uint8_t>(tab, rows, d, x, length, out, s));
}
