// K1, gf_apply: out (p, L) = M (p, d) x X (d, L) over GF(2^8).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_gf_apply_kernel
// (reached through _apply_pallas and apply_matrix_pallas), which bit-sliced
// each tile and ran a GF(2) bit-matmul on the MXU.
//
// Bound on this card: bytes.  A (1, 10) x (10, 1 MiB) reconstruct moves
// 11 MiB (3.4 us at 3.35 TB/s) against 21 M conflict-free table lookups
// (0.66 M warp wavefronts, ~2.5 us of shared-memory time spread over 132
// SMs), so the floor is device memory, and what keeps a simple kernel
// from it is latency: a single wave of threads each waiting on one load
// at a time.  The first port had each thread load one 4-byte word per
// input row and look it up before loading the next row's word, 10 loads
// in series with nothing to hide them.  Design:
//  * each thread owns one 16-byte column chunk and issues the uint4 loads
//    of up to C = 16 input rows before its first lookup, so a thread has
//    up to 256 bytes in flight and works on each row as it arrives (d >
//    16 loads the next 16 after); the next chunk's first C loads are issued
//    before the current chunk's stores (a grid of one chunk per thread
//    measured faster than two chunks per thread with that overlap);
//  * the row-packed nibble tables of gf_core.cuh: two conflict-free
//    lookups per input byte serve up to four output rows (G groups for
//    up to 16), instead of four byte lookups per row;
//  * the tables (d * G * 128 bytes) go to shared memory by asynchronous
//    copies issued before the data loads: they land while the data is in
//    flight, and each thread starts on an input row as soon as it arrives;
//  * the grid is as many 256-thread blocks as the chunks need, capped at
//    what is resident on the card (a grid-stride loop covers the rest).
// Measured on an H100 (PERF.md): ~8.7 us of kernel time at that shape,
// about 2.5x its bound: the loads' ramp and the compute after the last
// row lands are not hidden inside one wave.
// A second path inside the kernel (VEC = false, C = 4) serves any L, any
// row stride and any pointer alignment, such as a view into a larger
// buffer: it assembles the chunk from byte loads and stores bytes, masking
// the ragged tail.  Rows of the input and of the output are `xs` and `os`
// bytes apart (a row of a strided view, or the (p, B*L) rows of the pooled
// parity step's output slot); bytes within a row are contiguous.
#include "gf_core.cuh"

namespace {

constexpr int kThreads = 256;

template <int C, bool VEC>
__device__ __forceinline__ void load_rows(uint4 (&v)[C],
                                          const uint8_t* __restrict__ x,
                                          long long xs, int d, int j0,
                                          long long q, long long nchunks,
                                          long long n) {
#pragma unroll
  for (int jj = 0; jj < C; ++jj) {
    const int j = j0 + jj;
    v[jj] = make_uint4(0u, 0u, 0u, 0u);
    if (j < d && q < nchunks) {
      const uint8_t* src = x + j * xs + q * 16;
      if (VEC) {
        v[jj] = __ldcs(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (q * 16 + e < n)
            w[e / 4] |= static_cast<uint32_t>(src[e]) << (8 * (e % 4));
        v[jj] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

template <int G, int C, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint32_t* __restrict__ tab_g, int p, int d,
                const uint8_t* __restrict__ x, long long xs, long long n,
                uint8_t* __restrict__ out, long long os) {
  extern __shared__ __align__(16) uint32_t tab[];
  const long long nchunks = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the tables go first, asynchronously: they land (L2 hits) while the
  // data loads are in flight, so each thread starts on its first input
  // row as soon as that row arrives
  for (int k = threadIdx.x; k < d * G * swgf::kGroupWords / 4;
       k += blockDim.x)
    swgf::cp_async16(tab + 4 * k, tab_g + 4 * k, true);
  swgf::cp_async_commit();
  uint4 v[C];
  load_rows<C, VEC>(v, x, xs, d, 0, q, nchunks, n);
  swgf::cp_async_wait_all();
  __syncthreads();
  for (; q < nchunks; q += stride) {
    uint32_t acc[4][4][G];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[w][e][g] = 0u;
    for (int j0 = 0;;) {
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        if (j0 + jj < d) {
          const uint32_t* t = tab + (j0 + jj) * G * swgf::kGroupWords;
          swgf::gf_mac<G>(t, v[jj].x, acc[0]);
          swgf::gf_mac<G>(t, v[jj].y, acc[1]);
          swgf::gf_mac<G>(t, v[jj].z, acc[2]);
          swgf::gf_mac<G>(t, v[jj].w, acc[3]);
        }
      }
      j0 += C;
      if (j0 >= d) break;
      load_rows<C, VEC>(v, x, xs, d, j0, q, nchunks, n);
    }
    // the next chunk's loads go out before this chunk's stores
    load_rows<C, VEC>(v, x, xs, d, 0, q + stride, nchunks, n);
    uint32_t rw[4][4 * G];
#pragma unroll
    for (int w = 0; w < 4; ++w) swgf::gf_rows<G>(acc[w], rw[w]);
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) {
      if (i >= p) break;
      uint8_t* dst = out + i * os + q * 16;
      if (VEC) {
        __stcs(reinterpret_cast<uint4*>(dst),
               make_uint4(rw[0][i], rw[1][i], rw[2][i], rw[3][i]));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (q * 16 + e < n)
            dst[e] = static_cast<uint8_t>(rw[e / 4][i] >> (8 * (e % 4)));
      }
    }
  }
}

template <int G, int C, bool VEC>
cudaError_t launch(const void* tab, int p, int d, const void* x, long long xs,
                   long long n, void* out, long long os,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * G * swgf::kGroupWords * 4;
  static swgf::Resident resident;
  cudaError_t err = swgf::resident_blocks(gf_apply_kernel<G, C, VEC>,
                                          kThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long nchunks = (n + 15) / 16;
  long long blocks = (nchunks + kThreads - 1) / kThreads;
  if (blocks > resident.blocks) blocks = resident.blocks;
  gf_apply_kernel<G, C, VEC>
      <<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(tab), p, d,
      static_cast<const uint8_t*>(x), xs, n, static_cast<uint8_t*>(out), os);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_g(const void* tab, int p, int d, const void* x,
                     long long xs, long long n, void* out, long long os,
                     cudaStream_t s) {
  // rows loaded ahead: 16 uint4 loads in flight per thread; the byte
  // path, bound by its byte loads anyway, batches 4 to keep its code small
  constexpr int C = VEC ? 16 : 4;
  switch ((p + 3) / 4) {
    case 1: return launch<1, C, VEC>(tab, p, d, x, xs, n, out, os, s);
    case 2: return launch<2, C, VEC>(tab, p, d, x, xs, n, out, os, s);
    case 3: return launch<3, C, VEC>(tab, p, d, x, xs, n, out, os, s);
    default: return launch<4, C, VEC>(tab, p, d, x, xs, n, out, os, s);
  }
}

}  // namespace

// tab: (d, G, 2, 16) uint32 row-packed nibble tables on the device
// (G = ceil(p / 4), see gf_core.cuh); x: (d, L) bytes, rows xs bytes
// apart; out: (p, L) bytes, rows os bytes apart.  Returns a cudaError_t.
extern "C" int sw_gf_apply(const void* tab, int p, int d, const void* x,
                           long long xs, long long length, void* out,
                           long long os, void* stream) {
  if (p < 1 || p > swgf::kMaxRows || d < 1 || length < 1 ||
      (d > 1 && xs < length) || (p > 1 && os < length) ||
      static_cast<size_t>(d) * ((p + 3) / 4) * swgf::kGroupWords * 4 >
          swgf::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = length % 16 == 0 && xs % 16 == 0 && os % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return static_cast<int>(
        launch_g<true>(tab, p, d, x, xs, length, out, os, s));
  return static_cast<int>(
      launch_g<false>(tab, p, d, x, xs, length, out, os, s));
}
