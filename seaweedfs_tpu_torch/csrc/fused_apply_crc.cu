// K2, fused_apply_crc: for a batch X (B, d, L) of byte rows and a
// (p, d) GF(2^8) matrix M, one pass computes
//   out (B, p, L) = M x X[b]                      (parity, or rebuilt rows)
//   crc (B, d + p) = raw_update(0, row)            (raw CRC32C image of
//                                                   every input and output row)
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py:_fused_words_kernel
// (reached through _fused_encode_words and fused_encode_words) and the XLA
// epilogue that folded its per-segment CRC partials.
//
// Bound on this card: bytes.  A launch at the encode shape (6, 10, 1 MiB)
// reads 60 MiB and writes 24 MiB, about 26 us at 3.35 TB/s; the table
// lookups and the CRC's dependent chain are latency the design hides
// behind enough resident blocks.  Design:
//  * a block owns one (d, T) column tile of one batch row and reads it from
//    device memory exactly once, into shared memory;
//  * it computes the tile's p output rows from the shared product tables
//    (the K1 core) into shared memory, and writes them out;
//  * the (d + p) rows of the tile are then CRC'd from shared memory: each
//    thread runs a slicing-by-4 table CRC over one T/S-byte sub-segment,
//    and one thread per row folds the S partials with the 32x32 GF(2)
//    operator Adv_{T/S} (32 uint32 columns built on the host);
//  * a second small kernel folds each row's tile partials, a warp per row:
//    every lane folds m consecutive tiles with Adv_T, then a shuffle tree
//    combines lanes with Adv_{m T 2^k}.
// Any L >= 1 works: the row is treated as front-padded with zeros to a
// whole number of tiles.  A raw CRC image is unchanged by leading zeros and
// GF rows of zero columns are zero, so only the first tile is short and
// only one advance length is needed per fold level.  Sub-segments sit in
// shared memory with one skew word after each, so the CRC threads of a
// warp hit distinct banks.
#include "gf_core.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t adv_apply(const uint32_t* cols,
                                              uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= cols[i] & (0u - ((x >> i) & 1u));
  return r;
}

struct Geometry {
  int d, p, rows;     // rows = d + p
  long long length;   // L
  int tile;           // T bytes per block, a power of two
  int sub;            // S sub-segments per tile row, a power of two
  int ntiles;
  int pad;            // ntiles * T - L leading virtual zero bytes
};

__global__ void __launch_bounds__(kThreads)
tile_kernel(Geometry g, bool vec, const uint8_t* __restrict__ tab_g,
            const uint32_t* __restrict__ crc_t_g,
            const uint32_t* __restrict__ adv_g,
            const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
            uint32_t* __restrict__ partial) {
  extern __shared__ uint32_t sm[];
  const int wpr = g.tile / 4;        // words per tile row
  const int wsub = wpr / g.sub;      // words per sub-segment
  const int rs = wpr + g.sub;        // row stride with one skew word per sub
  uint32_t* tile = sm;
  uint32_t* crc_t = tile + g.rows * rs;
  uint32_t* adv = crc_t + 1024;
  uint32_t* part = adv + 32;
  uint8_t* tab = reinterpret_cast<uint8_t*>(part + g.rows * g.sub);
  swgf::block_copy_words(reinterpret_cast<uint32_t*>(tab),
                         reinterpret_cast<const uint32_t*>(tab_g),
                         g.p * g.d * 64);
  swgf::block_copy_words(crc_t, crc_t_g, 1024);
  swgf::block_copy_words(adv, adv_g, 32);
  auto skew = [wsub](int w) { return w + w / wsub; };

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  // real column of the tile's first byte; negative columns are the
  // virtual leading zeros
  const long long v0 = static_cast<long long>(t) * g.tile - g.pad;
  const uint8_t* xb = x + static_cast<long long>(b) * g.d * g.length;
  uint8_t* ob = out + static_cast<long long>(b) * g.p * g.length;

  // 1. the (d, T) input tile, read from device memory once
  if (vec) {
    const int gpr = g.tile / 16;
    for (int k = threadIdx.x; k < g.d * gpr; k += blockDim.x) {
      const int j = k / gpr, q = k % gpr;
      const long long c = v0 + q * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c >= 0)
        val = *reinterpret_cast<const uint4*>(xb + j * g.length + c);
      uint32_t* dst = tile + j * rs + skew(q * 4);
      dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
    }
  } else {
    for (int k = threadIdx.x; k < g.d * wpr; k += blockDim.x) {
      const int j = k / wpr, w = k % wpr;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long c = v0 + w * 4 + e;
        if (c >= 0)
          word |= static_cast<uint32_t>(xb[j * g.length + c]) << (8 * e);
      }
      tile[j * rs + skew(w)] = word;
    }
  }
  __syncthreads();

  // 2. the p output rows of the tile, into shared memory
  for (int w = threadIdx.x; w < wpr; w += blockDim.x) {
    const int sw = skew(w);
    uint32_t acc[swgf::kMaxRows];
#pragma unroll
    for (int i = 0; i < swgf::kMaxRows; ++i) acc[i] = 0;
    for (int j = 0; j < g.d; ++j) {
      const uint32_t v = tile[j * rs + sw];
#pragma unroll
      for (int i = 0; i < swgf::kMaxRows; ++i)
        if (i < g.p) acc[i] ^= swgf::mul_word(tab + (i * g.d + j) * 256, v);
    }
#pragma unroll
    for (int i = 0; i < swgf::kMaxRows; ++i)
      if (i < g.p) tile[(g.d + i) * rs + sw] = acc[i];
  }
  __syncthreads();

  // 3. write the output rows' real columns
  if (vec) {
    const int gpr = g.tile / 16;
    for (int k = threadIdx.x; k < g.p * gpr; k += blockDim.x) {
      const int i = k / gpr, q = k % gpr;
      const long long c = v0 + q * 16;
      if (c < 0) continue;
      const uint32_t* src = tile + (g.d + i) * rs + skew(q * 4);
      *reinterpret_cast<uint4*>(ob + i * g.length + c) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int k = threadIdx.x; k < g.p * wpr; k += blockDim.x) {
      const int i = k / wpr, w = k % wpr;
      const uint32_t word = tile[(g.d + i) * rs + skew(w)];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long c = v0 + w * 4 + e;
        if (c >= 0)
          ob[i * g.length + c] = static_cast<uint8_t>(word >> (8 * e));
      }
    }
  }

  // 4. raw CRC of every sub-segment of the d + p tile rows
  if (threadIdx.x < g.rows * g.sub) {
    const int r = threadIdx.x / g.sub, s = threadIdx.x % g.sub;
    const uint32_t* src = tile + r * rs + s * (wsub + 1);
    uint32_t st = 0;
    for (int k = 0; k < wsub; ++k) {
      st ^= src[k];
      st = crc_t[768 + (st & 0xFFu)] ^ crc_t[512 + ((st >> 8) & 0xFFu)] ^
           crc_t[256 + ((st >> 16) & 0xFFu)] ^ crc_t[st >> 24];
    }
    part[threadIdx.x] = st;
  }
  __syncthreads();
  // 5. fold the sub-segments of each row into the tile's partial
  if (threadIdx.x < g.rows) {
    uint32_t acc = 0;
    for (int s = 0; s < g.sub; ++s)
      acc = adv_apply(adv, acc) ^ part[threadIdx.x * g.sub + s];
    partial[(static_cast<long long>(b) * g.rows + threadIdx.x) * g.ntiles +
            t] = acc;
  }
}

// One warp per (row, batch): folds the row's ntiles partials.  adv_g holds
// six operators of 32 columns: Adv_T, then Adv_{m T 2^k} for k = 0..4.
__global__ void fold_kernel(int rows, int ntiles, int m,
                            const uint32_t* __restrict__ adv_g,
                            const uint32_t* __restrict__ partial,
                            uint32_t* __restrict__ crc) {
  __shared__ uint32_t adv[6 * 32];
  for (int k = threadIdx.x; k < 6 * 32; k += blockDim.x) adv[k] = adv_g[k];
  __syncthreads();
  const int r = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const uint32_t* src =
      partial + (static_cast<long long>(b) * rows + r) * ntiles;
  const int lead = 32 * m - ntiles;  // virtual zero tiles at the front
  uint32_t acc = 0;
  for (int q = 0; q < m; ++q) {
    const int vt = lane * m + q - lead;
    acc = adv_apply(adv, acc) ^ (vt >= 0 ? src[vt] : 0u);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, acc, 1 << k);
    if ((lane & ((2 << k) - 1)) == 0)
      acc = adv_apply(adv + 32 * (k + 1), acc) ^ right;
  }
  if (lane == 0) crc[static_cast<long long>(b) * rows + r] = acc;
}

// Shared memory of one tile block, in bytes; ops/rs_cuda.py chooses T
// with the same formula.
long long smem_bytes(int p, int d, int tile, int sub) {
  const int rows = d + p;
  return (static_cast<long long>(rows) * (tile / 4 + sub) + 1024 + 32 +
          static_cast<long long>(rows) * sub) * 4 +
         static_cast<long long>(p) * d * 256;
}

}  // namespace

// tab: (p, d, 256) product table; crc_tables: (4, 256) slicing tables;
// adv_sub: Adv_{T/S} columns; adv_fold: six operators (see fold_kernel);
// x: (batch, d, L) bytes; out: (batch, p, L) bytes; partial: (batch, d + p,
// ntiles) uint32 scratch; crc: (batch, d + p) uint32.
extern "C" int sw_fused_apply_crc(const void* tab, int p, int d,
                                  const void* crc_tables,
                                  const void* adv_sub, const void* adv_fold,
                                  const void* x, int batch,
                                  long long length, int tile, int sub,
                                  void* out, void* partial, void* crc,
                                  void* stream) {
  const int rows = d + p;
  if (p < 1 || p > swgf::kMaxRows || d < 1 || batch < 1 || batch > 65535 ||
      length < 1 || sub < 1 || rows * sub > kThreads ||
      tile % (16 * sub) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(p, d, tile, sub);
  if (smem > static_cast<long long>(swgf::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.d = d;
  g.p = p;
  g.rows = rows;
  g.length = length;
  g.tile = tile;
  g.sub = sub;
  g.ntiles = static_cast<int>((length + tile - 1) / tile);
  g.pad = static_cast<int>(static_cast<long long>(g.ntiles) * tile - length);
  const bool vec = length % 16 == 0 && g.pad % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<<<dim3(g.ntiles, batch), kThreads, static_cast<size_t>(smem),
                s>>>(g, vec, static_cast<const uint8_t*>(tab),
                     static_cast<const uint32_t*>(crc_tables),
                     static_cast<const uint32_t*>(adv_sub),
                     static_cast<const uint8_t*>(x),
                     static_cast<uint8_t*>(out),
                     static_cast<uint32_t*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = (g.ntiles + 31) / 32;
  fold_kernel<<<dim3(rows, batch), 32, 0, s>>>(
      rows, g.ntiles, m, static_cast<const uint32_t*>(adv_fold),
      static_cast<const uint32_t*>(partial), static_cast<uint32_t*>(crc));
  return static_cast<int>(cudaGetLastError());
}
