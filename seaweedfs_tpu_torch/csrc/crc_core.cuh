// CRC32C device code shared by K2 (fused_apply_crc.cu) and K8
// (crc32c_rows.cu): tile staging offsets, the item walk of a persistent
// grid, one thread's CRC of a sub-segment as interleaved streams, the
// shuffle tree that folds a row's sub-segments, and the kernel that folds
// each row's tile partials.  Every step is a nibble-form map of
// gf_core.cuh (f = Adv_n), so every lookup is one conflict-free wavefront.
//
// A raw image g(M) = raw_update(0, M) is GF(2)-linear and unchanged by
// leading zeros, and g(A || B) = Adv_|B|(g(A)) ^ g(B): so a row is cut
// into tiles of T bytes (front-padded with zeros to a whole number), a
// tile row into S sub-segments (one thread each, S consecutive lanes of
// one warp), a sub-segment into kStreams streams (independent dependent
// chains, joined at the end), and the pieces are joined with advances.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "gf_core.cuh"

namespace swcrc {
// Internal linkage: each kernel library holds its own copy, so two loaded
// libraries never share a kernel symbol.
namespace {

// Interleaved CRC streams per sub-segment: four independent dependent
// chains per thread instead of one.
constexpr int kStreams = 4;
// Nibble maps before the sub-segment fold operators: Adv_4 (the CRC
// step), Adv_{T/4S} and Adv_{T/2S} (joining a thread's four streams).
constexpr int kStreamMaps = 3;

// Byte offset of 16-byte chunk q inside a staged tile row: one 16-byte
// skew chunk after every sub-segment, so the CRC threads' 16-byte reads of
// one warp phase hit distinct banks.
__device__ __forceinline__ int chunk_off(int q, int cps_shift) {
  return (q + (q >> cps_shift)) << 4;
}

// The next (row, tile) item of a block that walks items `step` apart: a
// division only when the walk wraps to another row.
__device__ __forceinline__ void next_item(int& b, int& t, int step,
                                          int ntiles) {
  t += step;
  if (t >= ntiles) {
    b += t / ntiles;
    t %= ntiles;
  }
}

// Raw CRC image of the `seg` staged bytes at `src` (16-byte aligned, seg a
// multiple of 16 * kStreams): kStreams interleaved streams of seg /
// kStreams bytes, each stepped one 4-byte word at a time by crc_map (Adv_4
// on state ^ word), then joined with Adv_{seg/4} and Adv_{seg/2}, the two
// maps after it.
__device__ __forceinline__ uint32_t crc_subsegment(
    const uint32_t* crc_map, const uint8_t* src, int seg) {
  const int part = seg / kStreams;
  uint32_t sk[kStreams] = {0u, 0u, 0u, 0u};
  for (int m = 0; m < part; m += 16) {
    uint4 v[kStreams];
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      v[k] = *reinterpret_cast<const uint4*>(src + k * part + m);
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      sk[k] = swgf::nib_apply(crc_map, sk[k] ^ v[k].x);
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      sk[k] = swgf::nib_apply(crc_map, sk[k] ^ v[k].y);
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      sk[k] = swgf::nib_apply(crc_map, sk[k] ^ v[k].z);
#pragma unroll
    for (int k = 0; k < kStreams; ++k)
      sk[k] = swgf::nib_apply(crc_map, sk[k] ^ v[k].w);
  }
  const uint32_t* adv_part = crc_map + swgf::kMapWords;
  return swgf::nib_apply(adv_part + swgf::kMapWords,
                         swgf::nib_apply(adv_part, sk[0]) ^ sk[1]) ^
         swgf::nib_apply(adv_part, sk[2]) ^ sk[3];
}

// Folds the sub-segment images of the S = 2^levels consecutive lanes that
// hold one tile row into the row's image, left in the group's first lane;
// level k's operator Adv_{T/S 2^k} is the nibble map adv + k * kMapWords.
// Every lane of the warp must call it.
__device__ __forceinline__ uint32_t shuffle_fold(uint32_t st,
                                                 const uint32_t* adv,
                                                 int levels) {
  for (int k = 0; k < levels; ++k) {
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, st, 1 << k);
    st = swgf::nib_apply(adv + k * swgf::kMapWords, st) ^ right;
  }
  return st;
}

// One warp per (row, batch): folds the row's ntiles partials into its raw
// CRC, written as an int64 holding the uint32 image.  The row is taken as
// 32 m tiles (virtual zero tiles in front); lane l Horner-folds tiles
// 32 q + l (coalesced loads) with Adv_{32 T}, and a shuffle tree joins
// lanes l and l + 2^k with Adv_{T 2^k}.  adv_g holds those six nibble
// maps: Adv_{32 T}, then Adv_{T 2^k} for k = 0..4.  partial and crc are
// laid out (batch, rows, ...).
__global__ void fold_kernel(int rows, int ntiles, int m,
                            const uint32_t* __restrict__ adv_g,
                            const uint32_t* __restrict__ partial,
                            long long* __restrict__ crc) {
  __shared__ uint32_t adv[6 * swgf::kMapWords];
#pragma unroll
  for (int i = 0; i < 6 * swgf::kMapWords / 32; ++i)
    adv[threadIdx.x + 32 * i] = adv_g[threadIdx.x + 32 * i];
  __syncthreads();
  const int r = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const uint32_t* src =
      partial + (static_cast<long long>(b) * rows + r) * ntiles;
  const int lead = 32 * m - ntiles;
  uint32_t acc = 0;
#pragma unroll 4
  for (int q = 0; q < m; ++q) {
    const int t = 32 * q + lane - lead;
    acc = swgf::nib_apply(adv, acc) ^ (t >= 0 ? src[t] : 0u);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, acc, 1 << k);
    if ((lane & ((2 << k) - 1)) == 0)
      acc = swgf::nib_apply(adv + swgf::kMapWords * (k + 1), acc) ^ right;
  }
  if (lane == 0) crc[static_cast<long long>(b) * rows + r] = acc;  // < 2^32
}

// log2 of a power of two, else -1.
inline int log2_exact(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return (1 << k) == v ? k : -1;
}

// Launches fold_kernel over (batch, rows, ntiles) partials into crc.
inline cudaError_t fold_partials(int rows, int batch, int ntiles,
                                 const void* adv_fold, const void* partial,
                                 void* crc, cudaStream_t s) {
  const int m = (ntiles + 31) / 32;
  fold_kernel<<<dim3(rows, batch), 32, 0, s>>>(
      rows, ntiles, m, static_cast<const uint32_t*>(adv_fold),
      static_cast<const uint32_t*>(partial), static_cast<long long*>(crc));
  return cudaGetLastError();
}

}  // namespace
}  // namespace swcrc
