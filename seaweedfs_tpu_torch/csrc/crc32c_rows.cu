// K8, crc32c_rows: for a batch X (B, R, L) of byte rows, the raw CRC32C
// image of every row,
//   crc (B, R) = raw_update(0, row)
// which the host finalizes and chains (ops/crc32c.py).  The deep scrub
// runs it over each batch's 14 staged shard rows and the 4 parity rows K1
// recomputed beside them, so no CRC of a recompute batch runs on the host
// and the parity never comes back.
//
// The CRC half of K2 (fused_apply_crc.cu) without its GF half, on the
// device code both include (crc_core.cuh): the CRC step over one 4-byte
// word as 8 conflict-free nibble lookups, each thread's sub-segment as 4
// interleaved streams, a tile row's S sub-segments folded in a shuffle
// tree, the tile partials folded by fold_kernel.
//
// Bound on this card: device-memory bytes (the scrub's shape (3, 18,
// 1 MiB) reads 54 MiB, 16.9 us at 3.35 TB/s) against the shared-memory
// and integer pipes: 8 lookups and ~26 integer ops per 4-byte word, ~14 M
// words per launch at that shape, so the two sides are about even.
// Design:
//  * Rows are taken one by one, not a batch item's R rows together as in
//    K2 (whose GF half needs a column of every row): an item is a group of
//    256 / S rows (row n = b R + r, at b * xbs + r * xrs bytes) over one
//    tile of T bytes, so every thread of a block CRCs whatever R is.  At
//    T = 4096, S = 32: 8 rows an item, a warp per row, 128 bytes a lane.
//  * A persistent grid (as many 256-thread blocks as are resident, ~74 KiB
//    of shared memory each) walks the items; each loads its maps once, and
//    a two-stage ring of tiles filled with 16-byte cp.async keeps the next
//    item's loads in flight while this one computes.
//  * Short rows take a smaller tile (down to 64 bytes, S = 1, 256 rows an
//    item), so a 16-byte row costs a 64-byte tile, not a 4 KiB one.
// Any L >= 1 works: a row is front-padded with zeros to a whole number of
// tiles, which leaves its raw image unchanged.  cp.async needs 16-byte
// aligned sources, so when L % 16 != 0, a stride is not a multiple of 16
// or the pointer is misaligned, a second path loads bytes with plain
// instructions; everything else is shared.
#include "crc_core.cuh"
#include "gf_core.cuh"

namespace {

using swcrc::chunk_off;
using swcrc::kStreamMaps;
using swcrc::kStreams;
using swcrc::log2_exact;
using swcrc::next_item;

constexpr int kThreads = 256;
// Room for every nibble map: the stream maps and up to log2(32) fold maps.
constexpr int kMapsWords = (kStreamMaps + 5) * swgf::kMapWords;

struct Geometry {
  int rows;           // R rows per batch item
  int nrows;          // B * R rows in all
  long long length;   // L
  int tile;           // T bytes per item, a power of two
  int sub;            // S sub-segments per tile row, a power of two <= 32
  int levels;         // log2(S)
  int cps_shift;      // log2(T / 16 / S): 16-byte chunks per sub-segment
  int group;          // rows per item, kThreads / S
  int ngroups;        // ceil(nrows / group)
  int ntiles;
  int pad;            // ntiles * T - L leading virtual zero bytes
  long long xbs, xrs;  // batch and row strides, bytes
};

// Stage the tile t of row group gi (group rows `rs` bytes apart in
// `stage`; rows past the last are zeros).  vec: asynchronous 16-byte
// copies (the caller commits the group); else plain byte loads.  A warp's
// copies of one row are 32 consecutive chunks.
__device__ __forceinline__ void load_tile(const Geometry& g, bool vec,
                                          const uint8_t* __restrict__ x,
                                          int gi, int t, uint8_t* stage,
                                          int rs) {
  const long long v0 = static_cast<long long>(t) * g.tile - g.pad;
  const int n0 = gi * g.group;
  const int b0 = n0 / g.rows, r0 = n0 - b0 * g.rows;
  for (int q = threadIdx.x; q < (g.tile >> 4); q += kThreads) {
    const long long c = v0 + q * 16;
    uint8_t* dst = stage + chunk_off(q, g.cps_shift);
    int b = b0, r = r0;
    for (int j = 0; j < g.group; ++j, dst += rs) {
      const bool row = n0 + j < g.nrows;
      const uint8_t* src =
          x + static_cast<long long>(b) * g.xbs + r * g.xrs + (c >= 0 ? c : 0);
      if (vec) {
        swgf::cp_async16(dst, row ? src : x, row && c >= 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (row) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (c + e >= 0)
              w[e / 4] |= static_cast<uint32_t>(src[c >= 0 ? e : c + e])
                          << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (++r == g.rows) {
        r = 0;
        ++b;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(Geometry g, bool vec, const uint32_t* __restrict__ maps_g,
            const uint8_t* __restrict__ x, uint32_t* __restrict__ partial) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* crc_map = sm;
  uint32_t* adv = crc_map + kStreamMaps * swgf::kMapWords;
  const int rs = g.tile + 16 * g.sub;  // bytes between staged rows
  uint8_t* stages = reinterpret_cast<uint8_t*>(sm + kMapsWords);
  const int seg = g.tile >> g.levels;

  int gi = blockIdx.x / g.ntiles, t = blockIdx.x % g.ntiles;
  if (gi < g.ngroups) load_tile(g, vec, x, gi, t, stages, rs);
  swgf::cp_async_commit();
  swgf::block_copy_words(crc_map, maps_g,
                         (kStreamMaps + g.levels) * swgf::kMapWords);

  const int r = threadIdx.x >> g.levels, s = threadIdx.x & (g.sub - 1);
  for (int it = 0; gi < g.ngroups; ++it) {
    uint8_t* cur = stages + (it & 1) * g.group * rs;
    // the next item's tile goes in flight before this one computes
    int ngi = gi, nt = t;
    next_item(ngi, nt, gridDim.x, g.ntiles);
    if (ngi < g.ngroups)
      load_tile(g, vec, x, ngi, nt, stages + ((it + 1) & 1) * g.group * rs,
                rs);
    swgf::cp_async_commit();
    swgf::cp_async_wait_prior();
    __syncthreads();

    // every thread CRCs one sub-segment; a row's S lanes then fold
    const int n = gi * g.group + r;
    uint32_t st = 0;
    if (n < g.nrows)
      st = swcrc::crc_subsegment(crc_map, cur + r * rs + s * (seg + 16), seg);
    st = swcrc::shuffle_fold(st, adv, g.levels);
    if (n < g.nrows && s == 0)
      partial[static_cast<long long>(n) * g.ntiles + t] = st;
    // the stage is free for the item after next
    __syncthreads();
    gi = ngi;
    t = nt;
  }
}

// Shared memory of one block, in bytes; ops/rs_cuda.py chooses T and S
// with the same formula.
long long smem_bytes(int tile, int sub) {
  return kMapsWords * 4LL +
         2LL * (kThreads / sub) * (static_cast<long long>(tile) + 16 * sub);
}

}  // namespace

// maps: 3 + log2(S) nibble maps of 128 uint32 (Adv_4 for the CRC step,
// Adv_{T/4S} and Adv_{T/2S} for its streams, then Adv_{T/S 2^k});
// adv_fold: six nibble maps (swcrc::fold_kernel); x: (batch, rows, L)
// bytes with batch and row strides xbs, xrs; partial: (batch, rows,
// ntiles) uint32 scratch; crc: (batch, rows) int64, each the uint32 raw
// image.
extern "C" int sw_crc32c_rows(const void* maps, const void* adv_fold,
                              const void* x, long long xbs, long long xrs,
                              int batch, int rows, long long length,
                              int tile, int sub, void* partial, void* crc,
                              void* stream) {
  const int levels = log2_exact(sub);
  if (batch < 1 || batch > 65535 || rows < 1 || rows > 65535 ||
      length < 1 || levels < 0 || sub > 32 || log2_exact(tile) < 0 ||
      tile % (16 * kStreams * sub) != 0 || xbs < 0 || xrs < 0 ||
      static_cast<long long>(batch) * rows > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(tile, sub);
  if (smem > static_cast<long long>(swgf::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.rows = rows;
  g.nrows = batch * rows;
  g.length = length;
  g.tile = tile;
  g.sub = sub;
  g.levels = levels;
  g.cps_shift = log2_exact(tile / 16 / sub);
  g.group = kThreads / sub;
  g.ngroups = (g.nrows + g.group - 1) / g.group;
  g.ntiles = static_cast<int>((length + tile - 1) / tile);
  g.pad = static_cast<int>(static_cast<long long>(g.ntiles) * tile - length);
  g.xbs = xbs;
  g.xrs = xrs;
  const bool vec = length % 16 == 0 && xbs % 16 == 0 && xrs % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static swgf::Resident resident;
  cudaError_t err = swgf::resident_blocks(rows_kernel, kThreads,
                                          static_cast<size_t>(smem),
                                          &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = resident.blocks;
  const long long items = static_cast<long long>(g.ngroups) * g.ntiles;
  if (blocks > items) blocks = items;
  rows_kernel<<<static_cast<int>(blocks), kThreads,
                static_cast<size_t>(smem), s>>>(
      g, vec, static_cast<const uint32_t*>(maps),
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      swcrc::fold_partials(rows, batch, g.ntiles, adv_fold, partial, crc, s));
}
