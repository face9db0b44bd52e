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
// Bound on this card: device-memory bytes in principle (a launch at the
// encode shape (6, 10, 1 MiB) reads 60 MiB and writes 24 MiB, 26.3 us at
// 3.35 TB/s), but every byte also goes through table lookups, and what
// binds this design is the SM's shared-memory pipe (one wavefront per
// distinct bank word a warp touches, one wavefront per clock) together
// with its integer pipe.  The first port spent ~24 M wavefronts per launch
// (~92 us at 1.98 GHz on 132 SMs): 4 byte lookups per (output row, input
// byte) into 256-byte tables with 2-way bank conflicts, and a slicing-by-4
// CRC on 256-word tables with random multi-way conflicts.  It also ran
// load, GF, CRC and fold in strict order and reloaded 14 KiB of tables
// for every 4 KiB column tile.  This design, per launch at that shape:
//  * GF: the row-packed nibble tables of gf_core.cuh.  Two conflict-free
//    lookups per input byte give the products of up to four output rows
//    (d * L * 2 lookups instead of p * d * L for p <= 4): 3.9 M wavefronts.
//  * CRC: the update of one 4-byte word, Adv_4(state ^ word), as 8
//    conflict-free nibble lookups: 5.5 M wavefronts.  The (d + p) * S
//    threads of a tile (S sub-segments per row, a power of two up to 32,
//    so a row's sub-segments lie in one warp) each CRC one contiguous
//    sub-segment as 4 interleaved streams (four dependent chains, joined
//    with Adv_{T/4S} and Adv_{T/2S}), and a row's S partials fold in a
//    shuffle tree whose level-k operator Adv_{T/S 2^k} is a nibble map.
//  * Every map and table sits at a shared-memory offset the compiler
//    knows (the row loop is unrolled up to d = 16), so a lookup is a PRMT
//    and an LDS [reg + imm]: 16 integer ops and 8 lookups per 4-byte word.
//  * A persistent grid: as many 256-thread blocks as are resident (2 per
//    SM at RS(10,4), 107 KiB of shared memory each) walk the (batch, tile)
//    items; each loads its tables once (1.4 MB per launch instead of 22),
//    and a two-stage ring of input tiles filled with 16-byte cp.async
//    keeps tile k+1's loads in flight while tile k computes.  Index math
//    has no division: tiles are walked incrementally, offsets are shifts.
//  * The output rows go to device memory straight from registers
//    (16-byte streaming stores) and to shared memory for the CRC.
//  * A second small kernel folds each row's tile partials, a warp per row
//    (fold_kernel), and writes the int64 images the wrapper returns.
// Counted: ~11.9 M wavefronts (45.6 us) and ~19.6 M integer warp
// instructions per launch; measured compute alone ~58 us and the kernel
// ~72 us on an H100 (PERF.md), so what remains is the two pipes' joint
// limit and the memory time the two-stage ring does not hide.
// Any L >= 1 works: the row is treated as front-padded with zeros to a
// whole number of tiles.  A raw CRC image is unchanged by leading zeros and
// GF rows of zero columns are zero, so only the first tile is short and
// only one advance length is needed per fold level.  cp.async needs
// 16-byte-aligned sources, so when L % 16 != 0, a stride is not a multiple
// of 16 or a pointer is misaligned (a view into a larger buffer) a second
// path inside the kernel loads and stores bytes with plain instructions;
// everything else is shared.  Input and output are strided views: batch
// b's row j starts b * xbs + j * xrs bytes into x (b * obs + i * ors into
// out), so the (B, k, L) permute of a (k, B, L) buffer, the pooled parity
// step's layout, reaches the kernel without a copy; bytes within a row are
// contiguous.  Each
// sub-segment sits in shared memory with a 16-byte skew after it, so the
// CRC threads' 16-byte reads of one warp phase hit distinct banks.
#include <type_traits>

#include "gf_core.cuh"

namespace {

constexpr int kThreads = 256;
// Interleaved CRC streams per sub-segment: four independent dependent
// chains per thread instead of one.
constexpr int kStreams = 4;
// Nibble maps before the sub-segment fold operators: Adv_4 (the CRC
// step), Adv_{T/4S} and Adv_{T/2S} (joining a thread's four streams).
constexpr int kStreamMaps = 3;
// Shared memory starts with room for every nibble map (the stream maps and
// up to log2(32) fold maps), then the GF tables: both at offsets the
// compiler knows, so a lookup is one LDS [reg + imm].
constexpr int kMapsWords = (kStreamMaps + 5) * swgf::kMapWords;
// Input rows up to which the GF loop is unrolled (larger d loops).
constexpr int kUnrollD = 16;

struct Geometry {
  int d, p, rows;     // rows = d + p
  long long length;   // L
  int tile;           // T bytes per item, a power of two
  int sub;            // S sub-segments per tile row, a power of two <= 32
  int levels;         // log2(S)
  int cps_shift;      // log2(T / 16 / S): 16-byte chunks per sub-segment
  int ntiles;
  int pad;            // ntiles * T - L leading virtual zero bytes
  int batch;
  long long xbs, xrs;  // input batch and row strides, bytes
  long long obs, ors;  // output batch and row strides, bytes
};

// Byte offset of 16-byte chunk q inside a tile row: one skew chunk after
// every sub-segment.
__device__ __forceinline__ int chunk_off(int q, int cps_shift) {
  return (q + (q >> cps_shift)) << 4;
}

// The next (batch row, tile) item of a block that walks items `step`
// apart: a division only when the walk wraps to another batch row.
__device__ __forceinline__ void next_item(int& b, int& t, int step,
                                          int ntiles) {
  t += step;
  if (t >= ntiles) {
    b += t / ntiles;
    t %= ntiles;
  }
}

// Stage the (d, T) input tile (b, t) into `stage` (rows `rs` bytes
// apart).  vec: asynchronous 16-byte copies (the caller commits the
// group); else plain byte loads.  A warp's copies of one row are 32
// consecutive chunks.
__device__ __forceinline__ void load_tile(const Geometry& g, bool vec,
                                          const uint8_t* __restrict__ x,
                                          int b, int t, uint8_t* stage,
                                          int rs) {
  const long long v0 = static_cast<long long>(t) * g.tile - g.pad;
  const uint8_t* xb = x + static_cast<long long>(b) * g.xbs;
  for (int q = threadIdx.x; q < (g.tile >> 4); q += kThreads) {
    const long long c = v0 + q * 16;
    const uint8_t* src = xb + (c >= 0 ? c : 0);
    uint8_t* dst = stage + chunk_off(q, g.cps_shift);
    for (int j = 0; j < g.d; ++j, src += g.xrs, dst += rs) {
      if (vec) {
        swgf::cp_async16(dst, src, c >= 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (c + e >= 0)
            w[e / 4] |= static_cast<uint32_t>(src[c >= 0 ? e : c + e])
                        << (8 * (e % 4));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// acc += the products of input row j's 16-byte chunk at byte `so` of the
// staged tile.
template <int G>
__device__ __forceinline__ void mac_chunk(const uint32_t* tab,
                                          const uint8_t* cur, int rs, int so,
                                          int j, uint32_t (&acc)[4][4][G]) {
  const uint4 v = *reinterpret_cast<const uint4*>(cur + j * rs + so);
  const uint32_t* tj = tab + j * G * swgf::kGroupWords;
  swgf::gf_mac<G>(tj, v.x, acc[0]);
  swgf::gf_mac<G>(tj, v.y, acc[1]);
  swgf::gf_mac<G>(tj, v.z, acc[2]);
  swgf::gf_mac<G>(tj, v.w, acc[3]);
}

template <int G, bool SMALL_D>
__global__ void __launch_bounds__(kThreads)
tile_kernel(Geometry g, bool vec, const uint32_t* __restrict__ tab_g,
            const uint32_t* __restrict__ maps_g,
            const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
            uint32_t* __restrict__ partial) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tab_words = g.d * G * swgf::kGroupWords;
  uint32_t* crc_map = sm;
  uint32_t* adv = crc_map + kStreamMaps * swgf::kMapWords;
  uint32_t* tab = sm + kMapsWords;
  const int rs = g.tile + 16 * g.sub;  // bytes between tile rows
  uint8_t* stages = reinterpret_cast<uint8_t*>(tab + tab_words);
  uint8_t* outs = stages + 2 * g.d * rs;
  const int cpr = g.tile >> 4, seg = g.tile >> g.levels;

  int b = blockIdx.x / g.ntiles, t = blockIdx.x % g.ntiles;
  if (b < g.batch) load_tile(g, vec, x, b, t, stages, rs);
  swgf::cp_async_commit();
  swgf::block_copy_words(tab, tab_g, tab_words);
  swgf::block_copy_words(crc_map, maps_g,
                         (kStreamMaps + g.levels) * swgf::kMapWords);

  for (int it = 0; b < g.batch; ++it) {
    uint8_t* cur = stages + (it & 1) * g.d * rs;
    // the next item's tile goes in flight before this one computes
    int nb = b, nt = t;
    next_item(nb, nt, gridDim.x, g.ntiles);
    if (nb < g.batch)
      load_tile(g, vec, x, nb, nt, stages + ((it + 1) & 1) * g.d * rs, rs);
    swgf::cp_async_commit();
    swgf::cp_async_wait_prior();
    __syncthreads();

    const long long v0 = static_cast<long long>(t) * g.tile - g.pad;
    uint8_t* ob = out + static_cast<long long>(b) * g.obs;

    // 1. the p output rows of the tile: to shared memory for the CRC and
    //    to device memory
    for (int q = threadIdx.x; q < cpr; q += blockDim.x) {
      const int so = chunk_off(q, g.cps_shift);
      uint32_t acc[4][4][G];
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int gg = 0; gg < G; ++gg) acc[w][e][gg] = 0u;
      if (SMALL_D) {
#pragma unroll
        for (int j = 0; j < kUnrollD; ++j)
          if (j < g.d) mac_chunk<G>(tab, cur, rs, so, j, acc);
      } else {
        for (int j = 0; j < g.d; ++j) mac_chunk<G>(tab, cur, rs, so, j, acc);
      }
      uint32_t rw[4][4 * G];
#pragma unroll
      for (int w = 0; w < 4; ++w) swgf::gf_rows<G>(acc[w], rw[w]);
      const long long c = v0 + q * 16;
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) {
        if (i >= g.p) break;
        const uint4 val = make_uint4(rw[0][i], rw[1][i], rw[2][i], rw[3][i]);
        *reinterpret_cast<uint4*>(outs + i * rs + so) = val;
        uint8_t* dst = ob + i * g.ors + c;
        if (vec) {
          if (c >= 0) __stcs(reinterpret_cast<uint4*>(dst), val);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (c + e >= 0)
              dst[e] = static_cast<uint8_t>(rw[e / 4][i] >> (8 * (e % 4)));
        }
      }
    }
    __syncthreads();

    // 2. raw CRC of every sub-segment of the d + p tile rows, then the
    //    row's sub-segments folded in a shuffle tree (a row's S lanes are
    //    consecutive lanes of one warp)
    const int r = threadIdx.x >> g.levels, s = threadIdx.x & (g.sub - 1);
    uint32_t st = 0;
    if (r < g.rows) {
      const uint8_t* src = (r < g.d ? cur + r * rs : outs + (r - g.d) * rs) +
                           s * (seg + 16);
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
      st = swgf::nib_apply(
               adv_part + swgf::kMapWords,
               swgf::nib_apply(adv_part, sk[0]) ^ sk[1]) ^
           swgf::nib_apply(adv_part, sk[2]) ^ sk[3];
    }
    if (threadIdx.x / 32 * 32 < g.rows * g.sub) {  // warps holding rows
      for (int k = 0; k < g.levels; ++k) {
        const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, st, 1 << k);
        st = swgf::nib_apply(adv + k * swgf::kMapWords, st) ^ right;
      }
    }
    if (r < g.rows && s == 0)
      partial[(static_cast<long long>(b) * g.rows + r) * g.ntiles + t] = st;
    // the stage and the output rows are free for the next item
    __syncthreads();
    b = nb;
    t = nt;
  }
}

// One warp per (row, batch): folds the row's ntiles partials into its raw
// CRC, written as an int64 holding the uint32 image.  The row is taken as
// 32 m tiles (virtual zero tiles in front); lane l Horner-folds tiles
// 32 q + l (coalesced loads) with Adv_{32 T}, and a shuffle tree joins
// lanes l and l + 2^k with Adv_{T 2^k}.  adv_g holds those six nibble
// maps: Adv_{32 T}, then Adv_{T 2^k} for k = 0..4.
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

int log2_exact(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return (1 << k) == v ? k : -1;
}

// Shared memory of one tile block, in bytes; ops/rs_cuda.py chooses T
// with the same formula.
long long smem_bytes(int p, int d, int tile, int sub) {
  const long long words = static_cast<long long>(d) * ((p + 3) / 4) *
                              swgf::kGroupWords + kMapsWords;
  return words * 4 + static_cast<long long>(2 * d + p) * (tile + 16 * sub);
}

template <int G, bool SMALL_D>
cudaError_t launch(const Geometry& g, bool vec, long long smem,
                   const void* tab, const void* maps, const void* x,
                   void* out, void* partial, cudaStream_t s) {
  static swgf::Resident resident;
  cudaError_t err = swgf::resident_blocks(tile_kernel<G, SMALL_D>, kThreads,
                                          static_cast<size_t>(smem),
                                          &resident);
  if (err != cudaSuccess) return err;
  long long blocks = resident.blocks;
  const long long items = static_cast<long long>(g.batch) * g.ntiles;
  if (blocks > items) blocks = items;
  tile_kernel<G, SMALL_D><<<static_cast<int>(blocks), kThreads,
                   static_cast<size_t>(smem), s>>>(
      g, vec, static_cast<const uint32_t*>(tab),
      static_cast<const uint32_t*>(maps), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(out), static_cast<uint32_t*>(partial));
  return cudaGetLastError();
}

template <bool SMALL_D>
cudaError_t launch_g(const Geometry& g, bool vec, long long smem,
                     const void* tab, const void* maps, const void* x,
                     void* out, void* partial, cudaStream_t s) {
  auto run = [&](auto groups) {
    return launch<decltype(groups)::value, SMALL_D>(g, vec, smem, tab, maps,
                                                    x, out, partial, s);
  };
  switch ((g.p + 3) / 4) {
    case 1: return run(std::integral_constant<int, 1>{});
    case 2: return run(std::integral_constant<int, 2>{});
    case 3: return run(std::integral_constant<int, 3>{});
    default: return run(std::integral_constant<int, 4>{});
  }
}

}  // namespace

// tab: (d, G, 2, 16) uint32 row-packed nibble tables (gf_core.cuh);
// maps: 3 + log2(S) nibble maps of 128 uint32 (Adv_4 for the CRC step,
// Adv_{T/4S} and Adv_{T/2S} for its streams, then Adv_{T/S 2^k});
// adv_fold: six nibble maps (see fold_kernel); x: (batch, d, L) bytes with
// batch and row strides xbs, xrs; out: (batch, p, L) bytes with strides
// obs, ors; partial: (batch, d + p, ntiles) uint32 scratch; crc: (batch,
// d + p) int64, each the uint32 raw image.
extern "C" int sw_fused_apply_crc(const void* tab, int p, int d,
                                  const void* maps, const void* adv_fold,
                                  const void* x, long long xbs,
                                  long long xrs, int batch,
                                  long long length, int tile, int sub,
                                  void* out, long long obs, long long ors,
                                  void* partial, void* crc, void* stream) {
  const int rows = d + p;
  const int levels = log2_exact(sub);
  if (p < 1 || p > swgf::kMaxRows || d < 1 || batch < 1 ||
      batch > 65535 || length < 1 || levels < 0 || sub > 32 ||
      rows * sub > kThreads || log2_exact(tile) < 0 ||
      tile % (16 * kStreams * sub) != 0 || xbs < 0 || xrs < 0 ||
      obs < 0 || ors < 0)
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
  g.levels = levels;
  g.cps_shift = log2_exact(tile / 16 / sub);
  g.ntiles = static_cast<int>((length + tile - 1) / tile);
  g.pad = static_cast<int>(static_cast<long long>(g.ntiles) * tile - length);
  g.batch = batch;
  g.xbs = xbs;
  g.xrs = xrs;
  g.obs = obs;
  g.ors = ors;
  const bool vec = length % 16 == 0 && xbs % 16 == 0 && xrs % 16 == 0 &&
                   obs % 16 == 0 && ors % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d <= kUnrollD
          ? launch_g<true>(g, vec, smem, tab, maps, x, out, partial, s)
          : launch_g<false>(g, vec, smem, tab, maps, x, out, partial, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = (g.ntiles + 31) / 32;
  fold_kernel<<<dim3(rows, batch), 32, 0, s>>>(
      rows, g.ntiles, m, static_cast<const uint32_t*>(adv_fold),
      static_cast<const uint32_t*>(partial), static_cast<long long*>(crc));
  return static_cast<int>(cudaGetLastError());
}
