// The forward walk over a dense strided bit pack, C = P^T B, shared by
// spmm_pattern.cu (one n_pad x n_pad pack; replaces _fwd_kernel,
// mg_gcn_tpu/ops/spmm_pattern.py:265) and spmm_pattern_ring.cu (a
// partition's P ring-ordered m x m blocks stacked as one (P*m, m/32) pack;
// replaces _fwd_ring_kernel, mg_gcn_tpu/ops/spmm_pattern_ring.py:128).
// Bit b of word pack[i, g*128 + w] holds P[i, g*4096 + b*128 + w], so the
// 32 output columns of a word are a strided column of the row-major pack.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Each feature chunk of
// 128 reads the pack once (6.8 GB at n_pad = 233,472: 2.087 ms with B and C;
// a ring partition's 1.9 GB: 0.592 ms); the 2*nnz*d additions are far below
// any peak. What the walk must keep cheap besides: per set bit, one gather
// of a B row slice from L2 and 4 adds into a register chosen by the bit.
//
// The design, for those limits:
// - Sums in registers. A warp owns one pack word and 16 of its bits (G = 1,
//   d_pad > 64: 128 features, 4 a lane) or a whole word with each half-warp
//   on 16 bits (G = 2, d_pad <= 64: 64 features, 4 a lane). Either way a
//   lane keeps 16 columns x 4 features = 64 sums live across its walk.
// - Bit tiles staged by asynchronous copies. A block owns 8 consecutive
//   words (32 B of each row: one full sector) and streams 256-row tiles of
//   them through a ring of 3 shared-memory stages with cp.async; completion
//   is signalled on an mbarrier a stage ("full": the 32 lanes of the
//   copying warp) and release on another ("empty": one arrival a warp).
//   Warp t % warps refills the stage of tile t once every warp has released
//   it: no __syncthreads in the walk.
// - Rows listed by a vote. For each 32-row span of a tile each lane reads
//   its row's word; one ballot gives the rows with a set bit in the warp's
//   bits, appended in row order to a per-warp list (one byte a row).
// - Gathers staged, adds by static register index. The listed rows' B
//   slices are copied with cp.async into one of two per-warp gather
//   buffers in shared memory (entry e's word in lane e), tile after tile
//   until the next tile's rows would not fit; then the other buffer, landed
//   meanwhile, is added. The adds run over the 16 owned columns k in a
//   static loop: one ballot over the entries finds those with bit k, and
//   each adds its staged slice into acc[k]. (A register chosen at run time
//   needs a branch a set bit, which ran slower on the H100.) A tile with
//   more listed rows than a buffer holds is added on its own, after
//   everything before it.
// - The whole card busy. When the column blocks alone would fill fewer
//   than about two full waves (a ring partition has 1,920 words, a quarter
//   of the main pack's 7,296), the walk is split into S row slices (S in
//   1, 2, 4, 8, chosen by the launcher from the occupancy the runtime
//   reports): the S blocks of one column block form a thread-block cluster,
//   each walks 1/S of the tiles, and their partial sums meet through
//   distributed shared memory, added in slice order. No atomics, no
//   scratch memory.
//
// Sum order, fixed: each output element C[j, f] is summed by one lane in
// row order over its slice's rows; with S > 1 slices the partials are
// added in slice order, ((p_0 + p_1) + p_2) + ... . Two launches give the
// same bits. Columns no set bit reaches are stored as 0.
//
// Offsets are 64-bit. Rows come in whole 256-row tiles (n_rows % 4096 ==
// 0), 16 tiles to 4096 rows, so S <= 8 slices are whole too.
#pragma once

#include <cooperative_groups.h>

#include <cmath>

#include "async_copy.cuh"
#include "pattern_modes.cuh"

namespace pattern {

constexpr int kFwdWords = 8;       // pack words a block owns: 32 B of a row, one sector
constexpr int kFwdRows = 256;      // pack rows in a staged tile
constexpr int kFwdStages = 3;      // tiles in the ring
constexpr int kOwnBits = 16;       // columns a lane owns
constexpr int kMaxSlices = 8;      // row slices: a portable cluster size
constexpr int kFwdBarBytes = 128;  // the 2 x kFwdStages mbarriers, padded
constexpr size_t kFwdRingBytes = (size_t)kFwdStages * kFwdRows * kFwdWords * sizeof(uint32_t);

// G lane groups a warp: G = 1 for d_pad > 64, G = 2 for d_pad <= 64.
template <int G>
struct FwdCfg {
  static constexpr int kWarps = kFwdWords * 2 / G;  // 16 bits a lane group
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kMinBlocks = G == 1 ? 1 : 2;         // >= 16 resident warps an SM
  static constexpr int kLanesF = 32 / G;                    // lanes with distinct features
  static constexpr int kSlotBytes = G == 1 ? 12288 : 8192;  // a warp's two gather buffers
};

// Entries (listed rows) a gather buffer holds: a row slice is kLanesF x 4
// features as stored.
template <typename T, int G>
__host__ __device__ constexpr int fwd_chunk_entries() {
  const int e = FwdCfg<G>::kSlotBytes / (2 * FwdCfg<G>::kLanesF * (int)sizeof(typename Mode<T>::Raw));
  return e < 32 ? e : 32;
}

// Dynamic shared memory: the barriers, a row list a warp (one byte a tile
// row), then the ring and the gather buffers; with row slices that space
// (after the walk) also holds the block's partial sums.
template <typename T, int G>
inline size_t fwd_smem_bytes(int slices) {
  const size_t partials =
      slices > 1 ? (size_t)FwdCfg<G>::kThreads * kOwnBits * sizeof(typename Mode<T>::Acc4) : 0;
  const size_t walk = kFwdRingBytes + (size_t)FwdCfg<G>::kWarps * FwdCfg<G>::kSlotBytes;
  return kFwdBarBytes + (size_t)FwdCfg<G>::kWarps * kFwdRows + (partials > walk ? partials : walk);
}

using async_copy::cp_async_arrive;
using async_copy::cp_async_ca;
using async_copy::cp_async_cg16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;
using async_copy::mbar_arrive;
using async_copy::mbar_init;
using async_copy::mbar_wait;
using async_copy::smem_u32;

// One warp copies a 256-row x 8-word tile into ``stage`` (two 16 B chunks
// a row, stored chunk-major: stage[c][r][4 words]) and has each lane's
// copies arrive on ``full`` when they land (init count 32).
__device__ __forceinline__ void fwd_issue_tile(uint32_t stage, uint32_t full, const uint32_t* pack,
                                               long long row0, long long words, long long w_first,
                                               int lane) {
#pragma unroll
  for (int i = 0; i < kFwdRows * 2 / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx >> 1, ch = idx & 1;  // lanes 2r, 2r+1 copy row r's 32 B
    const uint32_t* src = pack + (row0 + r) * words + w_first + 4 * ch;
    cp_async_cg16(stage + (uint32_t)((ch * kFwdRows + r) * 16), src);
  }
  cp_async_arrive(full);
}

// The column block and lane ownership of thread (warp, lane): the block's
// word ``lw``, the first owned bit ``shift`` and the first feature ``f0``.
template <int G>
struct FwdOwner {
  int lw, shift, f0;
  __device__ __forceinline__ FwdOwner(int warp, int lane, int chunk)
      : lw(G == 1 ? warp >> 1 : warp),
        shift(G == 1 ? (warp & 1) * kOwnBits : (lane >> 4) * kOwnBits),
        f0(G == 1 ? chunk * kChunkF + lane * kLaneF : (lane & 15) * kLaneF) {}
};

// Copies B[row, lane's features] of the ``n`` listed rows ``list[0, n)``
// (relative to ``bspan``) into entries [e0, e0 + n) of gather buffer
// ``buf``, by the lanes with distinct features (cp.async; the caller
// commits the group).
template <typename T, int G>
__device__ __forceinline__ void fwd_gather(typename Mode<T>::Raw* slots, int buf, int e0, int n,
                                           const uint8_t* list, const T* bspan, int d_pad, bool copier,
                                           int lane) {
  using Raw = typename Mode<T>::Raw;
  constexpr int kE = fwd_chunk_entries<T, G>(), kL = FwdCfg<G>::kLanesF;
  Raw* dst = slots + (buf * kE + e0) * kL + (lane & (kL - 1));
#pragma unroll 4
  for (int e = 0; e < n; ++e) {
    const int r = list[e];
    if (copier) cp_async_ca<(int)sizeof(Raw)>(smem_u32(dst + e * kL), bspan + (long long)r * d_pad);
  }
}

// Adds a landed buffer: for each owned column k (static), the entries
// (lane e: its row's word ``word_e``, 0 past the last) with bit shift + k,
// in entry (= row) order. The caller has waited for the copies and synced
// the warp, which shows each lane the copies of the lane sharing its
// features (G = 2).
template <typename T, int G>
__device__ __forceinline__ void fwd_add(typename Mode<T>::Acc4 (&acc)[kOwnBits],
                                        const typename Mode<T>::Raw* slots, int buf, uint32_t word_e,
                                        int shift, int lane) {
  constexpr int kE = fwd_chunk_entries<T, G>(), kL = FwdCfg<G>::kLanesF;
  const typename Mode<T>::Raw* src = slots + buf * kE * kL + (lane & (kL - 1));
#pragma unroll
  for (int k = 0; k < kOwnBits; ++k) {
    unsigned m;
    if (G == 1) {
      m = __ballot_sync(kFull, (word_e >> (shift + k)) & 1u);
    } else {  // each half-warp its own 16 bits
      const unsigned lo = __ballot_sync(kFull, (word_e >> k) & 1u);
      const unsigned hi = __ballot_sync(kFull, (word_e >> (kOwnBits + k)) & 1u);
      m = lane >> 4 ? hi : lo;
    }
    while (m) {
      const int e = __ffs(m) - 1;
      m &= m - 1;
      add(acc[k], Mode<T>::widen(src[e * kL]));
    }
  }
}

// C = P^T B over a pack of ``n_rows`` rows (see the top of the file). Grid:
// (words / kFwdWords * slices, G == 1 ? ceil(d_pad / 128) : 1), clusters
// of (slices, 1, 1); block FwdCfg<G>::kThreads; dynamic shared memory
// fwd_smem_bytes<T, G>(slices).
template <typename T, int G>
__device__ __forceinline__ void fwd_cols(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                                         typename Mode<T>::Acc* __restrict__ c, long long n_rows,
                                         long long words, int d_pad, int slices) {
  using Acc4 = typename Mode<T>::Acc4;
  using Raw = typename Mode<T>::Raw;
  using Cfg = FwdCfg<G>;
  constexpr int kE = fwd_chunk_entries<T, G>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int ring_off = kFwdBarBytes + Cfg::kWarps * kFwdRows;  // after the barriers and the row lists
  const uint32_t bars = smem_u32(smem);  // full[kFwdStages], then empty[kFwdStages]
  const uint32_t ring = bars + ring_off;
  const uint32_t* ring_words = reinterpret_cast<const uint32_t*>(smem + ring_off);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = (int)(blockIdx.x % (unsigned)slices);  // the cluster rank: clusters are (slices, 1, 1)
  const long long w_first = (long long)(blockIdx.x / (unsigned)slices) * kFwdWords;
  const FwdOwner<G> own(warp, lane, blockIdx.y);
  const uint32_t vote_mask = G == 1 ? 0xFFFFu << own.shift : kFull;  // the warp's bits
  const bool active = own.f0 < d_pad;
  const bool copier = active && (G == 1 || lane < 16);  // G = 2: the halves share the features

  const long long tiles = n_rows / kFwdRows;
  const long long per = (tiles + slices - 1) / slices;
  const long long t_first = min(tiles, (long long)slice * per);
  const int n_tiles = (int)(min(tiles, t_first + per) - t_first);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(bars + 8 * s, 32);
      mbar_init(bars + 8 * (kFwdStages + s), Cfg::kWarps);
    }
  }
  __syncthreads();  // the barriers are initialised (once, outside the walk)
  if (warp == 0) {
    for (int t = 0; t < kFwdStages && t < n_tiles; ++t)
      fwd_issue_tile(ring + t * kFwdRows * kFwdWords * 4, bars + 8 * t, pack, (t_first + t) * kFwdRows, words,
                     w_first, lane);
  }

  Acc4 acc[kOwnBits];
#pragma unroll
  for (int k = 0; k < kOwnBits; ++k) zero(acc[k]);

  // this warp's word of row r of a stage: stage[lw / 4][r][lw % 4]
  const int word_off = (own.lw >> 2) * kFwdRows * 4 + (own.lw & 3);
  uint8_t* list = reinterpret_cast<uint8_t*>(smem + kFwdBarBytes) + warp * kFwdRows;
  Raw* slots = reinterpret_cast<Raw*>(smem + ring_off + kFwdRingBytes + warp * Cfg::kSlotBytes);
  // Gather buffers: buffer ``buf`` fills with the listed rows of one tile
  // after another (entry e in lane e: ``cur_word``) until the next tile's
  // would not fit; then its copies are committed as one group and the
  // previous buffer (``prev_word``), landed meanwhile, is added.
  uint32_t cur_word = 0u, prev_word = 0u;
  int buf = 0, fill = 0;
  bool prev = false;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kFwdStages;
    const uint32_t parity = (uint32_t)(t / kFwdStages) & 1u;
    mbar_wait(bars + 8 * s, parity);
    const uint32_t* tile = ring_words + s * kFwdRows * kFwdWords + word_off;
    // 1. list the tile's rows with a set bit in the warp's bits, in row order
    int cnt = 0;
#pragma unroll
    for (int sp = 0; sp < kFwdRows; sp += 32) {
      const uint32_t w = tile[(sp + lane) * 4] & vote_mask;
      const unsigned m = __ballot_sync(kFull, w != 0u);
      if (w != 0u) list[cnt + __popc(m & ((1u << lane) - 1u))] = (uint8_t)(sp + lane);
      cnt += __popc(m);
    }
    __syncwarp();
    // 2. gather the listed rows into the buffer, adding the previous one
    //    whenever a buffer is full
    const T* bspan = b + (t_first + t) * kFwdRows * d_pad + own.f0;
    if (fill + cnt > kE && fill > 0) {
      cp_async_commit();
      cp_async_wait<1>();  // the previous buffer has landed
      __syncwarp();
      if (prev) fwd_add<T, G>(acc, slots, buf ^ 1, prev_word, own.shift, lane);
      prev_word = cur_word;
      prev = true;
      buf ^= 1;
      fill = 0;
      cur_word = 0u;
      __syncwarp();  // every lane has read what the new buffer held
    }
    if (cnt <= kE) {
      if (lane >= fill && lane < fill + cnt) cur_word = tile[list[lane - fill] * 4];
      fwd_gather<T, G>(slots, buf, fill, cnt, list, bspan, d_pad, copier, lane);
      fill += cnt;
    } else {  // more rows than a buffer holds (dense rows): everything pending first, in order
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      if (prev) fwd_add<T, G>(acc, slots, buf ^ 1, prev_word, own.shift, lane);
      if (fill > 0) fwd_add<T, G>(acc, slots, buf, cur_word, own.shift, lane);
      for (int c0 = 0; c0 < cnt; c0 += kE) {
        const int n = min(cnt - c0, kE);
        const uint32_t word_e = lane < n ? tile[list[c0 + lane] * 4] : 0u;
        __syncwarp();  // every lane has read what the buffer held
        fwd_gather<T, G>(slots, buf, 0, n, list + c0, bspan, d_pad, copier, lane);
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        fwd_add<T, G>(acc, slots, buf, word_e, own.shift, lane);
      }
      prev = false;
      fill = 0;
      cur_word = 0u;
      __syncwarp();
    }
    __syncwarp();  // the tile and the list are read
    if (lane == 0) mbar_arrive(bars + 8 * (kFwdStages + s));  // this warp is done with the stage
    if (warp == t % Cfg::kWarps && t + kFwdStages < n_tiles) {
      if (lane == 0) mbar_wait(bars + 8 * (kFwdStages + s), parity);  // every warp is
      __syncwarp();
      fwd_issue_tile(ring + s * kFwdRows * kFwdWords * 4, bars + 8 * s, pack,
                     (t_first + t + kFwdStages) * kFwdRows, words, w_first, lane);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  if (prev) fwd_add<T, G>(acc, slots, buf ^ 1, prev_word, own.shift, lane);
  if (fill > 0) fwd_add<T, G>(acc, slots, buf, cur_word, own.shift, lane);

  if (slices == 1) {
    const long long wi = w_first + own.lw;
    const long long jbase = (wi >> 7) * kGroup + (wi & 127);
    if (active) {
#pragma unroll
      for (int k = 0; k < kOwnBits; ++k)
        *reinterpret_cast<Acc4*>(c + (jbase + (long long)(own.shift + k) * 128) * d_pad + own.f0) = acc[k];
    }
    return;
  }

  // Row slices: the partials meet in distributed shared memory.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done with the ring and buffers the partials overwrite
  Acc4* part = reinterpret_cast<Acc4*>(smem + ring_off);  // [warp][bit k][lane]
#pragma unroll
  for (int k = 0; k < kOwnBits; ++k) part[(warp * kOwnBits + k) * 32 + lane] = acc[k];
  cluster.sync();
  // rank ``slice`` adds up its share of the block's entries over the ranks,
  // in rank (= slice) order, and stores them
  const int share = Cfg::kThreads * kOwnBits / slices;
  for (int e = slice * share + threadIdx.x; e < (slice + 1) * share; e += Cfg::kThreads) {
    Acc4 sum = *cluster.map_shared_rank(part + e, 0);
    for (int rk = 1; rk < slices; ++rk) add(sum, *cluster.map_shared_rank(part + e, rk));
    const int e_lane = e & 31, e_bit = (e >> 5) % kOwnBits, e_warp = (e >> 5) / kOwnBits;
    const FwdOwner<G> o(e_warp, e_lane, blockIdx.y);
    if (o.f0 < d_pad) {
      const long long wi = w_first + o.lw;
      const long long j = (wi >> 7) * kGroup + (wi & 127) + (long long)(o.shift + e_bit) * 128;
      *reinterpret_cast<Acc4*>(c + j * d_pad + o.f0) = sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// The launch geometry of a forward walk: grid, threads, dynamic shared
// memory, row slices (= cluster size) and resident blocks an SM.
struct FwdGeometry {
  int grid_x, grid_y, threads, smem, slices, blocks_per_sm, resident_blocks;
};

// Picks the row slices: the fewest S in 1, 2, 4, 8 whose waves over the
// resident blocks (the runtime's occupancy, clusters counted whole) use the
// card within 0.05 of the best S, where w waves use it w / ceil(w), and
// fewer than 2 waves w / 2.
template <typename T, int G, typename Kernel>
cudaError_t fwd_plan(Kernel kernel, long long n_rows, long long words, int d_pad, FwdGeometry* geo) {
  using Cfg = FwdCfg<G>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fwd_smem_bytes<T, G>(kMaxSlices));
  if (err != cudaSuccess) return err;
  const long long col_blocks = words / kFwdWords;
  const int grid_y = G == 1 ? (d_pad + kChunkF - 1) / kChunkF : 1;
  const long long tiles = n_rows / kFwdRows;
  FwdGeometry cand[4];
  double score[4], best = -1.0;
  int n = 0;
  for (int s = 1; s <= kMaxSlices && s <= tiles; s *= 2, ++n) {
    const size_t smem = fwd_smem_bytes<T, G>(s);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Cfg::kThreads, smem);
    if (err != cudaSuccess) return err;
    long long resident = (long long)per_sm * sms;
    if (s > 1) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = s;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3((unsigned)(col_blocks * s), (unsigned)grid_y);
      cfg.blockDim = dim3(Cfg::kThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
        (void)cudaGetLastError();  // a cluster this size cannot be placed: not a candidate
        clusters = 0;
      }
      resident = (long long)clusters * s;
    }
    cand[n] = FwdGeometry{(int)(col_blocks * s), grid_y, Cfg::kThreads, (int)smem, s, per_sm, (int)resident};
    const double waves = resident > 0 ? (double)(col_blocks * grid_y * s) / (double)resident : 0.0;
    score[n] = waves < 2.0 ? waves / 2.0 : waves / std::ceil(waves);
    if (score[n] > best) best = score[n];
  }
  for (int i = 0; i < n; ++i) {
    if (score[i] >= best - 0.05) {
      *geo = cand[i];
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;  // no S fits on an SM
}

// Plans and launches ``kernel`` (a __global__ wrapper of fwd_cols<T, G>) on
// ``stream``; returns the launch's cudaError_t.
template <typename T, int G, typename Kernel>
cudaError_t fwd_launch(Kernel kernel, const void* pack, const void* b, void* c, long long n_rows,
                       long long words, int d_pad, cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  FwdGeometry geo;
  cudaError_t err = fwd_plan<T, G>(kernel, n_rows, words, d_pad, &geo);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)geo.grid_x, (unsigned)geo.grid_y);
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = geo.slices > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(pack), static_cast<const T*>(b),
                           static_cast<Acc*>(c), n_rows, words, d_pad, geo.slices);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ``out`` = grid_x, grid_y, threads, smem, slices, blocks_per_sm,
// resident_blocks of the launch fwd_launch would make.
template <typename T, int G, typename Kernel>
cudaError_t fwd_geometry(Kernel kernel, long long n_rows, long long words, int d_pad, int* out) {
  FwdGeometry geo;
  const cudaError_t err = fwd_plan<T, G>(kernel, n_rows, words, d_pad, &geo);
  if (err != cudaSuccess) return err;
  const int vals[7] = {geo.grid_x, geo.grid_y, geo.threads, geo.smem, geo.slices, geo.blocks_per_sm,
                       geo.resident_blocks};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace pattern
