// The backward walk over a bit-packed pattern, C = P B, shared by three
// kernels: spmm_pattern.cu (one n_pad x n_pad pack; replaces _bwd_kernel,
// mg_gcn_tpu/ops/spmm_pattern.py:280), spmm_pattern_ring.cu (a partition's
// P ring-ordered m x m blocks, C = sum_s pack[s] slots[s]; replaces
// _bwd_ring_kernel, mg_gcn_tpu/ops/spmm_pattern_ring.py:204) and
// spmm_pattern_sparse.cu (the compact tile store of a clustered graph;
// replaces _bwd_kernel_sparse, mg_gcn_tpu/ops/spmm_pattern_sparse.py:392).
// The forward walks are pattern_fwd.cuh's and spmm_pattern_sparse.cu's.
// Bit b of word pack[i, g*128 + w] holds P[i, g*4096 + b*128 + w]; a pack
// row has ``words`` words, a multiple of 128, and bit 31 is used. The tile
// store keeps only the occupied (tile_r x 4096) regions, tiles[T][tile_r][128]
// in (row block, group) order: row r of tile t = (rb, tile_g[t]) is group
// tile_g[t]'s 128 words of pack row rb*tile_r + r, and row block rb's tiles
// are [rb_ptr[rb], rb_ptr[rb + 1]).
//
// What bounds it on an H100 SXM (3.35 TB/s): the pack, read once a feature
// chunk (6.8 GB at n_pad = 233,472: 2.087 ms with B and C; a ring
// partition's 1.9 GB: 0.592 ms). Besides, each set bit gathers a B row
// slice through L2 (115M x 256 B = 29.4 GB in bf16 at d = 128). The tile
// store of bench.py's banded graph is 0.354 GB (0.159 ms with B and C), so
// there the gathers alone bound the walk (110.5M x 256 B = 28.3 GB in bf16
// at d_pad 128, 10.6 GB at 48), and a row block's B rows lie in its few
// tile groups (about 3 x 4,096 rows, 6.3 MB at float32 d_pad 128), which
// stay in L2. The first walks of both (a warp a row, one 16-byte load a
// lane in flight, each 32-word sub-span listed and gathered on its own, 4
// features a lane) took the same 8.5 ms at d = 41 and 128 on the pack, the
// same 3.4 ms at d_pad 48 and 128 on the store: a chain of tiny dependent
// gather rounds bound them, not bytes.
//
// The design, for those limits:
// - One walk, three sources of words. A row's words are one stream of
//   128-word blocks: its pack row's, every round's in turn (PackStream), or
//   row r of each tile of its row block (TileStream). Block k of a stream
//   stands for the B rows base + b*128 + w, base = (first group + k)*4096
//   for a pack (over the rounds, row s*m of the stacked slots plus the
//   group's first column) and tile_g[t0 + k]*4096 for the store, whose
//   groups are copied beside the words into the warp's shared memory: a
//   span reads its bases once, no load a set bit.
// - The words streamed ahead. A warp owns one output row and streams its
//   words as kSpan-word spans through a ring of kStages spans in its own
//   shared memory, by 16-byte cp.async copies (each lane copies one 16-byte
//   chunk of each 128-word block): kStages - 1 spans (3 KB) are in flight
//   while the warp lists and gathers. The warp is its own producer and
//   consumer, so a cp.async.wait_group and a __syncwarp order each stage;
//   no barrier between warps, no __syncthreads. A span's chunks are stored
//   swizzled (chunk t at slot t ^ ((t >> 3) & 1)), so the lanes' 16-byte
//   reads of their own consecutive words hit distinct banks.
// - A whole span's bits listed at once. Lane l takes words 8l .. 8l + 7 of
//   the span (all in block l / 16 of it); one prefix sum of the lanes'
//   popcounts places every set bit, in stream (block, word, bit) order, in
//   the warp's list as its B row. A lane walks only its set bits (a mask of
//   its live words), so a span costs the warp about as many steps as its
//   busiest lane has bits. The list is a FIFO of kList entries that spans
//   keep filling; a span with more set bits than the list has room for is
//   listed in pieces, gathering between them, so a row with every bit set
//   is walked too.
// - Lane groups sized to the row, as csr_walk.cuh's. A lane loads F
//   features of a B row in one 16-byte load (8 bytes for an int8 row with
//   d_pad % 16 == 8): F = 4 float32, 8 bf16, 16 (or 8) int8. A group of L
//   lanes covers L F features, L the smallest power of two >= d_pad / F,
//   capped at 32 (bf16: L = 16 at d_pad 128, 8 at 48 and 64, 1 at 8), and
//   the warp's G = 32 / L groups take the row's entries in strides: entry e
//   of the row (counted over the whole stream, in list order) goes to group
//   e mod G. Whenever the list holds G U entries, each lane loads U B
//   rows at once (U by ``loads``) and adds them in entry order to its F
//   sums in registers; the row's last partial batch is added at the end. With one
//   group the warp also gathers each span's last entries before it lists
//   the next span, so its gathers keep pace with the stream.
// - One store. The G groups' sums, live across all spans, meet by a fixed
//   __shfl_xor_sync tree (groups 2i and 2i + 1 first, then pairs of pairs)
//   and group 0 writes the row once (zeros for a row with no set bit, and
//   for a row block with no tile). Rows wider than 32 lanes' loads (float32
//   d_pad > 128, bf16 > 256, int8 > 512) are walked once a chunk of 32 F
//   features, by grid y.
// - The card filled, B kept in L2 where it can be. A block is kWarps rows, 48
//   KB of rings and lists (and 32 B a warp of store groups); registers are
//   capped for 4 resident blocks an SM (32 warps) in bf16 and int8, 3 in
//   float32 and in the store's bf16 rows of 16 lanes (``loads``). With one
//   group (L = 32: float32 d_pad > 64, where B outgrows the 50 MB L2 at Reddit
//   scale, 120 MB at d_pad 128) the pack's launcher sizes the grid to one wave
//   of 2 blocks an SM that walk row after row, each lane 16 B rows at once,
//   and splits a one-round pack into column windows whose B rows fill at most
//   half the L2. The one launch, cooperative, walks them in turn: each warp
//   walks its rows over window 0, then, after a grid-wide barrier, over window
//   1, and so on, each row's sums going on from those the warp stored for it
//   at the window before, in the same order, so the sums are those of one
//   walk. The barrier keeps every warp on one window's B rows: without it the
//   warps drift apart across window edges and the walk took 9.46-9.49 ms
//   against 8.67 (PERF.md). (Without the windows, at float32 d = 128 on the
//   main graph, the walk took 11.4-13.5 ms on an H100 where the first walk
//   took 9.4: its gathers missed L2.) The store needs neither: its row blocks'
//   B rows stay in L2, so its walk runs a block of kWarps rows on the regular
//   grid at every L (float32 d_pad 128 on the banded graph: 5.68 ms, against
//   6.44-6.45 on one wave of 2 blocks an SM; PERF.md). There, at d_pad 128,
//   the gathers run at 9-10 TB/s through L2 (bf16 28.3 GB in 3.19 ms, float32
//   56.6 GB in 5.68), as the first store walk's float32 gathers already did:
//   the bytes of a B row a set bit are the floor.
//
// Sum order, fixed: each group sums its entries in row order, then the xor
// tree; it depends only on (dtype, d_pad), no atomics, so two launches give
// the same bits. Sums: float32 for float32 and bf16 operands, int32 for
// int8 (exact in any order). Offsets into the pack, the store and B are
// 64-bit.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"

namespace pattern_bwd {

constexpr int kWarps = 8;          // output rows (= warps) a block
constexpr int kSpan = 256;         // pack words a staged span
constexpr int kStages = 4;         // spans in a warp's ring
constexpr int kList = 512;         // entries of a warp's list (a power of two)
// B rows a lane loads at once, and the resident blocks an SM the registers
// are capped for, by operand type, lanes a group and source (``store``: the
// tile store): bf16 and int8 4 and 4 (32 warps an SM); float32, whose loads
// carry 4 features, 8 and 3, and 16 and 2 with one group (L = 32, d_pad >
// 64: fewer rows in flight, each with more loads; see the launcher); the
// store's bf16 rows of 16 lanes (d_pad 128) 8 and 3. With no pack stream
// beside its gathers, more B rows in flight won there (2.93 against 3.21 ms
// on the banded graph) and lost at the store's other bf16 and int8 widths
// (PERF.md).
template <typename T>
__host__ __device__ constexpr int loads(int l, bool store) {
  return std::is_same<T, float>::value ? (l == 32 ? 16 : 8)
                                       : (store && std::is_same<T, __nv_bfloat16>::value && l == 16 ? 8 : 4);
}
template <typename T>
__host__ __device__ constexpr int min_blocks(int l, bool store) {
  return std::is_same<T, float>::value ? (l == 32 ? 2 : 3)
                                       : (store && std::is_same<T, __nv_bfloat16>::value && l == 16 ? 3 : 4);
}
constexpr int kBlocks = kSpan / 128;    // 128-word blocks a span
constexpr int kLaneChunks = kSpan / 128;  // 16-byte chunks a lane lists a span (4 words each)
constexpr int kWarpBytes = kStages * kSpan * 4 + kList * 4;  // a warp's ring and list
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLaneChunks == 2, "the read swizzle below assumes two chunks a lane");
static_assert(2 * 16 * loads<float>(2, false) <= kList && 2 * 32 * loads<int8_t>(1, false) <= kList &&
                  2 * 2 * loads<__nv_bfloat16>(16, true) <= kList,
              "the list holds two of the largest batches (G loads entries)");

// Features a lane loads: 16 bytes, or 8 where an int8 row is only 8-byte
// aligned (d_pad % 16 == 8).
inline int features_for(int elt, int d_pad) { return ((d_pad * elt) % 16 == 0 ? 16 : 8) / elt; }

// Lanes a group: the smallest power of two >= d_pad / F, capped at 32.
inline int lanes_for(int f, int d_pad) {
  int l = 1;
  while (l < 32 && l * f < d_pad) l *= 2;
  return l;
}

// F consecutive features as loaded (Raw), added into F sums (Acc).
template <typename T, int F> struct Vec;
template <> struct Vec<float, 4> {
  using Raw = float4;
  using Acc = float;
  __device__ __forceinline__ static void add(Acc* a, const Raw& r) {
    a[0] += r.x; a[1] += r.y; a[2] += r.z; a[3] += r.w;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  using Acc = float;
  __device__ __forceinline__ static void add(Acc* a, const Raw& r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float32
      a[2 * i] += __uint_as_float(w[i] << 16);
      a[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <int F> struct VecI8 {
  using Raw = typename std::conditional<F == 16, uint4, uint2>::type;
  using Acc = int;
  __device__ __forceinline__ static void add(Acc* a, const Raw& r) {
    const unsigned* w = reinterpret_cast<const unsigned*>(&r);
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[4 * i + k] += (int)(int8_t)(w[i] >> (8 * k));
    }
  }
};
template <> struct Vec<int8_t, 16> : VecI8<16> {};
template <> struct Vec<int8_t, 8> : VecI8<8> {};

template <typename T>
using AccOf = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;

// The sources of a row's words. A stream is a row's 128-word blocks,
// kBlocks a span, the last span padded with zeros when the blocks are odd.
// ``fetch`` copies the next span into stage ``stage`` of the ring at shared
// address ``ring`` (one 16-byte chunk a lane of each block, chunk t at slot
// t ^ ((t >> 3) & 1)) and commits the copies as one group (empty past the
// row's end); ``base(t, lane, mine)`` is the B row of bit 0 of word 0 of
// the block that holds this lane's words of span t (block t*kBlocks +
// lane / 16), ``mine`` the warp's shared memory (its ring at word 0).

// A pack row over its rounds (``words`` words a round, round s at
// pack_round words on), or over one column window of a one-round pack
// (``words`` the window's, ``first`` its first 4096-column group). The
// words are a multiple of 128, so the stream's block index counts the row's
// groups over the rounds: block k stands for row s*m of the stacked slots
// plus its group's first column, (first + k)*4096. ``src`` is the next
// block to copy.
struct PackStream {
  const uint32_t* src;
  long long pack_round;
  int words, row_blocks, first, block = 0, word = 0;

  __device__ __forceinline__ void fetch(uint32_t ring, int stage, int lane) {
    if (block < row_blocks) {  // warp-uniform
#pragma unroll
      for (int k = 0; k < kBlocks; ++k) {
        const int t = k * 32 + lane;  // the chunk's index in the span
        const uint32_t dst = ring + (uint32_t)(stage * kSpan * 4 + ((t ^ ((t >> 3) & 1)) << 4));
        if (block < row_blocks) {
          async_copy::cp_async_cg16(dst, src + 4 * lane);
          ++block;
          src += 128;
          word += 128;
          if (word == words) {  // the row's next round
            word = 0;
            src += pack_round - words;
          }
        } else {
          async_copy::cp_async_cg16(dst, src, 0);  // zeros
        }
      }
    }
    async_copy::cp_async_commit();
  }

  __device__ __forceinline__ int base(int t, int lane, const uint32_t*) const {
    return (first + t * kBlocks + (lane >> 4)) << 12;
  }
};

// Row r of each tile of a row block of the tile store: block k is row r of
// tile t0 + k, standing for group tile_g[t0 + k]. Lane k copies block k's
// group beside its words, into the warp's kStages x kBlocks slots past its
// ring and list (kWarpBytes on), so each span reads its groups once.
struct TileStream {
  static constexpr int kBaseBytes = kStages * kBlocks * 4;
  const uint32_t* tiles;  // the store
  const int* tile_g;
  int t0, row_words, tile_words;  // the row block's first tile; r*128; tile_r*128
  int row_blocks, block = 0;

  __device__ __forceinline__ void fetch(uint32_t ring, int stage, int lane) {
    if (block < row_blocks) {  // warp-uniform
      const uint32_t slots = ring + (uint32_t)(kWarpBytes + stage * kBlocks * 4);
#pragma unroll
      for (int k = 0; k < kBlocks; ++k) {
        const int t = k * 32 + lane;
        const uint32_t dst = ring + (uint32_t)(stage * kSpan * 4 + ((t ^ ((t >> 3) & 1)) << 4));
        const uint32_t* src = tiles + (long long)(t0 + block) * tile_words + row_words;
        if (block < row_blocks) {
          async_copy::cp_async_cg16(dst, src + 4 * lane);
          if (lane == k) async_copy::cp_async_ca<4>(slots + 4 * k, tile_g + t0 + block);
          ++block;
        } else {
          async_copy::cp_async_cg16(dst, src, 0);  // zeros
        }
      }
    }
    async_copy::cp_async_commit();
  }

  __device__ __forceinline__ int base(int t, int lane, const uint32_t* mine) const {
    return (int)mine[kWarpBytes / 4 + (t % kStages) * kBlocks + (lane >> 4)] << 12;
  }
};

static_assert(4 * kLaneChunks * 16 == 128, "a lane's words lie in block lane / 16 of its span");

// Adds list entries [head, head + n) (n <= G U; group grp takes head + grp,
// head + grp + G, ...) into ``acc``, in entry order: each lane loads its F
// features of the U entries' B rows at once, then adds them.
template <typename T, int F, int G, int U>
__device__ __forceinline__ void gather(typename Vec<T, F>::Acc (&acc)[F], const int* list, unsigned head, int n,
                                       const T* bl, int d_pad, bool on, int grp) {
  using Raw = typename Vec<T, F>::Raw;
  Raw r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = grp + G * u;
    r[u] = Raw{};
    if (on && k < n) {
      const int row = list[(head + (unsigned)k) & (kList - 1)];
      r[u] = __ldg(reinterpret_cast<const Raw*>(bl + (size_t)row * d_pad));
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (grp + G * u < n) Vec<T, F>::add(acc, r[u]);
}

// Row i of C, walked by one warp over the words of stream ``in``. With
// ``resume`` (a pack's column window past the first, one group), the sums
// go on from those this warp stored for the row at the windows before. The
// warp's ring and list lie at ``mine`` in shared memory.
template <typename T, int F, int L, typename S>
__device__ __forceinline__ void walk_row(S in, const T* __restrict__ b, AccOf<T>* __restrict__ c, long long i,
                                         bool resume, int d_pad, unsigned char* mine) {
  using Acc = typename Vec<T, F>::Acc;
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes a group");
  constexpr int G = 32 / L;              // groups a warp
  constexpr int U = loads<T>(L, std::is_same<S, TileStream>::value);  // B rows a lane loads at once
  constexpr int kBatch = G * U;          // entries a warp gathers at once
  const int lane = threadIdx.x & 31;
  const uint32_t ring = async_copy::smem_u32(mine);
  const uint32_t* stages = reinterpret_cast<const uint32_t*>(mine);
  int* list = reinterpret_cast<int*>(mine + kStages * kSpan * 4);
  const int grp = lane / L, gl = lane % L;
  const int f0 = (int)blockIdx.y * 32 * F + gl * F;
  const bool on = f0 < d_pad;
  const T* bl = b + f0;

  const int n_spans = (in.row_blocks + kBlocks - 1) / kBlocks;
  __syncwarp();  // a row this warp walked before is done with the ring, the list and the bases
  for (int s = 0; s < kStages - 1; ++s) in.fetch(ring, s, lane);
  Acc acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = Acc(0);
  if constexpr (L == 32) {  // one group, one sum a feature: a later window goes on from the stored sums
    if (resume && on) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = c[(size_t)i * d_pad + f0 + f];
    }
  }
  unsigned head = 0, tail = 0;  // the row's entries gathered, listed (warp-uniform)
  for (int t = 0; t < n_spans; ++t) {
    async_copy::cp_async_wait<kStages - 2>();  // span t has landed (this lane's copies)
    __syncwarp();                               // ... and every lane's; stage (t - 1) % kStages is read
    in.fetch(ring, (t + kStages - 1) % kStages, lane);
    // this lane's words 8 lane .. 8 lane + 7 of the span: chunks 2 lane, 2 lane + 1
    const uint32_t* st = stages + (t % kStages) * kSpan;
    uint32_t w[4 * kLaneChunks];
#pragma unroll
    for (int q = 0; q < kLaneChunks; ++q) {
      const int ch = kLaneChunks * lane + q;
      const uint4 v = *reinterpret_cast<const uint4*>(st + 4 * (ch ^ ((ch >> 3) & 1)));
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    int cnt = 0;
    unsigned live = 0u;  // this lane's words with a set bit
#pragma unroll
    for (int k = 0; k < 4 * kLaneChunks; ++k) {
      cnt += __popc(w[k]);
      live |= (w[k] != 0u ? 1u : 0u) << k;
    }
    int incl = cnt;  // inclusive prefix sum of the counts over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total == 0) continue;  // warp-uniform
    const int first = incl - cnt;  // this lane's first entry, counted in the span
    // the B row of bit 0 of w[0]: its block's base plus the word's place in the block
    const int row0 = in.base(t, lane, stages) + ((4 * kLaneChunks * lane) & 127);
    if (total <= kList - (int)(tail - head)) {  // the span's entries fit: one pass over the set bits
      uint32_t x = 0u;
      int p = 0;
      for (int e = 0; e < cnt; ++e) {
        if (x == 0u) {  // the lane's next word with a set bit, from the stage
          const int k = __ffs(live) - 1;
          live &= live - 1u;
          const int ch = kLaneChunks * lane + (k >> 2);
          x = st[4 * (ch ^ ((ch >> 3) & 1)) + (k & 3)];
          p = row0 + k;
        }
        const int bit = __ffs(x) - 1;
        x &= x - 1u;
        list[(tail + (unsigned)(first + e)) & (kList - 1)] = p + bit * 128;
      }
      tail += (unsigned)total;
    } else {  // more entries than room: in pieces, gathering between them
      for (int lo = 0; lo < total;) {
        const int n = min(total - lo, kList - (int)(tail - head));
        if (first < lo + n && first + cnt > lo) {
          int e = first;
#pragma unroll
          for (int k = 0; k < 4 * kLaneChunks; ++k) {
            uint32_t x = w[k];
            while (x) {
              const int bit = __ffs(x) - 1;
              x &= x - 1u;
              if (e >= lo && e < lo + n) list[(tail + (unsigned)(e - lo)) & (kList - 1)] = row0 + k + bit * 128;
              ++e;
            }
          }
        }
        tail += (unsigned)n;
        lo += n;
        if (lo == total) break;  // the last piece is gathered below
        __syncwarp();            // the piece is listed
        for (; tail - head >= (unsigned)kBatch; head += kBatch)
          gather<T, F, G, U>(acc, list, head, kBatch, bl, d_pad, on, grp);
        __syncwarp();  // the gathered entries are read before the list is refilled
      }
    }
    __syncwarp();  // the span is listed
    for (; tail - head >= (unsigned)kBatch; head += kBatch)
      gather<T, F, G, U>(acc, list, head, kBatch, bl, d_pad, on, grp);
    if constexpr (G == 1) {  // one group: the span's last entries too, in step with the stream
      if (tail != head) gather<T, F, G, U>(acc, list, head, (int)(tail - head), bl, d_pad, on, grp);
      head = tail;
    }
    __syncwarp();  // the gathered entries are read before the list is refilled
  }
  if (tail != head) gather<T, F, G, U>(acc, list, head, (int)(tail - head), bl, d_pad, on, grp);

  // the groups' sums met by the xor tree, one store
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += __shfl_xor_sync(kFull, acc[f], off);
  }
  if (grp == 0 && on) {
    Acc* cr = c + (size_t)i * d_pad + f0;
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      if constexpr (std::is_same<Acc, int>::value)
        *reinterpret_cast<int4*>(cr + f) = make_int4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
      else
        *reinterpret_cast<float4*>(cr + f) = make_float4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
    }
  }
}

// The walk's operands besides B and C, by source. A pack: ``rounds`` of
// ``words`` words a row, round s at pack + s*pack_round and B row
// s*words*32 of the stacked slots; ``window`` is the words of a column
// window (``words`` but with one group and one round; set by the plan).
struct PackArgs {
  const uint32_t* pack;
  long long pack_round;
  int words, rounds, window;
};

inline PackArgs pack_args(const void* pack, int words, int rounds, long long pack_round) {
  return PackArgs{static_cast<const uint32_t*>(pack), pack_round, words, rounds, words};
}
// The tile store: tiles[T][tile_r][128], each tile's group, and row block
// rb's tiles [rb_ptr[rb], rb_ptr[rb + 1]).
struct TileArgs {
  const uint32_t* tiles;
  const int* tile_g;
  const int* rb_ptr;
  int tile_r;
};

template <typename A>
constexpr bool kTiles = std::is_same<A, TileArgs>::value;
// A warp's shared memory (its ring and list, and the store's group slots)
// and a block's.
template <typename A>
constexpr int kWarpBytesOf = kWarpBytes + (kTiles<A> ? TileStream::kBaseBytes : 0);
template <typename A>
constexpr int kSmemOf = kWarps * kWarpBytesOf<A>;

// C = P B for ``rows`` output rows, a warp a row: warp w of block x walks
// row x*kWarps + w and the rows gridDim.x*kWarps on after it (with one
// group the pack's launcher sizes the grid to one wave; otherwise a row
// each). A pack's rows are walked over each column window of
// ``src.window`` words in turn, with a grid-wide barrier between two (with
// more than one window the launch is cooperative). Grid: (rows / kWarps,
// or one wave; chunks of 32 F features); block kWarps*32 threads; dynamic
// shared memory kSmemOf<A>.
template <typename T, int F, int L, typename A>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<T>(L, kTiles<A>))
walk_kernel(A src, const T* __restrict__ b, AccOf<T>* __restrict__ c, long long rows, int d_pad) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* mine = bwd_smem + (threadIdx.x >> 5) * kWarpBytesOf<A>;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  if constexpr (kTiles<A>) {
    for (long long r = i; r < rows; r += stride) {
      const int rb = (int)(r / src.tile_r);
      const int t0 = __ldg(src.rb_ptr + rb);
      const TileStream in{src.tiles, src.tile_g, t0, (int)(r % src.tile_r) * 128, src.tile_r * 128,
                          __ldg(src.rb_ptr + rb + 1) - t0};
      walk_row<T, F, L>(in, b, c, r, false, d_pad, mine);
    }
  } else if constexpr (L == 32) {
    for (int w0 = 0; w0 < src.words; w0 += src.window) {
      if (w0 > 0) cooperative_groups::this_grid().sync();  // every warp done with the window before
      const int wn = src.words - w0 < src.window ? src.words - w0 : src.window;
      for (long long r = i; r < rows; r += stride) {
        const PackStream in{src.pack + r * src.words + w0, src.pack_round, wn, src.rounds * (wn / 128), w0 / 128};
        walk_row<T, F, L>(in, b, c, r, w0 > 0, d_pad, mine);
      }
    }
  } else if (i < rows) {
    const PackStream in{src.pack + i * src.words, src.pack_round, src.words, src.rounds * (src.words / 128), 0};
    walk_row<T, F, L>(in, b, c, i, false, d_pad, mine);
  }
}

template <typename T, typename A>
using Kernel = void (*)(A, const T*, AccOf<T>*, long long, int);

template <typename T, int F, typename A>
Kernel<T, A> pick_lanes(int l) {
  switch (l) {
    case 1: return walk_kernel<T, F, 1, A>;
    case 2: return walk_kernel<T, F, 2, A>;
    case 4: return walk_kernel<T, F, 4, A>;
    case 8: return walk_kernel<T, F, 8, A>;
    case 16: return walk_kernel<T, F, 16, A>;
    default: return walk_kernel<T, F, 32, A>;
  }
}

// The walk for a width: F by features_for, L by lanes_for. The one place
// that picks the schedule.
template <typename T, typename A>
Kernel<T, A> pick(int d_pad) {
  const int f = features_for((int)sizeof(T), d_pad);
  const int l = lanes_for(f, d_pad);
  if constexpr (std::is_same<T, int8_t>::value) return f == 8 ? pick_lanes<T, 8, A>(l) : pick_lanes<T, 16, A>(l);
  else return pick_lanes<T, 16 / (int)sizeof(T), A>(l);
}

// The launch's plan: the grid, chunks of 32 F features in y; in x a block
// a kWarps rows or, for a pack with one group (L = 32: float32 d_pad > 64,
// bf16 > 128, int8 > 256), one wave of blocks (the occupancy the runtime
// reports, over the SMs and the chunks) whose warps walk row after row;
// and, for a pack with one group and one round, the words of a column
// window: whole 4096-column groups whose B rows (the chunk's features of
// them) fill at most half the L2, walked in turn by the one launch
// (cooperative, so that the wave is resident and its barriers hold). The
// store's walk has no windows (its row blocks' B rows stay in L2) and a
// row a warp. Sets the kernel's dynamic shared memory limit.
struct Plan {
  dim3 grid;
  int windows;
};

template <typename T, typename A>
cudaError_t plan(Kernel<T, A> kernel, A* src, long long rows, int d_pad, Plan* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOf<A>);
  const int f = features_for((int)sizeof(T), d_pad);
  const int chunks = (d_pad + 32 * f - 1) / (32 * f);
  long long blocks = (rows + kWarps - 1) / kWarps;
  int windows = 1;
  if constexpr (!kTiles<A>) {
    src->window = src->words;
    if (lanes_for(f, d_pad) == 32) {
      int per_sm = 0, dev = 0, sms = 0, l2 = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, kSmemOf<A>);
      if (err == cudaSuccess) err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
      const long long wave = (long long)per_sm * sms / chunks;
      if (err == cudaSuccess && wave < blocks) blocks = wave > 0 ? wave : 1;
      const long long group_bytes = 4096LL * (d_pad < 32 * f ? d_pad : 32 * f) * (long long)sizeof(T);
      const long long groups = l2 / 2 / group_bytes;
      if (src->rounds == 1 && groups * 128 < src->words) src->window = (int)(groups > 0 ? groups : 1) * 128;
      windows = (src->words + src->window - 1) / src->window;
    }
  }
  *out = Plan{dim3((unsigned)blocks, (unsigned)chunks), windows};
  return err;
}

// Launches the walk picked for d_pad over ``rows`` output rows of the
// source ``src`` on ``stream``, one launch (cooperative with more than one
// column window); returns a cudaError_t.
template <typename T, typename A>
cudaError_t launch(A src, const void* b, void* c, long long rows, int d_pad, cudaStream_t stream) {
  const Kernel<T, A> kernel = pick<T, A>(d_pad);
  Plan p;
  cudaError_t err = plan<T, A>(kernel, &src, rows, d_pad, &p);
  if (err != cudaSuccess) return err;
  const T* bt = static_cast<const T*>(b);
  AccOf<T>* ct = static_cast<AccOf<T>*>(c);
  if (p.windows > 1) {
    void* args[] = {&src, &bt, &ct, &rows, &d_pad};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), p.grid, dim3(kWarps * 32), args,
                                       (size_t)kSmemOf<A>, stream);
  }
  kernel<<<p.grid, kWarps * 32, kSmemOf<A>, stream>>>(src, bt, ct, rows, d_pad);
  return cudaGetLastError();
}

// The launch geometry for ``rows`` output rows of width d_pad over
// ``src``, written to out[0..12]: async_copy::write_geometry's seven
// values (grid x, grid y, threads, dynamic shared memory, stages, resident
// blocks an SM, resident blocks on the card), then lanes L, groups G,
// features F, B rows a lane loads at once, words a span and column windows
// (walked in turn by the one launch, a grid-wide barrier between two).
// Returns a cudaError_t.
template <typename T, typename A>
cudaError_t geometry(A src, long long rows, int d_pad, int* out) {
  const Kernel<T, A> kernel = pick<T, A>(d_pad);
  Plan p;
  cudaError_t err = plan<T, A>(kernel, &src, rows, d_pad, &p);
  if (err == cudaSuccess) err = async_copy::write_geometry(kernel, kWarps * 32, kSmemOf<A>, p.grid, kStages, out);
  if (err != cudaSuccess) return err;
  const int f = features_for((int)sizeof(T), d_pad);
  out[7] = lanes_for(f, d_pad);
  out[8] = 32 / out[7];
  out[9] = f;
  out[10] = loads<T>(out[7], kTiles<A>);
  out[11] = kSpan;
  out[12] = p.windows;
  return cudaSuccess;
}

}  // namespace pattern_bwd
