// The backward walk over a dense strided bit pack, C = P B, shared by
// spmm_pattern.cu (one n_pad x n_pad pack; replaces _bwd_kernel,
// mg_gcn_tpu/ops/spmm_pattern.py:280) and spmm_pattern_ring.cu (a
// partition's P ring-ordered m x m blocks, C = sum_s pack[s] slots[s];
// replaces _bwd_ring_kernel, mg_gcn_tpu/ops/spmm_pattern_ring.py:204); the
// forward walk is pattern_fwd.cuh's. Bit b of word pack[i, g*128 + w] holds
// P[i, g*4096 + b*128 + w]; a pack row has ``words`` words, a multiple of
// 128, and bit 31 is used.
//
// What bounds it on an H100 SXM (3.35 TB/s): the pack, read once a feature
// chunk (6.8 GB at n_pad = 233,472: 2.087 ms with B and C; a ring
// partition's 1.9 GB: 0.592 ms). Besides, each set bit gathers a B row
// slice through L2 (115M x 256 B = 29.4 GB in bf16 at d = 128). PR 1's walk
// (a warp a row, one 16-byte pack load a lane in flight, each 32-word
// sub-span listed and gathered on its own, about 2 set bits at a time on
// the main graph) took the same 8.5 ms at d = 41 and 128: a chain of tiny
// dependent gather rounds bound it, not bytes.
//
// The design, for those limits:
// - The pack streamed ahead. A warp owns one output row and streams its
//   words, every round's in turn, as one stream of kSpan-word spans through
//   a ring of kStages spans in its own shared memory, by 16-byte cp.async
//   copies (each lane copies one 16-byte chunk of each 128-word block):
//   kStages - 1 spans (3 KB) are in flight while the warp lists and
//   gathers. The warp is its own producer and consumer, so a
//   cp.async.wait_group and a __syncwarp order each stage; no barrier
//   between warps, no __syncthreads. A span's chunks are stored swizzled
//   (chunk t at slot t ^ ((t >> 3) & 1)), so the lanes' 16-byte reads of
//   their own consecutive words hit distinct banks.
// - A whole span's bits listed at once. Lane l takes words 8l .. 8l + 7 of
//   the span; one prefix sum of the lanes' popcounts places every set bit,
//   in (round, word, bit) order, in the warp's list: the B row of the bit,
//   s*m + g*4096 + b*128 + w for round s (row s*m of the stacked slots). A
//   lane walks only its set bits (a mask of its live words), so a span
//   costs the warp about as many steps as its busiest lane has bits. The
//   list is a FIFO of kList entries that spans keep filling; a span with
//   more set bits than the list has room for is listed in pieces, gathering
//   between them, so a row with every bit set is walked too.
// - Lane groups sized to the row, as csr_walk.cuh's. A lane loads F
//   features of a B row in one 16-byte load (8 bytes for an int8 row with
//   d_pad % 16 == 8): F = 4 float32, 8 bf16, 16 (or 8) int8. A group of L
//   lanes covers L F features, L the smallest power of two >= d_pad / F,
//   capped at 32 (bf16: L = 16 at d_pad 128, 8 at 48 and 64, 1 at 8), and
//   the warp's G = 32 / L groups take the row's entries in strides: entry e
//   of the row (counted over all rounds, in list order) goes to group
//   e mod G. Whenever the list holds G kLoads entries, each lane loads
//   kLoads B rows at once and adds them in entry order to its F sums in
//   registers; the row's last partial batch is added at the end. With one
//   group the warp also gathers each span's last entries before it lists
//   the next span, so its gathers keep pace with the pack stream.
// - One store. The G groups' sums, live across all spans and rounds, meet
//   by a fixed __shfl_xor_sync tree (groups 2i and 2i + 1 first, then pairs
//   of pairs) and group 0 writes the row once (zeros for a row with no set
//   bit). Rows wider than 32 lanes' loads (float32 d_pad > 128, bf16 > 256,
//   int8 > 512) are walked once a chunk of 32 F features, by grid y.
// - The card filled, B kept in L2 where it can be. A block is kWarps rows,
//   48 KB of rings and lists; registers are capped for 4 resident blocks an
//   SM (32 warps) in bf16 and int8, 3 in float32. With one group (L = 32:
//   float32 d_pad > 64, where B outgrows the 50 MB L2 at Reddit scale, 120
//   MB at d_pad 128) the launcher sizes the grid to one wave of 2 blocks an
//   SM that walk row after row, each lane 16 B rows at once, and splits a
//   one-round pack into column windows whose B rows fill at most half the
//   L2. The one launch, cooperative, walks them in turn: each warp walks
//   its rows over window 0, then, after a grid-wide barrier, over window
//   1, and so on, each row's sums going on from those the warp stored for
//   it at the window before, in the same order, so the sums are those of
//   one walk. The barrier keeps every warp on one window's B rows: without
//   it the warps drift apart across window edges and the walk took
//   9.46-9.49 ms against 8.67 (PERF.md, PR 10). (Without the windows, at
//   float32 d = 128 on the main graph, the walk took 11.4-13.5 ms on an
//   H100 where PR 1's took 9.4: its gathers missed L2.)
//
// Sum order, fixed: each group sums its entries in row order, then the xor
// tree; it depends only on (dtype, d_pad), no atomics, so two launches give
// the same bits. Sums: float32 for float32 and bf16 operands, int32 for
// int8 (exact in any order). Offsets into the pack and B are 64-bit.
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
// are capped for, by operand type and lanes a group: bf16 and int8 4 and 4
// (32 warps an SM); float32, whose loads carry 4 features, 8 and 3, and 16
// and 2 with one group (L = 32, d_pad > 64: fewer rows in flight, each with
// more loads; see the launcher).
template <typename T, int L>
constexpr int kLoads = std::is_same<T, float>::value ? (L == 32 ? 16 : 8) : 4;
template <typename T, int L>
constexpr int kMinBlocks = std::is_same<T, float>::value ? (L == 32 ? 2 : 3) : 4;
constexpr int kBlocks = kSpan / 128;    // 128-word blocks a span
constexpr int kLaneChunks = kSpan / 128;  // 16-byte chunks a lane lists a span (4 words each)
constexpr int kWarpBytes = kStages * kSpan * 4 + kList * 4;
constexpr int kSmemBytes = kWarps * kWarpBytes;  // dynamic shared memory a block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLaneChunks == 2, "the read swizzle below assumes two chunks a lane");
static_assert(2 * 16 * kLoads<float, 2> <= kList && 2 * 32 * kLoads<int8_t, 1> <= kList,
              "the list holds two of the largest batches (G kLoads entries)");

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

// The copier of a row's stream: its rounds x ``words`` words (a round's
// words, or a column window's) in 128-word blocks, kBlocks a span; the last
// span is padded with zeros when the blocks are odd. ``src`` is the next
// block to copy.
struct Stream {
  const uint32_t* src;
  long long pack_round;
  int words, row_blocks, block = 0, word = 0;

  // Copies the next span into stage ``stage`` of the ring at shared address
  // ``ring`` (one 16-byte chunk a lane of each block, chunk t at slot
  // t ^ ((t >> 3) & 1)) and commits the copies as one group (empty past
  // the row's end).
  __device__ __forceinline__ void issue(uint32_t ring, int stage, int lane) {
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
};

// Adds list entries [head, head + n) (n <= G kLoads; group grp takes head +
// grp, head + grp + G, ...) into ``acc``, in entry order: each lane loads
// its F features of the entries' B rows at once, then adds them.
template <typename T, int F, int G>
__device__ __forceinline__ void gather(typename Vec<T, F>::Acc (&acc)[F], const int* list, unsigned head, int n,
                                       const T* bl, int d_pad, bool on, int grp) {
  using Raw = typename Vec<T, F>::Raw;
  Raw r[kLoads<T, 32 / G>];
#pragma unroll
  for (int u = 0; u < kLoads<T, 32 / G>; ++u) {
    const int k = grp + G * u;
    r[u] = Raw{};
    if (on && k < n) {
      const int row = list[(head + (unsigned)k) & (kList - 1)];
      r[u] = __ldg(reinterpret_cast<const Raw*>(bl + (size_t)row * d_pad));
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads<T, 32 / G>; ++u)
    if (grp + G * u < n) Vec<T, F>::add(acc, r[u]);
}

// The B row of bit ``bit`` of the word at stream position p of a row (p =
// s*words + w in round s): row s*m of the stacked slots, then the column
// g*4096 + bit*128 + w % 128 (words is a multiple of 128, so p / 128 counts
// the row's 4096-column groups over the rounds).
__device__ __forceinline__ int b_row(int p, int bit) { return ((p >> 7) << 12) + (p & 127) + bit * 128; }

// Row i of C = sum over ``rounds`` of P_s B_s, walked by one warp: round s
// reads the pack at pack + s*pack_round and B at row s*words*32 of ``b``
// (the stacked slots). With one round, only the column window of words
// [w0, w0 + wn) is walked; a window past the first (w0 > 0, one group)
// adds on to the sums this warp stored for the row at the windows before.
// The warp's ring and list lie at ``mine`` in shared memory.
template <typename T, int F, int L>
__device__ __forceinline__ void walk_row(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                                         AccOf<T>* __restrict__ c, long long i, int words, int w0, int wn, int d_pad,
                                         int rounds, long long pack_round, unsigned char* mine) {
  using Acc = typename Vec<T, F>::Acc;
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes a group");
  constexpr int G = 32 / L;              // groups a warp
  constexpr int kBatch = G * kLoads<T, L>;  // entries a warp gathers at once
  const int lane = threadIdx.x & 31;
  const uint32_t ring = async_copy::smem_u32(mine);
  const uint32_t* stages = reinterpret_cast<const uint32_t*>(mine);
  int* list = reinterpret_cast<int*>(mine + kStages * kSpan * 4);
  const int grp = lane / L, gl = lane % L;
  const int f0 = (int)blockIdx.y * 32 * F + gl * F;
  const bool on = f0 < d_pad;
  const T* bl = b + f0;

  Stream in{pack + i * words + w0, pack_round, wn, rounds * (wn / 128)};
  const int n_spans = (in.row_blocks + kBlocks - 1) / kBlocks;
  __syncwarp();  // a row this warp walked before is done with the ring and the list
  for (int s = 0; s < kStages - 1; ++s) in.issue(ring, s, lane);
  Acc acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = Acc(0);
  if constexpr (L == 32) {  // one group, one sum a feature: a later window goes on from the stored sums
    if (w0 > 0 && on) {
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = c[(size_t)i * d_pad + f0 + f];
    }
  }
  unsigned head = 0, tail = 0;  // the row's entries gathered, listed (warp-uniform)
  for (int t = 0; t < n_spans; ++t) {
    async_copy::cp_async_wait<kStages - 2>();  // span t has landed (this lane's copies)
    __syncwarp();                               // ... and every lane's; stage (t - 1) % kStages is read
    in.issue(ring, (t + kStages - 1) % kStages, lane);
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
    const int p0 = w0 + t * kSpan + 4 * kLaneChunks * lane;  // the stream position of w[0]
    if (total <= kList - (int)(tail - head)) {  // the span's entries fit: one pass over the set bits
      uint32_t x = 0u;
      int p = 0;
      for (int e = 0; e < cnt; ++e) {
        if (x == 0u) {  // the lane's next word with a set bit, from the stage
          const int k = __ffs(live) - 1;
          live &= live - 1u;
          const int ch = kLaneChunks * lane + (k >> 2);
          x = st[4 * (ch ^ ((ch >> 3) & 1)) + (k & 3)];
          p = p0 + k;
        }
        const int bit = __ffs(x) - 1;
        x &= x - 1u;
        list[(tail + (unsigned)(first + e)) & (kList - 1)] = b_row(p, bit);
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
              if (e >= lo && e < lo + n) list[(tail + (unsigned)(e - lo)) & (kList - 1)] = b_row(p0 + k, bit);
              ++e;
            }
          }
        }
        tail += (unsigned)n;
        lo += n;
        if (lo == total) break;  // the last piece is gathered below
        __syncwarp();            // the piece is listed
        for (; tail - head >= (unsigned)kBatch; head += kBatch)
          gather<T, F, G>(acc, list, head, kBatch, bl, d_pad, on, grp);
        __syncwarp();  // the gathered entries are read before the list is refilled
      }
    }
    __syncwarp();  // the span is listed
    for (; tail - head >= (unsigned)kBatch; head += kBatch)
      gather<T, F, G>(acc, list, head, kBatch, bl, d_pad, on, grp);
    if constexpr (G == 1) {  // one group: the span's last entries too, in step with the pack stream
      if (tail != head) gather<T, F, G>(acc, list, head, (int)(tail - head), bl, d_pad, on, grp);
      head = tail;
    }
    __syncwarp();  // the gathered entries are read before the list is refilled
  }
  if (tail != head) gather<T, F, G>(acc, list, head, (int)(tail - head), bl, d_pad, on, grp);

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

// C = sum over ``rounds`` of P_s B_s for ``rows`` output rows, a warp a row:
// warp w of block x walks row x*kWarps + w and, with one group (L = 32),
// the rows gridDim.x*kWarps on after it (the launcher then sizes the grid
// to one wave), over each column window of ``window`` words in turn, with
// a grid-wide barrier between two windows (``window`` is ``words`` but
// with one group and one round; with more than one window the launch is
// cooperative). Grid: (rows / kWarps, or one wave; chunks of 32 F
// features); block kWarps*32 threads; dynamic shared memory kSmemBytes.
template <typename T, int F, int L>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<T, L>)
walk_kernel(const uint32_t* __restrict__ pack, const T* __restrict__ b, AccOf<T>* __restrict__ c, long long rows,
            int words, int window, int d_pad, int rounds, long long pack_round) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  unsigned char* mine = bwd_smem + (threadIdx.x >> 5) * kWarpBytes;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if constexpr (L == 32) {
    for (int w0 = 0; w0 < words; w0 += window) {
      if (w0 > 0) cooperative_groups::this_grid().sync();  // every warp done with the window before
      const int wn = words - w0 < window ? words - w0 : window;
      for (long long r = i; r < rows; r += (long long)gridDim.x * kWarps)
        walk_row<T, F, L>(pack, b, c, r, words, w0, wn, d_pad, rounds, pack_round, mine);
    }
  } else if (i < rows) {
    walk_row<T, F, L>(pack, b, c, i, words, 0, words, d_pad, rounds, pack_round, mine);
  }
}

template <typename T>
using Kernel = void (*)(const uint32_t*, const T*, AccOf<T>*, long long, int, int, int, int, long long);

template <typename T, int F>
Kernel<T> pick_lanes(int l) {
  switch (l) {
    case 1: return walk_kernel<T, F, 1>;
    case 2: return walk_kernel<T, F, 2>;
    case 4: return walk_kernel<T, F, 4>;
    case 8: return walk_kernel<T, F, 8>;
    case 16: return walk_kernel<T, F, 16>;
    default: return walk_kernel<T, F, 32>;
  }
}

// The walk for a width: F by features_for, L by lanes_for. The one place
// that picks the schedule.
template <typename T>
Kernel<T> pick(int d_pad) {
  const int f = features_for((int)sizeof(T), d_pad);
  const int l = lanes_for(f, d_pad);
  if constexpr (std::is_same<T, int8_t>::value) return f == 8 ? pick_lanes<T, 8>(l) : pick_lanes<T, 16>(l);
  else return pick_lanes<T, 16 / (int)sizeof(T)>(l);
}

// The launch's plan: the grid, chunks of 32 F features in y; in x a block
// a kWarps rows or, with one group (L = 32: float32 d_pad > 64, bf16 > 128,
// int8 > 256), one wave of blocks (the occupancy the runtime reports, over
// the SMs and the chunks) whose warps walk row after row; and, with one
// group and one round, the words of a column window: whole 4096-column
// groups whose B rows (the chunk's features of them) fill at most half the
// L2, walked in turn by the one launch (cooperative, so that the wave is
// resident and its barriers hold). Sets the kernel's dynamic shared
// memory limit.
struct Plan {
  dim3 grid;
  int window_words;
};

template <typename T>
cudaError_t plan(Kernel<T> kernel, long long rows, int words, int d_pad, int rounds, Plan* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  const int f = features_for((int)sizeof(T), d_pad);
  const int chunks = (d_pad + 32 * f - 1) / (32 * f);
  long long blocks = (rows + kWarps - 1) / kWarps;
  int window_words = words;
  if (lanes_for(f, d_pad) == 32) {
    int per_sm = 0, dev = 0, sms = 0, l2 = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, kSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    const long long wave = (long long)per_sm * sms / chunks;
    if (err == cudaSuccess && wave < blocks) blocks = wave > 0 ? wave : 1;
    const long long group_bytes = 4096LL * (d_pad < 32 * f ? d_pad : 32 * f) * (long long)sizeof(T);
    const long long groups = l2 / 2 / group_bytes;
    if (rounds == 1 && groups * 128 < words) window_words = (int)(groups > 0 ? groups : 1) * 128;
  }
  *out = Plan{dim3((unsigned)blocks, (unsigned)chunks), window_words};
  return err;
}

// Launches the walk picked for d_pad on ``stream``, one launch (cooperative
// with more than one column window); returns a cudaError_t.
template <typename T>
cudaError_t launch(const void* pack, const void* b, void* c, long long rows, int words, int d_pad, int rounds,
                   long long pack_round, cudaStream_t stream) {
  const Kernel<T> kernel = pick<T>(d_pad);
  Plan p;
  cudaError_t err = plan<T>(kernel, rows, words, d_pad, rounds, &p);
  if (err != cudaSuccess) return err;
  const uint32_t* pk = static_cast<const uint32_t*>(pack);
  const T* bt = static_cast<const T*>(b);
  AccOf<T>* ct = static_cast<AccOf<T>*>(c);
  if (p.window_words < words) {
    void* args[] = {&pk, &bt, &ct, &rows, &words, &p.window_words, &d_pad, &rounds, &pack_round};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), p.grid, dim3(kWarps * 32), args,
                                       (size_t)kSmemBytes, stream);
  }
  kernel<<<p.grid, kWarps * 32, kSmemBytes, stream>>>(pk, bt, ct, rows, words, p.window_words, d_pad, rounds,
                                                      pack_round);
  return cudaGetLastError();
}

// The launch geometry for ``rows`` output rows of width d_pad, written to
// out[0..12]: async_copy::write_geometry's seven values (grid x, grid y,
// threads, dynamic shared memory, stages, resident blocks an SM, resident
// blocks on the card), then lanes L, groups G, features F, B rows a lane
// loads at once, pack words a span and column windows (walked in turn by
// the one launch, a grid-wide barrier between two). Returns a cudaError_t.
template <typename T>
cudaError_t geometry(long long rows, int words, int d_pad, int rounds, int* out) {
  const Kernel<T> kernel = pick<T>(d_pad);
  Plan p;
  cudaError_t err = plan<T>(kernel, rows, words, d_pad, rounds, &p);
  if (err == cudaSuccess) err = async_copy::write_geometry(kernel, kWarps * 32, kSmemBytes, p.grid, kStages, out);
  if (err != cudaSuccess) return err;
  const int f = features_for((int)sizeof(T), d_pad);
  out[7] = lanes_for(f, d_pad);
  out[8] = 32 / out[7];
  out[9] = f;
  out[10] = out[7] == 32 ? kLoads<T, 32> : kLoads<T, 16>;
  out[11] = kSpan;
  out[12] = (words + p.window_words - 1) / p.window_words;
  return cudaSuccess;
}

}  // namespace pattern_bwd
