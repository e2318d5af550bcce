// The two walks over a dense strided bit pack, shared by spmm_pattern.cu (one
// n_pad x n_pad pack) and spmm_pattern_ring.cu (a partition's P ring-ordered
// m x m blocks). Bit b of word pack[i, g*128 + w] holds P[i, g*4096 + b*128 + w];
// a pack row has ``words`` words, a multiple of 128. Offsets are 64-bit.
#pragma once

#include "pattern_modes.cuh"

namespace pattern {

constexpr int kFwdWords = 8;   // forward: words (= warps) per block
constexpr int kFwdRows = 128;  // forward: pack rows per staged tile
constexpr int kBwdRows = 8;    // backward: rows (= warps) per block

// Dynamic shared memory of a forward block: the staged tile and the sums.
template <typename T>
inline size_t fwd_smem_bytes(int d_pad) {
  const int fc_max = d_pad < kChunkF ? d_pad : kChunkF;
  return (size_t)kFwdRows * kFwdWords * sizeof(uint32_t) +
         (size_t)kFwdWords * 32 * fc_max * sizeof(typename Mode<T>::Acc);
}

// Backward, C = sum over ``rounds`` of P_s B_s, where round s reads the pack
// at ``pack + s*pack_round`` and B at ``b + s*b_round``. One warp per output
// row; each lane owns 4 features of the block's 128-feature chunk. For each
// round the warp streams its row's words 128 at a time (16 B a lane,
// coalesced, the next span's load in flight), skips an all-zero span with
// one vote, decodes the set bits of each 32-word sub-span into a per-warp
// list of columns j, then gathers B[j, chunk] four rows at a time into
// register sums that stay live across the rounds until the one store. Sums
// run in (round, word, bit) order: the result is deterministic and no
// atomics are used. Grid: (rows / kBwdRows, ceil(d_pad / 128)).
template <typename T>
__device__ __forceinline__ void bwd_rows(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                                         typename Mode<T>::Acc* __restrict__ c, long long words,
                                         int d_pad, int rounds, long long pack_round,
                                         long long b_round) {
  using Acc4 = typename Mode<T>::Acc4;
  __shared__ int cols[kBwdRows][32 * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kBwdRows + warp;
  const int f0 = blockIdx.y * kChunkF + lane * kLaneF;
  const bool active = f0 < d_pad;
  int* list = cols[warp];

  Acc4 acc;
  zero(acc);
  for (int s = 0; s < rounds; ++s) {
    const uint4* row = reinterpret_cast<const uint4*>(pack + s * pack_round + i * words);
    const T* bcol = b + s * b_round + f0;
    uint4 next = __ldg(row + lane);
    for (long long base = 0; base < words; base += 128) {
      const uint4 cur = next;
      if (base + 128 < words) next = __ldg(row + (base + 128) / 4 + lane);
      if (!__any_sync(kFull, (cur.x | cur.y | cur.z | cur.w) != 0u)) continue;
      const uint32_t span[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long wi = base + 4 * lane + q;  // this lane's word index
        gather_bits<T>(span[q], (int)(wi >> 7) * kGroup + (int)(wi & 127), list, bcol, d_pad, active,
                       acc);
      }
    }
  }
  if (active) *reinterpret_cast<Acc4*>(c + i * d_pad + f0) = acc;
}

// Forward, C = P^T B over a pack of ``n_rows`` rows: C[j, :] = sum_i P[i, j]
// B[i, :]. A column of the row-major pack is strided, so a block owns 8
// consecutive words of one group (one word per warp = 256 output columns)
// and walks ALL rows in order, staging a 128-row x 8-word tile (32 B a row)
// in shared memory with the next tile's load in flight. Each warp keeps a
// shared-memory sum for its 32 columns x the chunk's features; for its
// nonzero words it loads B[i, chunk] four rows at a time and adds it to the
// sum of every set bit. Each sum element belongs to one lane and is summed
// in row order: the result is deterministic and no atomics are used. A ring
// partition's P blocks stacked as (P*m, words), with its slots stacked as
// (P*m, d_pad), are one such pack: the walk runs the rounds in order and
// the sums stay on chip across them. Grid: (words / kFwdWords,
// ceil(d_pad / 128)); dynamic shared memory fwd_smem_bytes<T>(d_pad).
template <typename T>
__device__ __forceinline__ void fwd_cols(const uint32_t* __restrict__ pack, const T* __restrict__ b,
                                         typename Mode<T>::Acc* __restrict__ c, long long n_rows,
                                         long long words, int d_pad) {
  using Acc = typename Mode<T>::Acc;
  using Acc4 = typename Mode<T>::Acc4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);  // [kFwdRows][2] x 4 words
  const uint32_t* tile_words = reinterpret_cast<const uint32_t*>(smem);
  Acc* sums = reinterpret_cast<Acc*>(smem + kFwdRows * kFwdWords * sizeof(uint32_t));

  const int fc = min(kChunkF, d_pad - (int)blockIdx.y * kChunkF);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w_first = (long long)blockIdx.x * kFwdWords;
  const int f0 = blockIdx.y * kChunkF + lane * kLaneF;
  const bool active = lane * kLaneF < fc;
  for (int t = threadIdx.x; t < kFwdWords * 32 * fc; t += blockDim.x) sums[t] = Acc(0);
  Acc* mine = sums + warp * 32 * fc + lane * kLaneF;  // + bit * fc

  // thread t stages half a tile row: row t/2, words 4*(t%2) .. 4*(t%2)+3
  const uint32_t* src =
      pack + (long long)(threadIdx.x >> 1) * words + w_first + 4 * (threadIdx.x & 1);
  uint4 next = __ldg(reinterpret_cast<const uint4*>(src));
  for (long long r0 = 0; r0 < n_rows; r0 += kFwdRows) {
    __syncthreads();  // the previous tile is consumed (and the sums zeroed)
    tile[threadIdx.x] = next;
    __syncthreads();
    if (r0 + kFwdRows < n_rows)
      next = __ldg(reinterpret_cast<const uint4*>(src + (r0 + kFwdRows) * words));
    for (int s = 0; s < kFwdRows; s += 32) {
      const uint32_t w = tile_words[(s + lane) * kFwdWords + warp];
      unsigned m = __ballot_sync(kFull, w != 0u);
      while (m) {
        int r[4];
        uint32_t bits[4];
        Acc4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // up to 4 nonzero rows at once
          r[q] = m ? __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bits[q] = __shfl_sync(kFull, w, r[q] < 0 ? 0 : r[q]);
          zero(v[q]);
          if (r[q] >= 0 && active)
            v[q] = Mode<T>::load(b + (size_t)(r0 + s + r[q]) * d_pad + f0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = r[q] < 0 ? 0u : bits[q];
          while (x) {
            const int bit = __ffs(x) - 1;
            x &= x - 1;
            if (active) {
              Acc4* a = reinterpret_cast<Acc4*>(mine + bit * fc);
              Acc4 t = *a;
              add(t, v[q]);
              *a = t;
            }
          }
        }
      }
    }
  }
  // each lane reads back only the sum elements it wrote
  const long long wi = w_first + warp;
  const long long jbase = (wi >> 7) * kGroup + (wi & 127);
  if (active) {
    for (int bit = 0; bit < 32; ++bit)
      *reinterpret_cast<Acc4*>(c + (jbase + bit * 128) * d_pad + f0) =
          *reinterpret_cast<const Acc4*>(mine + bit * fc);
  }
}

}  // namespace pattern
