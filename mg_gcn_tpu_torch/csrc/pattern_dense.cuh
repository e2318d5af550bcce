// The backward walk over a dense strided bit pack, shared by spmm_pattern.cu
// (one n_pad x n_pad pack) and spmm_pattern_ring.cu (a partition's P
// ring-ordered m x m blocks); the forward walk is pattern_fwd.cuh's. Bit b
// of word pack[i, g*128 + w] holds P[i, g*4096 + b*128 + w]; a pack row has
// ``words`` words, a multiple of 128. Offsets are 64-bit.
#pragma once

#include "pattern_modes.cuh"

namespace pattern {

constexpr int kBwdRows = 8;  // backward: rows (= warps) per block

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

}  // namespace pattern
