// Block-sparse bit-packed pattern SpMM pair for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of mg_gcn_tpu/ops/spmm_pattern_sparse.py:
//   block_fwd_kernel  <-  _fwd_kernel_sparse (spmm_pattern_sparse.py:366):  C = P^T B
//   block_bwd_kernel  <-  _bwd_kernel_sparse (spmm_pattern_sparse.py:392):  C = P   B
// over the compact tile store the JAX package builds: only the occupied
// (tile_r x 4096) regions of P are kept, as tiles[T][tile_r][128] int32,
// and bit b of word tiles[t][r][w] holds P[rb*tile_r + r, g*4096 + b*128 + w]
// for tile t = (row block rb, group g). Tiles are stored in (rb, g) order.
// The TPU kernels' plane-compacted K_PLANES schedules, empty-plane padding
// slots, the all-zero dummy tile, first-visit flags, scalar prefetch and
// D_MAX chunking worked around the TPU's sequential grid and MXU and are not
// reproduced. What is kept: the store, each tile's (rb, g), a by-group tile
// list for the forward, the by-row-block ranges for the backward (tiles are
// in rb order) and each tile's live-plane mask (bit b: plane b holds an edge).
//
// B and C are row-major (n_pad, d_pad), d_pad % 8 == 0; the wrapper
// (ops/spmm_pattern_sparse.py) pads and scales. Operand modes as in
// pattern_modes.cuh. Every output row that no tile reaches comes out 0.
//
// What bounds them on an H100 SXM (3.35 TB/s): on bench.py's banded Reddit
// graph (n_pad = 233,472, ~1,400 tiles, 0.36 GB of tiles, ~111M edges) the
// store is read in ~0.11 ms, so both kernels are bound by the per-edge
// work: one 4-feature B slice a lane per set bit (2*nnz*d operations, and
// the band's B rows stay in L2). The backward decodes each tile row once;
// the forward reads a live tile once per live plane, through L2 (the 32
// plane blocks of one group run side by side). No atomics: every sum has
// one owner and a fixed order, so results repeat bit for bit.
//
// Offsets into the store and into B/C are 64-bit.

#include "pattern_modes.cuh"

namespace {

using pattern::add;
using pattern::kChunkF;
using pattern::kFull;
using pattern::kGroup;
using pattern::kLaneF;
using pattern::Mode;
using pattern::zero;

constexpr int kBwdRows = 8;   // backward: output rows (= warps) per block
constexpr int kFwdWarps = 8;  // forward: each warp owns 16 of a plane's 128 columns
constexpr int kFwdCols = 128 / kFwdWarps;

// Backward, C = P B. One warp per output row i = rb*tile_r + r; each lane
// owns 4 features of the block's 128-feature chunk. The warp walks the
// tiles of row block rb (tiles [rb_ptr[rb], rb_ptr[rb+1])), reads the
// 128-word row r of each (16 B a lane, coalesced), skips an all-zero row
// with one vote and gathers B[j, chunk] for its set bits in (tile, word,
// bit) order (pattern::gather_bits). A row block with no tile writes 0.
template <typename T>
__global__ void __launch_bounds__(kBwdRows * 32)
block_bwd_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ tile_g,
                 const int* __restrict__ rb_ptr, const T* __restrict__ b,
                 typename Mode<T>::Acc* __restrict__ c, int tile_r, int d_pad) {
  using Acc4 = typename Mode<T>::Acc4;
  __shared__ int cols[kBwdRows][32 * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kBwdRows + warp;
  const int rb = (int)(i / tile_r);
  const int r = (int)(i % tile_r);
  const int f0 = blockIdx.y * kChunkF + lane * kLaneF;
  const bool active = f0 < d_pad;
  int* list = cols[warp];
  const T* bcol = b + f0;

  Acc4 acc;
  zero(acc);
  const int t1 = __ldg(rb_ptr + rb + 1);
  for (int t = __ldg(rb_ptr + rb); t < t1; ++t) {
    const uint4 cur =
        __ldg(reinterpret_cast<const uint4*>(tiles + ((long long)t * tile_r + r) * 128) + lane);
    if (!__any_sync(kFull, (cur.x | cur.y | cur.z | cur.w) != 0u)) continue;
    const int jbase = __ldg(tile_g + t) * kGroup + 4 * lane;
    const uint32_t span[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) pattern::gather_bits<T>(span[q], jbase + q, list, bcol, d_pad, active, acc);
  }
  if (active) *reinterpret_cast<Acc4*>(c + i * d_pad + f0) = acc;
}

// Forward, C = P^T B. A block owns (plane b, group g, feature chunk): the
// 128 output rows j = g*4096 + b*128 + w, w < 128, whose sums (128 x up to
// 128 features) live in shared memory. It walks the tiles of group g
// (g_tiles[g_ptr[g] .. g_ptr[g+1]), in row-block order) whose live-plane
// mask has bit b, and skips the others without reading them. Warp k owns
// the columns w in [16k, 16k + 16): per step its lanes read words w of two
// tile rows (64 B each, the next step's in flight), one ballot finds the
// rows and columns whose bit b is set, and for up to four of them at once
// each lane loads its 4 features of B[rb*tile_r + r] and adds them to the
// sum of column w. Each sum element belongs to one lane and is summed in
// (tile, row) order: the result is deterministic and no atomics are used.
// A plane no tile has writes 0. Per set bit each lane reads and writes 16 B
// of its sums: on the banded graph at d = 128 in bf16 that shared-memory
// traffic (~113 GB) and the B rows (~28 GB through L1/L2) bound the
// kernel, not load latency (walking 8 or 16 rows a step, or loading 8 set
// bits' rows at once, measured no faster on the H100).
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
block_fwd_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ tile_rb,
                 const int* __restrict__ g_ptr, const int* __restrict__ g_tiles,
                 const int* __restrict__ pmask, const T* __restrict__ b,
                 typename Mode<T>::Acc* __restrict__ c, int tile_r, int d_pad) {
  using Acc = typename Mode<T>::Acc;
  using Acc4 = typename Mode<T>::Acc4;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sums = reinterpret_cast<Acc*>(smem);  // [128][fc]

  const int plane = blockIdx.x;
  const int g = blockIdx.y;
  const int fc = min(kChunkF, d_pad - (int)blockIdx.z * kChunkF);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.z * kChunkF + lane * kLaneF;
  const bool active = lane * kLaneF < fc;
  for (int t = threadIdx.x; t < 128 * fc; t += blockDim.x) sums[t] = Acc(0);
  __syncthreads();
  Acc* mine = sums + warp * kFwdCols * fc + lane * kLaneF;  // + column * fc

  const int half = lane >> 4;                  // which of the step's two rows
  const int w = warp * kFwdCols + (lane & 15);  // this lane's word (column)
  const int k1 = __ldg(g_ptr + g + 1);
  for (int k = __ldg(g_ptr + g); k < k1; ++k) {
    const int t = __ldg(g_tiles + k);
    if (!((__ldg(pmask + t) >> plane) & 1)) continue;
    const long long row0 = (long long)__ldg(tile_rb + t) * tile_r;
    const uint32_t* words = tiles + (long long)t * tile_r * 128 + (long long)half * 128 + w;
    uint32_t next = half < tile_r ? __ldg(words) : 0u;
    for (int r0 = 0; r0 < tile_r; r0 += 2) {
      const uint32_t word = next;
      next = r0 + 2 + half < tile_r ? __ldg(words + (long long)(r0 + 2) * 128) : 0u;
      unsigned m = __ballot_sync(kFull, (word >> plane) & 1u);
      while (m) {
        int src[4];
        Acc4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // up to 4 set bits at once
          src[q] = m ? __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zero(v[q]);
          if (src[q] >= 0 && active)
            v[q] = Mode<T>::load(b + (size_t)(row0 + r0 + (src[q] >> 4)) * d_pad + f0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (src[q] >= 0 && active) {
            Acc4* a = reinterpret_cast<Acc4*>(mine + (src[q] & 15) * fc);
            Acc4 s = *a;
            add(s, v[q]);
            *a = s;
          }
        }
      }
    }
  }
  // each lane reads back only the sum elements it wrote
  if (active) {
    const long long j0 = (long long)g * kGroup + plane * 128 + warp * kFwdCols;
    for (int col = 0; col < kFwdCols; ++col)
      *reinterpret_cast<Acc4*>(c + (j0 + col) * d_pad + f0) = *reinterpret_cast<const Acc4*>(mine + col * fc);
  }
}

bool bad_shape(long long n_pad, int tile_r, int d_pad) {
  return n_pad <= 0 || n_pad % kGroup != 0 || tile_r <= 0 || kGroup % tile_r != 0 || d_pad <= 0 ||
         d_pad % 8 != 0;
}

template <typename T>
int launch_fwd(const void* tiles, const void* tile_rb, const void* g_ptr, const void* g_tiles,
               const void* pmask, const void* b, void* c, long long n_pad, int tile_r, int d_pad,
               cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  const int fc_max = d_pad < kChunkF ? d_pad : kChunkF;
  const size_t smem = (size_t)128 * fc_max * sizeof(Acc);
  cudaError_t err =
      cudaFuncSetAttribute(block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(32u, (unsigned)(n_pad / kGroup), (unsigned)((d_pad + kChunkF - 1) / kChunkF));
  block_fwd_kernel<T><<<grid, kFwdWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const int*>(tile_rb),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_tiles), static_cast<const int*>(pmask),
      static_cast<const T*>(b), static_cast<Acc*>(c), tile_r, d_pad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* tiles, const void* tile_g, const void* rb_ptr, const void* b, void* c,
               long long n_pad, int tile_r, int d_pad, cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  const dim3 grid((unsigned)(n_pad / kBwdRows), (unsigned)((d_pad + kChunkF - 1) / kChunkF));
  block_bwd_kernel<T><<<grid, kBwdRows * 32, 0, stream>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const int*>(tile_g),
      static_cast<const int*>(rb_ptr), static_cast<const T*>(b), static_cast<Acc*>(c), tile_r, d_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (C is int32). Returns a
// cudaError_t; 0 means the launch was accepted. Index arrays are int32.
int mggcn_block_fwd(const void* tiles, const void* tile_rb, const void* g_ptr, const void* g_tiles,
                    const void* pmask, const void* b, void* c, long long n_pad, int tile_r, int d_pad,
                    int dtype, void* stream) {
  if (bad_shape(n_pad, tile_r, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(tiles, tile_rb, g_ptr, g_tiles, pmask, b, c, n_pad, tile_r, d_pad, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(tiles, tile_rb, g_ptr, g_tiles, pmask, b, c, n_pad, tile_r, d_pad, s);
    case 2: return launch_fwd<int8_t>(tiles, tile_rb, g_ptr, g_tiles, pmask, b, c, n_pad, tile_r, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mggcn_block_bwd(const void* tiles, const void* tile_g, const void* rb_ptr, const void* b, void* c,
                    long long n_pad, int tile_r, int d_pad, int dtype, void* stream) {
  if (bad_shape(n_pad, tile_r, d_pad)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(tiles, tile_g, rb_ptr, b, c, n_pad, tile_r, d_pad, s);
    case 1: return launch_bwd<__nv_bfloat16>(tiles, tile_g, rb_ptr, b, c, n_pad, tile_r, d_pad, s);
    case 2: return launch_bwd<int8_t>(tiles, tile_g, rb_ptr, b, c, n_pad, tile_r, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
