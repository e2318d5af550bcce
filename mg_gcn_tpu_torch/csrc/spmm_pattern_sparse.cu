// Block-sparse bit-packed pattern SpMM pair for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of mg_gcn_tpu/ops/spmm_pattern_sparse.py:
//   block_fwd_kernel              <-  _fwd_kernel_sparse (spmm_pattern_sparse.py:366):  C = P^T B
//   pattern_bwd.cuh's store walk  <-  _bwd_kernel_sparse (spmm_pattern_sparse.py:392):  C = P   B
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
// The backward is the backward pattern walk of pattern_bwd.cuh, shared with
// spmm_pattern.cu and spmm_pattern_ring.cu, over the store as its word
// source: a warp an output row, row r of its row block's tiles streamed by
// cp.async, their set bits listed a span at once, lane groups sized to the
// row (its design, bound and sum order are there). The forward multiplies
// the live bit planes, decoded to 0/1 fragments, on the tensor cores
// (below). No atomics: every sum has one owner and a fixed order, so
// results repeat bit for bit.
//
// Offsets into the store and into B/C are 64-bit.

#include <type_traits>

#include "async_copy.cuh"
#include "pattern_bwd.cuh"
#include "pattern_modes.cuh"

namespace {

using async_copy::cp_async_ca;
using async_copy::cp_async_cg16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;
using async_copy::smem_u32;

using pattern::kGroup;
using pattern::Mode;

// ---------------------------------------------------------------------------
// Forward, C = P^T B, on the tensor cores. For output row
// j = g*4096 + b*128 + w:
//   C[j, :] = sum over the tiles t of group g (row-block order) with plane b
//             live, of sum_r bit_b(tiles[t, r, w]) * B[tile_rb[t]*tile_r + r, :]
// so each live (tile, plane) is a (128 x tile_r) x (tile_r x d) product
// whose left operand is 0/1, as the TPU kernel's MXU product over the
// unpacked plane (_fwd_kernel_sparse, spmm_pattern_sparse.py:366).
//
// What bounds it on an H100 SXM: operations. On bench.py's banded graph
// about 30,800 (tile, plane) pairs of the 1,352 stored tiles are live, and
// inside a live plane 5.5% of the bits are set, so the dense products over
// the live planes, 2 * 30,800 * 512 * 128 * d (516 GFLOP at d = 128), are
// what the tensor cores must do: 0.52 ms at the bf16 peak. Besides, every
// bit must be decoded into an A fragment once per feature chunk, and the
// bit words and B rows reach the block through L2 once per chunk and per
// 16-word run.
//
// The design:
// - A block owns (16-word run, group g, feature chunk): 16 warps, warp k the
//   planes 2k, 2k+1 and the chunk's n8 tiles (8 of them, 64 features; 4 and
//   32 in float32), so a lane holds 2 planes x 8 tiles of mma.sync m16n8
//   running sums (64; 32 in float32). Each decoded A fragment feeds 8 MMAs: the
//   decode, not the MMA, was what a narrower chunk spent its time on. A warp
//   skips a tile's stages when both its planes are dead there (pmask); a
//   dead plane beside a live one is multiplied through (its A fragments are
//   0), since a branch a plane cost more time than the MMAs it saved. The chunk
//   index varies fastest in the grid, so the chunks of one run share its bit
//   words in L2, and the runs of a group its B rows.
// - A fragments decoded from the bit words in registers. For m16n8k16 a
//   lane needs words g, g+8 (g = lane/4) of tile rows 2t, 2t+1, 2t+8, 2t+9
//   (t = lane%4); for int8's m16n8k32, rows 4t..4t+3 and 4t+16..4t+19. One
//   byte_perm gathers the byte of those words that holds the warp's planes;
//   a plane's register is then a shift, a mask and (bf16) a multiply by
//   0x3F80, bf16's 1.0. One load of the words serves both planes.
// - Stages of 64 tile rows, filled by 16-byte cp.async copies into a ring
//   of 4 stages: the run's bit words and the tile's B rows x the chunk's
//   features, both row-major with their 16-byte chunks XOR-swizzled by row,
//   so that the lanes' 4-byte reads of bit words and of B (float32, int8)
//   and ldmatrix.trans (bf16) hit distinct banks. Rows past tile_r and
//   features past d_pad are zero-filled. The group's tile list (id, first B
//   row, plane mask) is read into shared memory 512 tiles at a time, so no
//   stage waits on a chain of global loads.
// - One __syncthreads a stage, not pattern_fwd.cuh's full/empty mbarriers:
//   every thread copies a share of every stage (a stage is 8-16 KB, too
//   much for one warp's copies to keep up) and every warp reads all of it,
//   so a stage is full only when all 512 threads' copies have landed and
//   free only when all 16 warps are done. A full/empty pair would still let
//   a warp that skips a dead tile run a stage or two ahead of the others;
//   the barrier makes it wait (not measured against an mbarrier ring).
// - Operand modes (pattern_modes.cuh's contract):
//   bfloat16: bf16 MMA, float32 sums (fresh sums a stage, below).
//   int8: s8 x s8 -> s32 MMA, exact. A lane reads 4 features of 4 rows and
//     transposes the 16 bytes in registers; within each 32 features the n8
//     tiles then hold features strided by 4 (tile j: features 4n + j), which
//     the epilogue undoes.
//   float32: no TF32. Each B value is split exactly into three bf16 parts,
//     hi = x truncated to bf16, mid = (x - hi) truncated, lo = x - hi - mid
//     (exact for |x| >= 2^-100; below, the error is under 2^-126), and
//     three MMAs add them (a 0/1 operand makes every product exact). hi
//     goes into one set of sums, where 8-bit values add exactly as in bf16
//     mode, and mid and lo into a second, 2^8 smaller. Holding both sets the
//     chunk: 32 features. B must be finite.
// - Fresh sums a stage (both float modes). The tensor cores' float32 sums
//   drop the bits of an addend below the accumulator's last place: they
//   truncate toward zero, so errors kept in one accumulator over a column's
//   ~475 set bits all lean one way (sum(e sign) / sum|e| = -0.87 against the
//   float64 sum on a positive float32 operand, with sums kept on the tensor
//   cores from the first tile to the last). So a stage's MMAs (64 tile rows)
//   go into zeroed fragments, whose partial sums are small enough that hi
//   values add exactly, and at the end of the stage a float32 add, which
//   rounds to nearest, takes them into the running sums (float32: hi + (mid
//   + lo) first). To keep the stage's fragments and the running sums in
//   registers together, a stage decodes its A fragments for every MMA step
//   first and then walks its n8 tiles one (float32) or two (bf16, one
//   ldmatrix) at a time. int8 sums are exact and keep the step-major order.
//
// Sum order, fixed: every output element is one lane's accumulator, summed
// over (tile, stage) in order, each stage's MMA steps in order into fresh
// sums first (int8: over (tile, stage, MMA step) in one integer sum). Two
// launches give the same bits; rows no live plane reaches are stored as 0.

constexpr int kRunWords = 16;   // words a block owns: one M fragment a plane
constexpr int kRuns = 128 / kRunWords;
constexpr int kStageRows = 64;  // tile rows a stage
constexpr int kFwdStages = 4;   // stages in the ring
constexpr int kPlanes = 2;      // planes a warp
constexpr int kFwdWarps = 32 / kPlanes;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kBitBytes = kStageRows * kRunWords * 4;
constexpr int kTab = 512;  // tiles of a group in the block's shared table at a time

template <typename T>
struct Fwd {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kNT = kF32 ? 4 : 8;                   // n8 tiles a warp
  static constexpr int kFeat = 8 * kNT;                      // features a block
  static constexpr int kStep = kInt8 ? 32 : 16;              // tile rows an MMA
  static constexpr int kSteps = kStageRows / kStep;          // MMA steps a stage
  static constexpr int kQ = kInt8 ? 16 : 8;                  // bit words a lane an MMA step
  static constexpr int kRowBytes = kFeat * (int)sizeof(T);   // a stage row of B: 64 / 128 / 128 B
  static constexpr int kPiece = kInt8 ? 8 : 16;              // bytes a cp.async (int8 rows are 8-B aligned)
  static constexpr int kStageBytes = kBitBytes + kStageRows * kRowBytes;
  using Acc = typename Mode<T>::Acc;

  // Byte offset in a stage's B part of byte ``x`` of row r (x < kRowBytes).
  __device__ __forceinline__ static int b_off(int r, int x) {
    if constexpr (kInt8) {  // two rows a line; chunks XOR 2 * ((r / 4) % 4)
      return ((r >> 1) << 7) + (((((r & 1) << 2) | (x >> 4)) ^ (((r >> 2) & 3) << 1)) << 4) + (x & 15);
    } else if constexpr (kF32) {  // one row a line; chunks XOR 2 * ((r / 2) % 4)
      return (r << 7) + (((x >> 4) ^ (((r >> 1) & 3) << 1)) << 4) + (x & 15);
    } else {  // one row a line; chunks XOR r % 8
      return (r << 7) + (((x >> 4) ^ (r & 7)) << 4) + (x & 15);
    }
  }
  // The tile row (within an MMA step) of word q of lane (g, t); its word is
  // g + 8 (q & 1).
  __device__ __forceinline__ static int q_row(int q, int t) {
    const int ri = q >> 1;
    return kInt8 ? 4 * t + (ri & 3) + 16 * (ri >> 2) : 2 * t + (ri & 1) + 8 * (ri >> 1);
  }
  // Byte offset in a stage's bit part of word w of row r: rows of 64 B, two
  // a line, the line's 16-byte chunks XOR-swizzled so that the 32 words a
  // warp reads for one register (rows 2t or 4t, words g or g + 8) hit 32
  // banks.
  __device__ __forceinline__ static int bit_off(int r, int w) {
    const int f = kInt8 ? (r >> 2) & 3 : (r >> 1) & 3;
    return ((r >> 1) << 7) + (((((r & 1) << 2) | (w >> 2)) ^ (2 * f)) << 4) + ((w & 3) << 2);
  }
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// x = hi + mid + lo, each a bf16 held in the upper half of a float's bits.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// The A fragments (0/1, as bf16 or int8) of the warp's kPlanes planes at
// MMA step s of a stage: lane (g, t) reads its kQ bit words, one prmt
// gathers the byte that holds the planes, and a plane is a shift and a
// mask (bf16: times 0x3F80, the bits of 1.0).
template <typename T>
__device__ __forceinline__ void decode_planes(const unsigned char* st, int s, int g, int t, uint32_t m, int sh,
                                              uint32_t (&a)[kPlanes][4]) {
  using F = Fwd<T>;
  uint32_t x[F::kQ];
#pragma unroll
  for (int q = 0; q < F::kQ; ++q)
    x[q] = *reinterpret_cast<const uint32_t*>(st + F::bit_off(s * F::kStep + F::q_row(q, t), g + 8 * (q & 1)));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t y;
    if constexpr (F::kInt8) {  // byte i' <- row 4t + i' (+16), word g (+8)
      const int q0 = (j >> 1) * 8 + (j & 1);
      const uint32_t sel = m * 0x11u + 0x40u;
      y = __byte_perm(__byte_perm(x[q0], x[q0 + 2], sel), __byte_perm(x[q0 + 4], x[q0 + 6], sel), 0x5410);
    } else {  // half 0 <- row 2t (+8), half 1 <- row 2t + 1 (+8), word g (+8)
      const int q0 = (j >> 1) * 4 + (j & 1);
      y = __byte_perm(x[q0], x[q0 + 2], m * 0x1111u + 0x4400u);
    }
    y >>= sh;
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) a[i][j] = F::kInt8 ? (y >> i) & 0x01010101u : ((y >> i) & 0x00010001u) * 0x3F80u;
  }
}

// The block fills ``stage`` with unit (tile ti, rows r0 .. r0 + 64) and
// commits the copies as one group: the run's 16 bit words of each row in
// 16-byte copies (bit_off), then the B rows (b_off).
template <typename T>
__device__ __forceinline__ void fwd_fill(unsigned char* stage, const uint32_t* __restrict__ tiles,
                                          const T* __restrict__ b, int ti, long long brow0, int r0, int tile_r,
                                          int run, int f0, int d_pad) {
  using F = Fwd<T>;
  const uint32_t dst = smem_u32(stage);
  const uint32_t* tsrc = tiles + (long long)ti * tile_r * 128 + run * kRunWords;
  for (int e = threadIdx.x; e < kStageRows * kRunWords / 4; e += kFwdThreads) {
    const int row = e >> 2, w = 4 * (e & 3);
    const bool in = r0 + row < tile_r;
    const uint32_t* src = in ? tsrc + (long long)(r0 + row) * 128 + w : tiles;
    cp_async_cg16(dst + F::bit_off(row, w), src, in ? 16 : 0);
  }
  constexpr int kPieces = F::kRowBytes / F::kPiece, kElems = F::kPiece / (int)sizeof(T);
  const T* bsrc = b + (brow0 + r0) * d_pad + f0;
  for (int e = threadIdx.x; e < kStageRows * kPieces; e += kFwdThreads) {
    const int r = e / kPieces, p = e % kPieces;
    const bool in = r0 + r < tile_r && f0 + p * kElems < d_pad;
    const T* src = in ? bsrc + (long long)r * d_pad + p * kElems : b;
    const uint32_t to = dst + kBitBytes + F::b_off(r, p * F::kPiece);
    if constexpr (F::kInt8)
      cp_async_ca<8>(to, src, in ? 8 : 0);
    else
      cp_async_cg16(to, src, in ? 16 : 0);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 1)
block_fwd_kernel(const uint32_t* __restrict__ tiles, const int* __restrict__ tile_rb,
                 const int* __restrict__ g_ptr, const int* __restrict__ g_tiles,
                 const int* __restrict__ pmask, const T* __restrict__ b,
                 typename Mode<T>::Acc* __restrict__ c, int tile_r, int d_pad) {
  using F = Fwd<T>;
  using Acc = typename F::Acc;
  constexpr int kNT = F::kNT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_chunks = (d_pad + F::kFeat - 1) / F::kFeat;
  const int f0 = (blockIdx.x % n_chunks) * F::kFeat, run = blockIdx.x / n_chunks, grp = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int first = __ldg(g_ptr + grp), n_tiles = __ldg(g_ptr + grp + 1) - first;
  const int nk = (tile_r + kStageRows - 1) / kStageRows;  // stages a tile
  const int nt_live = min(kNT, (d_pad - f0) >> 3);  // n8 tiles inside d_pad
  // this warp's planes, and the byte of a word that holds them and their shift in it
  const int plane0 = kPlanes * warp;
  const uint32_t m = (uint32_t)plane0 >> 3;
  const int sh = plane0 & 7;

  Acc acc[kPlanes][kNT][4];
#pragma unroll
  for (int i = 0; i < kPlanes; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  // The group's tiles go by in windows of kTab: each window's (tile id, first
  // B row, plane mask) is read into shared memory once, then its units
  // (tile, 64-row stage) stream through the ring, which drains at the end of
  // the window. The windows keep the tiles' order, so the sums' order does
  // not depend on kTab.
  __shared__ int tab_ti[kTab];
  __shared__ long long tab_row[kTab];
  __shared__ uint32_t tab_pm[kTab];
  for (int w0 = 0; w0 < n_tiles; w0 += kTab) {
    const int units = min(kTab, n_tiles - w0) * nk;
    __syncthreads();  // every warp is done with the previous window's table and stages
    for (int k = threadIdx.x; k < units / nk; k += kFwdThreads) {
      const int ti = __ldg(g_tiles + first + w0 + k);
      tab_ti[k] = ti;
      tab_row[k] = (long long)__ldg(tile_rb + ti) * tile_r;
      tab_pm[k] = (uint32_t)__ldg(pmask + ti);
    }
    __syncthreads();
    auto fill = [&](int u, int s) {
      fwd_fill<T>(smem + s * F::kStageBytes, tiles, b, tab_ti[u / nk], tab_row[u / nk], (u % nk) * kStageRows,
                  tile_r, run, f0, d_pad);
    };
#pragma unroll
    for (int s = 0; s < kFwdStages - 1; ++s) {
      if (s < units)
        fill(s, s);
      else
        cp_async_commit();
    }

    for (int u = 0; u < units; ++u) {
      cp_async_wait<kFwdStages - 2>();
      __syncthreads();  // unit u landed; the stage refilled below was released by every warp
      if (u + kFwdStages - 1 < units)
        fill(u + kFwdStages - 1, (u + kFwdStages - 1) % kFwdStages);
      else
        cp_async_commit();

      if (!((tab_pm[u / nk] >> plane0) & ((1u << kPlanes) - 1))) continue;  // both planes dead here
      const unsigned char* st = smem + (u % kFwdStages) * F::kStageBytes;
      const unsigned char* bst = st + kBitBytes;
      if constexpr (F::kInt8) {
#pragma unroll
        for (int s = 0; s < F::kSteps; ++s) {
          uint32_t a[kPlanes][4];
          decode_planes<T>(st, s, g, t, m, sh, a);
#pragma unroll
          for (int qd = 0; qd < kNT / 4; ++qd) {
            if (32 * qd + f0 >= d_pad) break;
            uint32_t bq[2][4];  // [k half][n8 tile of the quad]
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t rw[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                rw[i] =
                    *reinterpret_cast<const uint32_t*>(bst + F::b_off(s * 32 + 16 * h + 4 * t + i, 32 * qd + 4 * g));
              const uint32_t x0 = __byte_perm(rw[0], rw[1], 0x5140), x1 = __byte_perm(rw[0], rw[1], 0x7362);
              const uint32_t y0 = __byte_perm(rw[2], rw[3], 0x5140), y1 = __byte_perm(rw[2], rw[3], 0x7362);
              bq[h][0] = __byte_perm(x0, y0, 0x5410);
              bq[h][1] = __byte_perm(x0, y0, 0x7632);
              bq[h][2] = __byte_perm(x1, y1, 0x5410);
              bq[h][3] = __byte_perm(x1, y1, 0x7632);
            }
#pragma unroll
            for (int i = 0; i < kPlanes; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_s8(acc[i][4 * qd + j], a[i], bq[0][j], bq[1][j]);
          }
        }
      } else {
        // a[s][i]: the A fragment of plane plane0 + i at MMA step s
        uint32_t a[F::kSteps][kPlanes][4];
#pragma unroll
        for (int s = 0; s < F::kSteps; ++s) decode_planes<T>(st, s, g, t, m, sh, a[s]);
        // kJ n8 tiles at a time, the stage's MMAs into fresh sums (float32:
        // hi in one set, mid and lo in another), then added into acc by
        // float32 adds, which round to nearest
        constexpr int kJ = F::kF32 ? 1 : 2;
#pragma unroll
        for (int jj = 0; jj < kNT; jj += kJ) {
          if (jj >= nt_live) break;
          float hi[kPlanes][kJ][4] = {}, lo[kPlanes][kJ][4] = {};
#pragma unroll
          for (int s = 0; s < F::kSteps; ++s) {
            if constexpr (F::kF32) {
              const int x = 4 * (8 * jj + g);
              const int r0 = s * 16 + 2 * t;
              uint32_t hv[4], mv[4], lv[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)  // rows r0, r0 + 1, r0 + 8, r0 + 9
                split3(*reinterpret_cast<const float*>(bst + F::b_off(r0 + (e & 1) + 8 * (e >> 1), x)), hv[e],
                       mv[e], lv[e]);
              const uint32_t bh0 = __byte_perm(hv[0], hv[1], 0x7632), bh1 = __byte_perm(hv[2], hv[3], 0x7632);
              const uint32_t bm0 = __byte_perm(mv[0], mv[1], 0x7632), bm1 = __byte_perm(mv[2], mv[3], 0x7632);
              const uint32_t bl0 = __byte_perm(lv[0], lv[1], 0x7632), bl1 = __byte_perm(lv[2], lv[3], 0x7632);
#pragma unroll
              for (int i = 0; i < kPlanes; ++i) {
                mma_bf16(hi[i][0], a[s][i], bh0, bh1);
                mma_bf16(lo[i][0], a[s][i], bm0, bm1);
                mma_bf16(lo[i][0], a[s][i], bl0, bl1);
              }
            } else {
              uint32_t b0[2], b1[2];
              const int r = s * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
              ldsm_x4_trans(smem_u32(bst + F::b_off(r, 16 * (jj + (lane >> 4)))), b0[0], b1[0], b0[1], b1[1]);
#pragma unroll
              for (int i = 0; i < kPlanes; ++i) {
                mma_bf16(hi[i][0], a[s][i], b0[0], b1[0]);
                if (jj + 1 < nt_live) mma_bf16(hi[i][1], a[s][i], b0[1], b1[1]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kPlanes; ++i)
#pragma unroll
            for (int q = 0; q < kJ; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][jj + q][e] += F::kF32 ? hi[i][q][e] + lo[i][q][e] : hi[i][q][e];
        }
      }
    }
    cp_async_wait<0>();
  }

  // accumulator e of tile j: word g (e < 2) or g + 8, feature 8j + 2t + (e & 1)
  // (int8: feature 32 (j / 4) + 8t + 4 (e & 1) + j % 4)
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)grp * kGroup + (plane0 + i) * 128 + run * kRunWords + g + 8 * h;
      Acc* crow = c + row * d_pad + f0;
      if constexpr (F::kInt8) {
#pragma unroll
        for (int qd = 0; qd < kNT / 4; ++qd) {
          if (f0 + 32 * qd + 8 * t < d_pad) {
            const int j = 4 * qd;
            *reinterpret_cast<int4*>(crow + 32 * qd + 8 * t) =
                make_int4(acc[i][j][2 * h], acc[i][j + 1][2 * h], acc[i][j + 2][2 * h], acc[i][j + 3][2 * h]);
            *reinterpret_cast<int4*>(crow + 32 * qd + 8 * t + 4) = make_int4(
                acc[i][j][2 * h + 1], acc[i][j + 1][2 * h + 1], acc[i][j + 2][2 * h + 1], acc[i][j + 3][2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (j < nt_live)
            *reinterpret_cast<float2*>(crow + 8 * j + 2 * t) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

bool bad_shape(long long n_pad, int tile_r, int d_pad) {
  return n_pad <= 0 || n_pad % kGroup != 0 || tile_r <= 0 || kGroup % tile_r != 0 || d_pad <= 0 ||
         d_pad % 8 != 0;
}

template <typename T>
dim3 fwd_grid(long long n_pad, int d_pad) {
  const int n_chunks = (d_pad + Fwd<T>::kFeat - 1) / Fwd<T>::kFeat;
  return dim3((unsigned)(kRuns * n_chunks), (unsigned)(n_pad / kGroup));
}

template <typename T>
int launch_fwd(const void* tiles, const void* tile_rb, const void* g_ptr, const void* g_tiles,
               const void* pmask, const void* b, void* c, long long n_pad, int tile_r, int d_pad,
               cudaStream_t stream) {
  using Acc = typename Mode<T>::Acc;
  const int smem = kFwdStages * Fwd<T>::kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_fwd_kernel<T><<<fwd_grid<T>(n_pad, d_pad), kFwdThreads, smem, stream>>>(
      static_cast<const uint32_t*>(tiles), static_cast<const int*>(tile_rb),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_tiles), static_cast<const int*>(pmask),
      static_cast<const T*>(b), static_cast<Acc*>(c), tile_r, d_pad);
  return (int)cudaGetLastError();
}

// out: async_copy::write_geometry's, with grid x = feature chunks x
// 16-word runs and grid y = groups.
template <typename T>
int geometry_fwd(long long n_pad, int d_pad, int* out) {
  return (int)async_copy::write_geometry(block_fwd_kernel<T>, kFwdThreads, kFwdStages * Fwd<T>::kStageBytes,
                                         fwd_grid<T>(n_pad, d_pad), kFwdStages, out);
}

// The store walk of pattern_bwd.cuh over n_pad output rows.
pattern_bwd::TileArgs tile_args(const void* tiles, const void* tile_g, const void* rb_ptr, int tile_r) {
  return pattern_bwd::TileArgs{static_cast<const uint32_t*>(tiles), static_cast<const int*>(tile_g),
                               static_cast<const int*>(rb_ptr), tile_r};
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

// The forward's launch geometry for these operands, written to out[0..6]
// (see geometry_fwd). Returns a cudaError_t.
int mggcn_block_fwd_geometry(long long n_pad, int tile_r, int d_pad, int dtype, int* out) {
  if (bad_shape(n_pad, tile_r, d_pad)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return geometry_fwd<float>(n_pad, d_pad, out);
    case 1: return geometry_fwd<__nv_bfloat16>(n_pad, d_pad, out);
    case 2: return geometry_fwd<int8_t>(n_pad, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mggcn_block_bwd(const void* tiles, const void* tile_g, const void* rb_ptr, const void* b, void* c,
                    long long n_pad, int tile_r, int d_pad, int dtype, void* stream) {
  if (bad_shape(n_pad, tile_r, d_pad)) return (int)cudaErrorInvalidValue;
  const pattern_bwd::TileArgs src = tile_args(tiles, tile_g, rb_ptr, tile_r);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)pattern_bwd::launch<float>(src, b, c, n_pad, d_pad, s);
    case 1: return (int)pattern_bwd::launch<__nv_bfloat16>(src, b, c, n_pad, d_pad, s);
    case 2: return (int)pattern_bwd::launch<int8_t>(src, b, c, n_pad, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's launch geometry for these operands, written to out[0..12]
// as mggcn_pattern_bwd_geometry's (spmm_pattern.cu): one column window.
// Returns a cudaError_t.
int mggcn_block_bwd_geometry(long long n_pad, int tile_r, int d_pad, int dtype, int* out) {
  if (bad_shape(n_pad, tile_r, d_pad)) return (int)cudaErrorInvalidValue;
  const pattern_bwd::TileArgs src = tile_args(nullptr, nullptr, nullptr, tile_r);
  switch (dtype) {
    case 0: return (int)pattern_bwd::geometry<float>(src, n_pad, d_pad, out);
    case 1: return (int)pattern_bwd::geometry<__nv_bfloat16>(src, n_pad, d_pad, out);
    case 2: return (int)pattern_bwd::geometry<int8_t>(src, n_pad, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
