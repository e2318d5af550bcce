// Tiled-ELL SpMM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mg_gcn_tpu/ops/spmm_pallas.py:_spmm_kernel
// (spmm_pallas.py:161):
//   C[rb*br + r] = sum over cb < n_cb and k < nsteps[rb, cb] of
//                  val[rb, cb, k, r] * B[cb*bc + lcol[rb, cb, k, r]]
// over the TiledMat store: lcol int32 and val float32 (n_rb, n_cb, K, br),
// slot-major, padded slots carrying val 0 and lcol 0; nsteps int32
// (n_rb, n_cb). B is float32 row-major (n_cb*bc, d), padded by the wrapper
// (ops/spmm_pallas.py); C is float32 (n_rb*br, d), summed in float32.
//
// The TPU kernel's square-tile requirement (br == bc) worked around Mosaic's
// vector gather and is not needed here; TiledMat.from_csr still refuses
// br != bc, to take the same inputs as the JAX package. Its sequential grid
// carried the row block's sum from one column block to the next in VMEM;
// here each thread keeps its row's sums in registers across all the column
// blocks, so no sum leaves the chip before its one store.
//
// What bounds it on an H100 SXM: bytes. The slots a row block uses (8 bytes
// each) and B, C once each; the work is 2*nnz*d float32 operations. What the
// design must keep cheap besides: the gathers of B rows (one per entry) and
// the slot walk, three quarters of whose slots are padding on a random
// graph (ELL K is the most entries any (tile, row) pair holds).
//
// The design, for those limits:
// - Threads over a row block's rows. A block owns up to 512 rows of one row
//   block and a 16-feature chunk; thread r reads its slots lcol/val[rb, cb,
//   k, r], so a warp reads 128 contiguous bytes a slot (the layout the
//   slot-major store was built for), and keeps 16 sums in registers. The
//   slots stream in batches of four, each batch loaded while the one before
//   it is added, a unit's first batch before the barrier that opens it.
// - nsteps[rb, cb] is uniform over the block: it is read once a column block
//   (a broadcast load), and a column block with no slot is skipped whole,
//   its B rows never copied.
// - Padding slots skipped. A slot whose val is 0 adds nothing and is not
//   gathered: for finite B this gives the same sums as the plain version and
//   the TPU kernel, which multiply padding by B.
// - The column block's B rows staged in shared memory: the block copies
//   B[cb*bc + i, chunk] for i < bc (up to 512 rows a stage; a larger bc is
//   walked in sub-slabs of 512, each slot added in the sub-slab that holds
//   its column) with cp.async into a ring of 3 stages while it adds the
//   previous column block, so every gather is a shared-memory read. One
//   __syncthreads a stage, not full/empty mbarriers: every thread copies a
//   share of each stage and any thread may read any of its rows, so a stage
//   is full, and free again, only for the whole block at once.
// - Banks: a stage row is 64 bytes (16 floats), two rows a 128-byte line,
//   and the line's eight 16-byte chunks are XOR-swizzled by the line index,
//   so the 8 lanes of a quarter-warp reading 16 B of 8 random rows spread
//   over all eight bank groups instead of two.
//
// Sum order, fixed: each C[i, f] is one thread's register, summed in
// (column block, sub-slab, slot) order. Two launches give the same bits.
//
// Offsets into the slots and into B/C are 64-bit.

#include "async_copy.cuh"

namespace {

using async_copy::cp_async_ca;
using async_copy::cp_async_cg16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;
using async_copy::smem_u32;

constexpr int kMaxThreads = 512;  // rows a block
constexpr int kF = 16;            // features a thread (a block's chunk)
constexpr int kSlabRows = 512;    // B rows a stage
constexpr int kStages = 3;        // stages in the ring
constexpr int kMinBlocks = 2;     // resident blocks an SM at 512 threads

// Byte offset of row i's 16-byte chunk q (features 4q..4q+3) in a stage.
__device__ __forceinline__ int slab_off(int i, int q) {
  return ((i >> 1) << 7) | (((((i & 1) << 2) | q) ^ ((i >> 1) & 7)) << 4);
}

int stage_bytes(int bc) {
  const int rows = bc < kSlabRows ? bc : kSlabRows;
  return ((rows + 1) >> 1) * 128;
}

struct Walk {
  const int* ns_row;  // nsteps[rb, :]
  int n_cb, n_sub, sub_rows;

  // The first unit (column block * n_sub + sub-slab) at or after u whose
  // column block has a slot; n_cb * n_sub when there is none.
  __device__ __forceinline__ int advance(int u) const {
    if (u % n_sub) return u;
    int cb = u / n_sub;
    while (cb < n_cb && __ldg(ns_row + cb) == 0) ++cb;
    return cb * n_sub;
  }
};

// The block copies unit u's B rows x its feature chunk into ``stage``
// (zero-filled past d): 16-byte copies when rows are 16-byte aligned,
// 4-byte copies otherwise.
__device__ __forceinline__ void fill_slab(unsigned char* stage, const float* __restrict__ b, const Walk& w, int u,
                                           int bc, int d, int f0, bool vec) {
  const int cb = u / w.n_sub, lo = (u % w.n_sub) * w.sub_rows;
  const int rows = min(w.sub_rows, bc - lo);
  const float* src0 = b + ((long long)cb * bc + lo) * d + f0;
  const uint32_t dst0 = smem_u32(stage);
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * 4; idx += blockDim.x) {
      const int i = idx >> 2, q = idx & 3;
      const bool in = f0 + 4 * q < d;
      const float* src = in ? src0 + (long long)i * d + 4 * q : b;
      cp_async_cg16(dst0 + slab_off(i, q), src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kF; idx += blockDim.x) {
      const int i = idx >> 4, e = idx & 15;
      const bool in = f0 + e < d;
      const float* src = in ? src0 + (long long)i * d + e : b;
      cp_async_ca<4>(dst0 + slab_off(i, e >> 2) + 4 * (e & 3), src, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
tiled_kernel(const int* __restrict__ lcol, const float* __restrict__ val, const int* __restrict__ nsteps,
             const float* __restrict__ b, float* __restrict__ c, int n_cb, int K, int br, int bc, int d,
             int row_chunks, int vec) {
  extern __shared__ __align__(128) unsigned char slab[];
  const int rb = blockIdx.x / row_chunks;
  const int r = (blockIdx.x % row_chunks) * blockDim.x + threadIdx.x;
  const bool active = r < br;
  const int f0 = blockIdx.y * kF;
  const int sub_rows = bc < kSlabRows ? bc : kSlabRows;
  const Walk w{nsteps + (long long)rb * n_cb, n_cb, (bc + sub_rows - 1) / sub_rows, sub_rows};
  const int sbytes = ((sub_rows + 1) >> 1) * 128;
  const int end = n_cb * w.n_sub;

  float acc[kF];
#pragma unroll
  for (int e = 0; e < kF; ++e) acc[e] = 0.f;

  int u_fill = w.advance(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (u_fill < end) {
      fill_slab(slab + s * sbytes, b, w, u_fill, bc, d, f0, vec);
      u_fill = w.advance(u_fill + 1);
    } else {
      cp_async_commit();
    }
  }
  // The slots stream in batches of 4, one batch ahead of the adds: a unit's
  // first batch is loaded during the previous unit's last, before the barrier.
  int pcol[4];
  float pv[4];
  const long long slots_rb = (long long)rb * n_cb * K * br + r;
  auto load_batch = [&](int u, int k0) {
    const int cb = u / w.n_sub, ns = __ldg(w.ns_row + cb);
    const long long slot0 = slots_rb + (long long)cb * K * br;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = k0 + q < ns;
      pcol[q] = ok ? __ldg(lcol + slot0 + (long long)(k0 + q) * br) : 0;
      pv[q] = ok ? __ldg(val + slot0 + (long long)(k0 + q) * br) : 0.f;
    }
  };
  int stage = 0;
  int u = w.advance(0);
  if (active && u < end) load_batch(u, 0);
  for (; u < end; u = w.advance(u + 1)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // unit u landed for every thread; the stage refilled below is released
    const int refill = (stage + kStages - 1) % kStages;
    if (u_fill < end) {
      fill_slab(slab + refill * sbytes, b, w, u_fill, bc, d, f0, vec);
      u_fill = w.advance(u_fill + 1);
    } else {
      cp_async_commit();
    }
    if (active) {
      const int cb = u / w.n_sub, lo = (u % w.n_sub) * sub_rows;
      const unsigned rows = (unsigned)min(sub_rows, bc - lo);
      const int ns = __ldg(w.ns_row + cb);
      const unsigned char* st = slab + stage * sbytes;
      for (int k0 = 0; k0 < ns; k0 += 4) {
        int col[4];
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) col[q] = pcol[q], v[q] = pv[q];
        if (k0 + 4 < ns) {
          load_batch(u, k0 + 4);
        } else {
          const int next = w.advance(u + 1);
          if (next < end) load_batch(next, 0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = col[q] - lo;
          if (v[q] != 0.f && (unsigned)i < rows) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const float4 x = *reinterpret_cast<const float4*>(st + slab_off(i, h));
              acc[4 * h] += v[q] * x.x;
              acc[4 * h + 1] += v[q] * x.y;
              acc[4 * h + 2] += v[q] * x.z;
              acc[4 * h + 3] += v[q] * x.w;
            }
          }
        }
      }
    }
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
  if (!active) return;
  float* crow = c + ((long long)rb * br + r) * d + f0;
  if (vec) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (f0 + 4 * h < d)
        *reinterpret_cast<float4*>(crow + 4 * h) = make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2],
                                                               acc[4 * h + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kF; ++e)
      if (f0 + e < d) crow[e] = acc[e];
  }
}

struct Plan {
  dim3 grid;
  int threads, row_chunks, smem;
};

Plan plan(int n_rb, int br, int bc, int d) {
  Plan p;
  p.threads = br < kMaxThreads ? (br + 31) / 32 * 32 : kMaxThreads;
  p.row_chunks = (br + p.threads - 1) / p.threads;
  p.grid = dim3((unsigned)(n_rb * p.row_chunks), (unsigned)((d + kF - 1) / kF));
  p.smem = kStages * stage_bytes(bc);
  return p;
}

bool bad_shape(int n_rb, int n_cb, int K, int br, int bc, int d) {
  return n_rb <= 0 || n_cb <= 0 || K <= 0 || br <= 0 || bc <= 0 || d <= 0 ||
         (long long)n_rb * ((br + kMaxThreads - 1) / kMaxThreads) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.
int mggcn_tiled(const void* lcol, const void* val, const void* nsteps, const void* b, void* c, int n_rb,
                int n_cb, int K, int br, int bc, int d, void* stream) {
  if (bad_shape(n_rb, n_cb, K, br, bc, d)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n_rb, br, bc, d);
  cudaError_t err = cudaFuncSetAttribute(tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  tiled_kernel<<<p.grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lcol), static_cast<const float*>(val), static_cast<const int*>(nsteps),
      static_cast<const float*>(b), static_cast<float*>(c), n_cb, K, br, bc, d, p.row_chunks, vec);
  return (int)cudaGetLastError();
}

// The launch geometry for these operands, written to out[0..6]: grid x,
// grid y, threads, dynamic shared memory, stages, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and resident blocks on
// the card. Returns a cudaError_t.
int mggcn_tiled_geometry(int n_rb, int n_cb, int K, int br, int bc, int d, int* out) {
  if (bad_shape(n_rb, n_cb, K, br, bc, d)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n_rb, br, bc, d);
  return (int)async_copy::write_geometry(tiled_kernel, p.threads, p.smem, p.grid, kStages, out);
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
