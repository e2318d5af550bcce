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
// br != bc, to take the same inputs as the JAX package. Its sequential grid carried
// the row block's sum from one column block to the next in VMEM; here one
// warp owns an output row and keeps its sums in registers across all the
// column blocks, so no sum leaves the chip before its one store.
//
// What bounds it on an H100 SXM: the slots (8 bytes each of lcol and val)
// and the gathered B rows (one 128-byte line a lane group per slot, through
// L2); the work is 2*nnz*d float32 operations. The design is the plain one:
// lanes over features (f, f+32, f+64, f+96 of a 128-feature chunk, so any d
// is taken without padding), the slot's column and value read once per warp
// (one broadcast), the next slot's index in flight.
//
// Offsets into the slots and into B/C are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // output rows (= warps) per block
constexpr int kChunkF = 128; // features per block (grid.y chunks)
constexpr int kPerLane = kChunkF / 32;

__global__ void __launch_bounds__(kRows * 32)
tiled_kernel(const int* __restrict__ lcol, const float* __restrict__ val, const int* __restrict__ nsteps,
             const float* __restrict__ b, float* __restrict__ c, long long n_rows, int n_cb, int K, int br,
             int bc, int d) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kRows + (threadIdx.x >> 5);
  if (i >= n_rows) return;
  const int rb = (int)(i / br);
  const int r = (int)(i % br);
  const int f = blockIdx.y * kChunkF + lane;
  float acc[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;

  for (int cb = 0; cb < n_cb; ++cb) {
    const int ns = __ldg(nsteps + (long long)rb * n_cb + cb);
    if (ns == 0) continue;
    const long long slot0 = ((long long)rb * n_cb + cb) * K * br + r;
    const float* bblk = b + (long long)cb * bc * d + f;
    int col = __ldg(lcol + slot0);
    float v = __ldg(val + slot0);
    for (int k = 0; k < ns; ++k) {
      const int col_k = col;
      const float v_k = v;
      if (k + 1 < ns) {
        col = __ldg(lcol + slot0 + (long long)(k + 1) * br);
        v = __ldg(val + slot0 + (long long)(k + 1) * br);
      }
      const float* brow = bblk + (long long)col_k * d;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        if (f + 32 * q < d) acc[q] += v_k * __ldg(brow + 32 * q);
    }
  }
  float* crow = c + i * d + f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    if (f + 32 * q < d) crow[32 * q] = acc[q];
}

}  // namespace

extern "C" {

// Returns a cudaError_t; 0 means the launch was accepted.
int mggcn_tiled(const void* lcol, const void* val, const void* nsteps, const void* b, void* c, int n_rb,
                int n_cb, int K, int br, int bc, int d, void* stream) {
  if (n_rb <= 0 || n_cb <= 0 || K <= 0 || br <= 0 || bc <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)n_rb * br;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)((d + kChunkF - 1) / kChunkF));
  tiled_kernel<<<grid, kRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lcol), static_cast<const float*>(val), static_cast<const int*>(nsteps),
      static_cast<const float*>(b), static_cast<float*>(c), n_rows, n_cb, K, br, bc, d);
  return (int)cudaGetLastError();
}

const char* mggcn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
