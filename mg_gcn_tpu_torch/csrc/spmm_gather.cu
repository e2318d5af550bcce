// Ultra-sparse SpMM for NVIDIA Hopper (sm_90a): the serial-gather engine.
//
// Replaces the TPU kernel of mg_gcn_tpu/ops/spmm_gather.py:
//   mggcn_gather  <-  _gather_kernel (spmm_gather.py:499):
//       C[r, :] = sum_e (w_e *) B[c_e, :], float32 sums, C float32
// in its modes: weighted (float32 w) or binary (no w; the wrapper applies
// the diagonal pre/post scales), and B in float32 or, in stream mode, in
// bfloat16 widened to float32 at load (the walk stays float32). It runs the
// row walk of csr_walk.cuh (walk_kernel<float, float | bf16, HAS_W, L, NV>:
// at d_pad 48, two groups of 16 lanes split a row's entries; at d_pad >= 128
// one warp takes them in order).
// The matrix is row-sorted CSR (indptr int64, indices int32). The TPU
// kernel's pair and single entries, windows, super-tiles, accumulator banks
// and R_ROWS / W_ROWS / E_BLK / D_MAX_G worked around a serial scalar walk
// and VMEM; none of them is needed where a gather is an ordinary load.
//
// What bounds it on an H100 SXM (3.35 TB/s): the bytes each input is read
// once and the output written once. At the products shape (n = 2,449,029,
// nnz ~ 125M, d = 256, binary, float32) that is 0.50 GB of indices, 2.51 GB
// of B and 2.51 GB of C, >= 1.65 ms. A row walk reads a B row per ENTRY:
// 125M x 1 KB = 128 GB at d = 256, >= 38.2 ms at the memory rate, because
// B is 50x the 50 MB L2 and uniform columns give it no reuse: a schedule
// reuses a B row only across the rows whose sums are live at once, about
// (live rows x 51 entries) / n. With 227 KB of accumulators an SM at 1 KB a
// row, 132 x ~200 x 51 ~ 1.35M against n = 2.45M, ~0.55 reuses a row; sums
// kept in device memory instead cost a read and a write of C (5 GB) a
// column window. So on this uniform graph the walk's 43.9 ms is ~87% of the
// rate its per-entry traffic allows; a graph with locality is where a
// column-blocked schedule would pay.

#include "csr_walk.cuh"

extern "C" {

// w: float32 weights, or null for a binary matrix. b_dtype: 0 = float32,
// 1 = bfloat16 (stream mode). C is float32. Returns a cudaError_t; 0 means
// the launch was accepted.
int mggcn_gather(const void* indptr, const void* indices, const void* w, const void* b, void* c,
                 long long n_out, int d_pad, int b_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_w = w != nullptr;
  switch (b_dtype) {
    case 0:
      return has_w ? csr::launch<float, float, true>(indptr, indices, w, b, c, n_out, d_pad, s)
                   : csr::launch<float, float, false>(indptr, indices, w, b, c, n_out, d_pad, s);
    case 1:
      return has_w ? csr::launch<float, __nv_bfloat16, true>(indptr, indices, w, b, c, n_out, d_pad, s)
                   : csr::launch<float, __nv_bfloat16, false>(indptr, indices, w, b, c, n_out, d_pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of mggcn_gather for these operands over n_out output
// rows of width d_pad, written to out[0..8] (csr::geometry). Returns a
// cudaError_t.
int mggcn_gather_geometry(long long n_out, int d_pad, int weighted, int b_dtype, int* out) {
  switch (b_dtype) {
    case 0:
      return weighted ? csr::geometry<float, float, true>(n_out, d_pad, out)
                      : csr::geometry<float, float, false>(n_out, d_pad, out);
    case 1:
      return weighted ? csr::geometry<float, __nv_bfloat16, true>(n_out, d_pad, out)
                      : csr::geometry<float, __nv_bfloat16, false>(n_out, d_pad, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
