// Weighted-CSR SpMM for NVIDIA Hopper (sm_90a): the edge engine.
//
// Replaces three TPU kernels of mg_gcn_tpu/ops/spmm_edges.py:
//   mggcn_edge     <-  _edge_kernel    (spmm_edges.py:550):
//       C[r, :] = sum_e f32(w_e) * f32(B[c_e, :]), float32 sums, C float32;
//       w and B both float32 or both bfloat16
//   mggcn_edge_i8  <-  _edge_kernel_i8 (spmm_edges.py:604):
//       acc[r, :] = sum_e wq_e * bq[c_e, :], int32 sums (exact), acc int32
//   mggcn_edge_t   <-  _edge_t_kernel  (spmm_edges.py:980):
//       C[c, :] = sum_{e in column c} f32(w_e) * f32(A[r_e, :]), i.e. M^T(w) A,
//       float32 sums, C float32 (n_in, d_pad); w and A as for mggcn_edge
// All run the row walk of csr_walk.cuh (walk_kernel<T, T, true, L, NV, PERM>:
// a warp a row, in G = 32 / L groups of L lanes that split the row's
// entries, L following d_pad). The matrix is row-sorted CSR (indptr int64,
// indices int32, one weight per entry, duplicates merged at build). The TPU
// kernels' slot chunks, one-hot MXU selects, step schedule and D_MAX_E
// chunking routed a gather through the MXU and fit SMEM/VMEM; here a
// gather is an ordinary load, so each entry's B row is read directly.
//
// What bounds them on an H100 SXM (3.35 TB/s): the bytes each input is read
// once and the output written once. At the weighted-Reddit shape (n =
// 232,968, nnz = 114,964,049, d = 128, bf16) that is 0.46 GB of indices,
// 0.23 GB of weights, 60 MB of B and 119 MB of C, >= 0.26 ms; the 2*nnz*d
// operations are far below any peak. A row walk reads B once per ENTRY, not
// once: nnz * d * 2 bytes = 29 GB at d = 128, which only the 50 MB L2 can
// turn into less device-memory traffic. On the GAT path (the same graph,
// bf16) the bytes bound mggcn_edge at every width it runs: indices +
// weights 0.69 GB, >= 0.207 ms at d_pad 8, where B is 3.7 MB and lives in
// L2; 0.224 / 0.233 ms at d_pad 48 / 64 (B 22 / 30 MB). There the groups
// keep every lane busy: at d_pad 8, 16 groups of 2 lanes take 16 entries
// at once where one warp took one.
//
// mggcn_edge_t walks the matrix's CSR transpose (t_indptr int64 over the
// n_in columns, t_rows int32) with PERM: the weight of transposed entry j
// is w[perm[j]], read through the int32 permutation, so the backward pass
// of the attention ops transposes per-edge values (scores' cotangents,
// attention weights) without writing a permuted copy. The TPU kernel's
// column-window-sorted step schedule (TSched, dummy zero-init steps, split
// parts) accumulated output windows across sequential grid steps; here
// each output row is one warp's walk, and a column with no entries writes
// zeros. Its bytes bound adds 4 bytes of perm per entry to mggcn_edge's: at
// the GAT shape (nnz = 114,964,049, d_pad 8 bf16) 0.46 GB indices + 0.46 GB
// perm + 0.23 GB w + 3.7 MB A + 7.5 MB C, >= 0.35 ms. But the weights are
// read in permuted (scattered) order, one 32-byte sector for each 2-byte
// weight: 3.7 GB, >= 1.1 ms at the memory rate, the floor for this layout
// (a permuted copy of the weights would move it, at a write of the copy
// each time the weights change).

#include "csr_walk.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (w and B alike); C is float32. Returns
// a cudaError_t; 0 means the launch was accepted.
int mggcn_edge(const void* indptr, const void* indices, const void* w, const void* b, void* c,
               long long n_out, int d_pad, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return csr::launch<float, float, true>(indptr, indices, w, b, c, n_out, d_pad, s);
    case 1:
      return csr::launch<__nv_bfloat16, __nv_bfloat16, true>(indptr, indices, w, b, c, n_out, d_pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 weights and B; C is int32.
int mggcn_edge_i8(const void* indptr, const void* indices, const void* wq, const void* bq,
                  void* c, long long n_out, int d_pad, void* stream) {
  return csr::launch<int8_t, int8_t, true>(indptr, indices, wq, bq, c, n_out, d_pad,
                                           static_cast<cudaStream_t>(stream));
}

// The transposed product: (t_indptr, t_rows) is the CSR transpose of the
// matrix whose weights are w, perm[j] the matrix entry of transposed entry
// j; A (n_out, d_pad) and C (n_in, d_pad). dtype as mggcn_edge.
int mggcn_edge_t(const void* t_indptr, const void* t_rows, const void* perm, const void* w,
                 const void* a, void* c, long long n_in, int d_pad, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return csr::launch<float, float, true, true>(t_indptr, t_rows, w, a, c, n_in, d_pad, s, perm);
    case 1:
      return csr::launch<__nv_bfloat16, __nv_bfloat16, true, true>(t_indptr, t_rows, w, a, c, n_in, d_pad, s,
                                                                   perm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry of the walk for kernel 0 = mggcn_edge, 1 =
// mggcn_edge_i8, 2 = mggcn_edge_t (dtype as theirs; ignored for 1) over
// n_out output rows of width d_pad, written to out[0..8] (csr::geometry).
// Returns a cudaError_t.
int mggcn_edge_geometry(long long n_out, int d_pad, int kernel, int dtype, int* out) {
  using bf16 = __nv_bfloat16;
  if (kernel == 1) return csr::geometry<int8_t, int8_t, true>(n_out, d_pad, out);
  if ((kernel != 0 && kernel != 2) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (kernel == 2)
    return dtype == 0 ? csr::geometry<float, float, true, true>(n_out, d_pad, out)
                      : csr::geometry<bf16, bf16, true, true>(n_out, d_pad, out);
  return dtype == 0 ? csr::geometry<float, float, true>(n_out, d_pad, out)
                    : csr::geometry<bf16, bf16, true>(n_out, d_pad, out);
}

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
