// Host-side graph preprocessing for mg_gcn_tpu_torch (loaded by native.py).
//
// The port's copy of the JAX package's csrc/mggcn_host.cpp, cut to what the
// port calls: the CSR row expansion, degree normalization, transpose and
// the communication volume of a row partition (the reference's TBB host
// ops, matrix.hpp:340-424, prep.py:232-272), OpenMP-parallel behind a plain
// C ABI. The TPU slot-layout builders (edge/gather sort and fill) have no
// counterpart: the port builds no slots.
//
// Every result is element-equal to the numpy path of sparse.py, which it
// replaces:
// - normalize(axis=0) rounds each row's float64 sum to float32 and divides
//   in float32 (numpy's data / row_sum[rows]); normalize(axis=1) sums each
//   column in float64 in edge order (np.bincount's order) and divides in
//   float64, rounding the quotient to float32;
// - transpose is a stable counting sort (np.argsort(kind="stable")): rows
//   are cut into one contiguous chunk per worker, each chunk counts its
//   columns, and each chunk's slots in a column follow the earlier
//   chunks', so a column's entries keep their source order.
//
// Conventions: indptr is int64, indices int32, data float32; every output
// is caller-allocated.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

int max_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // namespace

extern "C" {

// rows[e] = row id of edge e (CSR indptr expansion).
void mggcn_expand_rows(int64_t n, const int64_t* indptr, int32_t* rows) {
#pragma omp parallel for schedule(static)
  for (int64_t v = 0; v < n; ++v) {
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) rows[e] = (int32_t)v;
  }
}

// Degree-normalize edge weights.
// axis == 0: each row sums to 1 (row-stochastic).
// axis == 1: each column sums to 1 (divide by weighted in-degree), the GCN
//            normalization (reference matrix.hpp:351-364).
// colsum_scratch must hold m doubles when axis == 1 (unused otherwise).
void mggcn_normalize(int64_t n, int64_t m, const int64_t* indptr,
                     const int32_t* indices, const float* data_in,
                     float* data_out, int axis, double* colsum_scratch) {
  if (axis == 0) {
#pragma omp parallel for schedule(dynamic, 1024)
    for (int64_t v = 0; v < n; ++v) {
      double sum = 0;
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) sum += data_in[e];
      const float s = (float)sum;
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e)
        data_out[e] = data_in[e] / s;
    }
    return;
  }
  const int64_t nnz = indptr[n];
  std::memset(colsum_scratch, 0, sizeof(double) * (size_t)m);
  // one pass in edge order: the float64 sums are np.bincount's bit for bit
  for (int64_t e = 0; e < nnz; ++e) colsum_scratch[indices[e]] += (double)data_in[e];
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < nnz; ++e)
    data_out[e] = (float)((double)data_in[e] / colsum_scratch[indices[e]]);
}

// CSR transpose by a stable parallel counting sort (see the header). A
// chunk's per-column counts, then its first slots, are int32 offsets from
// the column's start (a column holds fewer than 2^31 entries); the chunks
// are as many as the workers while their tables stay within 1 GiB.
void mggcn_transpose(int64_t n, int64_t m, int64_t nnz, const int64_t* indptr,
                     const int32_t* indices, const float* data,
                     int64_t* t_indptr, int32_t* t_indices, float* t_data) {
  (void)nnz;
  const int64_t fit = std::max<int64_t>(1, (int64_t{1} << 30) / (4 * std::max<int64_t>(m, 1)));
  const int64_t chunks = std::max<int64_t>(1, std::min<int64_t>({(int64_t)max_threads(), fit, n}));
  std::vector<int32_t> cnt((size_t)(chunks * m), 0);
  auto row0 = [&](int64_t k) { return n * k / chunks; };
#pragma omp parallel for schedule(static, 1)
  for (int64_t k = 0; k < chunks; ++k) {
    int32_t* mine = cnt.data() + k * m;
    for (int64_t e = indptr[row0(k)]; e < indptr[row0(k + 1)]; ++e) ++mine[indices[e]];
  }
  t_indptr[0] = 0;
  for (int64_t c = 0; c < m; ++c) {
    int32_t at = 0;
    for (int64_t k = 0; k < chunks; ++k) {
      const int32_t here = cnt[(size_t)(k * m + c)];
      cnt[(size_t)(k * m + c)] = at;
      at += here;
    }
    t_indptr[c + 1] = t_indptr[c] + at;
  }
#pragma omp parallel for schedule(static, 1)
  for (int64_t k = 0; k < chunks; ++k) {
    int32_t* slot = cnt.data() + k * m;
    for (int64_t v = row0(k); v < row0(k + 1); ++v) {
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        const int32_t c = indices[e];
        const int64_t at = t_indptr[c] + slot[c]++;
        t_indices[at] = (int32_t)v;
        t_data[at] = data[e];
      }
    }
  }
}

// P x P communication-volume matrix for a 1-D partition (prep.py:232-272):
// vol[i*P + j] = number of distinct columns in partition j referenced by
// rows of partition i. `marks` must hold P*m bytes (caller-zeroed).
void mggcn_comm_volume(int64_t n, int64_t P, const int64_t* part,
                       const int64_t* indptr, const int32_t* indices,
                       uint8_t* marks, int64_t m, int64_t* vol) {
  (void)n;
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i = 0; i < P; ++i) {
    uint8_t* mark = marks + i * m;
    for (int64_t v = part[i]; v < part[i + 1]; ++v) {
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) mark[indices[e]] = 1;
    }
    for (int64_t j = 0; j < P; ++j) {
      int64_t cnt = 0;
      for (int64_t c = part[j]; c < part[j + 1]; ++c) cnt += mark[c];
      vol[i * P + j] = cnt;
    }
  }
}

int mggcn_num_threads(void) { return max_threads(); }

}  // extern "C"
