// GAT's edge softmax for NVIDIA Hopper (sm_90a): one head's attention
// weights from its score vectors, and their gradient, as fused row walks.
//
// For entry e = (r, c) of a row-sorted CSR matrix (indptr int64, indices
// int32) and the head's score vectors e_dst (n_out) and e_src (n_in), already
// rounded to the graph's dtype T (float32 or bfloat16):
//
//   p_e = e_dst[r] + e_src[c]                          the LeakyReLU's input
//   s_e = (p_e > 0 ? p_e : slope * p_e) (+ bias_e)     the score
//
// and the two-pass row softmax of ops/edge_attention.slot_softmax, with its
// rounding points (r(x): x rounded to T, as the composite's products round
// their operands; sums float32):
//
//   smax   = max_e s_e (0 where not finite)            mggcn_softmax_fwd, walk 1
//   rs1    = sum_e r(exp(clamp(s_e - smax, -80, 0)))   walk 2, per row
//   shift  = r(smax + log(max(rs1, 1e-30)))
//   rowsum = sum_e r(exp(s_e - shift))
//   slot   = r(log(max(rowsum, 1e-30)))
//   alpha  = exp(s_e - shift - slot)
//
// Walk 2 keeps shift, slot and rowsum per row (stats, 3 x n_out float32),
// the only state the backward needs besides its inputs. The backward walk
// (mggcn_softmax_bwd) takes the cotangent dalpha, recomputes s, e = exp(s -
// shift) and alpha with the same operations, and gives what autograd gives
// the composite (sddmm -> leaky_relu -> + bias -> slot_softmax):
//
//   g_t      = dalpha * alpha
//   g_log_rs = sum_e r(-g_t)
//   g_rowsum = rowsum >= 1e-30 ? g_log_rs / rowsum : 0
//   g_s      = g_t + r(g_rowsum) * e
//   g_pre    = p > 0 ? g_s : slope * g_s               written as r(g_pre), type T
//   de_dst   = sum_e r(g_pre)
//
// de_src, the column sums of r(g_pre), is the transposed product's (edge_t).
// Each product and each add is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into a fused multiply-add the composite does not make); exp
// and log are the accurate expf and logf.
//
// Geometry: the CSR walk's (csr_walk.cuh) at one value an entry: a warp a
// row, lane l taking the row's entries l, l + 32, l + 64, ... in order, its
// sums in a register, the 32 lanes' sums met by a fixed __shfl_xor_sync
// tree (every lane ends with the same bits). Walk 2 makes three passes over
// its row (rs1, rowsum, alpha) and the backward two; a lane scores its first
// kCache entries once, all their loads in flight together, and keeps them in
// registers for the later passes (entries past them are scored again). The
// global max: walk 1 runs a fixed grid of warps over the rows, each block's
// max taken by a shared-memory tree and folded into one 32-bit key by
// atomicMax on an order-preserving encoding (a max is exact in any order,
// so two launches give the same bits); walk 2 decodes it. No value is read
// back to the host, so a captured step captures the three walks. There is
// no atomic sum: every sum has one order.
//
// What bounds them on an H100 SXM (3.35 TB/s): the index list read once a
// walk, the per-entry weights written once and read once, the per-entry
// bias read where there is one. At the GAT cell's 114.96M entries, bf16, no
// bias: walk 1 0.46 GB (>= 0.137 ms), walk 2 0.46 GB of indices and 0.46 GB
// of float32 alpha (>= 0.275 ms), the backward 0.46 GB of indices, 0.46 GB of
// dalpha and 0.23 GB of bf16 g_pre (>= 0.343 ms). e_dst and e_src (0.47 MB
// each in bf16) stay in L2, but each entry's e_src read is an L2 sector of
// its own on a graph without locality: one such gather an entry a walk is
// this layout's floor (walk 1 alone, which does little else, takes 0.76 ms
// there, 5.6x its bytes bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>


namespace edge_softmax {

constexpr int kWarps = 8;          // rows (= warps) a block
constexpr int kMaxBlocks = 2048;   // walk 1's grid, at most: its warps loop over the rows
// Entries a lane keeps in registers between the passes of walk 2 and of the backward: a row
// of up to 32 kCache entries reads its indices and gathers e_src once (Reddit's uniform rows
// hold 493 on average, 601 at most); the entries past them are scored again in each pass.
constexpr int kCache = 16;
static_assert(kCache <= 32, "the backward keeps its cached entries' signs in one 32-bit mask");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// r(x): x rounded to T (to nearest even), as float32.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// torch.clamp's: NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// The 32 lanes' sums, every lane's the same: lanes l and l ^ 1 first, then pairs of pairs.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Entry e's score; *pre gets the LeakyReLU's input.
template <typename T>
__device__ __forceinline__ float score(float ed, const T* __restrict__ e_src, const int* __restrict__ indices,
                                       const float* __restrict__ bias, long long e, float slope, float* pre) {
  const float p = __fadd_rn(ed, widen(e_src[__ldg(indices + e)]));
  float s = p > 0.f ? p : __fmul_rn(slope, p);
  if (bias != nullptr) s = __fadd_rn(s, __ldg(bias + e));
  *pre = p;
  return s;
}

// An order-preserving 32-bit key of a float (NaN excluded): larger float,
// larger key. Key 0 (the memset's) decodes to a NaN: no entry.
__device__ __forceinline__ unsigned max_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The larger of a running max and a score; a NaN score counts as +inf: the
// composite's max is then NaN, and either way not finite, so 0.
__device__ __forceinline__ float max_with(float m, float s) {
  return s != s ? __uint_as_float(kInfBits) : fmaxf(m, s);
}

// Walk 1: the largest score into *key.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
max_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices, const T* __restrict__ e_dst,
           const T* __restrict__ e_src, const float* __restrict__ bias, float slope, long long n_out,
           unsigned* __restrict__ key) {
  __shared__ float warp_max[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = -__uint_as_float(kInfBits), pre;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n_out; r += (long long)gridDim.x * kWarps) {
    const float ed = widen(e_dst[r]);
    const long long e0 = indptr[r] + lane, e1 = indptr[r + 1];
    float s[kCache];
#pragma unroll
    for (int k = 0; k < kCache; ++k)  // every score's loads in flight at once
      if (e0 + 32LL * k < e1) s[k] = score(ed, e_src, indices, bias, e0 + 32LL * k, slope, &pre);
#pragma unroll
    for (int k = 0; k < kCache; ++k)
      if (e0 + 32LL * k < e1) m = max_with(m, s[k]);
#pragma unroll 4
    for (long long e = e0 + 32LL * kCache; e < e1; e += 32)
      m = max_with(m, score(ed, e_src, indices, bias, e, slope, &pre));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(key, max_key(m));
  }
}

// Walk 2: rs1, shift, rowsum, slot and alpha of row r; stats = (shift, slot, rowsum) x n_out.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices, const T* __restrict__ e_dst,
           const T* __restrict__ e_src, const float* __restrict__ bias, float slope, long long n_out,
           const unsigned* __restrict__ key, float* __restrict__ alpha, float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_out) return;  // warp-uniform
  float smax = from_key(*key);
  if (!isfinite(smax)) smax = 0.f;
  const float ed = widen(e_dst[r]);
  const long long e0 = indptr[r] + lane, e1 = indptr[r + 1], past = e0 + 32LL * kCache;
  float s[kCache], pre, acc = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k)  // every score's loads in flight at once
    if (e0 + 32LL * k < e1) s[k] = score(ed, e_src, indices, bias, e0 + 32LL * k, slope, &pre);
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (e0 + 32LL * k < e1) acc += round_to<T>(expf(clamp(s[k] - smax, -80.f, 0.f)));
#pragma unroll 4
  for (long long e = past; e < e1; e += 32)
    acc += round_to<T>(expf(clamp(score(ed, e_src, indices, bias, e, slope, &pre) - smax, -80.f, 0.f)));
  const float rs1 = warp_sum(acc);
  const float shift = round_to<T>(smax + logf(clamp_lo(rs1, 1e-30f)));
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (e0 + 32LL * k < e1) acc += round_to<T>(expf(s[k] - shift));
#pragma unroll 4
  for (long long e = past; e < e1; e += 32)
    acc += round_to<T>(expf(score(ed, e_src, indices, bias, e, slope, &pre) - shift));
  const float rowsum = warp_sum(acc);
  const float slot = round_to<T>(logf(clamp_lo(rowsum, 1e-30f)));
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (e0 + 32LL * k < e1) alpha[e0 + 32LL * k] = expf((s[k] - shift) - slot);
#pragma unroll 4
  for (long long e = past; e < e1; e += 32)
    alpha[e] = expf((score(ed, e_src, indices, bias, e, slope, &pre) - shift) - slot);
  if (lane == 0) {
    stats[r] = shift;
    stats[n_out + r] = slot;
    stats[2 * n_out + r] = rowsum;
  }
}

// The backward of entry e: its g_t = dalpha * alpha, with u = s - shift and whether the
// LeakyReLU's input is positive.
template <typename T>
__device__ __forceinline__ float grad_t(float ed, const T* __restrict__ e_src, const int* __restrict__ indices,
                                        const float* __restrict__ bias, const float* __restrict__ dalpha, long long e,
                                        float slope, float shift, float slot, float* u, bool* pos) {
  float pre;
  *u = score(ed, e_src, indices, bias, e, slope, &pre) - shift;
  *pos = pre > 0.f;
  return __fmul_rn(__ldg(dalpha + e), expf(*u - slot));
}

// r(g_pre) of entry e from its g_t, u and sign, and r(g_rowsum).
template <typename T>
__device__ __forceinline__ float grad_pre(float g_t, float u, bool pos, float g_rowsum, float slope) {
  const float g_s = __fadd_rn(g_t, __fmul_rn(g_rowsum, expf(u)));
  return round_to<T>(pos ? g_s : __fmul_rn(slope, g_s));
}

// The backward walk of row r: r(g_pre) an entry and de_dst[r]. At most 80 registers a
// thread (3 blocks an SM): uncapped, the bfloat16 walk took 110 and ran no faster, and the
// float32 one 1.5x slower.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 3)
bwd_kernel(const long long* __restrict__ indptr, const int* __restrict__ indices, const T* __restrict__ e_dst,
           const T* __restrict__ e_src, const float* __restrict__ bias, float slope, long long n_out,
           const float* __restrict__ stats, const float* __restrict__ dalpha, float* __restrict__ de_dst,
           T* __restrict__ g_pre) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_out) return;  // warp-uniform
  const float shift = stats[r], slot = stats[n_out + r], rowsum = stats[2 * n_out + r];
  const float ed = widen(e_dst[r]);
  const long long e0 = indptr[r] + lane, e1 = indptr[r + 1], past = e0 + 32LL * kCache;
  float u[kCache], g_t[kCache], uk, acc = 0.f;
  unsigned pos = 0;  // bit k: entry k's LeakyReLU input is positive
  bool pk;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    if (e0 + 32LL * k < e1) {
      g_t[k] = grad_t(ed, e_src, indices, bias, dalpha, e0 + 32LL * k, slope, shift, slot, &u[k], &pk);
      pos |= (unsigned)pk << k;
    }
  }
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (e0 + 32LL * k < e1) acc += round_to<T>(-g_t[k]);
#pragma unroll 4
  for (long long e = past; e < e1; e += 32)
    acc += round_to<T>(-grad_t(ed, e_src, indices, bias, dalpha, e, slope, shift, slot, &uk, &pk));
  const float g_log_rs = warp_sum(acc);
  const float g_rowsum = round_to<T>(rowsum >= 1e-30f ? __fdiv_rn(g_log_rs, rowsum) : 0.f);
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    if (e0 + 32LL * k < e1) {
      const float g = grad_pre<T>(g_t[k], u[k], (pos >> k) & 1u, g_rowsum, slope);
      store(g_pre + e0 + 32LL * k, g);
      acc += g;
    }
  }
#pragma unroll 4
  for (long long e = past; e < e1; e += 32) {
    const float g_te = grad_t(ed, e_src, indices, bias, dalpha, e, slope, shift, slot, &uk, &pk);
    const float g = grad_pre<T>(g_te, uk, pk, g_rowsum, slope);
    store(g_pre + e, g);
    acc += g;
  }
  const float de = warp_sum(acc);
  if (lane == 0) de_dst[r] = de;
}

inline dim3 row_grid(long long n_out) { return dim3((unsigned)((n_out + kWarps - 1) / kWarps)); }

inline bool bad_shape(long long n_out) { return n_out <= 0 || n_out > (long long)kWarps * 0x7fffffffLL; }

template <typename T>
int fwd(const void* indptr, const void* indices, const void* e_dst, const void* e_src, const void* bias,
        void* key, void* alpha, void* stats, long long n_out, float slope, cudaStream_t stream) {
  if (bad_shape(n_out)) return (int)cudaErrorInvalidValue;
  const auto* ip = static_cast<const long long*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* ed = static_cast<const T*>(e_dst);
  const auto* es = static_cast<const T*>(e_src);
  const auto* bs = static_cast<const float*>(bias);
  auto* k = static_cast<unsigned*>(key);
  cudaError_t err = cudaMemsetAsync(k, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = row_grid(n_out).x;
  max_kernel<T><<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kWarps * 32, 0, stream>>>(ip, ix, ed, es, bs, slope,
                                                                                       n_out, k);
  fwd_kernel<T><<<row_grid(n_out), kWarps * 32, 0, stream>>>(ip, ix, ed, es, bs, slope, n_out, k,
                                                             static_cast<float*>(alpha), static_cast<float*>(stats));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* indptr, const void* indices, const void* e_dst, const void* e_src, const void* bias,
        const void* stats, const void* dalpha, void* de_dst, void* g_pre, long long n_out, float slope,
        cudaStream_t stream) {
  if (bad_shape(n_out)) return (int)cudaErrorInvalidValue;
  bwd_kernel<T><<<row_grid(n_out), kWarps * 32, 0, stream>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(indices), static_cast<const T*>(e_dst),
      static_cast<const T*>(e_src), static_cast<const float*>(bias), slope, n_out, static_cast<const float*>(stats),
      static_cast<const float*>(dalpha), static_cast<float*>(de_dst), static_cast<T*>(g_pre));
  return (int)cudaGetLastError();
}

}  // namespace edge_softmax

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (e_dst, e_src and g_pre alike); bias is
// float32 or null; key is 4 bytes of scratch on the device. Returns a
// cudaError_t; 0 means the launches were accepted.
int mggcn_softmax_fwd(const void* indptr, const void* indices, const void* e_dst, const void* e_src,
                      const void* bias, void* key, void* alpha, void* stats, long long n_out, float slope,
                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return edge_softmax::fwd<float>(indptr, indices, e_dst, e_src, bias, key, alpha, stats, n_out, slope, s);
    case 1:
      return edge_softmax::fwd<__nv_bfloat16>(indptr, indices, e_dst, e_src, bias, key, alpha, stats, n_out, slope,
                                              s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mggcn_softmax_bwd(const void* indptr, const void* indices, const void* e_dst, const void* e_src,
                      const void* bias, const void* stats, const void* dalpha, void* de_dst, void* g_pre,
                      long long n_out, float slope, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return edge_softmax::bwd<float>(indptr, indices, e_dst, e_src, bias, stats, dalpha, de_dst, g_pre, n_out,
                                      slope, s);
    case 1:
      return edge_softmax::bwd<__nv_bfloat16>(indptr, indices, e_dst, e_src, bias, stats, dalpha, de_dst, g_pre,
                                              n_out, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mggcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
