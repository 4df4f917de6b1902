// Coefficient SpMM kernels for Hopper (sm_90a): the weighted neighbour sum
// out[r] = sum_e coef[e] * x[s_e] over the receiver CSR (K11), the same
// kernel over the sender CSR for its x-gradient (K11T), and the per-edge
// dot product of its coefficient gradient (K12).
//
// Replaces (cal_tpu/ops/pallas_spmm.py coo_spmm and its VJP):
//   K11  _spmm_call on tiles_fwd (_coo_fwd)             -> coo_spmm_launch, perm null
//   K11T _spmm_call on tiles_bwd (_coo_bwd, dx)         -> coo_spmm_launch, perm given
//   K12  _sddmm_call on tiles_fwd (_coo_bwd, dcoef)     -> coo_sddmm_launch
//
// Contract (coo_spmm with a coefficient per edge, no loop manipulation):
//   K11:  out[r]  = sum over e with r_e = r of coef[e] * x[s_e];
//   K11T: dx[s]   = sum over e with s_e = s of coef[e] * g[r_e];
//   K12:  dcoef[e] = <g[r_e], x[s_e]> for EVERY edge, dead ones included
//         (cal_tpu's tile plan holds every edge of the batch; only its
//         trailing [E + 1] pad entry is zeroed, which the port does not have).
// Liveness is the coefficient alone: a self loop is an ordinary edge (sparse
// GIN passes coef = edge_mask), and no index is ever compared.  K11/K11T
// skip edges of coefficient 0 (their product is 0 for finite features), so
// the padded run at node V-1 costs one coefficient read per edge.
//
// Rounding: x and g are read in their stored dtype (f32 or bf16, each its
// own in K12); coefficients, products and sums are f32, and outputs are f32
// ([V, H] for K11/K11T, [E] for K12).  The wrappers in ops/coo_spmm.py round
// nothing; callers round a [V, H] result once to the model dtype.  On bf16
// tile plans cal_tpu also rounds each product coef * x to bf16 before the
// receiver sum (and g to bf16 in the VJP): exact for GIN's 0/1 coefficients
// on bf16 features, not for a general coefficient.
//
// Design.  K11/K11T are the CSR walk of csrc/spmm.cu K2/K3, csr_rows.cuh's
// csr_spmm_kernel (rows in groups of 32 edges, at most 64 chunks a row, one
// warp a chunk), with the CooSpmm policy: the lanes read a group's 32
// coefficients and neighbours at once, a ballot lists the edges of nonzero
// coefficient, and for each in turn every lane accumulates H / 32 features
// of the neighbour's row (8- or 16-byte loads).  A row of one chunk is
// written by its warp; a longer row (a hub, the padded run) writes one f32
// partial per chunk and a combine pass sums its <= 64 partials in chunk
// order.  K12 keeps g[r] of its row in registers, walks every edge of the
// group, reduces each dot product across the warp (a neighbour equal to the
// previous edge's reuses its value: duplicates and the padded run), and the
// edge's own lane writes it in edge order.  No float atomics: a result does
// not change between runs.
//
// Bound: bytes.  K11 reads x [V, H] once (plus a neighbour row per live
// edge, mostly from L2), 8 bytes of metadata per edge (12 through perm) and
// writes f32 [V, H]; K12 reads x and g [V, H] and 8 bytes per edge and
// writes 4 bytes per edge; H FMAs per edge are far below the FMA floor.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in
// ops/coo_spmm.py allocate every output and scratch buffer and pass
// PyTorch's stream.

#include "csr_rows.cuh"

namespace {

// ---- K11 / K11T: coefficient SpMM over a CSR ---------------------------

// The csr_spmm_kernel policy of K11: one branch, liveness and coefficient
// from coef alone, the f32 row written as summed.
template <typename T>
struct CooSpmm {
  using Elem = T;
  static constexpr int kBranches = 1;
  const T* x[1];        // [V, H]: x (K11) or the cotangent g (K11T)
  const float* coef;    // [E], edge order
  const int* nbr;       // senders (receiver CSR) or receivers (sender CSR)
  const int* perm;      // null: edge i of the CSR is edge i; else edge perm[i]
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* out;           // [V, H]
  float* partial;       // [n_chunks, H]
  int n_chunks, num_nodes, h;

  struct Row {};

  __device__ __forceinline__ Row row(int) const { return Row{}; }

  __device__ __forceinline__ bool edge(int e, const Row&, int& s, float (&cf)[1]) const {
    cf[0] = coef[e];
    if (cf[0] == 0.0f) return false;
    s = nbr[e];
    return true;
  }

  template <int F>
  __device__ __forceinline__ void write_row(int r, int lane, const float (&acc)[1][F]) const {
    store_vec<float, F>(out + (size_t)r * h + lane * F, acc[0]);
  }
};

template <typename T>
cudaError_t spmm_typed(const void* x, const float* coef, const int* nbr, const int* perm,
                       const int* ptr, const int* chunk_ptr, const int* chunk_row,
                       int n_chunks, int num_nodes, int h, float* out, float* partial,
                       cudaStream_t stream) {
  CooSpmm<T> a;
  a.x[0] = static_cast<const T*>(x);
  a.coef = coef;
  a.nbr = nbr;
  a.perm = perm;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.out = out;
  a.partial = partial;
  a.n_chunks = n_chunks;
  a.num_nodes = num_nodes;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

// ---- K12: per-edge dot products over the receiver CSR -------------------

template <typename TX, typename TG>
struct SddmmArgs {
  const TX* x;          // [V, H]
  const TG* g;          // [V, H]: the cotangent of K11's output
  const int* senders;   // receiver-sorted edge order
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* dcoef;         // [E]
  int n_chunks, h;
};

template <typename TX, typename TG, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_sddmm_kernel(const SddmmArgs<TX, TG> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  if (k.beg >= k.end) return;
  float gr[F];
  load_vec<TG, F>(a.g + (size_t)k.row * a.h + lane * F, gr);
  int prev_s = -1;
  float prev_p = 0.0f;
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    const int i = g0 + lane;
    const int s_l = i < k.end ? a.senders[i] : 0;
    const int n = min(kGroup, k.end - g0);
    float dc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, s_l, j);   // warp-uniform
      if (s != prev_s) {
        float xs[F];
        load_vec<TX, F>(a.x + (size_t)s * a.h + lane * F, xs);
        float p = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) p = fmaf(gr[f], xs[f], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
        prev_s = s;
        prev_p = p;
      }
      if (lane == j) dc = prev_p;
    }
    if (i < k.end) a.dcoef[i] = dc;
  }
}

template <typename TX, typename TG>
cudaError_t sddmm_typed(const void* x, const void* g, const int* senders, const int* ptr,
                        const int* chunk_ptr, const int* chunk_row, int n_chunks, int h,
                        float* dcoef, cudaStream_t stream) {
  SddmmArgs<TX, TG> a;
  a.x = static_cast<const TX*>(x);
  a.g = static_cast<const TG*>(g);
  a.senders = senders;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.dcoef = dcoef;
  a.n_chunks = n_chunks;
  a.h = h;
  const int blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = kWarpsPerBlock * 32;
  switch (h / 32) {
    case 1: coo_sddmm_kernel<TX, TG, 1><<<blocks, threads, 0, stream>>>(a); break;
    case 2: coo_sddmm_kernel<TX, TG, 2><<<blocks, threads, 0, stream>>>(a); break;
    case 4: coo_sddmm_kernel<TX, TG, 4><<<blocks, threads, 0, stream>>>(a); break;
    case 8: coo_sddmm_kernel<TX, TG, 8><<<blocks, threads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t sddmm_by_g(int g_dtype, const void* x, const void* g, const int* senders,
                       const int* ptr, const int* chunk_ptr, const int* chunk_row,
                       int n_chunks, int h, float* dcoef, cudaStream_t stream) {
  if (g_dtype == 0)
    return sddmm_typed<TX, float>(x, g, senders, ptr, chunk_ptr, chunk_row, n_chunks, h,
                                  dcoef, stream);
  if (g_dtype == 1)
    return sddmm_typed<TX, __nv_bfloat16>(x, g, senders, ptr, chunk_ptr, chunk_row, n_chunks,
                                          h, dcoef, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K11 / K11T.  dtype of x: 0 = float32, 1 = bfloat16.  h % 32 == 0 and
// h / 32 in {1, 2, 4, 8}; x rows aligned to h / 32 elements.  Forward (K11):
// perm null, nbr = senders, the receiver CSR.  Transposed (K11T): perm = the
// sender CSR's perm, nbr = receivers, the sender CSR, x = the cotangent.
// Writes out [V, H] f32; partial holds n_chunks * h floats.
int coo_spmm_launch(const void* x, int dtype, const float* coef, const int* nbr,
                    const int* perm, const int* ptr, const int* chunk_ptr,
                    const int* chunk_row, int n_chunks, int num_nodes, int h, float* out,
                    float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0 || h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)spmm_typed<float>(x, coef, nbr, perm, ptr, chunk_ptr, chunk_row, n_chunks,
                                  num_nodes, h, out, partial, stream);
  if (dtype == 1)
    return (int)spmm_typed<__nv_bfloat16>(x, coef, nbr, perm, ptr, chunk_ptr, chunk_row,
                                          n_chunks, num_nodes, h, out, partial, stream);
  return (int)cudaErrorInvalidValue;
}

// K12.  x_dtype, g_dtype: 0 = float32, 1 = bfloat16 (each its own).  The
// receiver CSR (ptr, chunk_ptr, chunk_row, n_chunks) over the receiver-sorted
// senders.  Writes dcoef [E] f32 in edge order.
int coo_sddmm_launch(const void* x, int x_dtype, const void* g, int g_dtype,
                     const int* senders, const int* ptr, const int* chunk_ptr,
                     const int* chunk_row, int n_chunks, int h, float* dcoef,
                     cudaStream_t stream) {
  if (n_chunks <= 0 || h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return (int)sddmm_by_g<float>(g_dtype, x, g, senders, ptr, chunk_ptr, chunk_row,
                                  n_chunks, h, dcoef, stream);
  if (x_dtype == 1)
    return (int)sddmm_by_g<__nv_bfloat16>(g_dtype, x, g, senders, ptr, chunk_ptr, chunk_row,
                                          n_chunks, h, dcoef, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
