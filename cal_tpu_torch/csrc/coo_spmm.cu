// Coefficient SpMM kernels for Hopper (sm_90a): the weighted neighbour sum
// out[r] = sum_e coef[e] * x[s_e] over the receiver CSR (K11; per head, K19),
// the same kernel over the sender CSR for its x-gradient (K11T; K19T), the
// per-edge dot product of its coefficient gradient (K12; per head, K20), and
// the per-receiver max of per-edge value planes (K21).
//
// Replaces (cal_tpu/ops/pallas_spmm.py coo_spmm and coo_spmm_mh with their
// VJPs, and tile_scatter_max):
//   K11  _spmm_call on tiles_fwd (_coo_fwd)             -> coo_spmm_launch, heads 1, perm null
//   K11T _spmm_call on tiles_bwd (_coo_bwd, dx)         -> coo_spmm_launch, heads 1, perm given
//   K12  _sddmm_call on tiles_fwd (_coo_bwd, dcoef)     -> coo_sddmm_launch, heads 1
//   K19  _spmm_mh_call on tiles_fwd (_coo_mh_fwd)       -> coo_spmm_launch, heads > 1, perm null
//   K19T _spmm_mh_call on tiles_bwd (_coo_mh_bwd, dx)   -> coo_spmm_launch, heads > 1, perm given
//   K20  _sddmm_mh_call on tiles_fwd (_coo_mh_bwd)      -> coo_sddmm_launch, heads > 1
//   K21  tile_scatter_max (_tile_scatter_max_kernel)    -> segment_max_launch
//
// Contract (coo_spmm with a coefficient per edge and head, no loop
// manipulation; x rows hold `heads` heads of d = H / heads features, heads 1
// for K11/K11T/K12):
//   K11/K19:  out[r, h] = sum over e with r_e = r of coef[e, h] * x[s_e, h];
//   K11T/K19T: dx[s, h] = sum over e with s_e = s of coef[e, h] * g[r_e, h];
//   K12/K20:  dcoef[e, h] = <g[r_e, h], x[s_e, h]> for EVERY edge, dead ones
//             included (cal_tpu's tile plan holds every edge of the batch;
//             only its trailing [E + 1] pad entry is zeroed, which the port
//             does not have);
//   K21:      out[k, v] = max(-1e30, max over e with r_e = v of vals[k, e])
//             for K value planes in edge order, over every edge (the
//             callers set dead edges to -1e30; the kernel does not rely on it).
// Liveness is the coefficient alone: a self loop is an ordinary edge (sparse
// GIN passes coef = edge_mask; sparse GAT zeroes its dead and self-loop
// edges), and no index is ever compared.  K11/K19 skip edges whose
// coefficients are all 0 (their product is 0 for finite features), so the
// padded run at node V-1 costs one coefficient read per edge and head.
//
// Rounding: x and g are read in their stored dtype (f32 or bf16, each its
// own in K12/K20); coefficients, products and sums are f32, and outputs are
// f32 ([V, H] for K11/K19, [E, heads] for K12/K20, [K, V] for K21).  The
// wrappers in ops/coo_spmm.py round nothing; callers round a [V, H] result
// once to the model dtype.  On bf16 tile plans cal_tpu also rounds each
// product coef * x to bf16 before the receiver sum (and g to bf16 in the
// VJP): exact for GIN's 0/1 coefficients on bf16 features, not for a general
// coefficient.
//
// Design.  K11/K11T/K19/K19T are csr_rows.cuh's coefficient SpMM walk
// (csr_spmm_kernel, as K2/K3/K14 in csrc/spmm.cu) with the CooSpmm policy: a
// light row (<= 32 edges) is one lane group's item (16-byte loads, 32 / G
// rows a warp), addressed by row; the chunks of a heavier row (a hub, the
// padded run) are items from the host-built list, each writing an f32
// partial that a pass over the heavy rows alone sums in chunk order.  A
// group reads a window's coefficients and neighbours at once, a ballot lists
// the edges with a nonzero coefficient, and it loads up to kInFlight
// neighbour rows before their FMAs, each feature weighted by the coefficient
// of the head it belongs to (a lane's features lie in one head).  The padded
// run at node V-1 holds coefficient 0: its edges cost a coefficient read
// each (K11 sums whatever is nonzero) and no neighbour row.  K12/K20 give
// one warp a chunk, keep g[r] of its row in registers, walk every edge of
// the group, reduce each dot product across the 32 / heads lanes of each
// head (a neighbour equal to the previous edge's reuses its value:
// duplicates and the padded run), and write it in edge order.  K21 is
// csr_rows.cuh's per-row reduction (csr_reduce_kernel) with MaxOp over the
// receiver CSR, in one launch: a light row is one 4-lane group's item (16-
// byte loads of 4 planes at once, 8 rows a warp); a heavy row's chunks (the
// padded run's 62 included: K21 reads whatever the caller put there) are a
// warp's each, and the row's last chunk to arrive takes the max of the
// chunks' partials.  No float atomics: a result does not change between
// runs, and a max is exact in any order, so K21 equals its twin bit for bit.
//
// Bound: bytes.  K11/K19 read x [V, H] once (plus a neighbour row per live
// edge, mostly from L2), 4 + 4 * heads bytes of metadata per edge (4 more
// through perm) and write f32 [V, H]; K12/K20 read x and g [V, H] and 8
// bytes per edge and write 4 * heads bytes per edge; K21 reads 4 K bytes per
// edge and writes 4 K per node.  H FMAs per edge are far below the FMA floor.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in
// ops/coo_spmm.py allocate every output and scratch buffer and pass
// PyTorch's stream.

#include "csr_rows.cuh"

namespace {

// ---- K11 / K11T, K19 / K19T: coefficient SpMM over a CSR ---------------

// The csr_spmm_kernel policy of K11 (NH = 1) and K19: one branch, NH
// coefficients per edge, liveness and coefficients from coef alone, the f32
// row written as summed.
template <typename T, int NH>
struct CooSpmm : CsrRows {
  using Elem = T;
  static constexpr int kBranches = 1;
  static constexpr int kHeads = NH;
  static constexpr bool kMaskedDead = false;   // liveness is the coefficient
  const T* x[1];        // [V, H]: x (K11/K19) or the cotangent g (K11T/K19T)
  const float* coef;    // [E, NH], edge order
  const int* nbr;       // senders (receiver CSR) or receivers (sender CSR)
  float* out;           // [V, H]
  float* partial;       // [n_heavy_chunks, H]
  int h;

  struct Row {};

  __device__ __forceinline__ Row row(int) const { return Row{}; }

  __device__ __forceinline__ bool edge(int e, const Row&, int& s, float (&cf)[NH]) const {
    bool live = false;
#pragma unroll
    for (int hd = 0; hd < NH; ++hd) {
      cf[hd] = coef[(size_t)e * NH + hd];
      live |= cf[hd] != 0.0f;
    }
    s = nbr[e];
    return live;
  }

  template <int F>
  __device__ __forceinline__ void write_row(int r, int lane, const float (&acc)[1][F]) const {
    store_vec<float, F>(out + (size_t)r * h + lane * F, acc[0]);
  }
};

template <typename T, int NH>
cudaError_t spmm_typed(const void* x, const float* coef, const int* nbr, const CsrRows& csr,
                       int h, float* out, float* partial, cudaStream_t stream) {
  CooSpmm<T, NH> a;
  static_cast<CsrRows&>(a) = csr;
  a.x[0] = static_cast<const T*>(x);
  a.coef = coef;
  a.nbr = nbr;
  a.out = out;
  a.partial = partial;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

template <typename T>
cudaError_t spmm_heads(int heads, const void* x, const float* coef, const int* nbr,
                       const CsrRows& csr, int h, float* out, float* partial,
                       cudaStream_t stream) {
  switch (heads) {
#define CASE(NH) \
  case NH: return spmm_typed<T, NH>(x, coef, nbr, csr, h, out, partial, stream);
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// ---- K12 / K20: per-edge dot products over the receiver CSR --------------

template <typename TX, typename TG>
struct SddmmArgs {
  const TX* x;          // [V, H]
  const TG* g;          // [V, H]: the cotangent of K11's output
  const int* senders;   // receiver-sorted edge order
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* dcoef;         // [E, NH]
  int n_chunks, h;
};

template <typename TX, typename TG, int F, int NH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_sddmm_kernel(const SddmmArgs<TX, TG> a) {
  constexpr int kLanes = 32 / NH;   // lanes of one head
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
        for (int off = kLanes / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
        prev_s = s;
        prev_p = p;
      }
      if (NH == 1) {
        if (lane == j) dc = prev_p;
      } else if (lane % kLanes == 0) {
        a.dcoef[(size_t)(g0 + j) * NH + lane / kLanes] = prev_p;
      }
    }
    if (NH == 1 && i < k.end) a.dcoef[i] = dc;
  }
}

template <typename TX, typename TG, int NH>
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
    case 1: coo_sddmm_kernel<TX, TG, 1, NH><<<blocks, threads, 0, stream>>>(a); break;
    case 2: coo_sddmm_kernel<TX, TG, 2, NH><<<blocks, threads, 0, stream>>>(a); break;
    case 4: coo_sddmm_kernel<TX, TG, 4, NH><<<blocks, threads, 0, stream>>>(a); break;
    case 8: coo_sddmm_kernel<TX, TG, 8, NH><<<blocks, threads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TX, typename TG>
cudaError_t sddmm_heads(int heads, const void* x, const void* g, const int* senders,
                        const int* ptr, const int* chunk_ptr, const int* chunk_row,
                        int n_chunks, int h, float* dcoef, cudaStream_t stream) {
  switch (heads) {
#define CASE(NH)                                                                          \
  case NH:                                                                                \
    return sddmm_typed<TX, TG, NH>(x, g, senders, ptr, chunk_ptr, chunk_row, n_chunks, h, \
                                   dcoef, stream);
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t sddmm_by_g(int g_dtype, int heads, const void* x, const void* g,
                       const int* senders, const int* ptr, const int* chunk_ptr,
                       const int* chunk_row, int n_chunks, int h, float* dcoef,
                       cudaStream_t stream) {
  if (g_dtype == 0)
    return sddmm_heads<TX, float>(heads, x, g, senders, ptr, chunk_ptr, chunk_row, n_chunks, h,
                                  dcoef, stream);
  if (g_dtype == 1)
    return sddmm_heads<TX, __nv_bfloat16>(heads, x, g, senders, ptr, chunk_ptr, chunk_row,
                                          n_chunks, h, dcoef, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K11 / K11T (heads 1), K19 / K19T (heads 2, 4 or 8).  dtype of x: 0 =
// float32, 1 = bfloat16.  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows
// aligned as launch_csr_spmm says; coef [E, heads] f32.  Forward (K11/K19):
// perm null, nbr = senders, the receiver CSR.  Transposed (K11T/K19T): perm
// = the sender CSR's perm, nbr = receivers, the sender CSR, x = the
// cotangent.  The CSR is graph.EdgeCsr's (heavy_chunks and heavy_masked
// included); arrivals holds n_heavy_chunks ints, 0 before the launch and
// after it.  Writes out [V, H] f32; partial holds n_heavy_chunks * h floats.
int coo_spmm_launch(const void* x, int dtype, const float* coef, int heads, const int* nbr,
                    const int* perm, const int* ptr, const int* chunk_ptr,
                    const int* chunk_row, const int* heavy_chunks, const uint8_t* heavy_masked,
                    int n_heavy_chunks, int* arrivals, int num_nodes, int h, float* out,
                    float* partial, cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked,
                    arrivals, perm, n_heavy_chunks, num_nodes};
  if (dtype == 0) return (int)spmm_heads<float>(heads, x, coef, nbr, csr, h, out, partial, stream);
  if (dtype == 1)
    return (int)spmm_heads<__nv_bfloat16>(heads, x, coef, nbr, csr, h, out, partial, stream);
  return (int)cudaErrorInvalidValue;
}

// K12 (heads 1), K20 (heads 2, 4 or 8).  x_dtype, g_dtype: 0 = float32, 1 =
// bfloat16 (each its own).  The receiver CSR (ptr, chunk_ptr, chunk_row,
// n_chunks) over the receiver-sorted senders.  Writes dcoef [E, heads] f32 in
// edge order.
int coo_sddmm_launch(const void* x, int x_dtype, const void* g, int g_dtype, int heads,
                     const int* senders, const int* ptr, const int* chunk_ptr,
                     const int* chunk_row, int n_chunks, int h, float* dcoef,
                     cudaStream_t stream) {
  if (n_chunks <= 0 || h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return (int)sddmm_by_g<float>(g_dtype, heads, x, g, senders, ptr, chunk_ptr, chunk_row,
                                  n_chunks, h, dcoef, stream);
  if (x_dtype == 1)
    return (int)sddmm_by_g<__nv_bfloat16>(g_dtype, heads, x, g, senders, ptr, chunk_ptr,
                                          chunk_row, n_chunks, h, dcoef, stream);
  return (int)cudaErrorInvalidValue;
}

// K21.  vals [planes, E] f32 in edge order; the receiver CSR as
// coo_spmm_launch takes it (heavy_masked unread: every edge is walked).
// Writes out [planes, V] f32; partial holds n_heavy_chunks * planes floats.
int segment_max_launch(const float* vals, int num_edges, int planes, const int* ptr,
                       const int* chunk_ptr, const int* chunk_row, const int* heavy_chunks,
                       const uint8_t* heavy_masked, int n_heavy_chunks, int* arrivals,
                       int num_nodes, float* out, float* partial, cudaStream_t stream) {
  RowReduce a;
  static_cast<CsrRows&>(a) = CsrRows{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                                     heavy_masked, arrivals, nullptr, n_heavy_chunks,
                                     num_nodes};
  a.vals = vals;
  a.num_edges = num_edges;
  a.planes = planes;
  a.vec = num_edges % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  a.edge_major = false;
  a.skip_masked = false;   // K21 reads whatever the caller put there
  a.out = out;
  a.partial = partial;
  return (int)launch_csr_reduce<MaxOp>(a, stream);
}

}  // extern "C"
