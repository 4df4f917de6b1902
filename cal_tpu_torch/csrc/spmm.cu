// Sparse-layout GCN kernels for Hopper (sm_90a): the sender degree of both
// masked branches (K1), the GCN SpMM with its coefficient chain built
// in-kernel, in a pair form for the two masked causal convs (K2) and a plain
// form for the backbone convs (K3), each also in a transposed mode for its
// dx (K2T, K3T), and the two backward passes of the pair's degree chain: the
// SDDMM chain head (K5) and its tail (K6).
//
// Replaces (cal_tpu/ops/pallas_spmm.py):
//   K1  _pair_stats_call (_pair_stats_kernel)            -> sender_degree_launch
//   K2  _pair_coef_spmm_call (_pair_coef_spmm_kernel)    -> coef_spmm_launch, branches 2
//   K3  _plain_coef_spmm_call (_plain_coef_spmm_kernel)  -> coef_spmm_launch, branches 1
//   K2T _pair_coef_spmm_call on tiles_bwd (_pair_bwd)    -> coef_spmm_launch, perm given
//   K3T _plain_coef_spmm_call on tiles_bwd (_plain_bwd)  -> coef_spmm_launch, perm given
//   K5  _pair_sddmm_chain_call (_pair_sddmm_chain_kernel) -> pair_sddmm_chain_launch
//   K6  _pair_dpre_call (_pair_dpre_kernel)              -> pair_dpre_launch
//
// Contract (gcn_aggregate_sparse_sigmoid_pair_pallas and
// gcn_aggregate_sparse_plain_pallas with their VJPs, i.e. cal_tpu/ops/gcn.py
// gcn_aggregate_sparse): an edge e = (s -> r) is live when edge_mask[e] and
// s != r (self loops are dropped; liveness never comes from an index).
//   K1: deg[0][v] = sum over live e with s_e = v of sigmoid(src[v] + dst[r_e]),
//       deg[1][v] = the same sum of 1 - sigmoid; null src/dst mean logits 0
//       (sigmoid(0) = 0.5 exactly: the plain conv's degree is 2 deg[0]).
//   K2: for branch k (w_0 = sigmoid, w_1 = 1 - sigmoid),
//       out_k[r] = sum over live e with r_e = r of
//                  dis_k[s] * w_k * dis_k[r] * x_k[s]  +  x_k[r] / deg_k[r];
//   K3: the same with one branch and w = 1.
//   K2T/K3T (perm given): the same sums over the SENDER CSR, rows s and
//       neighbours r: dx_k[s] = sum over live e with s_e = s of
//       dis_k[r] * w_k * dis_k[s] * g_k[r]  +  g_k[s] / deg_k[s], i.e. the
//       VJP of K2/K3 in x.  The kernel computes sigmoid(src[nbr] + dst[row]),
//       so the caller passes the logits swapped (as cal_tpu does on its
//       transposed plan): the argument stays src[s] + dst[r].
//   K5: per live e, dc_k = <g_k[r], x_k[s]>;
//       vec[e] = (dc_0 dis_0[s] dis_0[r], dc_1 dis_1[s] dis_1[r], w_0 w_1)
//       (zeros on dead edges); ddis_s[k][s] += dc_k w_k dis_k[r] and
//       ddis_r[k][r] += dc_k w_k dis_k[s].
//   K6: dpre[e] = (vec0 + ddeg_0[s] - vec1 - ddeg_1[s]) * vec2;
//       dsrc[s] += dpre[e], ddst[r] += dpre[e] (vec2 = 0 zeroes dead edges).
//   deg / dis [branches, V] f32 are deg + 1 and its rsqrt, and ddeg [2, V]
//   the degree gradient, from the caller (the elementwise step between K5
//   and K6 is plain PyTorch, as it is plain XLA in cal_tpu).
//
// Rounding: x, g and the logits are stored in the model dtype (f32 or
// bf16); everything else is f32: the sigmoid, the coefficient (dis_nbr * w)
// * dis_row, each message, dot product and every sum, the self term x / deg
// (IEEE division); each [V, H] output is rounded to the model dtype once
// (K5/K6 outputs stay f32).  The plain twins in ops/spmm.py round at exactly
// these points.  cal_tpu's bf16 tile plans round more (the gathered logit
// and dis planes, the per-slot weights, each message before the receiver
// sum): the port does not.
//
// Design.  Rows (senders for K1, K2T, K3T; receivers for K2, K3, K5, K6)
// come in CSR form (graph.EdgeCsr; the sender CSR reads edge perm[i]): a
// row's edges form groups of kGroup = 32 and the groups at most kMaxChunks =
// 64 chunks of equal group counts.  One warp owns one chunk and walks its
// groups: the lanes read a group's 32 edges' metadata at once (lane i <->
// edge i) and compute liveness, weight and coefficient; K1 and K6 keep
// per-lane sums and end with a butterfly shuffle; K2/K3 (csr_rows.cuh's
// csr_spmm_kernel with the GcnSpmm policy) take the group's live edges from
// a ballot and, for each in turn, broadcast its neighbour and coefficient
// while every lane accumulates H / 32 features of each branch (8- or
// 16-byte loads of the neighbour's row).  K5 keeps g[r] of
// its row in registers, takes each live edge from the ballot, reduces the
// dot products with x[s] across the warp, and the edge's own lane then
// forms its per-edge outputs.  A row of a single chunk is written by its
// warp directly (K2/K3 with the self term fused); a longer row (a hub, or
// the padded-edge run at node V-1, in both CSRs) writes one f32 partial per
// chunk, and a second pass sums its <= 64 partials in chunk order.  Sums by
// sender that K5 and K6 need from their receiver walk (ddis_s, dsrc) are
// taken by a second kernel over the sender CSR (sender_sum_kernel) from
// per-edge f32 columns that the first one wrote: K1's structure, per-lane
// sums and a butterfly.  So no row is serialized on one warp, every sum has
// one owner, no float atomics: a result does not change between runs.
//
// Bound: bytes.  K2 reads x [V, 2H] once (plus a neighbour row per live
// edge, mostly from L2) and writes [V, 2H]; the metadata is 9 bytes per edge
// (13 through perm); K5 reads x and g [V, 2H] and writes 5 f32 per edge; the
// arithmetic (2H FMAs per edge) is far below the tensor-core or FMA floor.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in ops/spmm.py
// allocate every output and scratch buffer and pass PyTorch's stream.

#include "csr_rows.cuh"

namespace {

// ---- K1: sender degree of both branches --------------------------------

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sender_degree_kernel(const T* __restrict__ src, const T* __restrict__ dst,
                     const int* __restrict__ receivers,
                     const uint8_t* __restrict__ edge_mask,
                     const int* __restrict__ perm, const int* __restrict__ ptr,
                     const int* __restrict__ chunk_ptr,
                     const int* __restrict__ chunk_row, int n_chunks, int num_nodes,
                     float* __restrict__ deg, float* __restrict__ partial) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const Chunk k = chunk_of(c, ptr, chunk_ptr, chunk_row);
  const int v = k.row;
  const float sv = src == nullptr ? 0.0f : to_f(src[v]);
  float w[2] = {0.0f, 0.0f};
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int e = perm[i];
    const int r = receivers[e];
    if (edge_mask[e] && r != v) {
      const float sg = sigmoid_f(src == nullptr ? 0.0f : sv + to_f(dst[r]));
      w[0] += sg;
      w[1] += 1.0f - sg;
    }
  }
  finish_row<2>(w, k, c, lane, num_nodes, deg, partial);
}

// ---- K2 / K3: coefficient SpMM over the receiver CSR (K2T / K3T: sender) --

// The csr_spmm_kernel policy of K2 (NB = 2) and K3 (NB = 1): liveness from
// the mask and s != r, the coefficient chain built per edge, the self term
// added when the row is written.
template <typename T, int NB>
struct GcnSpmm {
  using Elem = T;
  static constexpr int kBranches = NB;
  const T* x[NB];
  T* out[NB];
  const T* src;       // transposed mode: the forward's dst
  const T* dst;       // transposed mode: the forward's src
  const int* nbr;     // senders (receiver CSR) or receivers (sender CSR)
  const int* perm;    // null: edge i of the CSR is edge i; else edge perm[i]
  const uint8_t* edge_mask;
  const float* deg;   // [NB, V]
  const float* dis;   // [NB, V]
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* partial;     // [n_chunks, NB, H]
  int n_chunks, num_nodes, h;

  struct Row {
    int r;
    float dis_r[NB], dst_r;
  };

  __device__ __forceinline__ Row row(int r) const {
    Row w;
    w.r = r;
#pragma unroll
    for (int b = 0; b < NB; ++b) w.dis_r[b] = dis[(size_t)b * num_nodes + r];
    w.dst_r = 0.0f;
    if constexpr (NB == 2) w.dst_r = to_f(dst[r]);
    return w;
  }

  __device__ __forceinline__ bool edge(int e, const Row& w, int& s, float (&cf)[NB]) const {
    s = nbr[e];
    if (!edge_mask[e] || s == w.r) return false;
    if constexpr (NB == 2) {
      const float sg = sigmoid_f(to_f(src[s]) + w.dst_r);
      cf[0] = (dis[s] * sg) * w.dis_r[0];
      cf[1] = (dis[(size_t)num_nodes + s] * (1.0f - sg)) * w.dis_r[1];
    } else {
      cf[0] = dis[s] * w.dis_r[0];
    }
    return true;
  }

  // out_b[r] = acc_b + x_b[r] / deg_b[r], rounded once to T.
  template <int F>
  __device__ __forceinline__ void write_row(int r, int lane, const float (&acc)[NB][F]) const {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const size_t off = (size_t)r * h + lane * F;
      float xs[F];
      load_vec<T, F>(x[b] + off, xs);
      const float d = deg[(size_t)b * num_nodes + r];
      float o[F];
#pragma unroll
      for (int f = 0; f < F; ++f) o[f] = acc[b][f] + xs[f] / d;
      store_vec<T, F>(out[b] + off, o);
    }
  }
};

template <typename T, int NB>
cudaError_t launch_spmm(const void* x0, const void* x1, const void* src, const void* dst,
                        const int* nbr, const int* perm, const uint8_t* edge_mask,
                        const float* deg, const float* dis, const int* ptr,
                        const int* chunk_ptr, const int* chunk_row, int n_chunks,
                        int num_nodes, int h, void* out0, void* out1, float* partial,
                        cudaStream_t stream) {
  GcnSpmm<T, NB> a;
  a.x[0] = static_cast<const T*>(x0);
  a.out[0] = static_cast<T*>(out0);
  if constexpr (NB == 2) {
    a.x[1] = static_cast<const T*>(x1);
    a.out[1] = static_cast<T*>(out1);
  }
  a.src = static_cast<const T*>(src);
  a.dst = static_cast<const T*>(dst);
  a.nbr = nbr;
  a.perm = perm;
  a.edge_mask = edge_mask;
  a.deg = deg;
  a.dis = dis;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.partial = partial;
  a.n_chunks = n_chunks;
  a.num_nodes = num_nodes;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

// ---- K5: the SDDMM chain head of the pair VJP ----------------------------

template <typename T>
struct ChainArgs {
  const T* x[2];      // xc, xo [V, H]
  const T* g[2];      // gc, go [V, H]: the cotangents of (out_c, out_o)
  const T* src;
  const T* dst;
  const int* senders;
  const uint8_t* edge_mask;
  const float* dis;   // [2, V]
  const int* ptr;     // receiver CSR
  const int* chunk_ptr;
  const int* chunk_row;
  float* edge_out;    // [5, E]: vec0, vec1, vec2, then the two ddis_s terms
  float* ddis_r;      // [2, V]
  float* partial;     // [n_chunks, 2]
  int n_chunks, num_nodes, num_edges, h;
};

template <typename T, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pair_sddmm_chain_kernel(const ChainArgs<T> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int r = k.row;
  const size_t V = a.num_nodes, E = a.num_edges;
  const float dis_r[2] = {a.dis[r], a.dis[V + r]};
  const float dst_r = to_f(a.dst[r]);
  float gr[2][F];
#pragma unroll
  for (int b = 0; b < 2; ++b) load_vec<T, F>(a.g[b] + (size_t)r * a.h + lane * F, gr[b]);
  float acc[2] = {0.0f, 0.0f};            // this lane's ddis_r terms
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    const int i = g0 + lane;
    int s_l = 0;
    bool live = false;
    if (i < k.end) {
      s_l = a.senders[i];
      live = a.edge_mask[i] && s_l != r;
    }
    // the dot products of each live edge of the group, reduced across the
    // warp; the edge's own lane keeps them
    float dc[2] = {0.0f, 0.0f};
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int s = __shfl_sync(kFull, s_l, j);
      float p[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float xs[F];
        load_vec<T, F>(a.x[b] + (size_t)s * a.h + lane * F, xs);
        p[b] = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) p[b] = fmaf(gr[b][f], xs[f], p[b]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        p[0] += __shfl_xor_sync(kFull, p[0], off);
        p[1] += __shfl_xor_sync(kFull, p[1], off);
      }
      if (lane == j) {
        dc[0] = p[0];
        dc[1] = p[1];
      }
    }
    if (i < k.end) {
      float out[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (live) {
        const float sg = sigmoid_f(to_f(a.src[s_l]) + dst_r);
        const float w[2] = {sg, 1.0f - sg};
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float dis_s = a.dis[b * V + s_l];
          out[b] = dc[b] * dis_s * dis_r[b];
          out[3 + b] = dc[b] * w[b] * dis_r[b];
          acc[b] += dc[b] * w[b] * dis_s;
        }
        out[2] = w[0] * w[1];
      }
#pragma unroll
      for (int j = 0; j < 5; ++j) a.edge_out[j * E + i] = out[j];
    }
  }
  finish_row<2>(acc, k, c, lane, a.num_nodes, a.ddis_r, a.partial);
}

template <typename T, int F>
cudaError_t launch_chain(const ChainArgs<T>& a, cudaStream_t stream) {
  pair_sddmm_chain_kernel<T, F><<<(a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                                  kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chain(int f, const ChainArgs<T>& a, cudaStream_t stream) {
  switch (f) {
    case 1: return launch_chain<T, 1>(a, stream);
    case 2: return launch_chain<T, 2>(a, stream);
    case 4: return launch_chain<T, 4>(a, stream);
    case 8: return launch_chain<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t chain_typed(const void* xc, const void* xo, const void* gc, const void* go,
                        const void* src, const void* dst, const int* senders,
                        const uint8_t* edge_mask, const float* dis, const int* ptr,
                        const int* chunk_ptr, const int* chunk_row, int n_chunks,
                        int num_nodes, int num_edges, int h, float* edge_out, float* ddis_r,
                        float* partial, cudaStream_t stream) {
  ChainArgs<T> a;
  a.x[0] = static_cast<const T*>(xc);
  a.x[1] = static_cast<const T*>(xo);
  a.g[0] = static_cast<const T*>(gc);
  a.g[1] = static_cast<const T*>(go);
  a.src = static_cast<const T*>(src);
  a.dst = static_cast<const T*>(dst);
  a.senders = senders;
  a.edge_mask = edge_mask;
  a.dis = dis;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.edge_out = edge_out;
  a.ddis_r = ddis_r;
  a.partial = partial;
  a.n_chunks = n_chunks;
  a.num_nodes = num_nodes;
  a.num_edges = num_edges;
  a.h = h;
  return dispatch_chain<T>(h / 32, a, stream);
}

// ---- K6: the chain tail (dpre and its receiver sum) ----------------------

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pair_dpre_kernel(const float* __restrict__ vec, const float* __restrict__ ddeg,
                 const int* __restrict__ senders, const int* __restrict__ ptr,
                 const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
                 int n_chunks, int num_nodes, int num_edges, float* __restrict__ dpre,
                 float* __restrict__ ddst, float* __restrict__ partial) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const Chunk k = chunk_of(c, ptr, chunk_ptr, chunk_row);
  const size_t V = num_nodes, E = num_edges;
  float acc[1] = {0.0f};
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int s = senders[i];
    // vec2 = w_c w_o is 0 on dead edges and self loops: their dpre is 0
    const float d = (vec[i] + ddeg[s] - vec[E + i] - ddeg[V + s]) * vec[2 * E + i];
    dpre[i] = d;
    acc[0] += d;
  }
  finish_row<1>(acc, k, c, lane, num_nodes, ddst, partial);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (src and dst; may both be null).
int sender_degree_launch(const void* src, const void* dst, int dtype, const int* receivers,
                         const uint8_t* edge_mask, const int* perm, const int* ptr,
                         const int* chunk_ptr, const int* chunk_row, int n_chunks,
                         int num_nodes, float* deg, float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = kWarpsPerBlock * 32;
  if (dtype == 1) {
    sender_degree_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(dst),
        receivers, edge_mask, perm, ptr, chunk_ptr, chunk_row, n_chunks, num_nodes, deg,
        partial);
  } else if (dtype == 0) {
    sender_degree_kernel<float><<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(src), static_cast<const float*>(dst), receivers,
        edge_mask, perm, ptr, chunk_ptr, chunk_row, n_chunks, num_nodes, deg, partial);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine<2>(chunk_ptr, num_nodes, partial, deg, stream);
}

// branches: 2 (pair: x0 = xc, x1 = xo, logits src/dst) or 1 (plain: x0,
// src/dst unused).  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned
// to h / 32 elements.  Forward (K2/K3): perm null, nbr = senders, the
// receiver CSR.  Transposed (K2T/K3T): perm = the sender CSR's perm, nbr =
// receivers, the sender CSR, and the logits swapped (src <- dst, dst <- src).
int coef_spmm_launch(int branches, const void* x0, const void* x1, const void* src,
                     const void* dst, int dtype, const int* nbr, const int* perm,
                     const uint8_t* edge_mask, const float* deg, const float* dis,
                     const int* ptr, const int* chunk_ptr, const int* chunk_row,
                     int n_chunks, int num_nodes, int h, void* out0, void* out1,
                     float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0 || h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && branches == 2)
    return (int)launch_spmm<__nv_bfloat16, 2>(x0, x1, src, dst, nbr, perm, edge_mask, deg, dis,
                                              ptr, chunk_ptr, chunk_row, n_chunks, num_nodes,
                                              h, out0, out1, partial, stream);
  if (dtype == 1 && branches == 1)
    return (int)launch_spmm<__nv_bfloat16, 1>(x0, x1, src, dst, nbr, perm, edge_mask, deg, dis,
                                              ptr, chunk_ptr, chunk_row, n_chunks, num_nodes,
                                              h, out0, out1, partial, stream);
  if (dtype == 0 && branches == 2)
    return (int)launch_spmm<float, 2>(x0, x1, src, dst, nbr, perm, edge_mask, deg, dis, ptr,
                                      chunk_ptr, chunk_row, n_chunks, num_nodes, h, out0, out1,
                                      partial, stream);
  if (dtype == 0 && branches == 1)
    return (int)launch_spmm<float, 1>(x0, x1, src, dst, nbr, perm, edge_mask, deg, dis, ptr,
                                      chunk_ptr, chunk_row, n_chunks, num_nodes, h, out0, out1,
                                      partial, stream);
  return (int)cudaErrorInvalidValue;
}

// K5.  dtype: 0 = float32, 1 = bfloat16 (xc, xo, gc, go, src, dst).  The
// receiver CSR (ptr, chunk_ptr, chunk_row, r_chunks) for the per-edge pass,
// the sender CSR (sptr, schunk_ptr, schunk_row, sperm, s_chunks) for the
// ddis_s sums.  Writes edge_out [5, E] (vec = rows 0-2; rows 3-4 are the
// per-edge ddis_s terms), ddis_s and ddis_r [2, V]; partial holds
// 2 * max(r_chunks, s_chunks) floats.
int pair_sddmm_chain_launch(const void* xc, const void* xo, const void* gc, const void* go,
                            const void* src, const void* dst, int dtype, const int* senders,
                            const uint8_t* edge_mask, const float* dis, const int* ptr,
                            const int* chunk_ptr, const int* chunk_row, int r_chunks,
                            const int* sptr, const int* schunk_ptr, const int* schunk_row,
                            const int* sperm, int s_chunks, int num_nodes, int num_edges, int h,
                            float* edge_out, float* ddis_s, float* ddis_r, float* partial,
                            cudaStream_t stream) {
  if (r_chunks <= 0 || s_chunks <= 0 || num_nodes <= 0 || num_edges <= 0 || h <= 0 || h % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1)
    err = chain_typed<__nv_bfloat16>(xc, xo, gc, go, src, dst, senders, edge_mask, dis, ptr,
                                     chunk_ptr, chunk_row, r_chunks, num_nodes, num_edges, h,
                                     edge_out, ddis_r, partial, stream);
  else if (dtype == 0)
    err = chain_typed<float>(xc, xo, gc, go, src, dst, senders, edge_mask, dis, ptr, chunk_ptr,
                             chunk_row, r_chunks, num_nodes, num_edges, h, edge_out, ddis_r,
                             partial, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  err = launch_combine<2>(chunk_ptr, num_nodes, partial, ddis_r, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sender_sum<2>(edge_out + 3 * (size_t)num_edges, num_edges, sperm, sptr,
                                   schunk_ptr, schunk_row, s_chunks, num_nodes, ddis_s,
                                   partial, stream);
}

// K6.  vec [3, E] (K5's edge_out rows 0-2), ddeg [2, V] f32; CSRs as K5.
// Writes dpre [E] (scratch), dsrc and ddst [V]; partial holds
// max(r_chunks, s_chunks) floats.
int pair_dpre_launch(const float* vec, const float* ddeg, const int* senders, const int* ptr,
                     const int* chunk_ptr, const int* chunk_row, int r_chunks, const int* sptr,
                     const int* schunk_ptr, const int* schunk_row, const int* sperm,
                     int s_chunks, int num_nodes, int num_edges, float* dpre, float* dsrc,
                     float* ddst, float* partial, cudaStream_t stream) {
  if (r_chunks <= 0 || s_chunks <= 0 || num_nodes <= 0 || num_edges <= 0)
    return (int)cudaErrorInvalidValue;
  pair_dpre_kernel<<<(r_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, 0,
                     stream>>>(vec, ddeg, senders, ptr, chunk_ptr, chunk_row, r_chunks,
                               num_nodes, num_edges, dpre, ddst, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_combine<1>(chunk_ptr, num_nodes, partial, ddst, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sender_sum<1>(dpre, num_edges, sperm, sptr, schunk_ptr, schunk_row,
                                   s_chunks, num_nodes, dsrc, partial, stream);
}

}  // extern "C"
