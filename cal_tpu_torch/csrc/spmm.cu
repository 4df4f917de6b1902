// Sparse-layout GCN kernels for Hopper (sm_90a): the sender degree of both
// masked branches (K1), the GCN SpMM with its coefficient chain built
// in-kernel, in a pair form for the two masked causal convs (K2) and a plain
// form for the backbone convs (K3), each also in a transposed mode for its
// dx (K2T, K3T), and the two backward passes of the pair's degree chain: the
// SDDMM chain head (K5) and its tail (K6).  K13-K16 are the same four
// functions for ONE sigmoid-weighted branch (w = sigmoid, or 1 - sigmoid
// under ``negate``): its sender degree with deg and dis (K13), its
// coefficient SpMM (K14; K14T on the sender CSR for dx), its SDDMM chain
// head (K15) and tail (K16).  Each function is one walk templated on its
// branches: NB = 2 for the pair, NB = 1 with a compile-time NEG for the
// single branch (K13/K15/K16 are K1/K5/K6 at NB = 1, K14 is K3's
// csr_spmm_kernel policy with a sigmoid weight).
//
// Replaces (cal_tpu/ops/pallas_spmm.py):
//   K1  _pair_stats_call (_pair_stats_kernel)            -> sender_degree_launch, branches 2
//   K2  _pair_coef_spmm_call (_pair_coef_spmm_kernel)    -> coef_spmm_launch, branches 2
//   K3  _plain_coef_spmm_call (_plain_coef_spmm_kernel)  -> coef_spmm_launch, branches 1
//   K2T _pair_coef_spmm_call on tiles_bwd (_pair_bwd)    -> coef_spmm_launch, perm given
//   K3T _plain_coef_spmm_call on tiles_bwd (_plain_bwd)  -> coef_spmm_launch, perm given
//   K5  _pair_sddmm_chain_call (_pair_sddmm_chain_kernel) -> sddmm_chain_launch, branches 2
//   K6  _pair_dpre_call (_pair_dpre_kernel)              -> dpre_launch, branches 2
//   gcn_aggregate_sparse_sigmoid_pallas (_sig_fwd, _sig_bwd), whose gathers
//   and scatters in tile-slot order run through tile_gather2 (:1126) and
//   tile_scatter2 (:1990):
//   K13 tile_gather2 of the logits, tile_scatter2 of w     -> sender_degree_launch, branches 1
//   K14 _spmm_call on tiles_fwd with the slot coefficients -> sig_coef_spmm_launch
//   K14T _spmm_call on tiles_bwd (dx)                      -> sig_coef_spmm_launch, perm given
//   K15 _sddmm_call and tile_scatter2 of the ddis terms    -> sddmm_chain_launch, branches 1
//   K16 the ddeg[s] gather, dpre and tile_scatter2 of it   -> dpre_launch, branches 1
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
//   Single branch, w = sigmoid(src[s] + dst[r]), or 1 - it when negate:
//   K13: deg[v] = 1 + sum over live e with s_e = v of w, dis = deg^-1/2
//       (rsqrtf).
//   K14: out[r] = sum over live e with r_e = r of dis[s] w dis[r] x[s]
//       + x[r] / deg[r];  K14T the same over the sender CSR (dx, with the
//       logits swapped by the caller, as K2T).
//   K15: per live e, dc = <g[r], x[s]>; vec[e] = (dc dis[s] dis[r],
//       w (1 - w)) (zeros on dead edges); ddis_s[s] += dc w dis[r],
//       ddis_r[r] += dc w dis[s].
//   K16: dpre[e] = (vec0 + ddeg[s]) vec1, negated under negate (d/dz of
//       1 - sigmoid); dsrc[s] += dpre[e], ddst[r] += dpre[e].  vec1 = w(1 -
//       w) is 0 on dead edges (w = 0 there): the coefficient weights them,
//       no index compare does.
//
// Rounding: x, g and the pair's logits are stored in the model dtype (f32
// or bf16), the single branch's logits in f32 (cal_tpu's row 12 takes them
// in their own dtype and gathers them as f32; the wrappers cast); everything
// else is f32: the sigmoid, the coefficient (dis_nbr * w)
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
// 64 chunks of equal group counts.  K1, K5 and K6 give one warp a chunk: the
// lanes read a group's 32 edges' metadata at once (lane i <-> edge i) and
// compute liveness, weight and coefficient; K1 and K6 keep per-lane sums and
// end with a butterfly shuffle; K5 keeps g[r] of its row in registers,
// takes each live edge from a ballot, reduces the dot products with x[s]
// across the warp, and the edge's own lane then forms its per-edge outputs.
// A row of a single chunk is written by its warp directly; a longer row (a
// hub, or the padded-edge run at node V-1, in both CSRs) writes one f32
// partial per chunk, and a second pass sums its <= 64 partials in chunk
// order.  K2/K3/K14 (and their transposed modes) are csr_rows.cuh's
// coefficient SpMM walk with the GcnSpmm / SigSpmm policies: a light row (<=
// 32 edges, most rows of real batches) is one lane group's item (16-byte
// loads of its features, 32 / G rows a warp), addressed by row; the chunks
// of the heavier rows are items from the host-built list, whose partials a
// pass over those rows alone sums in chunk order; a group loads up to
// kInFlight neighbour rows of a window's live edges before their FMAs, and
// the self term is fused into the row's write.  The padded run's edges are
// self loops at node V-1, never live: each costs its mask and neighbour
// read, and no neighbour row.  Sums by sender that K5 and K6 need from their
// receiver walk (ddis_s, dsrc) are taken by a second kernel over the sender
// CSR (sender_sum_kernel) from per-edge f32 columns that the first one
// wrote: K1's structure, per-lane sums and a butterfly.  So no row is
// serialized on one warp, every sum has one owner, no float atomics: a
// result does not change between runs.
//
// Bound: bytes.  K2 reads x [V, 2H] once (plus a neighbour row per live
// edge, mostly from L2) and writes [V, 2H]; the metadata is 9 bytes per edge
// (13 through perm); K5 reads x and g [V, 2H] and writes 5 f32 per edge; the
// arithmetic (2H FMAs per edge) is far below the tensor-core or FMA floor.
// K13-K16 are the one-branch halves: K14 reads x [V, H] and writes [V, H],
// K15 reads x and g [V, H] and writes 3 f32 per edge.  K13 adds the deg/dis
// epilogue to K1's walk.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in ops/spmm.py
// allocate every output and scratch buffer and pass PyTorch's stream.

#include <type_traits>

#include "csr_rows.cuh"


namespace {

// The branch weights of an edge from its logit sum z: the pair's
// (sigmoid, 1 - sigmoid) when NB = 2; one branch's sigmoid, or 1 - sigmoid
// under NEG, when NB = 1.
template <int NB, bool NEG>
__device__ __forceinline__ void branch_weights(float z, float (&w)[NB]) {
  const float sg = sigmoid_f(z);
  if constexpr (NB == 2) {
    w[0] = sg;
    w[1] = 1.0f - sg;
  } else {
    w[0] = NEG ? 1.0f - sg : sg;
  }
}

// ---- K1 / K13: sender degree ---------------------------------------------

template <typename L>
struct DegreeArgs {
  const L* src;       // null with dst: logits 0
  const L* dst;
  const int* receivers;
  const uint8_t* edge_mask;
  const int* perm;    // sender CSR
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* deg;         // [NB, V]
  float* partial;     // [n_chunks, NB]
  int n_chunks, num_nodes;
};

template <typename L, int NB, bool NEG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sender_degree_kernel(const DegreeArgs<L> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int v = k.row;
  const float sv = a.src == nullptr ? 0.0f : to_f(a.src[v]);
  float acc[NB] = {};
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int e = a.perm[i];
    const int r = a.receivers[e];
    if (a.edge_mask[e] && r != v) {
      float w[NB];
      branch_weights<NB, NEG>(a.src == nullptr ? 0.0f : sv + to_f(a.dst[r]), w);
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] += w[b];
    }
  }
  finish_row<NB>(acc, k, c, lane, a.num_nodes, a.deg, a.partial);
}

// deg <- 1 + deg, dis = deg^-1/2 (K13's epilogue)
__global__ void deg_dis_kernel(int num_nodes, float* __restrict__ deg, float* __restrict__ dis) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_nodes) return;
  const float d = 1.0f + deg[v];
  deg[v] = d;
  dis[v] = rsqrtf(d);
}

template <typename L, int NB, bool NEG>
cudaError_t launch_degree(const DegreeArgs<L>& a, cudaStream_t stream) {
  sender_degree_kernel<L, NB, NEG><<<(a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                                     kWarpsPerBlock * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<NB>(a.chunk_ptr, a.num_nodes, a.partial, a.deg, stream);
}

template <typename L>
cudaError_t degree_typed(int branches, bool negate, const void* src, const void* dst,
                         const int* receivers, const uint8_t* edge_mask, const int* perm,
                         const int* ptr, const int* chunk_ptr, const int* chunk_row,
                         int n_chunks, int num_nodes, float* deg, float* partial,
                         cudaStream_t stream) {
  const DegreeArgs<L> a{static_cast<const L*>(src), static_cast<const L*>(dst), receivers,
                        edge_mask, perm, ptr, chunk_ptr, chunk_row, deg, partial, n_chunks,
                        num_nodes};
  if (branches == 2) return launch_degree<L, 2, false>(a, stream);
  if (branches == 1)
    return negate ? launch_degree<L, 1, true>(a, stream) : launch_degree<L, 1, false>(a, stream);
  return cudaErrorInvalidValue;
}

// ---- K2 / K3: coefficient SpMM over the receiver CSR (K2T / K3T: sender) --

// The csr_spmm_kernel policy of K2 (NB = 2) and K3 (NB = 1): liveness from
// the mask and s != r, the coefficient chain built per edge (for every edge
// the walk reads; a dead edge's neighbour is a node all the same), the self
// term added when the row is written.
template <typename T, int NB, typename L = T>
struct GcnSpmm : CsrRows {
  using Elem = T;
  static constexpr int kBranches = NB;
  static constexpr bool kMaskedDead = true;
  const T* x[NB];
  T* out[NB];
  const L* src;       // transposed mode: the forward's dst
  const L* dst;       // transposed mode: the forward's src
  const int* nbr;     // senders (receiver CSR) or receivers (sender CSR)
  const uint8_t* edge_mask;
  const float* deg;   // [NB, V]
  const float* dis;   // [NB, V]
  float* partial;     // [n_heavy_chunks, NB, H]
  int h;

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
    const bool live = edge_mask[e] && s != w.r;
    if constexpr (NB == 2) {
      const float sg = sigmoid_f(to_f(src[s]) + w.dst_r);
      cf[0] = (dis[s] * sg) * w.dis_r[0];
      cf[1] = (dis[(size_t)num_nodes + s] * (1.0f - sg)) * w.dis_r[1];
    } else {
      cf[0] = dis[s] * w.dis_r[0];
    }
    return live;
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
                        const int* nbr, const uint8_t* edge_mask, const float* deg,
                        const float* dis, const CsrRows& csr, int h, void* out0, void* out1,
                        float* partial, cudaStream_t stream) {
  GcnSpmm<T, NB> a;
  static_cast<CsrRows&>(a) = csr;
  a.x[0] = static_cast<const T*>(x0);
  a.out[0] = static_cast<T*>(out0);
  if constexpr (NB == 2) {
    a.x[1] = static_cast<const T*>(x1);
    a.out[1] = static_cast<T*>(out1);
  }
  a.src = static_cast<const T*>(src);
  a.dst = static_cast<const T*>(dst);
  a.nbr = nbr;
  a.edge_mask = edge_mask;
  a.deg = deg;
  a.dis = dis;
  a.partial = partial;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

// K14 / K14T: the csr_spmm_kernel policy of one sigmoid-weighted branch
// (f32 logits); the self term and the row write are GcnSpmm<T, 1>'s.
template <typename T, bool NEG>
struct SigSpmm : GcnSpmm<T, 1, float> {
  struct Row {
    int r;
    float dis_r, dst_r;
  };

  __device__ __forceinline__ Row row(int r) const {
    return Row{r, this->dis[r], this->dst[r]};
  }

  __device__ __forceinline__ bool edge(int e, const Row& w, int& s, float (&cf)[1]) const {
    s = this->nbr[e];
    const bool live = this->edge_mask[e] && s != w.r;
    float wt[1];
    branch_weights<1, NEG>(this->src[s] + w.dst_r, wt);
    cf[0] = (this->dis[s] * wt[0]) * w.dis_r;
    return live;
  }
};

template <typename T, bool NEG>
cudaError_t launch_sig_spmm(const void* x, const float* src, const float* dst, const int* nbr,
                            const uint8_t* edge_mask, const float* deg, const float* dis,
                            const CsrRows& csr, int h, void* out, float* partial,
                            cudaStream_t stream) {
  SigSpmm<T, NEG> a;
  static_cast<CsrRows&>(a) = csr;
  a.x[0] = static_cast<const T*>(x);
  a.out[0] = static_cast<T*>(out);
  a.src = src;
  a.dst = dst;
  a.nbr = nbr;
  a.edge_mask = edge_mask;
  a.deg = deg;
  a.dis = dis;
  a.partial = partial;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

// ---- K5 / K15: the SDDMM chain head --------------------------------------

template <typename T, typename L, int NB>
struct ChainArgs {
  const T* x[NB];     // [V, H] each (the pair: xc, xo)
  const T* g[NB];     // [V, H] each: the cotangents of the outputs
  const L* src;
  const L* dst;
  const int* senders;
  const uint8_t* edge_mask;
  const float* dis;   // [NB, V]
  const int* ptr;     // receiver CSR
  const int* chunk_ptr;
  const int* chunk_row;
  const int* sptr;    // sender CSR, for the ddis_s sums
  const int* schunk_ptr;
  const int* schunk_row;
  const int* sperm;
  float* edge_out;    // [2 NB + 1, E]: vec (NB + 1 rows), then the NB ddis_s terms
  float* ddis_s;      // [NB, V]
  float* ddis_r;      // [NB, V]
  float* partial;     // [max(n_chunks, s_chunks), NB]
  int n_chunks, s_chunks, num_nodes, num_edges, h;
};

template <typename T, typename L, int F, int NB, bool NEG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sddmm_chain_kernel(const ChainArgs<T, L, NB> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int r = k.row;
  const size_t V = a.num_nodes, E = a.num_edges;
  float dis_r[NB];
  float gr[NB][F];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    dis_r[b] = a.dis[b * V + r];
    load_vec<T, F>(a.g[b] + (size_t)r * a.h + lane * F, gr[b]);
  }
  const float dst_r = to_f(a.dst[r]);
  float acc[NB] = {};                     // this lane's ddis_r terms
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
    float dc[NB] = {};
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int s = __shfl_sync(kFull, s_l, j);
      float p[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float xs[F];
        load_vec<T, F>(a.x[b] + (size_t)s * a.h + lane * F, xs);
        p[b] = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) p[b] = fmaf(gr[b][f], xs[f], p[b]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int b = 0; b < NB; ++b) p[b] += __shfl_xor_sync(kFull, p[b], off);
      }
      if (lane == j) {
#pragma unroll
        for (int b = 0; b < NB; ++b) dc[b] = p[b];
      }
    }
    if (i < k.end) {
      float out[2 * NB + 1] = {};
      if (live) {
        float w[NB];
        branch_weights<NB, NEG>(to_f(a.src[s_l]) + dst_r, w);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float dis_s = a.dis[b * V + s_l];
          out[b] = dc[b] * dis_s * dis_r[b];
          out[NB + 1 + b] = dc[b] * w[b] * dis_r[b];
          acc[b] += dc[b] * w[b] * dis_s;
        }
        // the sigmoid's derivative, sg (1 - sg)
        if constexpr (NB == 2)
          out[NB] = w[0] * w[1];
        else
          out[NB] = w[0] * (1.0f - w[0]);
      }
#pragma unroll
      for (int j = 0; j < 2 * NB + 1; ++j) a.edge_out[j * E + i] = out[j];
    }
  }
  finish_row<NB>(acc, k, c, lane, a.num_nodes, a.ddis_r, a.partial);
}

template <typename T, typename L, int NB, bool NEG>
cudaError_t launch_chain(const ChainArgs<T, L, NB>& a, cudaStream_t stream) {
  const int blocks = (a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = kWarpsPerBlock * 32;
  switch (a.h / 32) {
    case 1: sddmm_chain_kernel<T, L, 1, NB, NEG><<<blocks, threads, 0, stream>>>(a); break;
    case 2: sddmm_chain_kernel<T, L, 2, NB, NEG><<<blocks, threads, 0, stream>>>(a); break;
    case 4: sddmm_chain_kernel<T, L, 4, NB, NEG><<<blocks, threads, 0, stream>>>(a); break;
    case 8: sddmm_chain_kernel<T, L, 8, NB, NEG><<<blocks, threads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_combine<NB>(a.chunk_ptr, a.num_nodes, a.partial, a.ddis_r, stream);
  if (err != cudaSuccess) return err;
  return launch_sender_sum<NB>(a.edge_out + (NB + 1) * (size_t)a.num_edges, a.num_edges,
                               a.sperm, a.sptr, a.schunk_ptr, a.schunk_row, a.s_chunks,
                               a.num_nodes, a.ddis_s, a.partial, stream);
}

// The pair (NB = 2) takes its logits in x's dtype, the single branch
// (NB = 1) in f32.
template <typename T, int NB, bool NEG>
cudaError_t chain_typed(const void* const (&x)[2], const void* const (&g)[2], const void* src,
                        const void* dst, const int* senders, const uint8_t* edge_mask,
                        const float* dis, const int* ptr, const int* chunk_ptr,
                        const int* chunk_row, int r_chunks, const int* sptr,
                        const int* schunk_ptr, const int* schunk_row, const int* sperm,
                        int s_chunks, int num_nodes, int num_edges, int h, float* edge_out,
                        float* ddis_s, float* ddis_r, float* partial, cudaStream_t stream) {
  using L = std::conditional_t<NB == 2, T, float>;
  ChainArgs<T, L, NB> a;
  for (int b = 0; b < NB; ++b) {
    a.x[b] = static_cast<const T*>(x[b]);
    a.g[b] = static_cast<const T*>(g[b]);
  }
  a.src = static_cast<const L*>(src);
  a.dst = static_cast<const L*>(dst);
  a.senders = senders;
  a.edge_mask = edge_mask;
  a.dis = dis;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.sptr = sptr;
  a.schunk_ptr = schunk_ptr;
  a.schunk_row = schunk_row;
  a.sperm = sperm;
  a.edge_out = edge_out;
  a.ddis_s = ddis_s;
  a.ddis_r = ddis_r;
  a.partial = partial;
  a.n_chunks = r_chunks;
  a.s_chunks = s_chunks;
  a.num_nodes = num_nodes;
  a.num_edges = num_edges;
  a.h = h;
  return launch_chain<T, L, NB, NEG>(a, stream);
}

// ---- K6 / K16: the chain tail (dpre and its receiver sum) ----------------

template <int NB, bool NEG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dpre_kernel(const float* __restrict__ vec, const float* __restrict__ ddeg,
            const int* __restrict__ senders, const int* __restrict__ ptr,
            const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row, int n_chunks,
            int num_nodes, int num_edges, float* __restrict__ dpre, float* __restrict__ ddst,
            float* __restrict__ partial) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const Chunk k = chunk_of(c, ptr, chunk_ptr, chunk_row);
  const size_t V = num_nodes, E = num_edges;
  float acc[1] = {0.0f};
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int s = senders[i];
    // vec[NB] (the sigmoid's derivative) is 0 on dead edges and self loops
    // (w = 0 there): their dpre is 0
    float d;
    if constexpr (NB == 2)
      d = (vec[i] + ddeg[s] - vec[E + i] - ddeg[V + s]) * vec[2 * E + i];
    else
      d = (vec[i] + ddeg[s]) * vec[E + i];
    if (NEG) d = -d;
    dpre[i] = d;
    acc[0] += d;
  }
  finish_row<1>(acc, k, c, lane, num_nodes, ddst, partial);
}

template <int NB, bool NEG>
cudaError_t launch_dpre(const float* vec, const float* ddeg, const int* senders, const int* ptr,
                        const int* chunk_ptr, const int* chunk_row, int r_chunks,
                        const int* sptr, const int* schunk_ptr, const int* schunk_row,
                        const int* sperm, int s_chunks, int num_nodes, int num_edges,
                        float* dpre, float* dsrc, float* ddst, float* partial,
                        cudaStream_t stream) {
  dpre_kernel<NB, NEG><<<(r_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         kWarpsPerBlock * 32, 0, stream>>>(
      vec, ddeg, senders, ptr, chunk_ptr, chunk_row, r_chunks, num_nodes, num_edges, dpre,
      ddst, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_combine<1>(chunk_ptr, num_nodes, partial, ddst, stream);
  if (err != cudaSuccess) return err;
  return launch_sender_sum<1>(dpre, num_edges, sperm, sptr, schunk_ptr, schunk_row, s_chunks,
                              num_nodes, dsrc, partial, stream);
}

}  // namespace

extern "C" {

// K1 (branches 2) / K13 (branches 1, negate).  dtype: 0 = float32,
// 1 = bfloat16 (src and dst; may both be null: logits 0).  dis null (K1):
// deg [branches, V] gets the sender sums.  dis given (K13): deg = 1 + the
// sums and dis = deg^-1/2, [V] each.  partial holds branches * n_chunks
// floats.
int sender_degree_launch(int branches, int negate, const void* src, const void* dst, int dtype,
                         const int* receivers, const uint8_t* edge_mask, const int* perm,
                         const int* ptr, const int* chunk_ptr, const int* chunk_row,
                         int n_chunks, int num_nodes, float* deg, float* dis, float* partial,
                         cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1)
    err = degree_typed<__nv_bfloat16>(branches, negate != 0, src, dst, receivers, edge_mask,
                                      perm, ptr, chunk_ptr, chunk_row, n_chunks, num_nodes,
                                      deg, partial, stream);
  else if (dtype == 0)
    err = degree_typed<float>(branches, negate != 0, src, dst, receivers, edge_mask, perm, ptr,
                              chunk_ptr, chunk_row, n_chunks, num_nodes, deg, partial, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || dis == nullptr) return (int)err;
  deg_dis_kernel<<<(num_nodes + 255) / 256, 256, 0, stream>>>(num_nodes, deg, dis);
  return (int)cudaGetLastError();
}

// branches: 2 (pair: x0 = xc, x1 = xo, logits src/dst) or 1 (plain: x0,
// src/dst unused).  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned
// as launch_csr_spmm says.  Forward (K2/K3): perm null, nbr = senders, the
// receiver CSR.  Transposed (K2T/K3T): perm = the sender CSR's perm, nbr =
// receivers, the sender CSR, and the logits swapped (src <- dst, dst <-
// src).  The CSR is graph.EdgeCsr's (heavy_chunks and heavy_masked
// included); arrivals holds n_heavy_chunks ints, 0 before the launch and
// after it; partial holds branches * n_heavy_chunks * h floats.
int coef_spmm_launch(int branches, const void* x0, const void* x1, const void* src,
                     const void* dst, int dtype, const int* nbr, const int* perm,
                     const uint8_t* edge_mask, const float* deg, const float* dis,
                     const int* ptr, const int* chunk_ptr, const int* chunk_row,
                     const int* heavy_chunks, const uint8_t* heavy_masked, int n_heavy_chunks,
                     int* arrivals, int num_nodes, int h, void* out0, void* out1,
                     float* partial, cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked,
                    arrivals, perm, n_heavy_chunks, num_nodes};
#define SPMM(T, NB) \
  launch_spmm<T, NB>(x0, x1, src, dst, nbr, edge_mask, deg, dis, csr, h, out0, out1, partial, stream)
  if (dtype == 1 && branches == 2) return (int)SPMM(__nv_bfloat16, 2);
  if (dtype == 1 && branches == 1) return (int)SPMM(__nv_bfloat16, 1);
  if (dtype == 0 && branches == 2) return (int)SPMM(float, 2);
  if (dtype == 0 && branches == 1) return (int)SPMM(float, 1);
#undef SPMM
  return (int)cudaErrorInvalidValue;
}

// K14 / K14T.  dtype: 0 = float32, 1 = bfloat16 (x); src and dst f32.
// Forward (K14): perm null, nbr = senders, the receiver CSR.  Transposed
// (K14T): perm = the sender CSR's perm, nbr = receivers, the sender CSR, and
// the logits swapped (src <- dst, dst <- src).  h, the CSR and arrivals as
// coef_spmm_launch; deg and dis [V] f32 (K13's); partial holds
// n_heavy_chunks * h floats.
int sig_coef_spmm_launch(const void* x, const float* src, const float* dst, int dtype,
                         int negate, const int* nbr, const int* perm, const uint8_t* edge_mask,
                         const float* deg, const float* dis, const int* ptr,
                         const int* chunk_ptr, const int* chunk_row, const int* heavy_chunks,
                         const uint8_t* heavy_masked, int n_heavy_chunks, int* arrivals,
                         int num_nodes, int h, void* out, float* partial,
                         cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked,
                    arrivals, perm, n_heavy_chunks, num_nodes};
#define SIG_SPMM(T, NEG) \
  launch_sig_spmm<T, NEG>(x, src, dst, nbr, edge_mask, deg, dis, csr, h, out, partial, stream)
  if (dtype == 1) return (int)(negate ? SIG_SPMM(__nv_bfloat16, true)
                                      : SIG_SPMM(__nv_bfloat16, false));
  if (dtype == 0) return (int)(negate ? SIG_SPMM(float, true) : SIG_SPMM(float, false));
#undef SIG_SPMM
  return (int)cudaErrorInvalidValue;
}

// K5 (branches 2: x0 = xc, x1 = xo, g0 = gc, g1 = go, logits in x's dtype)
// / K15 (branches 1, negate: x0, g0, f32 logits; x1 and g1 unused).  dtype:
// 0 = float32, 1 = bfloat16 (x and g).  The receiver CSR (ptr, chunk_ptr,
// chunk_row, r_chunks) for the per-edge pass, the sender CSR (sptr,
// schunk_ptr, schunk_row, sperm, s_chunks) for the ddis_s sums.  Writes
// edge_out [2 branches + 1, E] (vec = rows 0 to branches; the rest are the
// per-edge ddis_s terms), ddis_s and ddis_r [branches, V]; partial holds
// branches * max(r_chunks, s_chunks) floats.
int sddmm_chain_launch(int branches, int negate, const void* x0, const void* x1,
                       const void* g0, const void* g1, const void* src, const void* dst,
                       int dtype, const int* senders, const uint8_t* edge_mask,
                       const float* dis, const int* ptr, const int* chunk_ptr,
                       const int* chunk_row, int r_chunks, const int* sptr,
                       const int* schunk_ptr, const int* schunk_row, const int* sperm,
                       int s_chunks, int num_nodes, int num_edges, int h, float* edge_out,
                       float* ddis_s, float* ddis_r, float* partial, cudaStream_t stream) {
  if (r_chunks <= 0 || s_chunks <= 0 || num_nodes <= 0 || num_edges <= 0 || h <= 0 || h % 32)
    return (int)cudaErrorInvalidValue;
  const void* const xs[2] = {x0, x1};
  const void* const gs[2] = {g0, g1};
#define CHAIN(T, NB, NEG)                                                                    \
  chain_typed<T, NB, NEG>(xs, gs, src, dst, senders, edge_mask, dis, ptr, chunk_ptr,         \
                          chunk_row, r_chunks, sptr, schunk_ptr, schunk_row, sperm, s_chunks, \
                          num_nodes, num_edges, h, edge_out, ddis_s, ddis_r, partial, stream)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && branches == 2) err = CHAIN(__nv_bfloat16, 2, false);
  else if (dtype == 0 && branches == 2) err = CHAIN(float, 2, false);
  else if (dtype == 1 && branches == 1)
    err = negate ? CHAIN(__nv_bfloat16, 1, true) : CHAIN(__nv_bfloat16, 1, false);
  else if (dtype == 0 && branches == 1)
    err = negate ? CHAIN(float, 1, true) : CHAIN(float, 1, false);
#undef CHAIN
  return (int)err;
}

// K6 (branches 2: vec [3, E], ddeg [2, V]) / K16 (branches 1, negate:
// vec [2, E], ddeg [V]): K5's / K15's vec rows and the f32 degree gradient;
// CSRs as K5.  Writes dpre [E] (scratch), dsrc and ddst [V]; partial holds
// max(r_chunks, s_chunks) floats.
int dpre_launch(int branches, int negate, const float* vec, const float* ddeg,
                const int* senders, const int* ptr, const int* chunk_ptr, const int* chunk_row,
                int r_chunks, const int* sptr, const int* schunk_ptr, const int* schunk_row,
                const int* sperm, int s_chunks, int num_nodes, int num_edges, float* dpre,
                float* dsrc, float* ddst, float* partial, cudaStream_t stream) {
  if (r_chunks <= 0 || s_chunks <= 0 || num_nodes <= 0 || num_edges <= 0)
    return (int)cudaErrorInvalidValue;
#define DPRE(NB, NEG)                                                                       \
  launch_dpre<NB, NEG>(vec, ddeg, senders, ptr, chunk_ptr, chunk_row, r_chunks, sptr,       \
                       schunk_ptr, schunk_row, sperm, s_chunks, num_nodes, num_edges, dpre, \
                       dsrc, ddst, partial, stream)
  cudaError_t err = cudaErrorInvalidValue;
  if (branches == 2) err = DPRE(2, false);
  else if (branches == 1) err = negate ? DPRE(1, true) : DPRE(1, false);
#undef DPRE
  return (int)err;
}

}  // extern "C"
