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
//       (sigmoid(0) = 0.5 exactly: the plain conv's degree is 2 deg[0],
//       which the one-branch mode at null logits gives as a count); with
//       its epilogue deg = 1 + the sums and dis = deg^-1/2 (rsqrtf).
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
//       (zeros on dead edges and self loops); ddis_s[k][s] += dc_k w_k dis_k[r] and
//       ddis_r[k][r] += dc_k w_k dis_k[s].
//   K6: dpre[e] = (vec0 + ddeg_0[s] - vec1 - ddeg_1[s]) * vec2;
//       dsrc[s] += dpre[e], ddst[r] += dpre[e] (vec2 = 0 zeroes dead edges).
//   deg / dis [branches, V] f32 are deg + 1 and its rsqrt (K1's epilogue),
//   and ddeg [2, V] the degree gradient, from the caller (the elementwise
//   step between K5 and K6 is plain PyTorch, as it is plain XLA in
//   cal_tpu).
//   Single branch, w = sigmoid(src[s] + dst[r]), or 1 - it when negate:
//   K13: deg[v] = 1 + sum over live e with s_e = v of w, dis = deg^-1/2
//       (rsqrtf).
//   K14: out[r] = sum over live e with r_e = r of dis[s] w dis[r] x[s]
//       + x[r] / deg[r];  K14T the same over the sender CSR (dx, with the
//       logits swapped by the caller, as K2T).
//   K15: per live e, dc = <g[r], x[s]>; vec[e] = (dc dis[s] dis[r],
//       w (1 - w)) (zeros on dead edges and self loops); ddis_s[s] += dc w dis[r],
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
// these points; K5's dot products and every sum are in the walk's order
// (a lane's terms, then the group's shuffle tree, a heavy row's chunks in
// order), not the twins', so they may differ from them in the last bits.
// cal_tpu's bf16 tile plans round more (the gathered logit and dis planes,
// the per-slot weights, each message before the receiver sum): the port
// does not.
//
// Design.  Rows (senders for K1, K2T, K3T; receivers for K2, K3, K5) come
// in CSR form (graph.EdgeCsr; the sender CSR reads edge perm[i]): a row's
// edges form groups of kGroup = 32 and the groups at most kMaxChunks = 64
// chunks of equal group counts.  A light row (one chunk, at most 32 edges;
// most rows of real batches hold 1-4) is one lane group's item, several a
// warp; the chunks of a heavy row (a hub, or the padded-edge run at node V-1,
// in both CSRs), listed on the host (heavy_chunks), are the first items of
// the launch, each writing f32 partials, and the row's last chunk to arrive
// (an int counter in EdgeCsr.arrivals, 0 again when the launch ends) sums
// them in chunk order and writes the row.  So no pass visits all V rows,
// every sum has one owner and one order, and no float is summed
// atomically: a result does not change between runs.
//  - K2/K3/K14 (and their transposed modes) are csr_rows.cuh's coefficient
//    SpMM walk with the GcnSpmm / SigSpmm policies (16-byte loads of a
//    row's features, 32 / G rows a warp; a group loads up to kInFlight
//    neighbour rows of a window's live edges before their FMAs, and the self
//    term is fused into the row's write).  The padded run's edges are self
//    loops at node V-1, never live: a heavy chunk of them alone is not
//    walked.
//  - K5/K15, two launches.  The receiver pass (chain_head_kernel) is the
//    walk's lane group with 32 bytes of x a lane (HeadShape, K10's: 4 rows
//    a warp at H = 128 in bf16, 2 in f32, 2 blocks an SM): the group keeps
//    g[r] of each branch in registers, reads a window of G edges at once
//    (one a lane: its metadata, and a live edge's logits and dis[s]), lists
//    the live edges with a ballot, loads both branches' x[s] of kInFlight of
//    them before their dot products, reduces each over the group's lanes
//    (log2 G shuffle levels), and the edge's own lane forms vec, its ddis_s
//    terms (stored edge-major, [E, NB]) and its share of the row's ddis_r
//    (csr_rows.cuh's csr_item and finish_item, as K10's receiver pass).
//    Every CSR position gets its outputs: zeros on dead edges, self loops
//    and a heavy chunk of masked edges alone, which is not walked (K6's
//    vec[NB] = 0 is what keeps their dpre out of its sums).  ddis_s is
//    csr_reduce_kernel's sum of the terms over the sender CSR through perm.
//  - K6/K16, one launch (chain_tail_kernel): csr_rows.cuh's per-row
//    reduction over both CSRs in one grid, each edge's dpre formed in-kernel
//    from the vec planes and ddeg[s] by the twins' float operations: the
//    receiver CSR's rows give ddst, the sender CSR's (through perm) dsrc,
//    each CSR's heavy chunks first and finished by its own arrivals.  So no
//    dpre plane is written or read back.
//  - K1/K13, one launch: csr_rows.cuh's per-row reduction over the sender
//    CSR (through perm), each edge's branch weights formed in-kernel from
//    src[s] (once a lane) and dst[r] (DegreeSum), 8 light rows a warp, a
//    heavy row's chunks first, finished by g.send's arrivals; the row's
//    owner writes deg = 1 + the sum and dis = rsqrtf(deg) where the caller
//    asks (K13 always; K1 in the pair and plain aggregates), so no
//    elementwise launch follows.  The plain conv's degree is the same
//    kernel at zero logits with one branch: it counts live edges.
// The constants (32-byte lanes, a window of G edges, 2 blocks an SM, one
// grid for K6) are the measured winners: PERF.md gives the times of the
// alternatives (16-byte lanes, windows of 16 or 32 edges, 3 or 4 blocks an
// SM, g kept as packed words, one row in flight, K6 as two launches).  The
// terms are edge-major, one store an edge; as [NB, E] planes they timed
// within the spread between equal trees.
// The launches over one batch's CSR share its arrival counters on one
// stream: K2, K3, K14 and K5's receiver pass g.recv's, K1, K13, K2T, K3T,
// K14T and K5's sender sums g.send's, K6 both.
//
// Bound: bytes.  K2 reads x [V, 2H] once (plus a neighbour row per live
// edge, mostly from L2) and writes [V, 2H]; the metadata is 9 bytes per edge
// (13 through perm); K5 reads x and g [V, 2H] and writes 5 f32 per edge; K6
// reads vec and the CSRs and writes two planes; the arithmetic (2H FMAs per
// edge) is far below the tensor-core or FMA floor.  K13-K16 are the
// one-branch halves: K14 reads x [V, H] and writes [V, H], K15 reads x and
// g [V, H] and writes 3 f32 per edge.  K1 / K13 read 9 bytes per edge
// (perm, receiver, mask), the logits and the CSR, and write 4 (sums) or 8
// (deg, dis) bytes a row and branch.  The walks' own limit is latency: a
// light row is a chain of dependent loads (ptr, metadata, gathers or
// neighbour rows, store).
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

// The sender sums of the branch weights, a csr_reduce policy over the sender
// CSR (CSR position i of row `row` is edge perm[i]): a live edge (mask on,
// receiver r != row) adds branch_weights(src[row] + dst[r]), src[row] read
// once a lane.  Null logits weigh an edge 0.5 a branch in the pair
// (sigmoid(0)) and 1 in one branch, so that the one-branch sums count live
// edges: the plain conv's degree, exact in any order (2 x a sum of 0.5s,
// as cal_tpu's _plain_fwd forms it, is the same count).  A dead edge adds
// nothing, so a heavy chunk of masked-out edges alone (the padded run) is
// not read.  With dis given, the row's owner writes deg = 1 + the sum and
// dis = rsqrtf(deg) (the epilogue of K13, and of K1 as the aggregates take
// it); without, the sums.
template <typename L>
struct DegreeIo {
  const L* src;         // null with dst: logits 0
  const L* dst;
  const int* receivers;
  const uint8_t* edge_mask;
  float* out;           // [NB, V]: the sums, or deg = 1 + the sums when dis is given
  float* dis;           // null, or [NB, V]
  float* partial;       // [heavy_cap, NB]
};

constexpr int kDegreeBatch = 4;   // edges a lane of K1 / K13 loads together

template <typename L, int NB, bool NEG>
struct DegreeSum : CsrRows, DegreeIo<L> {
  static constexpr int planes = NB;
  static constexpr bool skip_masked = true;
  static constexpr bool kOwnStore = true;

  // The lane's edges beg + gl, beg + gl + G, ... below end, kDegreeBatch at
  // a time: their perm, receiver and mask loads, then their logit gathers,
  // each level in flight together (a lane past the range reads the last
  // edge again, never live); the weights are added in edge order.
  template <typename Op, int G>
  __device__ __forceinline__ void lane_values(int, int beg, int end, int row, int gl,
                                              float (&acc)[kPlaneBatch]) const {
    constexpr int U = kDegreeBatch;
    const float s_row = this->src == nullptr ? 0.0f : to_f(this->src[row]);
    for (int i0 = beg + gl; i0 < end; i0 += U * G) {
      int r[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = min(i0 + u * G, end - 1);
        const int e = __ldg(perm + i);
        r[u] = __ldg(this->receivers + e);
        live[u] = i0 + u * G < end && __ldg(this->edge_mask + e) && r[u] != row;
      }
      float w[U][NB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (this->src == nullptr) {
#pragma unroll
          for (int b = 0; b < NB; ++b) w[u][b] = NB == 1 ? 1.0f : 0.5f;
        } else {
          branch_weights<NB, NEG>(s_row + to_f(this->dst[r[u]]), w[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u])
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b] = Op::apply(acc[b], w[u][b]);
    }
  }

  __device__ __forceinline__ void store(int q, int r, float v) const {
    const size_t at = (size_t)q * num_nodes + r;
    if (this->dis == nullptr) {
      this->out[at] = v;
      return;
    }
    const float d = 1.0f + v;
    this->out[at] = d;
    this->dis[at] = rsqrtf(d);
  }
};

template <typename L, int NB, bool NEG>
cudaError_t launch_degree(const CsrRows& send, const DegreeIo<L>& io, cudaStream_t stream) {
  DegreeSum<L, NB, NEG> a;
  static_cast<CsrRows&>(a) = send;
  static_cast<DegreeIo<L>&>(a) = io;
  return launch_csr_reduce<SumOp>(a, stream);
}

template <typename L>
cudaError_t degree_typed(int branches, bool negate, const void* src, const void* dst,
                         const int* receivers, const uint8_t* edge_mask, const CsrRows& send,
                         float* deg, float* dis, float* partial, cudaStream_t stream) {
  const DegreeIo<L> io{static_cast<const L*>(src), static_cast<const L*>(dst), receivers,
                       edge_mask, deg, dis, partial};
  if (branches == 2) return launch_degree<L, 2, false>(send, io, stream);
  if (branches == 1)
    return negate ? launch_degree<L, 1, true>(send, io, stream)
                  : launch_degree<L, 1, false>(send, io, stream);
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
  float* partial;     // [heavy_cap, NB, H]
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

constexpr int kHeadBlocks = 2;   // the receiver pass's blocks an SM (__launch_bounds__)

template <typename T, typename L, int NB>
struct ChainHead : CsrRows {   // the receiver CSR
  const T* x[NB];     // [V, H] each (the pair: xc, xo)
  const T* g[NB];     // [V, H] each: the cotangents of the outputs
  const L* src;
  const L* dst;
  const int* senders;
  const uint8_t* edge_mask;
  const float* dis;   // [NB, V]
  float* vec;         // [NB + 1, E]
  float* terms;       // [E, NB]: each edge's ddis_s terms, for the sender sums
  float* ddis_r;      // [NB, V]
  float* partial;     // [heavy_cap, NB]: a heavy chunk's ddis_r sums
  int num_edges, h;
};

// The receiver pass's lane group: 32 bytes of x (and of g) a lane, G = H /
// F lanes a row, so at H = 128 4 rows a warp in bf16 and 2 in f32 (K10's
// ChainShape).
template <typename T, int Q>
using HeadShape = LightShape<T, Q, 1, 32>;

// One item a lane group, 32 / G a warp, as csr_spmm_kernel (items [0,
// live_heavy) the heavy chunks, partial i for item i; the others the
// rows, a heavy row's group idle).  Every CSR position of the item gets its
// vec and terms, zeros where the edge is dead.
template <typename T, typename L, int NB, bool NEG, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kHeadBlocks)
chain_head_kernel(const ChainHead<T, L, NB> a) {
  using S = HeadShape<T, Q>;
  constexpr int F = S::F, G = S::G, U = kInFlight;
  constexpr int kWords = F * sizeof(T) / 4;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  const int nh = live_heavy(a);
  if (first >= nh + a.num_nodes) return;
  const int gl = lane % G, base = lane - gl;
  const unsigned gbits = G == 32 ? kFull : (1u << G) - 1u;
  const int item = first + lane / G;
  // a chunk of masked-out edges alone is not walked: its outputs are zeros
  const CsrItem it = csr_item(a, nh, item, true);
  const int r = it.r, wend = it.wend;
  const size_t V = a.num_nodes, E = a.num_edges;
  const int rr = min(r, a.num_nodes - 1);
  float gr[NB][F], dis_r[NB], acc[NB];   // acc: this lane's ddis_r terms
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    load_vec<T, F>(a.g[b] + (size_t)rr * a.h + gl * F, gr[b]);
    dis_r[b] = __ldg(a.dis + b * V + rr);
    acc[b] = 0.0f;
  }
  const float dst_r = to_f(a.dst[rr]);
  for (int w0 = it.beg; __any_sync(kFull, w0 < wend); w0 += G) {
    // a window of G edges, one a lane: its metadata, and a live edge's logit
    // sum and dis[s] in flight beside the neighbour rows (past the range a
    // lane reads nothing and is never live)
    const int i = w0 + gl;
    int s_l = 0;
    bool live = false;
    if (i < wend) {
      s_l = a.senders[i];
      live = a.edge_mask[i] && s_l != r;
    }
    float z = 0.0f, dis_s[NB] = {}, dc[NB] = {};
    if (live) {
      z = to_f(a.src[s_l]) + dst_r;
#pragma unroll
      for (int b = 0; b < NB; ++b) dis_s[b] = __ldg(a.dis + b * V + s_l);
    }
    unsigned msk = (__ballot_sync(kFull, live) >> base) & gbits;
    while (__any_sync(kFull, msk != 0)) {
      // the next U live edges of the group, in edge order: both branches'
      // neighbour rows loaded, then their dot products with g[r], reduced
      // over the group; the edge's own lane keeps them
      bool ok[U];
      int j[U];
      uint32_t xs[U][NB][kWords];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = msk != 0;
        j[u] = base + (ok[u] ? __ffs(msk) - 1 : 0);
        msk &= msk - 1;
        const int s = __shfl_sync(kFull, s_l, j[u]);
        if (ok[u])
#pragma unroll
          for (int b = 0; b < NB; ++b)
            load_words<T, F>(a.x[b] + (size_t)s * a.h + gl * F, xs[u][b]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float p[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          p[b] = 0.0f;
          if (ok[u])
#pragma unroll
            for (int f = 0; f < F; ++f) p[b] = fmaf(gr[b][f], word_elem<T>(xs[u][b], f), p[b]);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
          for (int b = 0; b < NB; ++b) p[b] += __shfl_xor_sync(kFull, p[b], off);
        if (ok[u] && lane == j[u])
#pragma unroll
          for (int b = 0; b < NB; ++b) dc[b] = p[b];
      }
    }
    if (i < wend) {
      float o[NB + 1] = {}, t[NB] = {};
      if (live) {
        float w[NB];
        branch_weights<NB, NEG>(z, w);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          o[b] = dc[b] * dis_s[b] * dis_r[b];
          t[b] = dc[b] * w[b] * dis_r[b];
          acc[b] += dc[b] * w[b] * dis_s[b];
        }
        // the sigmoid's derivative, sg (1 - sg)
        if constexpr (NB == 2)
          o[NB] = w[0] * w[1];
        else
          o[NB] = w[0] * (1.0f - w[0]);
      }
#pragma unroll
      for (int q = 0; q <= NB; ++q) a.vec[q * E + i] = o[q];
      store_vec<float, NB>(a.terms + (size_t)i * NB, t);
    }
  }
  if (it.masked) {
    const float zero[NB] = {};
    for (int i = it.beg + gl; i < it.end; i += G) {
#pragma unroll
      for (int q = 0; q <= NB; ++q) a.vec[q * E + i] = 0.0f;
      store_vec<float, NB>(a.terms + (size_t)i * NB, zero);
    }
  }
  finish_item<NB, G>(a, it, item, gl, acc, a.ddis_r, a.partial);
}

template <typename T, typename L, int NB, bool NEG, int Q>
cudaError_t launch_head_q(const ChainHead<T, L, NB>& a, cudaStream_t stream) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / HeadShape<T, Q>::G;
  const int items = a.heavy_cap + a.num_nodes;
  chain_head_kernel<T, L, NB, NEG, Q><<<(items + kItemsPerBlock - 1) / kItemsPerBlock,
                                        kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// The receiver pass, then ddis_s: csr_reduce_kernel's sums of the edges'
// terms ([E, NB]) over the sender CSR, a dead edge's terms 0.
template <typename T, typename L, int NB, bool NEG>
cudaError_t launch_chain(const ChainHead<T, L, NB>& a, const CsrRows& send, float* ddis_s,
                         cudaStream_t stream) {
  cudaError_t err;
  switch (a.h / 32) {
    case 1: err = launch_head_q<T, L, NB, NEG, 1>(a, stream); break;
    case 2: err = launch_head_q<T, L, NB, NEG, 2>(a, stream); break;
    case 4: err = launch_head_q<T, L, NB, NEG, 4>(a, stream); break;
    case 8: err = launch_head_q<T, L, NB, NEG, 8>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  RowReduce rd;
  static_cast<CsrRows&>(rd) = send;
  rd.vals = a.terms;
  rd.num_edges = a.num_edges;
  rd.planes = NB;
  rd.vec = false;   // through perm
  rd.edge_major = true;
  rd.skip_masked = true;
  rd.out = ddis_s;
  rd.partial = a.partial;
  return launch_csr_reduce<SumOp>(rd, stream);
}

// The pair (NB = 2) takes its logits in x's dtype, the single branch
// (NB = 1) in f32.
template <typename T, int NB, bool NEG>
cudaError_t chain_typed(const void* const (&x)[2], const void* const (&g)[2], const void* src,
                        const void* dst, const int* senders, const uint8_t* edge_mask,
                        const float* dis, const CsrRows& recv, const CsrRows& send,
                        int num_edges, int h, float* vec, float* terms, float* ddis_s,
                        float* ddis_r, float* partial, cudaStream_t stream) {
  using L = std::conditional_t<NB == 2, T, float>;
  ChainHead<T, L, NB> a;
  static_cast<CsrRows&>(a) = recv;
  for (int b = 0; b < NB; ++b) {
    a.x[b] = static_cast<const T*>(x[b]);
    a.g[b] = static_cast<const T*>(g[b]);
  }
  a.src = static_cast<const L*>(src);
  a.dst = static_cast<const L*>(dst);
  a.senders = senders;
  a.edge_mask = edge_mask;
  a.dis = dis;
  a.vec = vec;
  a.terms = terms;
  a.ddis_r = ddis_r;
  a.partial = partial;
  a.num_edges = num_edges;
  a.h = h;
  return launch_chain<T, L, NB, NEG>(a, send, ddis_s, stream);
}

// ---- K6 / K16: the chain tail (dpre and its sums by sender and receiver) --

// dpre of the edges of one CSR, a csr_reduce policy: over the receiver CSR
// (SEND false; ddst) edge i with sender senders[i], over the sender CSR
// (SEND true; dsrc) edge perm[i] with sender `row`.  dpre = (vec0 + ddeg_0[s]
// - vec1 - ddeg_1[s]) vec2 (NB = 2) or (vec0 + ddeg[s]) vec1 (NB = 1),
// negated under NEG: the twins' float operations in their order (the
// product is __fmul_rn, never contracted into the sum).  vec[NB] is 0 on
// dead edges (K5 writes zeros there), so a heavy chunk of masked-out edges
// alone adds 0 and is not read.
template <int NB, bool NEG, bool SEND>
struct DpreSum : CsrRows {
  static constexpr int planes = 1;
  static constexpr bool skip_masked = true;
  const float* vecs;     // [NB + 1, E]
  const float* ddeg;     // [NB, V]
  const int* senders;
  float* out;            // [V]
  float* partial;        // [heavy_cap]
  int num_edges;

  template <typename Op, int G>
  __device__ __forceinline__ void lane_values(int, int beg, int end, int row, int gl,
                                              float (&acc)[kPlaneBatch]) const {
    const size_t V = num_nodes, E = num_edges;
    float d_row[NB];
    if constexpr (SEND)
#pragma unroll
      for (int b = 0; b < NB; ++b) d_row[b] = __ldg(ddeg + b * V + row);
    for (int i = beg + gl; i < end; i += G) {
      size_t e;
      float dd[NB];
      if constexpr (SEND) {
        e = perm[i];
#pragma unroll
        for (int b = 0; b < NB; ++b) dd[b] = d_row[b];
      } else {
        e = i;
        const size_t s = senders[i];
#pragma unroll
        for (int b = 0; b < NB; ++b) dd[b] = __ldg(ddeg + b * V + s);
      }
      float t;
      if constexpr (NB == 2)
        t = __ldg(vecs + e) + dd[0] - __ldg(vecs + E + e) - dd[1];
      else
        t = __ldg(vecs + e) + dd[0];
      float d = __fmul_rn(t, __ldg(vecs + NB * E + e));
      if (NEG) d = -d;
      acc[0] = Op::apply(acc[0], d);
    }
  }
};

// One grid over both CSRs: the heavy chunks of the receiver CSR, then of the
// sender CSR (a warp each, finished by their own CSR's arrivals), then the
// light rows of each, 32 / kReduceGroup a warp; the grid's last warps (the
// heavy lists' unused capacity) return.
template <int NB, bool NEG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
chain_tail_kernel(const DpreSum<NB, NEG, false> rv, const DpreSum<NB, NEG, true> sd) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int hr = live_heavy(rv), hs = live_heavy(sd), lr = light_warps(rv);
  if (w < hr) reduce_heavy_chunk<SumOp>(rv, w, lane);
  else if (w < hr + hs) reduce_heavy_chunk<SumOp>(sd, w - hr, lane);
  else if (w < hr + hs + lr) reduce_light_rows<SumOp>(rv, w - hr - hs, lane);
  else reduce_light_rows<SumOp>(sd, w - hr - hs - lr, lane);
}

template <int NB, bool NEG>
cudaError_t launch_tail(const float* vec, const float* ddeg, const int* senders,
                        const CsrRows& recv, const CsrRows& send, int num_edges, float* dsrc,
                        float* ddst, float* partial, cudaStream_t stream) {
  DpreSum<NB, NEG, false> rv;
  DpreSum<NB, NEG, true> sd;
  static_cast<CsrRows&>(rv) = recv;
  static_cast<CsrRows&>(sd) = send;
  rv.vecs = sd.vecs = vec;
  rv.ddeg = sd.ddeg = ddeg;
  rv.senders = sd.senders = senders;
  rv.num_edges = sd.num_edges = num_edges;
  rv.out = ddst;
  sd.out = dsrc;
  rv.partial = partial;
  sd.partial = partial + recv.heavy_cap;
  const int warps = recv.heavy_cap + send.heavy_cap + light_warps(recv) + light_warps(send);
  chain_tail_kernel<NB, NEG><<<(warps + kWarpsPerBlock - 1) / kWarpsPerBlock,
                               kWarpsPerBlock * 32, 0, stream>>>(rv, sd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (branches 2) / K13 (branches 1, negate): csr_reduce_kernel's sums over
// the sender CSR, one launch.  dtype: 0 = float32, 1 = bfloat16 (src and
// dst; both null: logits 0, the pair's weights 0.5 each and one branch's 1,
// so that it counts live edges).  dis null: deg [branches, V] gets the
// sender sums; dis given: deg = 1 + the sums and dis = deg^-1/2, [branches,
// V] each.  The sender CSR (graph.EdgeCsr: perm, ptr, chunk_ptr, chunk_row,
// heavy_chunks and heavy_masked of heavy_cap entries, heavy_count [1] on the
// card, their live count, and arrivals: heavy_cap ints, 0 before the launch
// and after it); partial holds branches * heavy_cap floats.
int sender_degree_launch(int branches, int negate, const void* src, const void* dst, int dtype,
                         const int* receivers, const uint8_t* edge_mask, const int* perm,
                         const int* ptr, const int* chunk_ptr, const int* chunk_row,
                         const int* heavy_chunks, const uint8_t* heavy_masked, int heavy_cap,
                         const int* heavy_count, int* arrivals, int num_nodes, float* deg,
                         float* dis, float* partial, cudaStream_t stream) {
  if (num_nodes <= 0 || heavy_cap <= 0 || (src == nullptr) != (dst == nullptr))
    return (int)cudaErrorInvalidValue;
  const CsrRows send{ptr,      chunk_ptr, chunk_row, heavy_chunks, heavy_masked, heavy_count,
                     arrivals, perm,      heavy_cap, num_nodes};
  if (dtype == 1)
    return (int)degree_typed<__nv_bfloat16>(branches, negate != 0, src, dst, receivers,
                                            edge_mask, send, deg, dis, partial, stream);
  if (dtype == 0)
    return (int)degree_typed<float>(branches, negate != 0, src, dst, receivers, edge_mask,
                                    send, deg, dis, partial, stream);
  return (int)cudaErrorInvalidValue;
}

// branches: 2 (pair: x0 = xc, x1 = xo, logits src/dst) or 1 (plain: x0,
// src/dst unused).  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned
// as launch_csr_spmm says.  Forward (K2/K3): perm null, nbr = senders, the
// receiver CSR.  Transposed (K2T/K3T): perm = the sender CSR's perm, nbr =
// receivers, the sender CSR, and the logits swapped (src <- dst, dst <-
// src).  The CSR is graph.EdgeCsr's, as sender_degree_launch takes it;
// partial holds branches * heavy_cap * h floats.
int coef_spmm_launch(int branches, const void* x0, const void* x1, const void* src,
                     const void* dst, int dtype, const int* nbr, const int* perm,
                     const uint8_t* edge_mask, const float* deg, const float* dis,
                     const int* ptr, const int* chunk_ptr, const int* chunk_row,
                     const int* heavy_chunks, const uint8_t* heavy_masked, int heavy_cap,
                     const int* heavy_count, int* arrivals, int num_nodes, int h, void* out0,
                     void* out1, float* partial, cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked, heavy_count,
                    arrivals, perm, heavy_cap, num_nodes};
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
// heavy_cap * h floats.
int sig_coef_spmm_launch(const void* x, const float* src, const float* dst, int dtype,
                         int negate, const int* nbr, const int* perm, const uint8_t* edge_mask,
                         const float* deg, const float* dis, const int* ptr,
                         const int* chunk_ptr, const int* chunk_row, const int* heavy_chunks,
                         const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                         int* arrivals, int num_nodes, int h, void* out, float* partial,
                         cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked, heavy_count,
                    arrivals, perm, heavy_cap, num_nodes};
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
// 0 = float32, 1 = bfloat16 (x and g).  The receiver CSR (graph.EdgeCsr:
// ptr, chunk_ptr, chunk_row, heavy_chunks, heavy_masked, their capacity and
// live count, arrivals, as sender_degree_launch takes them) for the
// per-edge pass, the sender CSR (the same eight, its own counters) and its
// perm for the ddis_s sums.  Writes vec [branches + 1, E], terms (scratch:
// [E, branches]), ddis_s and ddis_r [branches, V], all f32; partial holds
// branches * max(heavy_cap, s_heavy_cap) floats.  h % 32 == 0, h /
// 32 in {1, 2, 4, 8}; x and g rows 16-byte aligned (a lane loads 32 bytes,
// csr_rows.cuh LightShape).  Two launches.
int sddmm_chain_launch(int branches, int negate, const void* x0, const void* x1,
                       const void* g0, const void* g1, const void* src, const void* dst,
                       int dtype, const int* senders, const uint8_t* edge_mask,
                       const float* dis, const int* ptr, const int* chunk_ptr,
                       const int* chunk_row, const int* heavy_chunks,
                       const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                       int* arrivals, const int* sptr, const int* schunk_ptr,
                       const int* schunk_row, const int* sheavy_chunks,
                       const uint8_t* sheavy_masked, int s_heavy_cap, const int* s_heavy_count,
                       int* sarrivals, const int* sperm, int num_nodes,
                       int num_edges, int h, float* vec, float* terms, float* ddis_s,
                       float* ddis_r, float* partial, cudaStream_t stream) {
  if (num_nodes <= 0 || num_edges <= 0 || heavy_cap <= 0 || s_heavy_cap <= 0 || h <= 0 ||
      h % 32)
    return (int)cudaErrorInvalidValue;
  const CsrRows recv{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                     heavy_masked, heavy_count, arrivals, nullptr, heavy_cap, num_nodes};
  const CsrRows send{sptr,      schunk_ptr, schunk_row,     sheavy_chunks,
                     sheavy_masked, s_heavy_count, sarrivals, sperm, s_heavy_cap, num_nodes};
  const void* const xs[2] = {x0, x1};
  const void* const gs[2] = {g0, g1};
#define CHAIN(T, NB, NEG)                                                                 \
  chain_typed<T, NB, NEG>(xs, gs, src, dst, senders, edge_mask, dis, recv, send, num_edges, \
                          h, vec, terms, ddis_s, ddis_r, partial, stream)
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
// the CSRs as K5.  Writes dsrc and ddst [V] f32; partial holds heavy_cap +
// s_heavy_cap floats.  One launch.
int dpre_launch(int branches, int negate, const float* vec, const float* ddeg,
                const int* senders, const int* ptr, const int* chunk_ptr, const int* chunk_row,
                const int* heavy_chunks, const uint8_t* heavy_masked, int heavy_cap,
                const int* heavy_count, int* arrivals, const int* sptr, const int* schunk_ptr,
                const int* schunk_row, const int* sheavy_chunks, const uint8_t* sheavy_masked,
                int s_heavy_cap, const int* s_heavy_count, int* sarrivals, const int* sperm,
                int num_nodes, int num_edges, float* dsrc, float* ddst, float* partial,
                cudaStream_t stream) {
  if (num_nodes <= 0 || num_edges <= 0 || heavy_cap <= 0 || s_heavy_cap <= 0)
    return (int)cudaErrorInvalidValue;
  const CsrRows recv{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                     heavy_masked, heavy_count, arrivals, nullptr, heavy_cap, num_nodes};
  const CsrRows send{sptr,      schunk_ptr, schunk_row,     sheavy_chunks,
                     sheavy_masked, s_heavy_count, sarrivals, sperm, s_heavy_cap, num_nodes};
#define TAIL(NB, NEG) \
  launch_tail<NB, NEG>(vec, ddeg, senders, recv, send, num_edges, dsrc, ddst, partial, stream)
  cudaError_t err = cudaErrorInvalidValue;
  if (branches == 2) err = TAIL(2, false);
  else if (branches == 1) err = negate ? TAIL(1, true) : TAIL(1, false);
#undef TAIL
  return (int)err;
}

}  // extern "C"
