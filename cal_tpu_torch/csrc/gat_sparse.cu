// Sparse multi-head GAT kernels for Hopper (sm_90a): the softmax row
// statistics (K8), the coefficient SpMM with the attention weights rebuilt
// per edge and head, over the receiver CSR for the forward and over the
// sender CSR for dxh (K9, K9T), and the SDDMM chain of the backward (K10).
//
// Replaces (cal_tpu/ops/pallas_spmm.py, behind cal_tpu/ops/gat.py
// gat_aggregate_sparse_fused):
//   K8   _gat_max_call + _gat_den_call (one pass)    -> gat_row_stats_launch
//   K9   _gat_coef_spmm_call, m_on_receiver=True     -> gat_coef_spmm_launch, perm null
//   K9T  _gat_coef_spmm_call on tiles_bwd (dx)       -> gat_coef_spmm_launch, perm given
//   K10  _gat_sddmm_chain_call                       -> gat_sddmm_chain_launch
//
// Contract.  An edge e = (s -> r) is live when edge_mask[e] and s != r;
// heads h = 0..NH-1, planes tj, ti, m, dD are [NH, V] f32, features
// [V, H] with H = NH * d (head h owns columns h*d .. h*d+d-1).
//   pre_e,h = tj[h][s] + ti[h][r], score = leaky_relu(pre, 0.2);
//   K8:  m[h][r]  = max(leaky_relu(ti[h][r] + tj[h][r]), max over live in-edges
//                   of score)  (the self score folded in, as ops/gat.py:277-278),
//        den[h][r] = sum over live in-edges of exp(score - m[h][r])  (no self term;
//                   +0 for a row without a live in-edge);
//   q_e,h = exp(score - m[h][r]) on live edges, times keep_e,h / (1 - rate)
//   when dropout is on; keep_e,h is the murmur-style hash of the edge id
//   (e * NH + h, salt 0) of cal_tpu/ops/gat.py _keep_mask, bit for bit;
//   K9:  out[r][h*d + f] = sum over live in-edges of q_e,h * x[s][h*d + f];
//   K9T: out[s][h*d + f] = sum over live out-edges of q_e,h * x[r][h*d + f]
//        (the same q: tj at the sender, ti and m at the receiver);
//   K10: dqm_e,h = <w[r, head h], x[s, head h]> (times keep / (1 - rate)),
//        dq = dqm + dD[h][r], dpre = q * dq * (pre > 0 ? 1 : 0.2) (q without
//        the keep factor); dti[h][r] = sum of dpre by receiver, dtj[h][s] by
//        sender.
//
// Rounding: x (K9, K10) is stored in the model dtype (f32 or bf16); the
// planes, w, q, every product and sum and every output are f32.  The plain
// twins in ops/gat_sparse.py round at exactly these points.  cal_tpu's bf16
// tile plans also round the gathered planes, w and each message to bf16:
// the port does not.  m is a max, exact in any order; den, dti and dtj are
// sums in the walk's order (a lane's edges, the group's shuffle tree, a
// heavy row's chunks in order), not the twin's, so they may differ from it
// (and from earlier designs of these kernels) in the last bits; K10 scales a
// kept dot product by 1 / (1 - rate), the twin divides by 1 - rate.
//
// Design.  K8, K9, K9T and K10 run on csr_rows.cuh's items (graph.EdgeCsr):
// a light row (one chunk, at most 32 edges; most rows of a real batch hold
// 1-4) is one lane group's item, several a warp; the chunks of a heavy row,
// listed on the host (heavy_chunks), are the first items of the launch,
// each writing f32 partials, and the row's last chunk to arrive (an int
// counter in EdgeCsr.arrivals, 0 again when the launch ends) combines them
// in chunk order and writes the row.  No pass visits all V rows, and no
// float is summed atomically: a result does not change between runs.
//  - K8, one launch: a light row is a group of kStatsGroup lanes; each lane
//    reads its edges' sender, mask and NH sender halves once and keeps the
//    scores in registers, the group takes the max (from the self score) and
//    then the exponential sums against it.  A heavy chunk is a warp's item:
//    each lane merges (max, sum) online over its edges, the warp merges its
//    lanes, and the row's last chunk takes m = max_c m_c and l = sum in chunk
//    order of l_c exp(m_c - m).  A chunk of masked edges alone (heavy_masked:
//    the padded run at node V-1) is not walked: its pair is (self score, 0).
//  - K9 and K9T, one launch each: csr_rows.cuh's coefficient SpMM walk
//    (csr_spmm_kernel, as K2, K3, K11, K14 and K19) with the GatSpmm policy,
//    32 bytes of x a lane (4 rows a warp at H = 128 in bf16, 2 in f32).  The
//    group reads a window's metadata (senders or receivers, mask, and for
//    K9T perm), lists its live edges with a ballot, and each lane forms the
//    weight q of its own head for each live edge after the ballot (one
//    gather of tj, or of ti and m at the receiver for K9T, one exp, one keep
//    hash) while it loads the edge's neighbour row, then its FMAs; a heavy
//    masked chunk is not walked (its partial is 0).  Forming all NH weights on the edge's own
//    lane before the ballot, as K10 forms dpre, was 17-27% slower: a level
//    of dependent gathers and NH shuffles more.  The transposed mode walks
//    the sender CSR through perm, so q and the keep bit stay keyed on the
//    forward edge id: both walks draw the same bit.  The float operations
//    of q and the fmaf order per feature are the first port's (a warp a
//    chunk and a combine pass over all V rows), so the outputs equal it bit
//    for bit.
//  - K10, two launches.  The receiver pass is csr_spmm_kernel's lane-group
//    walk with wider lanes (ChainShape: 32 bytes of x a lane, G = H / F
//    lanes an item, 4 rows a warp at H = 128 in bf16): the group keeps w[r]
//    in registers, reads a window's metadata and sender halves at once,
//    lists its live edges with a ballot, loads the neighbour rows x[s] of
//    kChainInFlight of them before their dot products, reduces each head's
//    over the head's lanes, and the edge's own lane forms dpre (a window
//    slot empty in the whole warp is skipped), stores it to the edge plane
//    ([E, NH], one 16-byte store at NH = 4) and adds it to the row's dti; a
//    heavy masked chunk stores zeros there.  Instruction count, not latency,
//    bounds this pass (every lane of a group runs its slot's NH heads of
//    dpre), so wider lanes, more rows a warp, and registers enough for them
//    (2 blocks an SM) beat occupancy.  The sender pass is csr_reduce_kernel with SumOp over
//    the sender CSR: an edge's NH values in one load through perm, a light
//    sender a 4-lane group's, heavy senders by chunk (a chunk of masked edges
//    alone not read: its values are 0), finished by g.send's arrivals.
// K8, K9 and K10's receiver pass share g.recv's counters on one stream, K9T
// and K10's sender sums g.send's.
//
// Bound: bytes.  K8 reads two planes, 5 bytes of metadata per edge and NH
// sender halves per live edge (mostly from L2) and writes two planes; K9
// reads x [V, H] (a neighbour row per live edge, mostly from L2), three
// planes and the metadata (K9T: perm too) and writes [V, H] f32; K10 reads x and w, the planes and the metadata of both CSRs and
// writes NH f32 per edge and two planes; H FMAs and NH exponentials per edge
// are far below the FMA or SFU floor.  The walks' own limit is latency: a
// light row is a chain of dependent loads (ptr, metadata, sender halves or
// neighbour rows, store).
//
// The constants below (K8's 4-lane groups and 4 blocks an SM; K10's 32-byte
// lanes, 2 neighbour rows in flight and 2 blocks an SM; the [E, NH] edge
// plane; tj read from its [NH, V] planes; K9's weights formed after the
// ballot and its 32-byte lanes; K9T's ti and m read from their planes) are
// the measured winners: PERF.md gives the times of the alternatives (an
// online (max, sum) merge for K8's light rows, an [NH, E] edge plane, a [V,
// NH] copy of tj, a [V, NH, 2] copy of K9T's ti and m, K9's weights formed
// before the ballot, 16-byte lanes, other group, block and in-flight
// counts).
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in
// ops/gat_sparse.py allocate every output and scratch buffer and pass
// PyTorch's stream.
#include <type_traits>

#include "csr_rows.cuh"

namespace {

constexpr float kNegSlope = 0.2f;   // PyG 1.1.0 GATConv negative_slope
constexpr int kStatsGroup = 4;      // lanes of a K8 light row
constexpr int kStatsBlocks = 4;     // K8's blocks an SM (__launch_bounds__)
constexpr int kChainBlocks = 2;     // K10 receiver pass's blocks an SM
constexpr int kChainInFlight = 2;   // neighbour rows K10 loads before their products

__device__ __forceinline__ float leaky(float p) { return p >= 0.0f ? p : p * kNegSlope; }

// Attention dropout of edge id ``id`` (cal_tpu/ops/gat.py _mix32 /
// _keep_mask and pallas_spmm.py _hash_keep).  The 64-bit seed lies in device
// memory (seed[0] its low word, seed[1] its high word: flash_gat.seed_buffer),
// read by the kernel, so a captured launch (a CUDA graph) takes the seed the
// host wrote there before each replay.
struct Dropout {
  const uint32_t* seed;
  uint32_t thresh;
  float keep_p;   // 1 - rate
  int on;
};

constexpr uint32_t kSalt = 0x632BE59Bu;   // = ops/gat.py _SALT

// The hash's two words: the seed's low word and its high word salted by
// stream ``salt`` (ops/gat.py salted_word; 0: the edges, 1: the self loops,
// which ops/gat_sparse.py draws); (0, 0) with dropout off, reading nothing.
struct KeepWords {
  uint32_t s0, s1;
};

__device__ __forceinline__ KeepWords keep_words(const Dropout& d, uint32_t salt) {
  if (!d.on) return KeepWords{0u, 0u};
  return KeepWords{__ldg(d.seed), __ldg(d.seed + 1) + kSalt * salt};
}

__device__ __forceinline__ bool keep_bit(uint32_t id, KeepWords w, uint32_t thresh) {
  uint32_t x = id * 0x9E3779B9u + w.s0;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x = x ^ (x >> 13) ^ w.s1;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < thresh;
}

// The sender halves tj[h][s] of node s, every head, from the [NH, V] planes.
template <int NH>
__device__ __forceinline__ void tj_at(const float* __restrict__ tj, int s, size_t V,
                                      float (&t)[NH]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) t[h] = __ldg(tj + h * V + s);
}

// ---- K8: per-receiver max and exponential sum ----------------------------

struct StatsArgs : CsrRows {
  const float* tj;            // [NH, V]
  const float* ti;            // [NH, V]
  const int* senders;         // receiver CSR order = edge order
  const uint8_t* edge_mask;
  float* m;                   // [NH, V]
  float* den;                 // [NH, V]
  float* partial;             // [heavy_cap, 2 NH]: a heavy chunk's (m_c, l_c) per head
};

// One score into a running (max, sum of exp(score - max)) pair.
__device__ __forceinline__ void online_add(float& mx, float& l, float sc) {
  if (sc > mx) {
    l = l * expf(mx - sc) + 1.0f;
    mx = sc;
  } else {
    l += expf(sc - mx);
  }
}

// The (max, sum) pairs of the lanes of each group of G lanes merged: every
// lane ends with its group's pair (a fixed shuffle order).
template <int NH, int G>
__device__ __forceinline__ void merge_pairs(float (&mx)[NH], float (&l)[NH]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float m = mx[h];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    l[h] *= expf(mx[h] - m);
    mx[h] = m;
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) l[h] += __shfl_xor_sync(kFull, l[h], off);
  }
}

// Row r's receiver halves and self scores, the start of its max.
template <int NH>
__device__ __forceinline__ void stats_row(const StatsArgs& a, int r, float (&ti_r)[NH],
                                          float (&mx)[NH], float (&l)[NH]) {
  const size_t V = a.num_nodes;
  float t[NH];
  tj_at<NH>(a.tj, r, V, t);
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    ti_r[h] = __ldg(a.ti + h * V + r);
    mx[h] = leaky(ti_r[h] + t[h]);
    l[h] = 0.0f;
  }
}

// The live edges at CSR positions i0, i0 + step, ... < end of row r merged
// online into (mx, l).
template <int NH>
__device__ __forceinline__ void stats_online(const StatsArgs& a, int r, int i0, int end,
                                             int step, const float (&ti_r)[NH],
                                             float (&mx)[NH], float (&l)[NH]) {
  const size_t V = a.num_nodes;
  for (int i = i0; i < end; i += step) {
    const int s = a.senders[i];
    if (a.edge_mask[i] && s != r) {
      float t[NH];
      tj_at<NH>(a.tj, s, V, t);
#pragma unroll
      for (int h = 0; h < NH; ++h) online_add(mx[h], l[h], leaky(t[h] + ti_r[h]));
    }
  }
}

// A heavy chunk, a warp: its (m_c, l_c) pairs, then, for the row's last
// chunk to arrive, the row from all of them.
template <int NH>
__device__ __forceinline__ void stats_heavy_chunk(const StatsArgs& a, int item, int lane) {
  const int c = a.heavy_chunks[item];
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int r = k.row;
  const size_t V = a.num_nodes;
  const int i0 = item - (c - a.chunk_ptr[r]);   // the row's first chunk on the list
  float ti_r[NH], mx[NH], l[NH];
  stats_row<NH>(a, r, ti_r, mx, l);
  if (!a.heavy_masked[item]) stats_online<NH>(a, r, k.beg + lane, k.end, 32, ti_r, mx, l);
  merge_pairs<NH, 32>(mx, l);
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      a.partial[(size_t)item * 2 * NH + h] = mx[h];
      a.partial[(size_t)item * 2 * NH + NH + h] = l[h];
    }
    __threadfence();
  }
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(a.arrivals + i0, 1) == k.count - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  // lanes j and j + 32 hold chunks j and j + 32 of the row (at most 64)
  const int n = k.count;
  const float* p = a.partial + (size_t)i0 * 2 * NH;
  const float kNegInf = __int_as_float(0xff800000u);
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float m0 = lane < n ? __ldcg(p + lane * 2 * NH + h) : kNegInf;
    const float m1 = lane + 32 < n ? __ldcg(p + (lane + 32) * 2 * NH + h) : kNegInf;
    float mr = fmaxf(m0, m1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mr = fmaxf(mr, __shfl_xor_sync(kFull, mr, off));
    const float t0 = lane < n ? __ldcg(p + lane * 2 * NH + NH + h) * expf(m0 - mr) : 0.0f;
    const float t1 =
        lane + 32 < n ? __ldcg(p + (lane + 32) * 2 * NH + NH + h) * expf(m1 - mr) : 0.0f;
    float sum = 0.0f;   // in chunk order
    for (int j = 0; j < n; ++j) sum += __shfl_sync(kFull, j < 32 ? t0 : t1, j & 31);
    if (lane == 0) {
      a.m[h * V + r] = mr;
      a.den[h * V + r] = sum;
    }
  }
  if (lane == 0) a.arrivals[i0] = 0;
}

// Warps [0, live_heavy) take the heavy chunks, a warp each; the others take
// the rows, 32 / kStatsGroup a warp (a heavy row's group idles), and the
// grid's last (the heavy list's unused capacity) return.
template <int NH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kStatsBlocks)
gat_row_stats_kernel(const StatsArgs a) {
  constexpr int G = kStatsGroup, K = kGroup / G;   // a lane's edges of a light row
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int nh = live_heavy(a);
  if (warp < nh) {
    stats_heavy_chunk<NH>(a, warp, lane);
    return;
  }
  const int first = (warp - nh) * (32 / G);
  if (first >= a.num_nodes) return;
  const int r = first + lane / G, gl = lane % G;
  const size_t V = a.num_nodes;
  int beg = 0, end = 0;
  if (r < a.num_nodes) {
    beg = a.ptr[r];
    end = a.ptr[r + 1];
  }
  const bool light = r < a.num_nodes && end - beg <= kGroup;
  if (!light) end = beg;
  float ti_r[NH], mx[NH], l[NH];
  stats_row<NH>(a, min(r, a.num_nodes - 1), ti_r, mx, l);
  // every edge's metadata, then every live edge's sender halves, in flight
  // together; the scores stay in registers between the max and the sums
  int s[K];
  bool live[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = beg + gl + k * G;
    s[k] = 0;
    live[k] = false;
    if (i < end) {
      s[k] = a.senders[i];
      live[k] = a.edge_mask[i] && s[k] != r;
    }
  }
  float sc[K][NH];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live[k]) {
      tj_at<NH>(a.tj, s[k], V, sc[k]);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        sc[k][h] = leaky(sc[k][h] + ti_r[h]);
        mx[h] = fmaxf(mx[h], sc[k][h]);
      }
    }
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], off));
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live[k])
#pragma unroll
      for (int h = 0; h < NH; ++h) l[h] += expf(sc[k][h] - mx[h]);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) l[h] += __shfl_xor_sync(kFull, l[h], off);
  if (light && gl == 0)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      a.m[h * V + r] = mx[h];
      a.den[h * V + r] = l[h];
    }
}

template <int NH>
cudaError_t launch_row_stats(const StatsArgs& a, cudaStream_t stream) {
  const int warps = a.heavy_cap + (a.num_nodes + 32 / kStatsGroup - 1) / (32 / kStatsGroup);
  gat_row_stats_kernel<NH><<<(warps + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32,
                             0, stream>>>(a);
  return cudaGetLastError();
}

// ---- K9 / K9T: coefficient SpMM with the weights rebuilt per edge --------

// The csr_spmm_kernel policy of K9 (TRANS false: the receiver CSR, the row
// the receiver r) and K9T (TRANS true: the sender CSR through perm, the row
// the sender s): one branch, NH heads, an edge live when its mask is on and
// it is no self loop; q = exp(leaky(tj[s] + ti[r]) - m[r]) per head, divided
// by keep_p where the keep bit of the forward edge id holds, 0 where not.
// Each lane of a group forms its own head's q of a live edge after the
// ballot (kLateCoef), beside the neighbour row's load; 32 bytes of x a lane
// (kLaneBytes: 4 rows a warp at H 128 in bf16, 2 in f32).
template <typename T, int NH, bool TRANS>
struct GatSpmm : CsrRows {
  using Elem = T;
  static constexpr int kBranches = 1;
  static constexpr int kHeads = NH;
  static constexpr bool kMaskedDead = true;
  static constexpr bool kLateCoef = true;
  static constexpr int kLaneBytes = 32;
  // At H = 128 (Q 4) the walk keeps the blocks an SM of its first design:
  // reading the heavy count and the seed on the card took K9 from 80 to 88
  // registers (3 blocks an SM to 2) and K9T from 64 to 68 (4 to 3), and
  // both ran 10-19% slower cold; bounded, neither spills there (PERF.md
  // section 6).  Other widths keep ptxas' own choice.
  static constexpr int min_blocks(int q) { return q == 4 ? (TRANS ? 4 : 3) : 1; }
  const T* x[1];            // [V, H]: xh (K9) or w (K9T)
  const float* tj;          // [NH, V]
  const float* ti;
  const float* m;
  const int* nbr;           // senders (receiver CSR) or receivers (sender CSR)
  const uint8_t* edge_mask;
  float* out;               // [V, H]
  float* partial;           // [heavy_cap, H]
  int h;
  Dropout drop;

  // the row's side of the lane's head: ti[r] and m[r] (K9) or tj[s] (K9T)
  struct Row {
    int r, head;
    float rt, rm;
  };

  __device__ __forceinline__ Row row(int r, int head) const {
    const size_t V = num_nodes;
    return Row{r, head, __ldg((TRANS ? tj : ti) + head * V + r),
               TRANS ? 0.0f : __ldg(m + head * V + r)};
  }

  __device__ __forceinline__ bool edge(int e, const Row& row, int& s) const {
    s = nbr[e];
    return edge_mask[e] && s != row.r;
  }

  // the neighbour's side: tj at the sender (K9) or ti and m at the receiver
  // (K9T); the parent design's float operations, so the same bits.  The
  // keep hash's words are read here, edge by edge (L1 hits).
  __device__ __forceinline__ float coef(int e, int nb, const Row& row) const {
    const size_t V = num_nodes;
    const float pre = TRANS ? row.rt + __ldg(ti + row.head * V + nb)
                            : __ldg(tj + row.head * V + nb) + row.rt;
    const float mr = TRANS ? __ldg(m + row.head * V + nb) : row.rm;
    float w = expf(leaky(pre) - mr);
    if (drop.on)
      w = keep_bit((uint32_t)e * NH + row.head, keep_words(drop, 0), drop.thresh)
              ? w / drop.keep_p : 0.0f;
    return w;
  }

  template <int F>
  __device__ __forceinline__ void write_row(int r, int lane, const float (&acc)[1][F]) const {
    store_vec<float, F>(out + (size_t)r * h + lane * F, acc[0]);
  }
};

// ---- K10: the SDDMM chain of the backward --------------------------------

template <typename T>
struct GatChainArgs : CsrRows {
  const T* x;                 // [V, H] xh
  const float* w;             // [V, H] gout / denom
  const float* tj;            // [NH, V]
  const float* ti;            // [NH, V]
  const float* m;
  const float* dD;
  const int* senders;         // receiver CSR order = edge order
  const uint8_t* edge_mask;
  float* edge_out;            // each edge's dpre: [E, NH]
  float* dti;                 // [NH, V]
  float* partial;             // [heavy_cap, NH]: a heavy chunk's dti sums
  int h;
  Dropout drop;
};

// K10's lane group: 32 bytes of x a lane, so at H = 128 4 rows a warp in
// bf16 and 2 in f32 (the walk's 16 bytes give half that: each lane's dpre
// work would be spent on fewer rows).
template <typename T, int Q, int NH>
using ChainShape = LightShape<T, Q, NH, 32>;

// The receiver pass: one item a lane group, 32 / G a warp, as
// csr_spmm_kernel (items [0, live_heavy) the heavy chunks, partial i for
// item i; the others the rows, a heavy row's group idle).
template <typename T, int NH, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kChainBlocks)
gat_chain_kernel(const GatChainArgs<T> a) {
  using S = ChainShape<T, Q, NH>;
  constexpr int F = S::F, G = S::G, W = kWindowEdges / G;
  constexpr int kLph = 32 * Q / NH / F;   // lanes of one head
  constexpr int U = kChainInFlight;
  constexpr int kWords = F * sizeof(T) / 4;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  const int nh = live_heavy(a);
  if (first >= nh + a.num_nodes) return;
  const int gl = lane % G, base = lane - gl;
  const unsigned gbits = G == 32 ? kFull : (1u << G) - 1u;
  const int item = first + lane / G;
  // a chunk of masked-out edges alone is not walked: its edges' dpre are 0
  const CsrItem it = csr_item(a, nh, item, true);
  const int r = it.r, wend = it.wend;
  const size_t V = a.num_nodes;
  const int rr = min(r, a.num_nodes - 1);
  float wr[F];
  load_vec<float, F>(a.w + (size_t)rr * a.h + gl * F, wr);
  const float inv_keep = 1.0f / a.drop.keep_p;
  const KeepWords kw = keep_words(a.drop, 0);   // the edges' stream
  float ti_r[NH], m_r[NH], dd_r[NH], acc[NH];
#pragma unroll
  for (int hd = 0; hd < NH; ++hd) {
    ti_r[hd] = __ldg(a.ti + hd * V + rr);
    m_r[hd] = __ldg(a.m + hd * V + rr);
    dd_r[hd] = __ldg(a.dD + hd * V + rr);
    acc[hd] = 0.0f;
  }
  for (int w0 = it.beg; __any_sync(kFull, w0 < wend); w0 += W * G) {
    // the window's metadata and the live edges' sender halves, in flight
    // together (past the range a lane reads nothing and is never live)
    int s_l[W];
    bool live[W];
    float tjs[W][NH], dqm[W][NH];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = w0 + k * G + gl;
      s_l[k] = 0;
      live[k] = false;
      if (i < wend) {
        s_l[k] = a.senders[i];
        live[k] = a.edge_mask[i] && s_l[k] != r;
      }
#pragma unroll
      for (int hd = 0; hd < NH; ++hd) dqm[k][hd] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (live[k]) tj_at<NH>(a.tj, s_l[k], V, tjs[k]);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      unsigned msk = (__ballot_sync(kFull, live[k]) >> base) & gbits;
      while (__any_sync(kFull, msk != 0)) {
        // the next U live edges of the group, in edge order: their neighbour
        // rows loaded, then their dot products with w[r], reduced per head;
        // the edge's own lane keeps its NH values
        bool ok[U];
        int j[U];
        uint32_t xs[U][kWords];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ok[u] = msk != 0;
          j[u] = base + (ok[u] ? __ffs(msk) - 1 : 0);
          msk &= msk - 1;
          const int s = __shfl_sync(kFull, s_l[k], j[u]);
          if (ok[u]) load_words<T, F>(a.x + (size_t)s * a.h + gl * F, xs[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.0f;
          if (ok[u])
#pragma unroll
            for (int f = 0; f < F; ++f) p = fmaf(wr[f], word_elem<T>(xs[u], f), p);
#pragma unroll
          for (int off = kLph / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
#pragma unroll
          for (int hd = 0; hd < NH; ++hd) {
            const float t = __shfl_sync(kFull, p, base + hd * kLph);
            if (ok[u] && lane == j[u]) dqm[k][hd] = t;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = w0 + k * G + gl;
      if (!__any_sync(kFull, i < wend)) continue;   // a slot past every item's range
      float dp[NH] = {};
      if (live[k])
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) {
          const float pre = tjs[k][hd] + ti_r[hd];
          const float q = expf(leaky(pre) - m_r[hd]);
          float d = dqm[k][hd];
          if (a.drop.on)
            d = keep_bit((uint32_t)i * NH + hd, kw, a.drop.thresh) ? d * inv_keep : 0.0f;
          dp[hd] = q * (d + dd_r[hd]) * (pre > 0.0f ? 1.0f : kNegSlope);
          acc[hd] += dp[hd];
        }
      if (i < wend) store_vec<float, NH>(a.edge_out + (size_t)i * NH, dp);
    }
  }
  if (it.masked) {
    const float zero[NH] = {};
    for (int i = it.beg + gl; i < it.end; i += G)
      store_vec<float, NH>(a.edge_out + (size_t)i * NH, zero);
  }
  finish_item<NH, G>(a, it, item, gl, acc, a.dti, a.partial);
}

template <typename T, int NH, int Q>
cudaError_t launch_chain(const GatChainArgs<T>& a, cudaStream_t stream) {
  using S = ChainShape<T, Q, NH>;
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / S::G;
  const int items = a.heavy_cap + a.num_nodes;
  gat_chain_kernel<T, NH, Q><<<(items + kItemsPerBlock - 1) / kItemsPerBlock,
                               kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// Calls fn(integral_constant<NH>, integral_constant<F>) for NH, F in {1, 2, 4, 8}.
template <int NH, typename Fn>
cudaError_t with_f(int f, Fn&& fn) {
  switch (f) {
    case 1: return fn(std::integral_constant<int, NH>{}, std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, NH>{}, std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, NH>{}, std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, NH>{}, std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Fn>
cudaError_t with_heads_f(int nh, int f, Fn&& fn) {
  switch (nh) {
    case 1: return with_f<1>(f, fn);
    case 2: return with_f<2>(f, fn);
    case 4: return with_f<4>(f, fn);
    case 8: return with_f<8>(f, fn);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_heads(int heads) { return heads == 1 || heads == 2 || heads == 4 || heads == 8; }

bool valid_width(int heads, int h) {
  return valid_heads(heads) && h > 0 && h % 32 == 0 && valid_heads(h / 32);
}

Dropout make_dropout(const void* seed, unsigned thresh, float keep_p, int on) {
  Dropout d;
  d.seed = static_cast<const uint32_t*>(seed);
  d.thresh = thresh;
  d.keep_p = keep_p;
  d.on = on;
  return d;
}

template <typename T, bool TRANS>
cudaError_t gat_spmm_typed(const void* x, const float* tj, const float* ti, const float* m,
                           int heads, const int* nbr, const uint8_t* edge_mask,
                           const CsrRows& csr, int h, const Dropout& drop, float* out,
                           float* partial, cudaStream_t stream) {
  auto go = [&](auto nh) {
    GatSpmm<T, decltype(nh)::value, TRANS> a;
    static_cast<CsrRows&>(a) = csr;
    a.x[0] = static_cast<const T*>(x);
    a.tj = tj;
    a.ti = ti;
    a.m = m;
    a.nbr = nbr;
    a.edge_mask = edge_mask;
    a.out = out;
    a.partial = partial;
    a.h = h;
    a.drop = drop;
    return launch_csr_spmm(a, stream);
  };
  switch (heads) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gat_chain_typed(GatChainArgs<T>& a, const void* x, int heads, cudaStream_t stream) {
  a.x = static_cast<const T*>(x);
  return with_heads_f(heads, a.h / 32, [&](auto nh, auto q) {
    return launch_chain<T, decltype(nh)::value, decltype(q)::value>(a, stream);
  });
}

}  // namespace

extern "C" {

// K8.  tj, ti [heads, V] f32; the receiver CSR (graph.EdgeCsr: ptr,
// chunk_ptr, chunk_row, heavy_chunks and heavy_masked of heavy_cap entries,
// heavy_count [1] on the card, their live count, and arrivals: heavy_cap
// ints, 0 before the launch and after it) and its senders.  Writes m and den
// [heads, V] f32; partial holds 2 * heads * heavy_cap floats.  One launch.
int gat_row_stats_launch(const float* tj, const float* ti, int heads, const int* senders,
                         const uint8_t* edge_mask, const int* ptr, const int* chunk_ptr,
                         const int* chunk_row, const int* heavy_chunks,
                         const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                         int* arrivals, int num_nodes, float* m, float* den, float* partial,
                         cudaStream_t stream) {
  if (num_nodes <= 0 || heavy_cap <= 0 || !valid_heads(heads))
    return (int)cudaErrorInvalidValue;
  StatsArgs a;
  static_cast<CsrRows&>(a) = CsrRows{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                                     heavy_masked, heavy_count, arrivals, nullptr, heavy_cap,
                                     num_nodes};
  a.tj = tj;
  a.ti = ti;
  a.senders = senders;
  a.edge_mask = edge_mask;
  a.m = m;
  a.den = den;
  a.partial = partial;
  switch (heads) {
    case 1: return (int)launch_row_stats<1>(a, stream);
    case 2: return (int)launch_row_stats<2>(a, stream);
    case 4: return (int)launch_row_stats<4>(a, stream);
    default: return (int)launch_row_stats<8>(a, stream);
  }
}

// K9 / K9T.  dtype: 0 = float32, 1 = bfloat16 (x).  Forward (K9): perm
// null, nbr = senders, the receiver CSR.  Transposed (K9T): perm = the sender
// CSR's perm, nbr = receivers, the sender CSR.  The CSR as
// gat_row_stats_launch takes it (its heavy chunks, their masks, their
// capacity and live count and its arrival counters).  tj, ti, m [heads, V]
// f32 in the forward's roles either way.  Dropout (drop != 0): keep an
// edge's head h when the hash of e * heads + h under the seed's low word and
// its high word (salt 0) is below thresh, and divide its weight by keep_p;
// seed: the 64-bit seed on the card (8 bytes, the low word first), read by
// the kernel.  Writes out [V, h] f32; partial holds h * heavy_cap floats.
// h % 32 == 0, h / 32 and heads in {1, 2, 4, 8}; x rows aligned to a light
// lane's load (csr_rows.cuh LightShape).  One launch.
int gat_coef_spmm_launch(const void* x, int dtype, const float* tj, const float* ti,
                         const float* m, int heads, const int* nbr, const int* perm,
                         const uint8_t* edge_mask, const int* ptr, const int* chunk_ptr,
                         const int* chunk_row, const int* heavy_chunks,
                         const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                         int* arrivals, int num_nodes, int h, const void* seed,
                         unsigned thresh, float keep_p, int drop, float* out, float* partial,
                         cudaStream_t stream) {
  if (num_nodes <= 0 || heavy_cap <= 0 || !valid_width(heads, h) ||
      (drop != 0 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,      chunk_ptr, chunk_row, heavy_chunks,   heavy_masked, heavy_count,
                    arrivals, perm,      heavy_cap, num_nodes};
  const Dropout d = make_dropout(seed, thresh, keep_p, drop);
  auto go = [&](auto bf16, auto trans) {
    using T = std::conditional_t<decltype(bf16)::value, __nv_bfloat16, float>;
    return (int)gat_spmm_typed<T, decltype(trans)::value>(x, tj, ti, m, heads, nbr, edge_mask,
                                                          csr, h, d, out, partial, stream);
  };
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (perm == nullptr)
    return dtype == 1 ? go(std::true_type{}, std::false_type{})
                      : go(std::false_type{}, std::false_type{});
  return dtype == 1 ? go(std::true_type{}, std::true_type{})
                    : go(std::false_type{}, std::true_type{});
}

// K10.  dtype: 0 = float32, 1 = bfloat16 (x); w [V, h] f32; tj, ti, m, dD
// [heads, V] f32.  The receiver CSR (as gat_row_stats_launch) for the
// per-edge pass, the sender CSR (the same eight arguments, its own counters)
// and its perm for the dtj sums.  Writes edge_out (scratch: [E, heads] f32),
// dtj and dti [heads, V] f32; partial holds heads * max(heavy_cap,
// s_heavy_cap) floats.  Dropout as K9.  h % 32 == 0, h / 32 and heads in
// {1, 2, 4, 8}; x rows aligned to a light lane's load (csr_rows.cuh
// LightShape), w rows and edge_out to 16 bytes.  Two launches.
int gat_sddmm_chain_launch(const void* x, int dtype, const float* w, const float* tj,
                           const float* ti, const float* m, const float* dD, int heads,
                           const int* senders, const uint8_t* edge_mask, const int* ptr,
                           const int* chunk_ptr, const int* chunk_row, const int* heavy_chunks,
                           const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                           int* arrivals, const int* sptr, const int* schunk_ptr,
                           const int* schunk_row, const int* sheavy_chunks,
                           const uint8_t* sheavy_masked, int s_heavy_cap,
                           const int* s_heavy_count, int* sarrivals, const int* sperm,
                           int num_nodes, int num_edges, int h, const void* seed,
                           unsigned thresh, float keep_p, int drop, float* edge_out, float* dtj,
                           float* dti, float* partial, cudaStream_t stream) {
  if (num_nodes <= 0 || num_edges <= 0 || heavy_cap <= 0 || s_heavy_cap <= 0 ||
      !valid_width(heads, h) || (drop != 0 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const CsrRows recv{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                     heavy_masked, heavy_count, arrivals, nullptr, heavy_cap, num_nodes};
  auto fill = [&](auto& a) {
    static_cast<CsrRows&>(a) = recv;
    a.w = w;
    a.tj = tj;
    a.ti = ti;
    a.m = m;
    a.dD = dD;
    a.senders = senders;
    a.edge_mask = edge_mask;
    a.edge_out = edge_out;
    a.dti = dti;
    a.partial = partial;
    a.h = h;
    a.drop = make_dropout(seed, thresh, keep_p, drop);
  };
  if (dtype == 1) {
    GatChainArgs<__nv_bfloat16> a;
    fill(a);
    err = gat_chain_typed(a, x, heads, stream);
  } else if (dtype == 0) {
    GatChainArgs<float> a;
    fill(a);
    err = gat_chain_typed(a, x, heads, stream);
  }
  if (err != cudaSuccess) return (int)err;
  RowReduce rd;
  static_cast<CsrRows&>(rd) = CsrRows{sptr,      schunk_ptr, schunk_row,     sheavy_chunks,
                                      sheavy_masked, s_heavy_count, sarrivals, sperm, s_heavy_cap,
                                      num_nodes};
  rd.vals = edge_out;
  rd.num_edges = num_edges;
  rd.planes = heads;
  rd.vec = false;   // through perm
  rd.edge_major = true;
  rd.skip_masked = true;   // a dead edge's dpre is 0
  rd.out = dtj;
  rd.partial = partial;
  return (int)launch_csr_reduce<SumOp>(rd, stream);
}

}  // extern "C"
