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
//        den[h][r] = sum over live in-edges of exp(score - m[h][r])  (no self term);
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
// the port does not.
//
// Design.  As spmm.cu (csr_rows.cuh): a CSR row's edges form groups of 32,
// the groups at most 64 chunks, and one warp owns one chunk.  K8 sweeps its
// chunk twice (the max, then the exponential sums against it), each lane
// over its own edges, and reduces across the warp; a row of several chunks
// writes one (max, sum) pair per chunk and head, which a second pass
// combines as l = sum_c l_c exp(m_c - m).  K9 takes each live edge of a
// group from a ballot, broadcasts its neighbour and its NH weights, and every
// lane accumulates the H / 32 features it owns (all of one head: d is a
// multiple of H / 32); long rows write f32 partials that a second pass sums
// in chunk order.  The transposed mode walks the sender CSR through perm,
// so q and the keep bit stay keyed on the forward edge id: both walks draw
// the same bit.  K10 keeps w[r] of its row in registers, reduces each live
// edge's per-head dot products over the head's d / (H / 32) lanes, and the
// edge's own lane forms dpre, keeps the receiver sum and writes the sender
// term per edge; the sender sums are then taken over the sender CSR by
// csr_rows.cuh's sender_sum_kernel.  Every sum has one owner, no float
// atomics: a result does not change between runs.
//
// Bound: bytes.  K8 reads two planes and 5 bytes of metadata per edge; K9
// reads x [V, H] (a neighbour row per live edge, mostly from L2) and writes
// [V, H] f32; K10 reads x and w and writes NH f32 per edge; H FMAs and NH
// exponentials per edge are far below the FMA or SFU floor.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in
// ops/gat_sparse.py allocate every output and scratch buffer and pass
// PyTorch's stream.
#include <type_traits>

#include "csr_rows.cuh"

namespace {

constexpr float kNegSlope = 0.2f;   // PyG 1.1.0 GATConv negative_slope

__device__ __forceinline__ float leaky(float p) { return p >= 0.0f ? p : p * kNegSlope; }

// Attention dropout of edge (or node) id ``id`` (cal_tpu/ops/gat.py _mix32 /
// _keep_mask and pallas_spmm.py _hash_keep): s1 already holds the salt word.
struct Dropout {
  uint32_t s0, s1, thresh;
  float keep_p;   // 1 - rate
  int on;
};

__device__ __forceinline__ bool keep_bit(uint32_t id, const Dropout& d) {
  uint32_t x = id * 0x9E3779B9u + d.s0;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x = x ^ (x >> 13) ^ d.s1;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x < d.thresh;
}

// ---- K8: per-receiver max and exponential sum ----------------------------

template <int NH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_row_stats_kernel(const float* __restrict__ tj, const float* __restrict__ ti,
                     const int* __restrict__ senders, const uint8_t* __restrict__ edge_mask,
                     const int* __restrict__ ptr, const int* __restrict__ chunk_ptr,
                     const int* __restrict__ chunk_row, int n_chunks, int num_nodes,
                     float* __restrict__ m_out, float* __restrict__ den_out,
                     float* __restrict__ partial) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const Chunk k = chunk_of(c, ptr, chunk_ptr, chunk_row);
  const int r = k.row;
  const size_t V = num_nodes;
  float ti_r[NH], mx[NH], l[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    ti_r[h] = ti[h * V + r];
    mx[h] = leaky(ti_r[h] + tj[h * V + r]);      // the self score
    l[h] = 0.0f;
  }
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int s = senders[i];
    if (edge_mask[i] && s != r) {
#pragma unroll
      for (int h = 0; h < NH; ++h) mx[h] = fmaxf(mx[h], leaky(tj[h * V + s] + ti_r[h]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int h = 0; h < NH; ++h) mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], off));
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int s = senders[i];
    if (edge_mask[i] && s != r) {
#pragma unroll
      for (int h = 0; h < NH; ++h) l[h] += expf(leaky(tj[h * V + s] + ti_r[h]) - mx[h]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int h = 0; h < NH; ++h) l[h] += __shfl_xor_sync(kFull, l[h], off);
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (k.count == 1) {
        m_out[h * V + r] = mx[h];
        den_out[h * V + r] = l[h];
      } else {
        partial[2 * NH * c + h] = mx[h];
        partial[2 * NH * c + NH + h] = l[h];
      }
    }
  }
}

// (m, l) of every row of more than one chunk: m = max_c m_c, l = sum in chunk
// order of l_c exp(m_c - m).
template <int NH>
__global__ void gat_row_stats_combine(const int* __restrict__ chunk_ptr, int num_nodes,
                                      const float* __restrict__ partial,
                                      float* __restrict__ m_out, float* __restrict__ den_out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_nodes) return;
  const int c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 <= 1) return;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float mx = partial[2 * NH * c0 + h];
    for (int c = c0 + 1; c < c1; ++c) mx = fmaxf(mx, partial[2 * NH * c + h]);
    float l = 0.0f;
    for (int c = c0; c < c1; ++c)
      l += partial[2 * NH * c + NH + h] * expf(partial[2 * NH * c + h] - mx);
    m_out[(size_t)h * num_nodes + v] = mx;
    den_out[(size_t)h * num_nodes + v] = l;
  }
}

// ---- K9 / K9T: coefficient SpMM with the weights rebuilt per edge --------

template <typename T>
struct GatSpmmArgs {
  const T* x;          // [V, H]: xh (forward) or w (transposed)
  const float* tj;     // [NH, V]
  const float* ti;
  const float* m;
  const int* nbr;      // senders (receiver CSR) or receivers (sender CSR)
  const int* perm;     // null: edge i of the CSR is edge i; else edge perm[i]
  const uint8_t* edge_mask;
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* out;          // [V, H] f32
  float* partial;      // [n_chunks, H]
  int n_chunks, num_nodes, h;
  Dropout drop;
};

template <typename T, int NH, int F, bool TRANS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_coef_spmm_kernel(const GatSpmmArgs<T> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int row = k.row;
  const size_t V = a.num_nodes;
  const int my_head = lane * NH / 32;      // the lane's F features lie in one head
  // the row's side of each edge: ti and m at the receiver (forward), tj at
  // the sender (transposed)
  float rt[NH], rm[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    rt[h] = TRANS ? a.tj[h * V + row] : a.ti[h * V + row];
    rm[h] = TRANS ? 0.0f : a.m[h * V + row];
  }
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    const int i = g0 + lane;
    int nb = 0;
    bool live = false;
    float q[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) q[h] = 0.0f;
    if (i < k.end) {
      const int e = TRANS ? a.perm[i] : i;
      nb = a.nbr[e];
      live = a.edge_mask[e] && nb != row;
      if (live) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float pre = TRANS ? rt[h] + a.ti[h * V + nb] : a.tj[h * V + nb] + rt[h];
          const float mr = TRANS ? a.m[h * V + nb] : rm[h];
          float w = expf(leaky(pre) - mr);
          if (a.drop.on) w = keep_bit((uint32_t)e * NH + h, a.drop) ? w / a.drop.keep_p : 0.0f;
          q[h] = w;
        }
      }
    }
    for (unsigned msk = __ballot_sync(kFull, live); msk != 0; msk &= msk - 1) {
      const int j = __ffs(msk) - 1;
      const int s = __shfl_sync(kFull, nb, j);
      float cf = 0.0f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float t = __shfl_sync(kFull, q[h], j);
        cf = h == my_head ? t : cf;
      }
      float xs[F];
      load_vec<T, F>(a.x + (size_t)s * a.h + lane * F, xs);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(cf, xs[f], acc[f]);
    }
  }
  float* dst = k.count == 1 ? a.out + (size_t)row * a.h : a.partial + (size_t)c * a.h;
  store_vec<float, F>(dst + lane * F, acc);
}

template <typename T, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_coef_spmm_combine(const GatSpmmArgs<T> a) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= a.num_nodes) return;
  const int c0 = a.chunk_ptr[r], c1 = a.chunk_ptr[r + 1];
  if (c1 - c0 <= 1) return;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    float p[F];
    load_vec<float, F>(a.partial + (size_t)c * a.h + lane * F, p);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += p[f];
  }
  store_vec<float, F>(a.out + (size_t)r * a.h + lane * F, acc);
}

template <typename T, int NH, int F>
cudaError_t launch_gat_spmm(const GatSpmmArgs<T>& a, cudaStream_t stream) {
  const int threads = kWarpsPerBlock * 32;
  const int blocks = (a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (a.perm == nullptr)
    gat_coef_spmm_kernel<T, NH, F, false><<<blocks, threads, 0, stream>>>(a);
  else
    gat_coef_spmm_kernel<T, NH, F, true><<<blocks, threads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gat_coef_spmm_combine<T, F><<<(a.num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock, threads,
                                0, stream>>>(a);
  return cudaGetLastError();
}

// ---- K10: the SDDMM chain of the backward --------------------------------

template <typename T>
struct GatChainArgs {
  const T* x;          // [V, H] xh
  const float* w;      // [V, H] gout / denom
  const float* tj;     // [NH, V]
  const float* ti;
  const float* m;
  const float* dD;
  const int* senders;
  const uint8_t* edge_mask;
  const int* ptr;      // receiver CSR
  const int* chunk_ptr;
  const int* chunk_row;
  float* edge_out;     // [NH, E]: each edge's dpre, summed by sender afterwards
  float* dti;          // [NH, V]
  float* partial;      // [n_chunks, NH]
  int n_chunks, num_nodes, num_edges, h;
  Dropout drop;
};

template <typename T, int NH, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_sddmm_chain_kernel(const GatChainArgs<T> a) {
  constexpr int kLanesPerHead = 32 / NH;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int r = k.row;
  const size_t V = a.num_nodes, E = a.num_edges;
  float wr[F];
  load_vec<float, F>(a.w + (size_t)r * a.h + lane * F, wr);
  float ti_r[NH], m_r[NH], dd_r[NH], acc[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    ti_r[h] = a.ti[h * V + r];
    m_r[h] = a.m[h * V + r];
    dd_r[h] = a.dD[h * V + r];
    acc[h] = 0.0f;
  }
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    const int i = g0 + lane;
    int s_l = 0;
    bool live = false;
    if (i < k.end) {
      s_l = a.senders[i];
      live = a.edge_mask[i] && s_l != r;
    }
    // each live edge's per-head dot products, reduced over the head's lanes;
    // the edge's own lane keeps them
    float dqm[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) dqm[h] = 0.0f;
    for (unsigned msk = __ballot_sync(kFull, live); msk != 0; msk &= msk - 1) {
      const int j = __ffs(msk) - 1;
      const int s = __shfl_sync(kFull, s_l, j);
      float xs[F];
      load_vec<T, F>(a.x + (size_t)s * a.h + lane * F, xs);
      float p = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) p = fmaf(wr[f], xs[f], p);
#pragma unroll
      for (int off = kLanesPerHead / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float t = __shfl_sync(kFull, p, h * kLanesPerHead);
        if (lane == j) dqm[h] = t;
      }
    }
    if (i < k.end) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float dpre = 0.0f;
        if (live) {
          const float pre = a.tj[h * V + s_l] + ti_r[h];
          const float q = expf(leaky(pre) - m_r[h]);
          float d = dqm[h];
          if (a.drop.on) d = keep_bit((uint32_t)i * NH + h, a.drop) ? d / a.drop.keep_p : 0.0f;
          dpre = q * (d + dd_r[h]) * (pre > 0.0f ? 1.0f : kNegSlope);
        }
        a.edge_out[h * E + i] = dpre;
        acc[h] += dpre;
      }
    }
  }
  finish_row<NH>(acc, k, c, lane, a.num_nodes, a.dti, a.partial);
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

Dropout make_dropout(unsigned s0, unsigned s1, unsigned thresh, float keep_p, int on) {
  Dropout d;
  d.s0 = s0;
  d.s1 = s1;
  d.thresh = thresh;
  d.keep_p = keep_p;
  d.on = on;
  return d;
}

template <typename T>
cudaError_t gat_spmm_typed(const void* x, const float* tj, const float* ti, const float* m,
                           int heads, const int* nbr, const int* perm, const uint8_t* edge_mask,
                           const int* ptr, const int* chunk_ptr, const int* chunk_row,
                           int n_chunks, int num_nodes, int h, const Dropout& drop, float* out,
                           float* partial, cudaStream_t stream) {
  GatSpmmArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.tj = tj;
  a.ti = ti;
  a.m = m;
  a.nbr = nbr;
  a.perm = perm;
  a.edge_mask = edge_mask;
  a.ptr = ptr;
  a.chunk_ptr = chunk_ptr;
  a.chunk_row = chunk_row;
  a.out = out;
  a.partial = partial;
  a.n_chunks = n_chunks;
  a.num_nodes = num_nodes;
  a.h = h;
  a.drop = drop;
  return with_heads_f(heads, h / 32, [&](auto nh, auto f) {
    return launch_gat_spmm<T, decltype(nh)::value, decltype(f)::value>(a, stream);
  });
}

template <typename T>
cudaError_t gat_chain_typed(GatChainArgs<T>& a, const void* x, int heads, cudaStream_t stream) {
  a.x = static_cast<const T*>(x);
  return with_heads_f(heads, a.h / 32, [&](auto nh, auto f) {
    constexpr int NH = decltype(nh)::value, F = decltype(f)::value;
    gat_sddmm_chain_kernel<T, NH, F><<<(a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                                       kWarpsPerBlock * 32, 0, stream>>>(a);
    return cudaGetLastError();
  });
}

template <int NH>
cudaError_t launch_row_stats(const float* tj, const float* ti, const int* senders,
                             const uint8_t* edge_mask, const int* ptr, const int* chunk_ptr,
                             const int* chunk_row, int n_chunks, int num_nodes, float* m,
                             float* den, float* partial, cudaStream_t stream) {
  gat_row_stats_kernel<NH><<<(n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                             kWarpsPerBlock * 32, 0, stream>>>(
      tj, ti, senders, edge_mask, ptr, chunk_ptr, chunk_row, n_chunks, num_nodes, m, den,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gat_row_stats_combine<NH><<<(num_nodes + 255) / 256, 256, 0, stream>>>(chunk_ptr, num_nodes,
                                                                         partial, m, den);
  return cudaGetLastError();
}

// K10's two row sums: dti over its receiver chunks, dtj over the sender CSR.
template <int NH>
cudaError_t launch_chain_sums(float* dti, const float* edge_out, int num_nodes, int num_edges,
                              const int* chunk_ptr, const int* sptr, const int* schunk_ptr,
                              const int* schunk_row, const int* sperm, int s_chunks, float* dtj,
                              float* partial, cudaStream_t stream) {
  cudaError_t err = launch_combine<NH>(chunk_ptr, num_nodes, partial, dti, stream);
  if (err != cudaSuccess) return err;
  return launch_sender_sum<NH>(edge_out, num_edges, sperm, sptr, schunk_ptr, schunk_row,
                               s_chunks, num_nodes, dtj, partial, stream);
}

}  // namespace

extern "C" {

// K8.  tj, ti [heads, V] f32; the receiver CSR (edges in row order) and its
// senders.  Writes m and den [heads, V] f32; partial holds 2 * heads *
// n_chunks floats.
int gat_row_stats_launch(const float* tj, const float* ti, int heads, const int* senders,
                         const uint8_t* edge_mask, const int* ptr, const int* chunk_ptr,
                         const int* chunk_row, int n_chunks, int num_nodes, float* m, float* den,
                         float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0 || !valid_heads(heads)) return (int)cudaErrorInvalidValue;
  switch (heads) {
    case 1: return (int)launch_row_stats<1>(tj, ti, senders, edge_mask, ptr, chunk_ptr, chunk_row,
                                            n_chunks, num_nodes, m, den, partial, stream);
    case 2: return (int)launch_row_stats<2>(tj, ti, senders, edge_mask, ptr, chunk_ptr, chunk_row,
                                            n_chunks, num_nodes, m, den, partial, stream);
    case 4: return (int)launch_row_stats<4>(tj, ti, senders, edge_mask, ptr, chunk_ptr, chunk_row,
                                            n_chunks, num_nodes, m, den, partial, stream);
    default: return (int)launch_row_stats<8>(tj, ti, senders, edge_mask, ptr, chunk_ptr,
                                             chunk_row, n_chunks, num_nodes, m, den, partial,
                                             stream);
  }
}

// K9 / K9T.  dtype: 0 = float32, 1 = bfloat16 (x).  Forward (K9): perm null,
// nbr = senders, the receiver CSR.  Transposed (K9T): perm = the sender
// CSR's perm, nbr = receivers, the sender CSR.  tj, ti, m [heads, V] f32 in
// the forward's roles either way.  Dropout (drop != 0): keep an edge's head
// h when the hash of e * heads + h under (s0, s1) is below thresh, and divide
// its weight by keep_p.  Writes out [V, h] f32; partial holds h * n_chunks
// floats.  h % 32 == 0, h / 32 and heads in {1, 2, 4, 8}; x rows aligned to
// h / 32 elements.
int gat_coef_spmm_launch(const void* x, int dtype, const float* tj, const float* ti,
                         const float* m, int heads, const int* nbr, const int* perm,
                         const uint8_t* edge_mask, const int* ptr, const int* chunk_ptr,
                         const int* chunk_row, int n_chunks, int num_nodes, int h, unsigned s0,
                         unsigned s1, unsigned thresh, float keep_p, int drop, float* out,
                         float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0 || !valid_width(heads, h)) return (int)cudaErrorInvalidValue;
  const Dropout d = make_dropout(s0, s1, thresh, keep_p, drop);
  if (dtype == 1)
    return (int)gat_spmm_typed<__nv_bfloat16>(x, tj, ti, m, heads, nbr, perm, edge_mask, ptr,
                                              chunk_ptr, chunk_row, n_chunks, num_nodes, h, d,
                                              out, partial, stream);
  if (dtype == 0)
    return (int)gat_spmm_typed<float>(x, tj, ti, m, heads, nbr, perm, edge_mask, ptr, chunk_ptr,
                                      chunk_row, n_chunks, num_nodes, h, d, out, partial,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

// K10.  dtype: 0 = float32, 1 = bfloat16 (x); w [V, h] f32; tj, ti, m, dD
// [heads, V] f32.  The receiver CSR (ptr, chunk_ptr, chunk_row, r_chunks)
// for the per-edge pass, the sender CSR (sptr, schunk_ptr, schunk_row, sperm,
// s_chunks) for the dtj sums.  Writes edge_out [heads, E] (scratch), dtj and
// dti [heads, V] f32; partial holds heads * max(r_chunks, s_chunks) floats.
// Dropout as K9.
int gat_sddmm_chain_launch(const void* x, int dtype, const float* w, const float* tj,
                           const float* ti, const float* m, const float* dD, int heads,
                           const int* senders, const uint8_t* edge_mask, const int* ptr,
                           const int* chunk_ptr, const int* chunk_row, int r_chunks,
                           const int* sptr, const int* schunk_ptr, const int* schunk_row,
                           const int* sperm, int s_chunks, int num_nodes, int num_edges, int h,
                           unsigned s0, unsigned s1, unsigned thresh, float keep_p, int drop,
                           float* edge_out, float* dtj, float* dti, float* partial,
                           cudaStream_t stream) {
  if (r_chunks <= 0 || s_chunks <= 0 || num_nodes <= 0 || num_edges <= 0 ||
      !valid_width(heads, h))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const Dropout d = make_dropout(s0, s1, thresh, keep_p, drop);
  auto fill = [&](auto& a) {
    a.w = w;
    a.tj = tj;
    a.ti = ti;
    a.m = m;
    a.dD = dD;
    a.senders = senders;
    a.edge_mask = edge_mask;
    a.ptr = ptr;
    a.chunk_ptr = chunk_ptr;
    a.chunk_row = chunk_row;
    a.edge_out = edge_out;
    a.dti = dti;
    a.partial = partial;
    a.n_chunks = r_chunks;
    a.num_nodes = num_nodes;
    a.num_edges = num_edges;
    a.h = h;
    a.drop = d;
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
  switch (heads) {
    case 1: return (int)launch_chain_sums<1>(dti, edge_out, num_nodes, num_edges, chunk_ptr, sptr,
                                             schunk_ptr, schunk_row, sperm, s_chunks, dtj,
                                             partial, stream);
    case 2: return (int)launch_chain_sums<2>(dti, edge_out, num_nodes, num_edges, chunk_ptr, sptr,
                                             schunk_ptr, schunk_row, sperm, s_chunks, dtj,
                                             partial, stream);
    case 4: return (int)launch_chain_sums<4>(dti, edge_out, num_nodes, num_edges, chunk_ptr, sptr,
                                             schunk_ptr, schunk_row, sperm, s_chunks, dtj,
                                             partial, stream);
    default: return (int)launch_chain_sums<8>(dti, edge_out, num_nodes, num_edges, chunk_ptr,
                                              sptr, schunk_ptr, schunk_row, sperm, s_chunks, dtj,
                                              partial, stream);
  }
}

}  // extern "C"
