// Sparse-layout GCN kernels for Hopper (sm_90a): the sender degree of both
// masked branches (K1) and the GCN SpMM with its coefficient chain built
// in-kernel, in a pair form for the two masked causal convs (K2) and a plain
// form for the backbone convs (K3).
//
// Replaces (cal_tpu/ops/pallas_spmm.py):
//   K1  _pair_stats_call (_pair_stats_kernel)            -> sender_degree_launch
//   K2  _pair_coef_spmm_call (_pair_coef_spmm_kernel)    -> coef_spmm_launch, branches 2
//   K3  _plain_coef_spmm_call (_plain_coef_spmm_kernel)  -> coef_spmm_launch, branches 1
//
// Contract (the forward of gcn_aggregate_sparse_sigmoid_pair_pallas and
// gcn_aggregate_sparse_plain_pallas, i.e. cal_tpu/ops/gcn.py
// gcn_aggregate_sparse): an edge e = (s -> r) is live when edge_mask[e] and
// s != r (self loops are dropped; liveness never comes from an index).
//   K1: deg[0][v] = sum over live e with s_e = v of sigmoid(src[v] + dst[r_e]),
//       deg[1][v] = the same sum of 1 - sigmoid; null src/dst mean logits 0
//       (sigmoid(0) = 0.5 exactly: the plain conv's degree is 2 deg[0]).
//   K2: for branch k (w_0 = sigmoid, w_1 = 1 - sigmoid),
//       out_k[r] = sum over live e with r_e = r of
//                  dis_k[s] * w_k * dis_k[r] * x_k[s]  +  x_k[r] / deg_k[r];
//   K3: the same with one branch and w = 1.
//   deg / dis [branches, V] f32 are deg + 1 and its rsqrt, from the caller.
//
// Rounding: x and the logits are stored in the model dtype (f32 or bf16);
// everything else is f32: the sigmoid, the coefficient (dis_s * w) * dis_r,
// each message and every sum, the self term x / deg (IEEE division); each
// output is rounded to the model dtype once.  The plain twins in
// ops/spmm.py round at exactly these points.  cal_tpu's bf16 tile plans
// round more (the gathered logit and dis planes, the per-slot weights, each
// message before the receiver sum): the port does not.
//
// Design.  Rows (senders for K1, receivers for K2/K3) come in CSR form
// (graph.EdgeCsr): a row's edges form groups of kGroup = 32 and the groups
// at most kMaxChunks = 64 chunks of equal group counts.  One warp owns one
// chunk and walks its groups: the lanes read a group's 32 edges' metadata
// at once (lane i <-> edge i) and compute liveness, weight and
// coefficient; K1 keeps per-lane sums and ends with a butterfly shuffle;
// K2/K3 take the group's live edges from a ballot and, for each in turn,
// broadcast its sender and coefficient while every lane accumulates H / 32
// features of each branch (8- or 16-byte loads of the sender's row).  A row
// of a single chunk is written by its warp directly (K2/K3 with the self
// term fused); a longer row (a hub, or the padded-edge run at node V-1)
// writes one f32 partial per chunk, and a second pass sums its <= 64
// partials in chunk order.  So no row is serialized on one warp (the cap
// keeps the combine short too: a serving batch's padded run holds ~29,000
// dead edges), every sum has one owner, no float atomics: a result does not
// change between runs.
//
// Bound: bytes.  K2 reads x [V, 2H] once (plus a sender row per live edge,
// mostly from L2) and writes [V, 2H]; the metadata is 9 bytes per edge; the
// arithmetic (2H FMAs per edge) is far below the tensor-core or FMA floor.
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in ops/spmm.py
// allocate every output and scratch buffer and pass PyTorch's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;          // = cal_tpu_torch.graph.CHUNK_EDGES
constexpr int kMaxChunks = 64;      // = cal_tpu_torch.graph.MAX_CHUNKS
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// F consecutive values of type T at p (aligned to F * sizeof(T) bytes) as f32.
template <typename T, int F>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[F]) {
  constexpr int kBytes = F * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[k * kPer + j] = to_f(t[j]);
    }
  } else if constexpr (kBytes == 8) {
    uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = to_f(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = to_f(p[j]);
  }
}

template <typename T, int F>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[F]) {
  constexpr int kBytes = F * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      uint4 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) t[j] = from_f<T>(v[k * kPer + j]);
      reinterpret_cast<uint4*>(p)[k] = u;
    }
  } else if constexpr (kBytes == 8) {
    uint2 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < F; ++j) t[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < F; ++j) p[j] = from_f<T>(v[j]);
  }
}

struct Chunk {
  int row, beg, end, count;   // edges [beg, end) of row; count = chunks of the row
};

// The split of graph.edge_csr: groups = max(1, ceil(len / 32)), per =
// ceil(groups / 64) groups per chunk.
__device__ __forceinline__ Chunk chunk_of(int c, const int* __restrict__ ptr,
                                          const int* __restrict__ chunk_ptr,
                                          const int* __restrict__ chunk_row) {
  Chunk k;
  k.row = chunk_row[c];
  const int first = chunk_ptr[k.row];
  k.count = chunk_ptr[k.row + 1] - first;
  const int row_beg = ptr[k.row], row_end = ptr[k.row + 1];
  const int groups = max(1, (row_end - row_beg + kGroup - 1) / kGroup);
  const int span = (groups + kMaxChunks - 1) / kMaxChunks * kGroup;
  k.beg = row_beg + (c - first) * span;
  k.end = min(k.beg + span, row_end);
  return k;
}

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
  float wc = 0.0f, wo = 0.0f;
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int e = perm[i];
    const int r = receivers[e];
    if (edge_mask[e] && r != v) {
      const float sg = sigmoid_f(src == nullptr ? 0.0f : sv + to_f(dst[r]));
      wc += sg;
      wo += 1.0f - sg;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wc += __shfl_xor_sync(kFull, wc, off);
    wo += __shfl_xor_sync(kFull, wo, off);
  }
  if (lane == 0) {
    if (k.count == 1) {
      deg[v] = wc;
      deg[num_nodes + v] = wo;
    } else {
      partial[2 * c] = wc;
      partial[2 * c + 1] = wo;
    }
  }
}

__global__ void sender_degree_combine(const int* __restrict__ chunk_ptr, int num_nodes,
                                      const float* __restrict__ partial,
                                      float* __restrict__ deg) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_nodes) return;
  const int c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 <= 1) return;
  float a = 0.0f, b = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    a += partial[2 * c];
    b += partial[2 * c + 1];
  }
  deg[v] = a;
  deg[num_nodes + v] = b;
}

// ---- K2 / K3: coefficient SpMM over the receiver CSR ---------------------

template <typename T, int NB, int F>
struct SpmmArgs {
  const T* x[NB];
  T* out[NB];
  const T* src;
  const T* dst;
  const int* senders;
  const uint8_t* edge_mask;
  const float* deg;   // [NB, V]
  const float* dis;   // [NB, V]
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  float* partial;     // [n_chunks, NB * H]
  int n_chunks, num_nodes, h;
};

// out_b[r] = acc_b + x_b[r] / deg_b[r], rounded once to T.
template <typename T, int NB, int F>
__device__ __forceinline__ void write_row(const SpmmArgs<T, NB, F>& a, int r, int lane,
                                          float (&acc)[NB][F]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const size_t off = (size_t)r * a.h + lane * F;
    float xs[F];
    load_vec<T, F>(a.x[b] + off, xs);
    const float d = a.deg[(size_t)b * a.num_nodes + r];
    float o[F];
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[b][f] + xs[f] / d;
    store_vec<T, F>(a.out[b] + off, o);
  }
}

template <typename T, int NB, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coef_spmm_kernel(const SpmmArgs<T, NB, F> a) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int r = k.row;
  const size_t V = a.num_nodes;
  float dis_r[NB], dst_r = 0.0f;
#pragma unroll
  for (int b = 0; b < NB; ++b) dis_r[b] = a.dis[b * V + r];
  if constexpr (NB == 2) dst_r = to_f(a.dst[r]);
  float acc[NB][F];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[b][f] = 0.0f;
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    // lane i: edge g0 + i -> (sender, coefficient per branch) when live
    const int i = g0 + lane;
    int s_l = 0;
    float coef_l[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) coef_l[b] = 0.0f;
    bool live = false;
    if (i < k.end) {
      s_l = a.senders[i];
      live = a.edge_mask[i] && s_l != r;
      if (live) {
        if constexpr (NB == 2) {
          const float sg = sigmoid_f(to_f(a.src[s_l]) + dst_r);
          coef_l[0] = (a.dis[s_l] * sg) * dis_r[0];
          coef_l[1] = (a.dis[V + s_l] * (1.0f - sg)) * dis_r[1];
        } else {
          coef_l[0] = a.dis[s_l] * dis_r[0];
        }
      }
    }
    // the group's live edges in edge order
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int s = __shfl_sync(kFull, s_l, j);
      float cf[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) cf[b] = __shfl_sync(kFull, coef_l[b], j);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float xs[F];
        load_vec<T, F>(a.x[b] + (size_t)s * a.h + lane * F, xs);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[b][f] = fmaf(cf[b], xs[f], acc[b][f]);
      }
    }
  }
  if (k.count == 1) {
    write_row<T, NB, F>(a, r, lane, acc);
  } else {
    float* p = a.partial + (size_t)c * NB * a.h + lane * F;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int f = 0; f < F; ++f) p[b * a.h + f] = acc[b][f];
  }
}

template <typename T, int NB, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coef_spmm_combine(const SpmmArgs<T, NB, F> a) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= a.num_nodes) return;
  const int c0 = a.chunk_ptr[r], c1 = a.chunk_ptr[r + 1];
  if (c1 - c0 <= 1) return;
  float acc[NB][F];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[b][f] = 0.0f;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const float* p = a.partial + (size_t)c * NB * a.h + lane * F;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[b][f] += p[b * a.h + f];
  }
  write_row<T, NB, F>(a, r, lane, acc);
}

template <typename T, int NB, int F>
cudaError_t launch_spmm(const void* x0, const void* x1, const void* src, const void* dst,
                        const int* senders, const uint8_t* edge_mask, const float* deg,
                        const float* dis, const int* ptr, const int* chunk_ptr,
                        const int* chunk_row, int n_chunks, int num_nodes, int h,
                        void* out0, void* out1, float* partial, cudaStream_t stream) {
  SpmmArgs<T, NB, F> a;
  a.x[0] = static_cast<const T*>(x0);
  a.out[0] = static_cast<T*>(out0);
  if constexpr (NB == 2) {
    a.x[1] = static_cast<const T*>(x1);
    a.out[1] = static_cast<T*>(out1);
  }
  a.src = static_cast<const T*>(src);
  a.dst = static_cast<const T*>(dst);
  a.senders = senders;
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
  const int threads = kWarpsPerBlock * 32;
  coef_spmm_kernel<T, NB, F><<<(n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0,
                               stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  coef_spmm_combine<T, NB, F><<<(num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock, threads,
                                0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t dispatch_f(int f, const void* x0, const void* x1, const void* src,
                       const void* dst, const int* senders, const uint8_t* edge_mask,
                       const float* deg, const float* dis, const int* ptr,
                       const int* chunk_ptr, const int* chunk_row, int n_chunks,
                       int num_nodes, int h, void* out0, void* out1, float* partial,
                       cudaStream_t stream) {
#define CAL_SPMM_F(FV)                                                                   \
  case FV:                                                                               \
    return launch_spmm<T, NB, FV>(x0, x1, src, dst, senders, edge_mask, deg, dis, ptr,  \
                                  chunk_ptr, chunk_row, n_chunks, num_nodes, h, out0,    \
                                  out1, partial, stream);
  switch (f) {
    CAL_SPMM_F(1)
    CAL_SPMM_F(2)
    CAL_SPMM_F(4)
    CAL_SPMM_F(8)
    default:
      break;
  }
#undef CAL_SPMM_F
  return cudaErrorInvalidValue;
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
  sender_degree_combine<<<(num_nodes + 255) / 256, 256, 0, stream>>>(chunk_ptr, num_nodes,
                                                                    partial, deg);
  return (int)cudaGetLastError();
}

// branches: 2 (pair: x0 = xc, x1 = xo, logits src/dst) or 1 (plain: x0,
// src/dst unused).  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned
// to h / 32 elements.
int coef_spmm_launch(int branches, const void* x0, const void* x1, const void* src,
                     const void* dst, int dtype, const int* senders,
                     const uint8_t* edge_mask, const float* deg, const float* dis,
                     const int* ptr, const int* chunk_ptr, const int* chunk_row,
                     int n_chunks, int num_nodes, int h, void* out0, void* out1,
                     float* partial, cudaStream_t stream) {
  if (n_chunks <= 0 || num_nodes <= 0 || h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const int f = h / 32;
  if (dtype == 1 && branches == 2)
    return (int)dispatch_f<__nv_bfloat16, 2>(f, x0, x1, src, dst, senders, edge_mask, deg,
                                             dis, ptr, chunk_ptr, chunk_row, n_chunks,
                                             num_nodes, h, out0, out1, partial, stream);
  if (dtype == 1 && branches == 1)
    return (int)dispatch_f<__nv_bfloat16, 1>(f, x0, x1, src, dst, senders, edge_mask, deg,
                                             dis, ptr, chunk_ptr, chunk_row, n_chunks,
                                             num_nodes, h, out0, out1, partial, stream);
  if (dtype == 0 && branches == 2)
    return (int)dispatch_f<float, 2>(f, x0, x1, src, dst, senders, edge_mask, deg, dis, ptr,
                                     chunk_ptr, chunk_row, n_chunks, num_nodes, h, out0,
                                     out1, partial, stream);
  if (dtype == 0 && branches == 1)
    return (int)dispatch_f<float, 1>(f, x0, x1, src, dst, senders, edge_mask, deg, dis, ptr,
                                     chunk_ptr, chunk_row, n_chunks, num_nodes, h, out0,
                                     out1, partial, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
