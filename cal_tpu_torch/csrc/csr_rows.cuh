// Shared CSR-row machinery of the sparse kernels (spmm.cu, gat_sparse.cu,
// coo_spmm.cu): the chunk split of graph.edge_csr, vector loads and stores of
// a lane's features, the per-warp row sums with their combine pass for long
// rows, the sender-CSR sum of per-edge f32 columns, and the coefficient SpMM
// walk that K2/K3, K11 and K19 instantiate.  Included by each source; it is
// not a build target of its own.
#pragma once

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

// ---- row sums: the combine pass of long rows ---------------------------

// out[j][v] = the sum in chunk order of the NC partials of every row v of
// more than one chunk (rows of one chunk were written by their warp).
template <int NC>
__global__ void row_combine(const int* __restrict__ chunk_ptr, int num_nodes,
                            const float* __restrict__ partial, float* __restrict__ out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_nodes) return;
  const int c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 <= 1) return;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] += partial[NC * c + j];
#pragma unroll
  for (int j = 0; j < NC; ++j) out[(size_t)j * num_nodes + v] = acc[j];
}

template <int NC>
cudaError_t launch_combine(const int* chunk_ptr, int num_nodes, const float* partial,
                           float* out, cudaStream_t stream) {
  row_combine<NC><<<(num_nodes + 255) / 256, 256, 0, stream>>>(chunk_ptr, num_nodes, partial,
                                                                out);
  return cudaGetLastError();
}

// The warp's per-lane sums of a chunk of row v: written to out[j][v] when
// the row has one chunk, else to the chunk's NC partials.
template <int NC>
__device__ __forceinline__ void finish_row(float (&acc)[NC], const Chunk& k, int c, int lane,
                                           int num_nodes, float* __restrict__ out,
                                           float* __restrict__ partial) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (k.count == 1) out[(size_t)j * num_nodes + k.row] = acc[j];
      else partial[NC * c + j] = acc[j];
    }
  }
}

// ---- sender sums of per-edge columns (the second pass of K5 and K6) ------

// out[j][v] = sum over the edges e of sender v (sender CSR, edge perm[i]) of
// cols[j][e], for NC f32 columns of E values.
template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sender_sum_kernel(const float* __restrict__ cols, int num_edges, const int* __restrict__ perm,
                  const int* __restrict__ ptr, const int* __restrict__ chunk_ptr,
                  const int* __restrict__ chunk_row, int n_chunks, int num_nodes,
                  float* __restrict__ out, float* __restrict__ partial) {
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  const Chunk k = chunk_of(c, ptr, chunk_ptr, chunk_row);
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
  for (int i = k.beg + lane; i < k.end; i += kGroup) {
    const int e = perm[i];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] += cols[(size_t)j * num_edges + e];
  }
  finish_row<NC>(acc, k, c, lane, num_nodes, out, partial);
}

template <int NC>
cudaError_t launch_sender_sum(const float* cols, int num_edges, const int* perm,
                              const int* ptr, const int* chunk_ptr, const int* chunk_row,
                              int n_chunks, int num_nodes, float* out, float* partial,
                              cudaStream_t stream) {
  sender_sum_kernel<NC><<<(n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                          kWarpsPerBlock * 32, 0, stream>>>(
      cols, num_edges, perm, ptr, chunk_ptr, chunk_row, n_chunks, num_nodes, out, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<NC>(chunk_ptr, num_nodes, partial, out, stream);
}

// ---- coefficient SpMM over a CSR (K2/K3 of spmm.cu, K11/K19 of coo_spmm.cu)
//
// out_b[r] = sum over the live edges e of row r of cf_b[e] * x_b[nbr_e], for
// kBranches branches b.  One warp owns one chunk and walks its groups of 32
// edges: lane i reads edge i's neighbour and coefficients through the
// policy, a ballot lists the group's live edges in edge order, and for each
// in turn every lane accumulates H / 32 features of each branch of the
// neighbour's row (8- or 16-byte loads).  A row of one chunk is written by
// its warp through the policy; a longer row writes one f32 partial per chunk
// ([n_chunks, kBranches, H]) and csr_spmm_combine sums its <= 64 partials in
// chunk order before writing it.  The policy P holds the CSR (perm: null
// when edge i of the CSR is edge i; ptr, chunk_ptr, chunk_row, n_chunks,
// num_nodes, h), x[kBranches] of element type Elem, partial, optionally
// kHeads (coefficients per branch and edge; default 1), and:
//   Row row(int r)                                     the row's own state;
//   bool edge(int e, const Row&, int& s, float (&cf)[kBranches * kHeads])
//       whether edge e is live, and then its neighbour s and coefficients
//       (cf[b * kHeads + hd]: branch b, head hd);
//   void write_row<F>(int r, int lane, const float (&acc)[kBranches][F])
//       the row's output from the lane's F sums per branch.
// With kHeads > 1 a row's h features are kHeads heads of h / kHeads, each
// weighted by its own coefficient; a lane's F features lie in one head
// (kHeads divides 32).
template <typename P, typename = void>
struct HeadsOf {
  static constexpr int v = 1;
};
template <typename P>
struct HeadsOf<P, decltype(void(P::kHeads))> {
  static constexpr int v = P::kHeads;
};

template <typename P, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const P a) {
  constexpr int NB = P::kBranches;
  constexpr int NH = HeadsOf<P>::v;
  using T = typename P::Elem;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= a.n_chunks) return;
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const typename P::Row row = a.row(k.row);
  const int head = lane * F / (a.h / NH);   // the head of the lane's features
  float acc[NB][F];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[b][f] = 0.0f;
  for (int g0 = k.beg; g0 < k.end; g0 += kGroup) {
    // lane i: edge g0 + i -> (neighbour, coefficients per branch) when live
    const int i = g0 + lane;
    int s_l = 0;
    float cf_l[NB * NH];
#pragma unroll
    for (int b = 0; b < NB * NH; ++b) cf_l[b] = 0.0f;
    const bool live = i < k.end && a.edge(a.perm == nullptr ? i : a.perm[i], row, s_l, cf_l);
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int s = __shfl_sync(kFull, s_l, j);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float cf = 0.0f;
#pragma unroll
        for (int hd = 0; hd < NH; ++hd) {
          const float v = __shfl_sync(kFull, cf_l[b * NH + hd], j);
          if (NH == 1 || hd == head) cf = v;
        }
        float xs[F];
        load_vec<T, F>(a.x[b] + (size_t)s * a.h + lane * F, xs);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[b][f] = fmaf(cf, xs[f], acc[b][f]);
      }
    }
  }
  if (k.count == 1) {
    a.template write_row<F>(k.row, lane, acc);
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      store_vec<float, F>(a.partial + ((size_t)c * NB + b) * a.h + lane * F, acc[b]);
  }
}

template <typename P, int F>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_combine(const P a) {
  constexpr int NB = P::kBranches;
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
  for (int c = c0; c < c1; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float p[F];
      load_vec<float, F>(a.partial + ((size_t)c * NB + b) * a.h + lane * F, p);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[b][f] += p[f];
    }
  a.template write_row<F>(r, lane, acc);
}

template <typename P, int F>
cudaError_t launch_csr_spmm_f(const P& a, cudaStream_t stream) {
  const int threads = kWarpsPerBlock * 32;
  csr_spmm_kernel<P, F><<<(a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0,
                          stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  csr_spmm_combine<P, F><<<(a.num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock, threads, 0,
                           stream>>>(a);
  return cudaGetLastError();
}

// h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned to h / 32 elements.
template <typename P>
cudaError_t launch_csr_spmm(const P& a, cudaStream_t stream) {
  switch (a.h / 32) {
    case 1: return launch_csr_spmm_f<P, 1>(a, stream);
    case 2: return launch_csr_spmm_f<P, 2>(a, stream);
    case 4: return launch_csr_spmm_f<P, 4>(a, stream);
    case 8: return launch_csr_spmm_f<P, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
