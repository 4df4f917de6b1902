// Sorted segment sum (sparse global_add_pool) for Hopper (sm_90a): K4, and
// its backward, the row gather K7.
//
// K4 replaces cal_tpu/ops/pallas_pool.py _pool_call (_pool_fwd_kernel), the
// forward of mxu_pool: x [V, H] (f32 or bf16) -> out [G1, H] f32 with
// out[g] = sum of the rows v with node_graph[v] == g, summed in f32.  Padded
// nodes carry node_graph == G1 - 1 (the trash segment), which the caller
// drops.  The TPU kernel multiplies a one-hot of node_graph into an f32
// block resident across the grid; here node_graph is non-decreasing (the
// packer lays each graph's nodes out contiguously, padding last), so the
// rows of segment g are one range [lower_bound(g), lower_bound(g + 1)).
//
// Design: one block of 32 warps per segment.  Thread 0 finds the range by
// binary search; warp w sums the rows of its 4-row slices beg + 4 w,
// beg + 4 (w + 32), ... (four independent loads in flight per lane), its
// lanes on H / 32 columns each (8- or 16-byte loads), and the 32 warp
// partials are added in warp order through shared memory.  Every output has
// one owner, no atomics: the result does not change between runs.  The
// widest segments set the time: the trash segment (~1,200 padded rows of a
// serving batch) and REDDIT-sized graphs (up to 3,800 rows).  Bound: bytes,
// one read of x (8 MB at V = 31,744, H = 128 bf16) and node_graph.
//
// K7 replaces cal_tpu/ops/pallas_pool.py _mxu_pool_bwd (_pool_bwd_kernel):
// dx[v] = dpooled[node_graph[v]] for dpooled [G1, H] f32, rounded once to
// x's dtype (the trash row's gradient is zero: the caller sliced it off).
// The TPU kernel multiplies the one-hot of node_graph with dpooled resident
// in VMEM; here it is a row gather whose bound is bytes: one write of dx [V,
// H] (8 MB at the canonical batch in bf16) and one read of node_graph.
// Design: a warp takes a run of kRun = 32 rows: one coalesced load of their
// node_graph ids (one a lane), then each store instruction writes 512
// contiguous bytes of dx, 16 bytes a lane (in bf16 at H = 128 a row is 16
// lanes, so 2 rows an instruction), the ids handed round by shuffles.
// node_graph is sorted in every caller (the packer lays graphs out
// contiguously), so each lane keeps its slice of the current dpooled row in
// registers and reloads it (from L2: G1 x H x 4 = 66 KB) only when its
// row's id changes; the check makes any node_graph right.  So a warp keeps
// its stores independent of each other, where one warp a row chained a
// node_graph load, the dpooled load and an 8-byte store a lane.  A block
// takes 8 runs: 124 blocks at V = 31,744, which runs of 16 rows (twice the
// warps) did not beat (PERF.md).
//
// Built by cal_tpu_torch/kernels/build.py (plain C interface, ctypes); the
// wrapper ops/pool.py allocates the output and passes PyTorch's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kRows = 4;            // rows per warp slice
constexpr int kMaxH = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

template <typename T, int F>
__global__ void __launch_bounds__(kWarps * 32)
pool_kernel(const T* __restrict__ x, const int* __restrict__ node_graph, int num_nodes,
            int h, float* __restrict__ out) {
  __shared__ int range[2];
  __shared__ float part[kWarps * kMaxH];
  const int g = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    range[0] = lower_bound(node_graph, num_nodes, g);
    range[1] = lower_bound(node_graph, num_nodes, g + 1);
  }
  __syncthreads();
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  const int end = range[1];
  for (int v0 = range[0] + w * kRows; v0 < end; v0 += kWarps * kRows) {
    float xs[kRows][F];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (v0 + u < end) {
        load_vec<T, F>(x + (size_t)(v0 + u) * h + lane * F, xs[u]);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) xs[u][f] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += xs[u][f];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) part[w * h + lane * F + f] = acc[f];
  __syncthreads();
  for (int col = threadIdx.x; col < h; col += kWarps * 32) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += part[k * h + col];
    out[(size_t)g * h + col] = s;
  }
}

template <typename T>
cudaError_t launch(int f, const void* x, const int* node_graph, int num_nodes, int h,
                   int num_segments, float* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  switch (f) {
    case 1: pool_kernel<T, 1><<<num_segments, kWarps * 32, 0, stream>>>(xt, node_graph, num_nodes, h, out); break;
    case 2: pool_kernel<T, 2><<<num_segments, kWarps * 32, 0, stream>>>(xt, node_graph, num_nodes, h, out); break;
    case 4: pool_kernel<T, 4><<<num_segments, kWarps * 32, 0, stream>>>(xt, node_graph, num_nodes, h, out); break;
    case 8: pool_kernel<T, 8><<<num_segments, kWarps * 32, 0, stream>>>(xt, node_graph, num_nodes, h, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kBwdWarps = 8;    // warps a block
constexpr int kRun = 32;        // rows a warp takes: one node_graph id a lane

template <typename T, int H>
__global__ void __launch_bounds__(kBwdWarps * 32)
pool_bwd_kernel(const float* __restrict__ dpooled, const int* __restrict__ node_graph,
                int num_nodes, T* __restrict__ dx) {
  constexpr int F = 16 / (int)sizeof(T);   // elements a lane stores at once: 16 bytes
  constexpr int L = H / F;                 // 16-byte words a row
  constexpr int LC = L < 32 ? L : 32;      // lanes a row
  constexpr int NW = L / LC;               // words a lane stores a row
  constexpr int RPW = 32 / LC;             // rows a store instruction writes
  const int lane = threadIdx.x & 31;
  const int sub = lane / LC, col = lane % LC;
  const int v0 = (blockIdx.x * kBwdWarps + (threadIdx.x >> 5)) * kRun;
  if (v0 >= num_nodes) return;
  const int ids = v0 + lane < num_nodes ? __ldg(node_graph + v0 + lane) : 0;
  int cur = -1;                            // the id of the dpooled slice in d
  float d[NW][F];
#pragma unroll 4
  for (int j = 0; j < kRun; j += RPW) {
    const int k = j + sub;                 // this lane's row: v0 + k
    const int g = __shfl_sync(0xffffffffu, ids, k);
    if (v0 + k < num_nodes) {
      if (g != cur) {
        cur = g;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          load_vec<float, F>(dpooled + (size_t)g * H + (col + w * LC) * F, d[w]);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
        store_vec<T, F>(dx + (size_t)(v0 + k) * H + (col + w * LC) * F, d[w]);
    }
  }
}

template <typename T, int H>
cudaError_t launch_bwd_h(const float* dpooled, const int* node_graph, int num_nodes, void* dx,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = kBwdWarps * kRun;
  pool_bwd_kernel<T, H><<<(num_nodes + kRowsPerBlock - 1) / kRowsPerBlock, kBwdWarps * 32, 0,
                          stream>>>(dpooled, node_graph, num_nodes, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const float* dpooled, const int* node_graph, int num_nodes, int h,
                       void* dx, cudaStream_t stream) {
  switch (h) {
    case 32: return launch_bwd_h<T, 32>(dpooled, node_graph, num_nodes, dx, stream);
    case 64: return launch_bwd_h<T, 64>(dpooled, node_graph, num_nodes, dx, stream);
    case 128: return launch_bwd_h<T, 128>(dpooled, node_graph, num_nodes, dx, stream);
    case 256: return launch_bwd_h<T, 256>(dpooled, node_graph, num_nodes, dx, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; h % 32 == 0, h <= 256; x rows aligned
// to h / 32 elements; node_graph [V] int32, non-decreasing.
int pool_launch(const void* x, int dtype, const int* node_graph, int num_nodes, int h,
                int num_segments, float* out, cudaStream_t stream) {
  if (num_segments <= 0 || num_nodes <= 0 || h <= 0 || h % 32 || h > kMaxH)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(h / 32, x, node_graph, num_nodes, h, num_segments, out,
                                      stream);
  if (dtype == 0)
    return (int)launch<float>(h / 32, x, node_graph, num_nodes, h, num_segments, out, stream);
  return (int)cudaErrorInvalidValue;
}

// K7.  dtype (of dx): 0 = float32, 1 = bfloat16; h in {32, 64, 128, 256};
// dpooled [G1, H] f32 and dx [V, H], both 16-byte aligned; node_graph [V]
// int32 in [0, G1), in any order (sorted is fastest).
int pool_bwd_launch(const float* dpooled, const int* node_graph, int num_nodes, int h,
                    int dtype, void* dx, cudaStream_t stream) {
  if (num_nodes <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(dpooled, node_graph, num_nodes, h, dx, stream);
  if (dtype == 0) return (int)launch_bwd<float>(dpooled, node_graph, num_nodes, h, dx, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
