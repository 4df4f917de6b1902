// Dense count adjacency from a sorted flat edge list, for Hopper (sm_90a).
//
// Replaces: cal_tpu/ops/pallas_adj.py::_adj_build_kernel (adj_build), which
// builds each graph's [N, N] block as a one-hot outer product on the TPU's
// matrix unit.
//
// Contract: edge_flat [E] holds (g*N + r)*N + s per directed edge s -> r,
// sorted ascending; values outside [0, B*N*N) (the padding sentinel B*N*N)
// are dropped.  out[B*N*N] gets the multiplicity count of each cell (row =
// receiver), zeros elsewhere, in f32 or bf16; counts are exact.
//
// Bound on this card: bytes.  The work is E index reads plus B*N*N output
// writes (16.8 MB in bf16 at B=128, N=256) and no arithmetic to speak of.
// Design: the output is cut into chunks of R consecutive global rows
// ([B*N, N] viewed flat).  A tiny pass finds where each chunk's edges start
// in the sorted list (one thread per edge, no search); then one block per
// chunk builds its R x N tile of counts in shared memory and writes every
// output element exactly once with 16-byte stores, so zeroing costs no
// extra pass.  Duplicates are adjacent in the sorted list: the first edge
// of each run writes the run length, so no atomics are needed and the
// result does not depend on scheduling.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename I>
__device__ __forceinline__ long long chunk_of(I v, long long total,
                                              long long chunk_cells,
                                              long long n_chunks) {
  if (v < 0) return -1;
  if ((long long)v >= total) return n_chunks;
  return (long long)v / chunk_cells;
}

// starts[k] = first edge whose chunk is >= k, for k in [0, n_chunks].
template <typename I>
__global__ void chunk_starts_kernel(const I* __restrict__ ef, long long E,
                                    long long total, long long chunk_cells,
                                    long long n_chunks, int* __restrict__ starts) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e > E) return;
  long long prev = e == 0 ? -1 : chunk_of(ef[e - 1], total, chunk_cells, n_chunks);
  long long cur = e == E ? n_chunks : chunk_of(ef[e], total, chunk_cells, n_chunks);
  for (long long k = prev + 1; k <= cur; ++k) starts[k] = (int)e;
}

template <typename T> __device__ __forceinline__ T from_count(int c);
template <> __device__ __forceinline__ float from_count<float>(int c) {
  return (float)c;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_count<__nv_bfloat16>(int c) {
  return __float2bfloat16((float)c);
}

template <typename I, typename T>
__global__ void adj_tile_kernel(const I* __restrict__ ef,
                                const int* __restrict__ starts, long long rows_total,
                                int n, int rows_per_chunk, T* __restrict__ out) {
  extern __shared__ int tile[];
  const long long k = blockIdx.x;
  const long long row0 = k * rows_per_chunk;
  const int rows = (int)min((long long)rows_per_chunk, rows_total - row0);
  const int cells = rows * n;
  const long long base = row0 * n;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0;
  __syncthreads();
  const int e0 = starts[k], e1 = starts[k + 1];
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const I v = ef[e];
    if (e > e0 && ef[e - 1] == v) continue;  // not the head of its run
    int run = 1;
    while (e + run < e1 && ef[e + run] == v) ++run;
    tile[(int)((long long)v - base)] = run;
  }
  __syncthreads();
  T* dst = out + base;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte store
  if (n % kVec == 0) {
    for (int i = threadIdx.x * kVec; i < cells; i += blockDim.x * kVec) {
      alignas(16) T vals[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = from_count<T>(tile[i + j]);
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(vals);
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += blockDim.x)
      dst[i] = from_count<T>(tile[i]);
  }
}

template <typename I, typename T>
int launch(const void* ef, long long E, int B, int N, int rows_per_chunk,
           void* out, int* starts, cudaStream_t stream) {
  const long long rows_total = (long long)B * N;
  const long long n_chunks = (rows_total + rows_per_chunk - 1) / rows_per_chunk;
  const long long chunk_cells = (long long)rows_per_chunk * N;
  const long long total = rows_total * N;
  const long long threads_needed = E + 1;
  chunk_starts_kernel<I><<<(unsigned)((threads_needed + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(
      static_cast<const I*>(ef), E, total, chunk_cells, n_chunks, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_chunks == 0) return 0;
  const size_t smem = (size_t)chunk_cells * sizeof(int);
  adj_tile_kernel<I, T><<<(unsigned)n_chunks, kThreads, smem, stream>>>(
      static_cast<const I*>(ef), starts, rows_total, N, rows_per_chunk,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// idx_bits: 32 or 64.  dtype: 0 = float32, 1 = bfloat16.
// starts: int32 scratch of ceil(B*N / rows_per_chunk) + 1 entries.
// rows_per_chunk * N * 4 bytes must fit in 48 KB of shared memory.
extern "C" int adj_build_launch(const void* edge_flat, int idx_bits, long long E,
                                int B, int N, int rows_per_chunk, int dtype,
                                void* out, void* starts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(starts);
  if (idx_bits == 32) {
    if (dtype == 0) return launch<int32_t, float>(edge_flat, E, B, N, rows_per_chunk, out, st, s);
    if (dtype == 1) return launch<int32_t, __nv_bfloat16>(edge_flat, E, B, N, rows_per_chunk, out, st, s);
  } else if (idx_bits == 64) {
    if (dtype == 0) return launch<int64_t, float>(edge_flat, E, B, N, rows_per_chunk, out, st, s);
    if (dtype == 1) return launch<int64_t, __nv_bfloat16>(edge_flat, E, B, N, rows_per_chunk, out, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
