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
// So the kernel's cost beyond the bound is fixed cost: per launch and, at
// small N, per block.  An edge value is its flat cell, so the output is cut
// into chunks of kChunk flat cells (16-byte aligned in both dtypes,
// whatever N), one block each, in one launch (1,024 blocks at B=128,
// N=256; 230,400 at N=3,840).  A block first issues its chunk's zeros,
// 16-byte stores that depend on nothing; then the block finds the chunk's
// first edge by a 256-way search of the sorted list (a probe a thread, ~3
// rounds of loads, the first shared by every block through L2), so no
// pass over every edge has to find the chunks' starts first.  The
// search's barriers order the zeros before the counts in the block; then
// each thread takes every 256th edge of the chunk, loading it and its
// neighbours at once: the first edge of each run of equal values writes
// the run's length.  No shared tile (zeroing, filling and reading back a
// tile in barrier-split phases caps blocks an SM and keeps a block's
// stores from overlapping its setup; a 16-bit tile written once measured
// within 3% cold and 5% slower warm), no atomics: a cell has one writer
// after the zeros, so the result does not depend on scheduling.  The count
// cells are written twice, both times into L2, which writes each line back
// once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;        // output cells a block: 16 KB in bf16, 32 KB in f32

// The first index of the sorted a[0, n) whose value is >= key (n if none),
// found by the whole block: each round probes kThreads evenly spaced places
// of the interval still open, counts those below key in its barrier
// (__syncthreads_count) and keeps the stretch between the last probe below
// key and the next; ~3 rounds at E = 128k.  Every thread gets the answer.
template <typename I>
__device__ __forceinline__ int lower_bound_block(const I* __restrict__ a, int n,
                                                 long long key) {
  int lo = 0, hi = n;                  // the answer lies in [lo, hi]
  while (hi - lo > kThreads) {
    const int stride = (hi - lo + kThreads - 1) / kThreads;
    const int i = lo + threadIdx.x * stride;
    const int m = __syncthreads_count(i < hi && (long long)__ldg(a + i) < key);
    const int nlo = m > 0 ? lo + (m - 1) * stride + 1 : lo;
    hi = min(hi, lo + m * stride);
    lo = nlo;
  }
  const int i = lo + threadIdx.x;
  return lo + __syncthreads_count(i < hi && (long long)__ldg(a + i) < key);
}

template <typename T> __device__ __forceinline__ T from_count(int c);
template <> __device__ __forceinline__ float from_count<float>(int c) {
  return (float)c;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_count<__nv_bfloat16>(int c) {
  return __float2bfloat16((float)c);
}

template <typename I, typename T>
__global__ void __launch_bounds__(kThreads)
adj_build_kernel(const I* __restrict__ ef, int num_edges, long long total,
                 T* __restrict__ out) {
  const long long c0 = (long long)blockIdx.x * kChunk;
  const int cells = (int)min((long long)kChunk, total - c0);
  T* dst = out + c0;
  constexpr int kVec = 16 / sizeof(T);  // cells a 16-byte store writes
  const int nvec = cells / kVec;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = nvec * kVec + threadIdx.x; i < cells; i += kThreads) dst[i] = from_count<T>(0);
  // the barriers of the search order the zeros before the counts
  const int first = lower_bound_block(ef, num_edges, c0);
  const long long c1 = c0 + cells;
  for (int e = first + threadIdx.x; e < num_edges; e += kThreads) {
    const I v = ef[e];
    const I before = e > 0 ? ef[e - 1] : ~v;           // ~v: not v
    const I after = e + 1 < num_edges ? ef[e + 1] : ~v;
    if ((long long)v >= c1) break;      // sorted: this thread's later edges too
    if (before == v) continue;          // not the head of its run
    int run = 1;
    if (after == v)
      for (run = 2; e + run < num_edges && ef[e + run] == v;) ++run;
    dst[(long long)v - c0] = from_count<T>(run);
  }
}

template <typename I, typename T>
int launch(const void* ef, int E, int B, int N, void* out, cudaStream_t stream) {
  const long long total = (long long)B * N * N;
  if (total == 0) return 0;
  adj_build_kernel<I, T><<<(unsigned)((total + kChunk - 1) / kChunk), kThreads, 0, stream>>>(
      static_cast<const I*>(ef), E, total, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// idx_bits: 32 or 64.  dtype: 0 = float32, 1 = bfloat16.  E < 2^31; out
// [B*N*N], 16-byte aligned.
extern "C" int adj_build_launch(const void* edge_flat, int idx_bits, int E, int B, int N,
                                int dtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bits == 32) {
    if (dtype == 0) return launch<int32_t, float>(edge_flat, E, B, N, out, s);
    if (dtype == 1) return launch<int32_t, __nv_bfloat16>(edge_flat, E, B, N, out, s);
  } else if (idx_bits == 64) {
    if (dtype == 0) return launch<int64_t, float>(edge_flat, E, B, N, out, s);
    if (dtype == 1) return launch<int64_t, __nv_bfloat16>(edge_flat, E, B, N, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
