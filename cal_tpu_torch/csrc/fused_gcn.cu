// The dense masked GCN convs, forward and backward, for Hopper (sm_90a): both
// causal convs of the causal models in one pass (the dual mode), one
// sigmoid-weighted conv (sig / neg), and the unweighted normalized aggregate
// with its transposed product (plain / plain-T).
//
// Replaces (cal_tpu/ops/pallas_gcn.py):
//   dual    _att_dual_fwd_kernel (fused_gcn_dense_att_dual forward)
//   sig/neg _att_fwd_kernel      (fused_gcn_dense_att forward, K18), negate false/true
//   plain   _mm_kernel           (fused_gcn_dense forward, K17)
//   plain-T _mm_kernel with transpose=True (the VJP of fused_gcn_dense, K17T)
//
// Contract, per graph b (all internal arithmetic in f32, inputs of type T):
//   w[r,s]  = sigmoid(src[s] + dst[r])             src: sender, dst: receiver
//   m       = a_off * w (sig), a_off * (1 - w) (neg), a_off (plain);
//             dual: mc = a_off * w, mo = a_off - mc  a_off = adj with zero diagonal
//   deg_s   = 1 + sum_r m[r,s]   (SENDER degree, a column sum), per branch
//   norm    = T((m[r,s] * deg_s^-1/2) * deg_r^-1/2)  rounded to T like the TPU kernel
//   out_r   = T(sum_s norm[r,s] * x[s,:]  +  x[r,:] / deg_r)   sum accumulated in f32
// for (xc, mc) -> oc and (xo, mo) -> oo in the dual mode, (x, m) -> o in the
// others.  plain-T sums norm[s,r] * x[s,:] instead (the product with M^T,
// the degree still M's column sums): out_r = T(sum_s norm[s,r] x[s] + x[r]/deg_r).
//
// Bound on this card: bytes in bf16: adj once, the x planes and the outputs
// (3.9 GB for the dual mode at B = 128, N = 3,840, H = 128, 1.17 ms, of which
// adj is 3.77 GB; 50 MB at N = 256).  The products a batch needs are those of
// its edges' cells, a few percent of 4 N^2 H per graph on a padded batch.  In
// f32 the products on the CUDA cores (no tensor cores, to keep full f32)
// bound a dense graph.
// Design: adj is read in full once, by the degree pass, which also writes
// the live map that the aggregate and the backward walk.
//   1. degree pass: a block per 32 lanes' columns of a graph, warp w summing
//      rows w, w + 8, ... of its columns with 16-byte loads (8 bf16 a lane),
//      four rows in flight, or, where that would leave SMs short of blocks
//      (as at N = 256), a column a lane (launch_degree chooses); then warp 0
//      adds the other warps' sums in warp order: the order of a walk by
//      columns, so the degrees do not depend on the path.  Neither path
//      forms a sigmoid where a count is 0 (the terms left out are +0, the
//      sums unchanged).  It writes deg^-1/2 and 1/deg of each branch to a
//      [2 * branches, B, N] f32 plane and the live map: a byte per (64-row
//      strip, 32-column group) of each graph, 1 where an edge other than a
//      self loop lies (the backward's format, which takes it from the
//      forward).
//   2. aggregate: a row-tiled product, one block per (64 rows of one graph,
//      128 feature columns), over the live steps of 32 senders of its strip
//      only, compacted in order from the live map (the products sum in the
//      order of a walk over every step; a skipped step's products are 0).
//      A block whose strip has none writes the self term x_r / deg_r and
//      reads nothing else: on a padded batch most blocks.  A step builds
//      each branch's norm tile from adj/src/dst in shared memory (the
//      weights and the [N, N] products never reach device memory) and stages
//      the x tiles.  bf16 runs the products on the tensor cores with mma.sync
//      m16n8k16 (bf16 in, f32 accumulate: exactly the contract's rounding),
//      each of 8 warps owning 32 rows x 32 columns of every branch; a live
//      step's adjacency tile, x tiles and sender factors (src, deg^-1/2)
//      arrive by cp.async in a ring of three stages, two steps ahead of the
//      products (a large graph's strip walks ~100 live steps in a row, so
//      their loads must overlap), and the norm tile is built from the
//      staged tile (plain-T stages its [32 senders, 64 rows] box along the
//      senders' rows and builds the [sender][row] tile that ldmatrix.trans
//      feeds).  f32 keeps full f32 FMA on the CUDA cores, 4 rows x 8 columns
//      per branch and thread, over the same live steps without the ring.
// The modes are compile-time: a single-branch mode runs half the dual mode's
// products, the plain modes no sigmoid.  What bounds it: on a padded batch the degree
// pass's read of adj (SYNREDDIT at N = 3,840: ~1% of the cells live); on a
// dense graph every step is live and the aggregate re-reads x per row tile
// from L2 through mma.sync (no wgmma).  What remains: adj is a dense count
// read in full for a few edges a row, so an edge-list contract is the next
// floor; TMA, deeper pipelines and wgmma for dense graphs are later work.  In
// the forward a cell without an edge forms no sigmoid, so a non-finite logit
// reaches only its edges' cells (the backward forms them on every cell of a
// tile that holds an edge).  bf16 plain / plain-T on graphs of up to 256 nodes take
// the one-launch cluster kernel at the end of this file instead.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;    // rows (receivers) per block
constexpr int kCols = 128;   // feature columns per block
constexpr int kStep = 32;    // senders per step

// weight modes (the ``mode`` argument of the C entry points)
enum Mode : int { kDual = 0, kSig = 1, kNeg = 2, kPlain = 3, kPlainT = 4 };
template <int M> struct Nb { static constexpr int v = M == kDual ? 2 : 1; };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round an f32 value to T and back (the TPU kernel's norm.astype(cdt))
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(s)), "l"(g), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` committed groups are still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// 16 bytes of a row into shared memory: columns [col, col + 16 / sizeof(T))
// of `row`, zero from column `valid` on (valid = 0 for a row past the graph,
// whose `row` is any readable address).  One cp.async when rows are 16-byte
// aligned and `valid` is a multiple of the chunk (vec), element by element
// otherwise.
template <typename T>
__device__ __forceinline__ void copy16(T* s, const T* row, int col, int valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const bool in = col < valid;
    cp_async16(s, in ? row + col : row, in ? 16 : 0);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = col + q < valid ? row[col + q] : from_f<T>(0.f);
  }
}

// m[r, s] of each branch from the count av and the sigmoid sg (unread in the
// plain modes), f32, as the TPU kernels build it
template <int M>
__device__ __forceinline__ void weigh(float av, float sg, float (&m)[Nb<M>::v]) {
  if constexpr (M == kDual) {
    m[0] = __fmul_rn(av, sg);
    m[1] = __fsub_rn(av, m[0]);
  } else if constexpr (M == kSig) {
    m[0] = __fmul_rn(av, sg);
  } else if constexpr (M == kNeg) {
    m[0] = __fmul_rn(av, __fsub_rn(1.0f, sg));
  } else {
    m[0] = av;
  }
}

// the sigmoid of edge s -> r (0 in the plain modes, which have no logits)
template <typename T, int M>
__device__ __forceinline__ float edge_sigmoid(const T* srcb, const T* dstb, int r, int s) {
  if constexpr (M == kPlain || M == kPlainT) return 0.f;
  else return sigmoid(to_f(srcb[s]) + to_f(dstb[r]));
}

// norm[i, k] of each branch, rounded to T: the conv's entry (receiver i,
// sender k), or (receiver k, sender i) in plain-T
template <typename T, int M>
__device__ __forceinline__ void norm_of(const T* a, const T* srcb, const T* dstb,
                                        const float* (&dis)[Nb<M>::v], int i, int k,
                                        int N, float (&nv)[Nb<M>::v]) {
  constexpr int NB = Nb<M>::v;
#pragma unroll
  for (int br = 0; br < NB; ++br) nv[br] = 0.f;
  if (i < N && k < N && i != k) {
    const int r = M == kPlainT ? k : i, s = M == kPlainT ? i : k;
    const float av = to_f(a[(size_t)r * N + s]);
    float m[NB];   // a zero count forms no sigmoid: its +0 terms are the same
    weigh<M == kPlainT ? kPlain : M>(av, av != 0.f ? edge_sigmoid<T, M>(srcb, dstb, r, s) : 0.f,
                                     m);
#pragma unroll
    for (int br = 0; br < NB; ++br)
      nv[br] = round_t<T>(__fmul_rn(__fmul_rn(m[br], dis[br][s]), dis[br][r]));
  }
}

// The live map: a byte per (64-row strip, 32-column group) of each graph's
// adjacency, [B, live_strips(N), live_cols(N)], 1 where an edge other than a
// self loop lies.  Its cell is the aggregate's tile of one step (kRows x
// kStep); the backward's node and edge passes walk it too.
constexpr int kLiveRows = 64, kLiveCols = 32;
static_assert(kRows == kLiveRows && kStep == kLiveCols, "a step of the aggregate is one cell");

__host__ __device__ __forceinline__ int live_strips(int N) {
  return (N + kLiveRows - 1) / kLiveRows;
}
__host__ __device__ __forceinline__ int live_cols(int N) { return (N + kLiveCols - 1) / kLiveCols; }
__host__ __device__ __forceinline__ int steps_of(int N) { return (N + kStep - 1) / kStep; }

// whether the live map has an edge in rows [r, r + rows) x columns [c, c + cs)
// of graph b (r and c multiples of the map's cells)
__device__ __forceinline__ bool live_any(const unsigned char* live, int b, int N, int r,
                                         int rows, int c, int cs) {
  bool any = false;
  for (int rb = r / kLiveRows; rb < live_strips(N) && rb * kLiveRows < r + rows; ++rb)
    for (int cb = c / kLiveCols; cb < live_cols(N) && cb * kLiveCols < c + cs; ++cb)
      any = any || live[((size_t)b * live_strips(N) + rb) * live_cols(N) + cb];
  return any;
}

// The live steps of a block, in order: list[0] their count, list[1..] the
// steps j in [0, steps) for which live_step(j) holds.  A flag per step, then
// warp 0 compacts them in place (a chunk's flags are all read before any of
// its slots is written).  Every thread of the block calls it.
template <typename F>
__device__ __forceinline__ int live_steps(int* list, int steps, F live_step) {
  int* step_of = list + 1;
  for (int j = threadIdx.x; j < steps; j += blockDim.x) step_of[j] = live_step(j);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int j0 = 0; j0 < steps; j0 += 32) {
      const bool f = j0 + lane < steps && step_of[j0 + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      __syncwarp();
      if (f) step_of[count + __popc(m & ((1u << lane) - 1))] = j0 + lane;
      count += __popc(m);
      __syncwarp();
    }
    if (lane == 0) list[0] = count;
  }
  __syncthreads();
  return list[0];
}

// whether step j of the aggregate block on rows r0.. of graph b is live:
// M's cell (rows r0.., senders 32 j..), or in plain-T the transposed box (M's
// rows 32 j.., columns r0..)
template <int M>
__device__ __forceinline__ bool step_live(const unsigned char* live, int b, int N, int r0, int j) {
  return M == kPlainT ? live_any(live, b, N, j * kStep, kStep, r0, kRows)
                      : live_any(live, b, N, r0, kRows, j * kStep, kStep);
}

constexpr int kDegWarps = kThreads / 32;   // row groups: warp w sums rows w, w + 8, ...
constexpr int kDegRows = 4;                // rows a warp of the wide pass has in flight

// deg^-1/2 and 1/deg of the block's columns from each warp's column sums:
// warp 0 adds warps 1..7's in warp order (part: theirs, [NB][7][cols])
template <int NB, int V, int kBlockCols>
__device__ __forceinline__ void finish_degrees(float (&sum)[NB][V],
                                               float (*part)[kDegWarps - 1][kBlockCols],
                                               float* stats, int b, int B, int N, int c) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp > 0) {
#pragma unroll
    for (int br = 0; br < NB; ++br)
#pragma unroll
      for (int q = 0; q < V; ++q) part[br][warp - 1][lane * V + q] = sum[br][q];
  }
  __syncthreads();
  if (warp != 0) return;
  const size_t plane = (size_t)B * N;
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (c + q >= N) continue;
      float s = sum[br][q];
      for (int g = 0; g < kDegWarps - 1; ++g) s += part[br][g][lane * V + q];
      const float deg = s + 1.0f;
      const size_t i = (size_t)b * N + c + q;
      stats[2 * br * plane + i] = rsqrtf(deg);
      stats[(2 * br + 1) * plane + i] = 1.0f / deg;
    }
}

// The degree pass, wide: a block takes 32 V columns of a graph (16 bytes, V
// = 16 / sizeof(T), a lane), each warp kDegRows rows in flight.  stats
// layout: [2 br] deg^-1/2, [2 br + 1] 1/deg of branch br, each [B, N]; live:
// the live map.  Dynamic shared memory: live_strips(N) words.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
degree_wide_kernel(const T* __restrict__ adj, const T* __restrict__ src,
                   const T* __restrict__ dst, float* __restrict__ stats,
                   unsigned char* __restrict__ live, int B, int N) {
  constexpr int NB = Nb<M>::v, V = 16 / sizeof(T), kBlockCols = 32 * V;
  constexpr bool kLogits = M != kPlain && M != kPlainT;
  // a count is non-zero when its bits other than the sign are
  constexpr unsigned kMag = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  __shared__ float part[NB][kDegWarps - 1][kBlockCols];
  extern __shared__ unsigned strip_bits[];   // per strip: bit g, column group g of the block
  const int b = blockIdx.y, c0 = blockIdx.x * kBlockCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, c = c0 + lane * V;
  for (int i = tid; i < live_strips(N); i += kThreads) strip_bits[i] = 0u;
  const T* a = adj + (size_t)b * N * N;
  const T* dstb = dst + (size_t)b * N;
  float lsrc[V];   // the logits of the lane's senders
#pragma unroll
  for (int q = 0; q < V; ++q)
    lsrc[q] = kLogits && c + q < N ? to_f(src[(size_t)b * N + c + q]) : 0.f;
  float sum[NB][V];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int q = 0; q < V; ++q) sum[br][q] = 0.f;
  const bool vec = N % V == 0 && aligned16(adj);
  const unsigned gbit = 1u << (lane / (kLiveCols / V));
  bool has = false;   // an edge in the lane's columns of the current strip
  __syncthreads();    // strip bits cleared

  for (int r0 = warp; r0 < N; r0 += kDegRows * kDegWarps) {
    uint4 w[kDegRows];
#pragma unroll
    for (int u = 0; u < kDegRows; ++u) {
      const int r = r0 + u * kDegWarps;
      if (r < N && c < N && vec) {
        w[u] = __ldg(reinterpret_cast<const uint4*>(a + (size_t)r * N + c));
      } else {
        alignas(16) T e[V];
#pragma unroll
        for (int q = 0; q < V; ++q)
          e[q] = r < N && c + q < N ? a[(size_t)r * N + c + q] : from_f<T>(0.f);
        w[u] = *reinterpret_cast<const uint4*>(e);
      }
    }
#pragma unroll
    for (int u = 0; u < kDegRows; ++u) {
      const int r = r0 + u * kDegWarps;
      if (((w[u].x | w[u].y | w[u].z | w[u].w) & kMag) != 0u) {   // a count in the lane's columns
        const T* v = reinterpret_cast<const T*>(&w[u]);
        const float dr = kLogits ? to_f(dstb[r]) : 0.f;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float av = c + q == r ? 0.f : to_f(v[q]);   // the self loop is dropped
          has = has || av != 0.f;
          if constexpr (!kLogits) {
            sum[0][q] += av;   // +0 where there is no count: the sum unchanged
          } else if (av != 0.f) {
            float m[NB];
            weigh<M>(av, sigmoid(lsrc[q] + dr), m);
#pragma unroll
            for (int br = 0; br < NB; ++br) sum[br][q] += m[br];
          }
        }
      }
      // the warp's last row of a strip (or of the graph): the lane's live bit
      if (r % kLiveRows + kDegWarps >= kLiveRows || r + kDegWarps >= N) {
        if (has) atomicOr(&strip_bits[r / kLiveRows], gbit);
        has = false;
      }
    }
  }
  finish_degrees<NB, V, kBlockCols>(sum, part, stats, b, B, N, c);   // synchronises first
  const int strips = live_strips(N), cols = live_cols(N);
  for (int i = tid; i < strips * V; i += kThreads) {   // the block's V column groups
    const int k = i / V, g = i % V, col = c0 / kLiveCols + g;
    if (col < cols) live[((size_t)b * strips + k) * cols + col] = (strip_bits[k] >> g) & 1u;
  }
}

// The degree pass, a column a lane: a block takes 32 columns (one live-map
// group) of a graph and each lane walks its column, warp w the rows w, w +
// 8, ... strip by strip, one load and one term a row, the sigmoid selected
// only where the count is not 0 (a zero count's term is +0: the wide pass's
// sums, in its order), then one warp vote a strip for the live map.  Held
// to 32 registers (eight blocks an SM), which ptxas meets without a spill:
// at B = 128, N = 256 its 1,024 blocks then run in one wave.  Dynamic
// shared memory: live_strips(N) bytes, a strip's flag.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 8)
degree_col_kernel(const T* __restrict__ adj, const T* __restrict__ src,
                  const T* __restrict__ dst, float* __restrict__ stats,
                  unsigned char* __restrict__ live, int B, int N) {
  constexpr int NB = Nb<M>::v;
  constexpr bool kLogits = M != kPlain && M != kPlainT;
  __shared__ float part[NB][kDegWarps - 1][32];
  extern __shared__ unsigned char strip_live[];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x * 32 + lane;
  const int strips = live_strips(N);
  for (int k = tid; k < strips; k += kThreads) strip_live[k] = 0;
  __syncthreads();
  const T* a = adj + (size_t)b * N * N;
  const T* dstb = dst + (size_t)b * N;
  const bool in = s < N;
  const float ls = kLogits && in ? to_f(src[(size_t)b * N + s]) : 0.f;
  float sum[NB][1];
#pragma unroll
  for (int br = 0; br < NB; ++br) sum[br][0] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kLiveRows) {   // warp-uniform: every lane votes
    const int end = min(k0 + kLiveRows, N);
    bool has = false;
    for (int r = k0 + warp; r < end; r += kDegWarps) {
      const float av = in && r != s ? to_f(a[(size_t)r * N + s]) : 0.f;   // no self loop
      const bool edge = av != 0.f;
      has = has || edge;
      float m[NB];
      weigh<M>(av, kLogits && edge ? sigmoid(ls + to_f(dstb[r])) : 0.f, m);
#pragma unroll
      for (int br = 0; br < NB; ++br) sum[br][0] += m[br];
    }
    if (__any_sync(0xffffffffu, has) && lane == 0) strip_live[k0 / kLiveRows] = 1;
  }
  finish_degrees<NB, 1, 32>(sum, part, stats, b, B, N, s);   // synchronises the block first
  const int cols = live_cols(N);
  for (int k = tid; k < strips; k += kThreads)
    live[((size_t)b * strips + k) * cols + blockIdx.x] = strip_live[k];
}

// graph b's rows of branch br: plane 0 or 1 of a [B, N, H] pair
template <typename T>
__device__ __forceinline__ T* rows_of(T* p0, T* p1, int br, int b, int N, int H) {
  return (br == 0 ? p0 : p1) + (size_t)b * N * H;
}

// graph b's entries of plane k of an f32 [*, B, N] scratch
__device__ __forceinline__ const float* plane_of(const float* p, int k, int b, int B, int N) {
  return p + (size_t)k * B * N + (size_t)b * N;
}

// An aggregate block without a live step: out_r = T(0 + x_r / deg_r) over
// its rows r0.. and columns h0.., the epilogue of a sum that stayed 0.  A
// thread's 16-byte chunks of a branch are all loaded before the first store
// (on a padded batch most blocks do nothing else, so the loads in flight set
// their pace); element by element where rows are not aligned.
template <typename T, int NB>
__device__ __forceinline__ void self_term(const T* x0, const T* x1, const float* stats, T* o0,
                                          T* o1, int b, int B, int N, int H, int r0, int h0) {
  constexpr int V = 16 / sizeof(T), kChunks = kRows * kCols / V / kThreads;
  static_assert(kRows * kCols % (V * kThreads) == 0, "whole chunks a thread");
  const bool vec = H % V == 0 && aligned16(x0) && aligned16(o0) &&
                   (NB == 1 || (aligned16(x1) && aligned16(o1)));
  if (vec) {
#pragma unroll 1
    for (int br = 0; br < NB; ++br) {
      const T* x = rows_of(x0, x1, br, b, N, H);
      T* out = rows_of(o0, o1, br, b, N, H);
      const float* inv = plane_of(stats, 2 * br + 1, b, B, N);
      uint4 u[kChunks];
      float iv[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int r = r0 + i / (kCols / V), col = h0 + (i % (kCols / V)) * V;
        const bool ok = r < N && col < H;
        u[j] = ok ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * H + col))
                  : make_uint4(0, 0, 0, 0);
        iv[j] = ok ? inv[r] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int r = r0 + i / (kCols / V), col = h0 + (i % (kCols / V)) * V;
        if (r >= N || col >= H) continue;
        T* e = reinterpret_cast<T*>(&u[j]);
#pragma unroll
        for (int q = 0; q < V; ++q) e[q] = from_f<T>(__fadd_rn(0.f, __fmul_rn(to_f(e[q]), iv[j])));
        *reinterpret_cast<uint4*>(out + (size_t)r * H + col) = u[j];
      }
    }
    return;
  }
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    const T* x = rows_of(x0, x1, br, b, N, H);
    T* out = rows_of(o0, o1, br, b, N, H);
    const float* inv = plane_of(stats, 2 * br + 1, b, B, N);
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = r0 + i / kCols, col = h0 + i % kCols;
      if (r < N && col < H) {
        const size_t at = (size_t)r * H + col;
        out[at] = from_f<T>(__fadd_rn(0.f, __fmul_rn(to_f(x[at]), inv[r])));
      }
    }
  }
}

// f32: full-f32 FMA on the CUDA cores.  Dynamic shared memory: the x and
// norm tiles, then the live-step list.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 2)
aggregate_fma_kernel(const T* __restrict__ adj, const T* __restrict__ x0,
                     const T* __restrict__ x1, const T* __restrict__ src,
                     const T* __restrict__ dst, const float* __restrict__ stats,
                     const unsigned char* __restrict__ live, T* __restrict__ o0,
                     T* __restrict__ o1, int B, int N, int H) {
  constexpr int NB = Nb<M>::v;
  extern __shared__ float smem[];
  float* xs = smem;                           // [NB][kStep][kCols]
  float* ns = xs + NB * kStep * kCols;        // [NB][kRows][kStep + 1]
  int* list = reinterpret_cast<int*>(ns + NB * kRows * (kStep + 1));   // live steps

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 + i; cols tx*4 + j and 64 + tx*4 + j

  if (live_steps(list, steps_of(N), [&](int j) { return step_live<M>(live, b, N, r0, j); }) ==
      0) {
    self_term<T, NB>(x0, x1, stats, o0, o1, b, B, N, H, r0, h0);
    return;
  }

  float acc[NB][4][8];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[br][i][j] = 0.f;

  // the per-graph pointers are formed from the parameters at their uses,
  // and the step count is read from shared memory: registers the
  // accumulators need
  for (int js = 0; js < list[0]; ++js) {
    const int s0 = list[1 + js] * kStep;
    for (int i = tid; i < kStep * kCols; i += kThreads) {
      const int k = i / kCols, c = i % kCols;
      const int s = s0 + k, col = h0 + c;
      const bool ok = s < N && col < H;
#pragma unroll
      for (int br = 0; br < NB; ++br)
        xs[br * kStep * kCols + i] =
            ok ? to_f(rows_of(x0, x1, br, b, N, H)[(size_t)s * H + col]) : 0.f;
    }
    for (int i = tid; i < kRows * kStep; i += kThreads) {
      // plain-T reads M's entry (s0 + k, r0 + rr): neighbouring threads take
      // neighbouring rows rr, i.e. neighbouring addresses of adj
      const int rr = M == kPlainT ? i % kRows : i / kStep;
      const int k = M == kPlainT ? i / kRows : i % kStep;
      const float* dis[NB];
#pragma unroll
      for (int br = 0; br < NB; ++br) dis[br] = plane_of(stats, 2 * br, b, B, N);
      float nv[NB];
      norm_of<T, M>(adj + (size_t)b * N * N, src + (size_t)b * N, dst + (size_t)b * N, dis,
                    r0 + rr, s0 + k, N, nv);
#pragma unroll
      for (int br = 0; br < NB; ++br) ns[(br * kRows + rr) * (kStep + 1) + k] = nv[br];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
#pragma unroll
      for (int br = 0; br < NB; ++br) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ns[(br * kRows + ty * 4 + i) * (kStep + 1) + k];
        const float* xk = xs + br * kStep * kCols + k * kCols;
        const float4 c0 = *reinterpret_cast<const float4*>(xk + tx * 4);
        const float4 c1 = *reinterpret_cast<const float4*>(xk + 64 + tx * 4);
        const float bv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[br][i][j] = fmaf(av[i], bv[j], acc[br][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= H) continue;
      const size_t at = (size_t)r * H + col;
#pragma unroll
      for (int br = 0; br < NB; ++br)
        rows_of(o0, o1, br, b, N, H)[at] = from_f<T>(__fadd_rn(
            acc[br][i][j], __fmul_rn(to_f(rows_of(x0, x1, br, b, N, H)[at]),
                                     plane_of(stats, 2 * br + 1, b, B, N)[r])));
    }
  }
}

// bf16: tensor-core products (mma.sync m16n8k16, f32 accumulate).
constexpr int kALd = kStep + 8;   // norm tile row pitch (bf16), 80 B: ldmatrix without bank conflicts
constexpr int kBLd = kCols + 8;   // x tile row pitch (bf16), 272 B
constexpr int kTLd = kRows + 8;   // plain-T's [sender][row] norm tile pitch (bf16), 144 B
static_assert(kStep * kTLd <= kRows * kALd, "plain-T's norm tile fits the norm tile buffer");

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// aggregate_mma_kernel's dynamic shared memory: kFwdStages stages, each
// the tiles of one live step as cp.async brings them (bytes: the adj tile,
// NB x tiles, the senders' src as T and deg^-1/2 of each branch as f32),
// then the live-step list (ints)
constexpr int kFwdStages = 3;                      // steps in flight
constexpr int kAdjTile = kRows * kStep;            // [row][sender], plain-T [sender][row]
constexpr int kXTile = kStep * kBLd;               // [sender][column]
template <int M>
struct MmaSmem {
  static constexpr int NB = Nb<M>::v;
  static constexpr int kX = kAdjTile * 2;                // byte offsets in a stage
  static constexpr int kSrc = kX + NB * kXTile * 2;
  static constexpr int kDis = kSrc + kStep * 2;
  static constexpr int kStage = kDis + NB * kStep * 4;
  static_assert(kX % 16 == 0 && kSrc % 16 == 0 && kDis % 16 == 0 && kStage % 16 == 0,
                "16-byte copies");
  __host__ __device__ static size_t bytes(int N) {
    return (size_t)kFwdStages * kStage + (steps_of(N) + 1) * sizeof(int);
  }
};

template <int M>
__global__ void __launch_bounds__(kThreads, 2)
aggregate_mma_kernel(const __nv_bfloat16* __restrict__ adj,
                     const __nv_bfloat16* __restrict__ x0,
                     const __nv_bfloat16* __restrict__ x1,
                     const __nv_bfloat16* __restrict__ src,
                     const __nv_bfloat16* __restrict__ dst,
                     const float* __restrict__ stats, const unsigned char* __restrict__ live,
                     __nv_bfloat16* __restrict__ o0, __nv_bfloat16* __restrict__ o1, int B,
                     int N, int H) {
  using bf16 = __nv_bfloat16;
  using S = MmaSmem<M>;
  constexpr int NB = Nb<M>::v;
  constexpr bool kLogits = M != kPlain && M != kPlainT;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  int* list = reinterpret_cast<int*>(mma_smem + kFwdStages * S::kStage);
  __shared__ __align__(16) bf16 As[NB][kRows * kALd];   // norm tiles [row][sender]
  __shared__ float rowf[1 + NB][kRows];   // the block's rows: dst, deg^-1/2 of each branch

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // warp owns rows wm*32.., columns wn*32..

  const int nk = live_steps(list, steps_of(N),
                            [&](int j) { return step_live<M>(live, b, N, r0, j); });
  if (nk == 0) {
    self_term<bf16, NB>(x0, x1, stats, o0, o1, b, B, N, H, r0, h0);
    return;
  }
  const int* step_of = list + 1;
  const bf16* a = adj + (size_t)b * N * N;
  const bool vec_x = H % 8 == 0 && aligned16(x0) && (NB == 1 || aligned16(x1));
  const bool vec_a = N % 8 == 0 && aligned16(adj);
  const bool vec_s = N % 8 == 0 && aligned16(src), vec_d = N % 4 == 0 && aligned16(stats);
  auto stage_of = [&](int js) { return mma_smem + (js % kFwdStages) * S::kStage; };

  // the tiles of the live step in slot js into its stage: 16 bytes a thread
  // of adj (M's rows r0.. at senders s0.., or in plain-T M's rows s0.. at
  // columns r0..), two of each x tile, and the senders' factors (0 past N)
  auto issue = [&](int js) {
    unsigned char* sb = stage_of(js);
    bf16* st = reinterpret_cast<bf16*>(sb);
    const int s0 = step_of[js] * kStep;
    if constexpr (M == kPlainT) {
      const int i = tid / (kRows / 8), j = (tid % (kRows / 8)) * 8, s = s0 + i;
      copy16(st + i * kRows + j, s < N ? a + (size_t)s * N : a, r0 + j, s < N ? N : 0, vec_a);
    } else {
      const int i = tid / (kStep / 8), j = (tid % (kStep / 8)) * 8, r = r0 + i;
      copy16(st + i * kStep + j, r < N ? a + (size_t)r * N : a, s0 + j, r < N ? N : 0, vec_a);
    }
#pragma unroll
    for (int br = 0; br < NB; ++br) {
      const bf16* xb = rows_of(x0, x1, br, b, N, H);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * kThreads;
        const int k = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8, sk = s0 + k;
        copy16(st + kAdjTile + br * kXTile + k * kBLd + c, sk < N ? xb + (size_t)sk * H : xb,
               h0 + c, sk < N ? H : 0, vec_x);
      }
    }
    if (kLogits && tid < kStep / 8) {
      copy16(reinterpret_cast<bf16*>(sb + S::kSrc) + tid * 8, src + (size_t)b * N, s0 + tid * 8,
             N, vec_s);
    } else if (tid >= kStep / 8 && tid < kStep / 8 + NB * kStep / 4) {
      const int q = tid - kStep / 8, br = q / (kStep / 4), c = (q % (kStep / 4)) * 4;
      copy16(reinterpret_cast<float*>(sb + S::kDis) + br * kStep + c,
             plane_of(stats, 2 * br, b, B, N), s0 + c, N, vec_d);
    }
  };
  // start the first live steps' copies, then stage the block's rows'
  // factors meanwhile (0 past N)
#pragma unroll
  for (int js = 0; js < kFwdStages - 1; ++js) {
    if (js < nk) issue(js);
    cp_async_commit();
  }
  for (int i = tid; i < kRows; i += kThreads) {
    const bool ok = r0 + i < N;
    if constexpr (kLogits) rowf[0][i] = ok ? to_f(dst[(size_t)b * N + r0 + i]) : 0.f;
#pragma unroll
    for (int br = 0; br < NB; ++br)
      rowf[1 + br][i] = ok ? plane_of(stats, 2 * br, b, B, N)[r0 + i] : 0.f;
  }

  // the norm tiles of the step in slot js from its adjacency tile: each
  // thread 8 senders of one row (plain-T: 8 rows of one sender, into the
  // [sender][row] tile that ldmatrix.trans feeds)
  auto build = [&](int js) {
    const unsigned char* sb = stage_of(js);
    const bf16* st = reinterpret_cast<const bf16*>(sb);
    const bf16* ssrc = reinterpret_cast<const bf16*>(sb + S::kSrc);      // [kStep]
    const float* sdis = reinterpret_cast<const float*>(sb + S::kDis);   // [NB][kStep]
    const int s0 = step_of[js] * kStep;
    alignas(16) bf16 n8[NB][8];
    if constexpr (M == kPlainT) {
      // entry (sender s, receiver rc) of M: (m * dis_rc) * dis_s, rc being
      // M's sender
      const int ts = tid / (kRows / 8), tc = (tid % (kRows / 8)) * 8, s = s0 + ts;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + ts * kRows + tc);
      const bf16* av = reinterpret_cast<const bf16*>(&raw);
      const float dis_s = sdis[ts];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rc = r0 + tc + j;
        const float nv = s < N && rc < N && s != rc
                             ? __fmul_rn(__fmul_rn(__bfloat162float(av[j]), rowf[1][tc + j]),
                                         dis_s)
                             : 0.f;
        n8[0][j] = __float2bfloat16(nv);
      }
      *reinterpret_cast<uint4*>(&As[0][ts * kTLd + tc]) = *reinterpret_cast<const uint4*>(n8[0]);
    } else {
      const int rr = tid / 4, g = tid % 4, r = r0 + rr;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + rr * kStep + g * 8);
      const bf16* av = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = g * 8 + j, s = s0 + k;
        float nv[NB];
#pragma unroll
        for (int br = 0; br < NB; ++br) nv[br] = 0.f;
        const float cnt = __bfloat162float(av[j]);
        if (r < N && s < N && s != r && cnt != 0.f) {   // a zero count: +0, no sigmoid
          float m[NB];
          weigh<M>(cnt, kLogits ? sigmoid(__bfloat162float(ssrc[k]) + rowf[0][rr]) : 0.f, m);
#pragma unroll
          for (int br = 0; br < NB; ++br)   // (m * dis_sender) * dis_receiver
            nv[br] = __fmul_rn(__fmul_rn(m[br], sdis[br * kStep + k]), rowf[1 + br][rr]);
        }
#pragma unroll
        for (int br = 0; br < NB; ++br) n8[br][j] = __float2bfloat16(nv[br]);
      }
#pragma unroll
      for (int br = 0; br < NB; ++br)
        *reinterpret_cast<uint4*>(&As[br][rr * kALd + g * 8]) =
            *reinterpret_cast<const uint4*>(n8[br]);
    }
  };

  float acc[NB][2][4][4];   // [branch][m tile][n tile][fragment]
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[br][mt][nt][f] = 0.f;

  static_assert(kFwdStages >= 2, "a step's copies are in flight while another is multiplied");
  for (int js = 0; js < nk; ++js) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();   // step js staged (rows' factors too); every warp done with step js - 1
    if (js + kFwdStages - 1 < nk) issue(js + kFwdStages - 1);
    cp_async_commit();
    build(js);
    __syncthreads();
    const bf16* xs = reinterpret_cast<const bf16*>(stage_of(js)) + kAdjTile;
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
#pragma unroll
      for (int br = 0; br < NB; ++br) {
        unsigned af[2][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (M == kPlainT)   // the [sender][row] tile, transposed
            ldsm_x4_trans(af[mt], &As[br][(kk + lane % 8 + (lane / 16) * 8) * kTLd + wm * 32 +
                                          mt * 16 + ((lane / 8) % 2) * 8]);
          else
            ldsm_x4(af[mt], &As[br][(wm * 32 + mt * 16 + lane % 16) * kALd + kk + (lane / 16) * 8]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned t[4];
          ldsm_x4_trans(t, xs + br * kXTile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kBLd +
                               wn * 32 + np * 16 + (lane / 16) * 8);
          bfr[np * 2][0] = t[0];
          bfr[np * 2][1] = t[1];
          bfr[np * 2 + 1][0] = t[2];
          bfr[np * 2 + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[br][mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int br = 0; br < NB; ++br) {
    const float* inv = plane_of(stats, 2 * br + 1, b, B, N);
    const bf16* xb = rows_of(x0, x1, br, b, N, H);
    bf16* out = rows_of(o0, o1, br, b, N, H);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = r0 + wm * 32 + mt * 16 + lane / 4 + (f / 2) * 8;
          const int col = h0 + wn * 32 + nt * 8 + (lane % 4) * 2 + f % 2;
          if (r >= N || col >= H) continue;
          const size_t at = (size_t)r * H + col;
          const float xv = __bfloat162float(xb[at]);
          out[at] = __float2bfloat16(__fadd_rn(acc[br][mt][nt][f], __fmul_rn(xv, inv[r])));
        }
  }
}

// Raise kernel fn's dynamic shared memory cap on the current device to
// `bytes`, calling cudaFuncSetAttribute only when no earlier call there set
// as much.  cap: the kernel's own per-device record (a function-local static
// of its launcher).
constexpr int kMaxDevices = 64;
cudaError_t raise_smem(const void* fn, std::atomic<int>* cap, size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cap[dev].load() >= (int)bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < kMaxDevices) {
    int seen = cap[dev].load();
    while (seen < (int)bytes && !cap[dev].compare_exchange_weak(seen, (int)bytes)) {
    }
  }
  return e;
}

// The degree pass, on one of two kernels with one result (the same
// statistics bit for bit and the same live map; neither forms a sigmoid
// where a count is 0): 16 bytes a lane (degree_wide_kernel) where 32 lanes'
// columns of a graph a block still give every SM four blocks, else a column
// a lane (degree_col_kernel, 32 columns a block), which keeps more blocks in
// flight.  Measured (H100, chip_smoke.py --rows): at B = 128, N = 3,840 the
// wide pass (1,920 blocks in bf16) reads adj at ~3.1 TB/s; at B = 128, N =
// 256 (128 wide blocks in bf16) the column pass (1,024 blocks) was the
// fastest of the lane widths tried.
template <typename T, int M>
int launch_degree(const void* adj, const void* src, const void* dst, float* stats,
                  unsigned char* live, int B, int N, cudaStream_t stream) {
  // plain-T's degree and live map are plain's: M's column sums and cells
  constexpr int MD = M == kPlainT ? kPlain : M;
  constexpr int kWideCols = 32 * 16 / (int)sizeof(T);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool wide = (long long)B * ((N + kWideCols - 1) / kWideCols) >= 4LL * sms;
  const T *a = static_cast<const T*>(adj), *s = static_cast<const T*>(src),
          *d = static_cast<const T*>(dst);
  if (!wide) {   // the strip flags: live_strips(N) bytes, far below the default limit
    degree_col_kernel<T, MD><<<dim3((N + 31) / 32, B), kThreads, live_strips(N), stream>>>(
        a, s, d, stats, live, B, N);
    return (int)cudaGetLastError();
  }
  const size_t smem = live_strips(N) * sizeof(unsigned);   // the strip bits
  static std::atomic<int> cap[kMaxDevices];
  e = raise_smem((const void*)degree_wide_kernel<T, MD>, cap, smem);
  if (e != cudaSuccess) return (int)e;
  degree_wide_kernel<T, MD><<<dim3((N + kWideCols - 1) / kWideCols, B), kThreads, smem,
                              stream>>>(a, s, d, stats, live, B, N);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd_f32(const void* adj, const void* x0, const void* x1, const void* src,
                   const void* dst, void* o0, void* o1, float* stats, unsigned char* live,
                   int B, int N, int H, cudaStream_t stream) {
  constexpr int NB = Nb<M>::v;
  int err = launch_degree<float, M>(adj, src, dst, stats, live, B, N, stream);
  if (err != 0) return err;
  const size_t smem = NB * (kStep * kCols + kRows * (kStep + 1)) * sizeof(float) +
                      (steps_of(N) + 1) * sizeof(int);
  static std::atomic<int> cap[kMaxDevices];
  cudaError_t e = raise_smem((const void*)aggregate_fma_kernel<float, M>, cap, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  aggregate_fma_kernel<float, M><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(adj), static_cast<const float*>(x0),
      static_cast<const float*>(x1), static_cast<const float*>(src),
      static_cast<const float*>(dst), stats, live, static_cast<float*>(o0),
      static_cast<float*>(o1), B, N, H);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd_bf16(const void* adj, const void* x0, const void* x1, const void* src,
                    const void* dst, void* o0, void* o1, float* stats, unsigned char* live,
                    int B, int N, int H, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int err = launch_degree<bf16, M>(adj, src, dst, stats, live, B, N, stream);
  if (err != 0) return err;
  const size_t smem = MmaSmem<M>::bytes(N);
  static std::atomic<int> cap[kMaxDevices];
  cudaError_t e = raise_smem((const void*)aggregate_mma_kernel<M>, cap, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  aggregate_mma_kernel<M><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(adj), static_cast<const bf16*>(x0),
      static_cast<const bf16*>(x1), static_cast<const bf16*>(src),
      static_cast<const bf16*>(dst), stats, live, static_cast<bf16*>(o0),
      static_cast<bf16*>(o1), B, N, H);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd(int dtype, const void* adj, const void* x0, const void* x1, const void* src,
               const void* dst, void* o0, void* o1, float* stats, unsigned char* live, int B,
               int N, int H, cudaStream_t stream) {
  if (dtype == 0)
    return launch_fwd_f32<M>(adj, x0, x1, src, dst, o0, o1, stats, live, B, N, H, stream);
  if (dtype == 1)
    return launch_fwd_bf16<M>(adj, x0, x1, src, dst, o0, o1, stats, live, B, N, H, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward (VJP) of the weighted convs, for Hopper (sm_90a).
//
// Replaces (cal_tpu/ops/pallas_gcn.py):
//   dual    _att_dual_bwd_kernel (the custom VJP of fused_gcn_dense_att_dual)
//   sig/neg _att_bwd_kernel      (the custom VJP of fused_gcn_dense_att, K18B)
//
// Contract, per graph and branch (m, x, g) = (mc, xc, gc) and (mo, xo, go)
// in the dual mode, (m, x, g) in sig/neg, with deg, dis = deg^-1/2 and inv =
// 1/deg of the forward:
//   p_s  = sum_r T(m_rs) * T(dis_r g_r)     dx_s = T(dis_s p_s + inv_s g_s)
//   u_r  = sum_s T(m_rs) * T(dis_s x_s)
//   t_n  = -1/2 dis_n^3 (g_n.u_n + p_n.x_n) - (g_n.x_n) inv_n^2
//   G_rs = g_r . x_s                        dm_rs = dis_r dis_s G_rs + t_s
//   dpre = (dm_c - dm_o) a_off sigma (1 - sigma)        (dual)
//          +/- dm a_off sigma (1 - sigma)              (sig: +, neg: -)
//   dsrc_s = T(sum_r dpre_rs),  ddst_r = T(sum_s dpre_rs)
// Products take T-valued inputs and accumulate in f32 (exact products for
// bf16); t, dm and dpre stay f32, as in the TPU kernels.
//
// Bound on this card: three products of 2 N^2 H per graph and branch (12.9
// GFLOP for the dual mode at B=128, N=256, H=128 on a dense adjacency), over
// the cells of real nodes only (padded slots hold no edge).  In bf16 the
// traffic bounds it (67 MB at N = 256, 0.020 ms; adj alone is 3.8 GB at N =
// 3,840, 1.1 ms); in f32 the products on the CUDA cores do on dense graphs.
// Design: t_s needs the whole column product p_s and row product u_s, and
// dsrc needs column sums over every receiver, so the work is split into
// passes (the TPU kernel holds a whole [N, N] graph in VMEM instead):
//   1. the forward's degree pass (deg^-1/2 and 1/deg of each branch, and the
//      live map: a byte per 64 x 32 cell of adj, 1 where an edge other than
//      a self loop lies; a padded batch is mostly empty cells), unless the
//      caller hands over the forward's own statistics and live map;
//   2. a scale pass, one warp per node: T(dis x) and T(dis g) of each branch
//      into a T scratch with 16-byte aligned rows, and g_n . x_n;
//   3. a node pass, one block per 64 nodes of a graph in one of two roles:
//      receivers (u = m T(dis x), along its rows of adj) or senders (p = m^T
//      T(dis g), down its columns; writes dx), over the live steps of 64
//      (f32: 32) neighbours only.  A step's m tile of every branch is built
//      once from a coalesced adj tile (sigmoid in f32, rounded to T) into
//      shared memory, one step ahead of the products that multiply it by the
//      staged T(dis x) / T(dis g) rows; g.u or p.x go to an f32 [3 branches,
//      B, N] scratch with g.x;
//   4. an edge pass, one block per 128 x 128 (receiver, sender) tile: G of
//      each branch, then dm and dpre straight from the accumulators, row and
//      column sums by warp shuffles and shared memory into f32 partial
//      planes; a tile without an edge writes zeros and reads nothing else;
//   5. a finalize pass summing the partial planes and casting once.
// bf16 runs all six products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate: the contract's rounding), each warp owning a 32 x 32 tile
// of every branch; the sender role feeds m^T by ldmatrix.trans.  f32 keeps
// full-f32 FMA on the CUDA cores (no TF32) over the same tiles and fragment
// layout.  Tiles arrive by cp.async, three stages deep; rows that are not
// 16-byte aligned are copied element by element.  No atomics: the sums are
// deterministic; the [N, N] intermediates never reach device memory.  What
// holds it on dense graphs: a sigmoid per element in each node role and the
// edge pass on the CUDA cores, and mma.sync's fragments staged through
// ldmatrix (no wgmma); TMA pipelines and persistent blocks are later work.

constexpr int kBwdRows = 64;     // nodes per block (node pass)
constexpr int kNodeCols = 128;   // feature columns per chunk (node pass)
constexpr int kStages = 3;       // tiles in flight (node and edge passes)
constexpr int kEdgeTile = 128;   // receivers x senders per block (edge pass)
constexpr int kEdgeThreads = kEdgeTile * kEdgeTile / 32;   // a warp per 32 x 32
// neighbours per step (node pass) and feature columns per step (edge pass):
// f32 tiles take twice the bytes, so half the width
template <typename T> struct NodeK { static constexpr int v = sizeof(T) == 2 ? 64 : 32; };
template <typename T> struct EdgeK { static constexpr int v = sizeof(T) == 2 ? 32 : 16; };

__host__ __device__ __forceinline__ int n_tiles(int N) {
  return (N + kEdgeTile - 1) / kEdgeTile;
}

// rows of the scaled scratch: H rounded up to 8 elements (16 bytes of bf16)
__host__ __device__ __forceinline__ int padded_cols(int H) { return (H + 7) / 8 * 8; }

// 8 consecutive elements of shared memory as f32, and 8 values stored as T
// (16-byte aligned)
__device__ __forceinline__ void lds8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(e[q]);
}
__device__ __forceinline__ void lds8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}
__device__ __forceinline__ void sts8(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    u[q] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void sts8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The products of one warp: acc[mt][nt] += A[32 rows, 16 k] B[16 k, 32 cols]
// for one 16-deep slice at k, in mma.sync's fragment layout (fragment f of
// (mt, nt) is row mt*16 + lane/4 + (f/2)*8, column nt*8 + (lane%4)*2 + f%2).
// A at `a` with row pitch `lda` (kATrans: stored [k][row]); B at `b` with
// pitch `ldb`, stored [k][col] (kBTrans) or [col][k].  bf16 on the tensor
// cores; f32 by FMA on the CUDA cores, full f32.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void warp_mma16(float (&acc)[2][4][4], const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* b, int ldb, int lane) {
  unsigned af[2][4], bfr[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (kATrans)
      ldsm_x4_trans(af[mt],
                    a + (lane % 8 + (lane / 16) * 8) * lda + mt * 16 + ((lane / 8) % 2) * 8);
    else
      ldsm_x4(af[mt], a + (mt * 16 + lane % 16) * lda + (lane / 16) * 8);
  }
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    unsigned t[4];
    if (kBTrans)
      ldsm_x4_trans(t, b + (lane % 8 + ((lane / 8) % 2) * 8) * ldb + np * 16 + (lane / 16) * 8);
    else
      ldsm_x4(t, b + (np * 16 + lane % 8 + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8);
    bfr[np * 2][0] = t[0];
    bfr[np * 2][1] = t[1];
    bfr[np * 2 + 1][0] = t[2];
    bfr[np * 2 + 1][1] = t[3];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
}
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void warp_mma16(float (&acc)[2][4][4], const float* a, int lda,
                                           const float* b, int ldb, int lane) {
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    float av[2][2], bv[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + lane / 4 + h * 8;
        av[mt][h] = kATrans ? a[k * lda + row] : a[row * lda + k];
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + (lane % 4) * 2;
      if (kBTrans) {
        const float2 v = *reinterpret_cast<const float2*>(b + k * ldb + col);
        bv[nt][0] = v.x;
        bv[nt][1] = v.y;
      } else {
        bv[nt][0] = b[col * ldb + k];
        bv[nt][1] = b[(col + 1) * ldb + k];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          acc[mt][nt][f] = fmaf(av[mt][f / 2], bv[nt][f % 2], acc[mt][nt][f]);
  }
}

// scratch (f32 words): stats [2 NB, B, N] | dots [3 NB, B, N] (g.u, p.x, g.x
// of each branch) | part_src, part_dst [B, tiles, N] | xd, gd [NB, B, N, HP]
// of T (T(dis x), T(dis g)) | live: the live map [B, live_strips(N),
// live_cols(N)] bytes; each 64-word aligned
struct BwdScratch {
  size_t dots, part_src, part_dst, xd, gd, live, total;
};

static_assert(kBwdRows == kLiveRows, "a node block is one strip of the live map");

__host__ __forceinline__ size_t round64(size_t v) { return (v + 63) / 64 * 64; }

inline BwdScratch bwd_scratch(int B, int N, int H, int elt, int NB) {
  const size_t plane = (size_t)B * N;
  BwdScratch s;
  s.dots = 2 * NB * plane;
  s.part_src = s.dots + 3 * NB * plane;
  s.part_dst = s.part_src + plane * n_tiles(N);
  s.xd = round64(s.part_dst + plane * n_tiles(N));
  const size_t scaled = round64((NB * plane * padded_cols(H) * elt + 3) / 4);
  s.gd = s.xd + scaled;
  s.live = s.gd + scaled;
  s.total = s.live + round64(((size_t)B * live_strips(N) * live_cols(N) + 3) / 4);
  return s;
}

// pass 2: xd = T(dis x), gd = T(dis g) of each branch (rows padded to HP with
// zeros) and g.x, one warp per node
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
bwd_scale_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                 const T* __restrict__ g0, const T* __restrict__ g1,
                 const float* __restrict__ stats, float* __restrict__ dots,
                 T* __restrict__ xd, T* __restrict__ gd, int B, int N, int H) {
  constexpr int NB = Nb<M>::v;
  const int lane = threadIdx.x % 32, HP = padded_cols(H);
  const size_t plane = (size_t)B * N;
  const size_t node = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;   // b * N + n
  if (node >= plane) return;
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    const T* x = (br == 0 ? x0 : x1) + node * H;
    const T* g = (br == 0 ? g0 : g1) + node * H;
    T* xo = xd + (br * plane + node) * HP;
    T* go = gd + (br * plane + node) * HP;
    const float d = stats[2 * br * plane + node];
    float gx = 0.f;
    for (int h = lane; h < HP; h += 32) {
      const float xv = h < H ? to_f(x[h]) : 0.f, gv = h < H ? to_f(g[h]) : 0.f;
      xo[h] = from_f<T>(__fmul_rn(xv, d));
      go[h] = from_f<T>(__fmul_rn(gv, d));
      gx = fmaf(gv, xv, gx);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) gx += __shfl_xor_sync(0xffffffffu, gx, off);
    if (lane == 0) dots[(3 * br + 2) * plane + node] = gx;
  }
}

// node pass shared memory (elements of T unless named): kStages stages of
// [adj tile | NB right-operand tiles], two buffers of NB m tiles, then f32:
// the reduction buffer, the block's own logits and the logits along the walk,
// then the block's live steps (ints)
template <typename T, int NB>
struct NodeSmem {
  static constexpr int K = NodeK<T>::v;
  static constexpr int P = 16 / sizeof(T);                       // row padding: 16 bytes
  static constexpr int kAdj = kBwdRows * K;                       // either orientation
  static constexpr int kXPitch = kNodeCols + P;
  static constexpr int kX = K * kXPitch;
  static constexpr int kStage = kAdj + NB * kX;
  static constexpr int kMRow = K + P;                             // m tile [node][k]
  static constexpr int kMCol = kBwdRows + P;                      // m tile [k][node]
  static constexpr int kM = kBwdRows * kMRow > K * kMCol ? kBwdRows * kMRow : K * kMCol;
  static constexpr int kRed = 4 * kBwdRows * NB;                  // floats
  __host__ __device__ static int steps(int N) { return (N + K - 1) / K; }
  static size_t bytes(int N) {
    return (kStages * kStage + 2 * NB * kM) * sizeof(T) +
           (kRed + kBwdRows + steps(N) * K) * sizeof(float) + (steps(N) + 1) * sizeof(int);
  }
};

// pass 3, one role: ROLE 0 (receivers) u = m T(dis x) and g.u; ROLE 1
// (senders) p = m^T T(dis g), dx and p.x.  The block owns nodes n0.. and walks
// the other end k of their edges in steps of K, over the feature columns in
// chunks of kNodeCols; only the steps the live map marks are loaded and
// multiplied (on padded batches most are not).
template <typename T, int M, int ROLE>
__device__ __forceinline__ void bwd_node_role(
    unsigned char* smem, const T* __restrict__ adj, const T* __restrict__ x0,
    const T* __restrict__ x1, const T* __restrict__ g0, const T* __restrict__ g1,
    const T* __restrict__ src, const T* __restrict__ dst, const float* __restrict__ stats,
    const T* __restrict__ xd, const T* __restrict__ gd, T* __restrict__ dx0,
    T* __restrict__ dx1, float* __restrict__ dots, const unsigned char* __restrict__ live,
    int B, int N, int H) {
  using S = NodeSmem<T, Nb<M>::v>;
  constexpr int NB = Nb<M>::v, V = 16 / sizeof(T), K = S::K;
  // the adj / m tile: [node][k] for receivers, [k][node] for senders
  constexpr int kTR = ROLE == 0 ? kBwdRows : K, kTC = ROLE == 0 ? K : kBwdRows;
  constexpr int kMP = ROLE == 0 ? S::kMRow : S::kMCol;
  T* stage = reinterpret_cast<T*>(smem);
  T* mtile = stage + kStages * S::kStage;
  float* red = reinterpret_cast<float*>(mtile + 2 * NB * S::kM);
  float* lo = red + S::kRed;           // [node] dst of the receivers / src of the senders
  float* lg = lo + kBwdRows;           // [k] src of the senders / dst of the receivers
  int* step_list = reinterpret_cast<int*>(lg + S::steps(N) * K);   // [count | steps]

  const int n0 = blockIdx.x * kBwdRows, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // warp owns nodes wm*32.., columns wn*32..
  const int HP = padded_cols(H);
  const size_t plane = (size_t)B * N, gN = (size_t)b * N;
  const T* a = adj + gN * N;
  const T* rhs[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) rhs[br] = (ROLE == 0 ? xd : gd) + (br * plane + gN) * HP;
  const T* walk = (ROLE == 0 ? src : dst) + gN;
  const T* own = (ROLE == 0 ? dst : src) + gN;
  for (int i = tid; i < S::steps(N) * K; i += kThreads) lg[i] = i < N ? to_f(walk[i]) : 0.f;
  for (int i = tid; i < kBwdRows; i += kThreads) lo[i] = n0 + i < N ? to_f(own[n0 + i]) : 0.f;
  // the live steps, in order
  const int* step_of = step_list + 1;
  const int nk = live_steps(step_list, S::steps(N), [&](int j) {
    return ROLE == 0 ? live_any(live, b, N, n0, kBwdRows, j * K, K)
                     : live_any(live, b, N, j * K, K, n0, kBwdRows);
  });
  const int chunks = (HP + kNodeCols - 1) / kNodeCols, total = nk * chunks;

  const bool vec_a = N % V == 0 && aligned16(adj);
  auto load = [&](int it) {
    T* st = stage + (it % kStages) * S::kStage;
    const int k0 = step_of[it % nk] * K, h0 = (it / nk) * kNodeCols;
    for (int c = tid; c < kTR * kTC / V; c += kThreads) {
      const int i = c / (kTC / V), j = (c % (kTC / V)) * V;
      const int r = (ROLE == 0 ? n0 : k0) + i, s = (ROLE == 0 ? k0 : n0) + j;
      copy16(st + i * kTC + j, r < N ? a + (size_t)r * N : a, s, r < N ? N : 0, vec_a);
    }
#pragma unroll
    for (int br = 0; br < NB; ++br)
      for (int c = tid; c < K * kNodeCols / V; c += kThreads) {
        const int k = c / (kNodeCols / V), j = (c % (kNodeCols / V)) * V, kr = k0 + k;
        copy16(st + S::kAdj + br * S::kX + k * S::kXPitch + j,
               kr < N ? rhs[br] + (size_t)kr * HP : rhs[br], h0 + j, kr < N ? HP : 0, true);
      }
    cp_async_commit();
  };
  // m of every branch for the tile of step it, rounded to T, into m buffer
  // it % 2: 8 consecutive elements of one tile row at a time, every sigmoid
  // computed and the edges that do not exist masked after, so that the
  // chains interleave; 8 elements without an edge skip their sigmoids
  auto build = [&](int it) {
    const int k0 = step_of[it % nk] * K;
    const T* at = stage + (it % kStages) * S::kStage;
    T* mt = mtile + (it % 2) * NB * S::kM;
    for (int e = tid; e < kTR * kTC / 8; e += kThreads) {
      const int bi = e / (kTC / 8), bj = (e % (kTC / 8)) * 8;
      float av[8], l8[8], m8[NB][8];
      lds8(av, at + bi * kTC + bj);   // 0 past the graph, as the logits
      lds8(l8, ROLE == 0 ? lg + k0 + bj : lo + bj);
      const float l1 = ROLE == 0 ? lo[bi] : lg[k0 + bi];
      // the self loop: element dq of these 8, if any
      const int dq = ROLE == 0 ? n0 + bi - k0 - bj : k0 + bi - n0 - bj;
      if ((unsigned)dq < 8u) {
#pragma unroll
        for (int q = 0; q < 8; ++q) av[q] = q == dq ? 0.f : av[q];
      }
      bool has = false;
#pragma unroll
      for (int q = 0; q < 8; ++q) has = has || av[q] != 0.f;
      if (has) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float m[NB];
          weigh<M>(av[q], sigmoid(l8[q] + l1), m);
#pragma unroll
          for (int br = 0; br < NB; ++br) m8[br][q] = m[br];
        }
      } else {
#pragma unroll
        for (int br = 0; br < NB; ++br)
#pragma unroll
          for (int q = 0; q < 8; ++q) m8[br][q] = 0.f;
      }
#pragma unroll
      for (int br = 0; br < NB; ++br) sts8(mt + br * S::kM + bi * kMP + bj, m8[br]);
    }
  };

  float acc[NB][2][4][4], dot[NB][2][2];   // dot: [branch][m tile][half] over the thread's columns
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dot[br][i][0] = dot[br][i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[br][i][j][f] = 0.f;
    }
  // a chunk's epilogue: g.u (receivers) or dx and p.x (senders); acc back to 0
  auto epilogue = [&](int h0) {
#pragma unroll
    for (int br = 0; br < NB; ++br) {
      const T* g = rows_of(g0, g1, br, b, N, H);
      const T* x = rows_of(x0, x1, br, b, N, H);
      T* dx = rows_of(dx0, dx1, br, b, N, H);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + wm * 32 + mt * 16 + lane / 4 + h * 8;
          if (n >= N) continue;
          float dis_n = 0.f, inv_n = 0.f;
          if (ROLE == 1) {
            dis_n = stats[2 * br * plane + gN + n];
            inv_n = stats[(2 * br + 1) * plane + gN + n];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = h0 + wn * 32 + nt * 8 + (lane % 4) * 2 + c;
              if (col >= H) continue;
              const size_t at = (size_t)n * H + col;
              const float v = acc[br][mt][nt][h * 2 + c], gv = to_f(g[at]);
              if (ROLE == 0) {
                dot[br][mt][h] += gv * v;
              } else {
                dx[at] = from_f<T>(__fadd_rn(__fmul_rn(v, dis_n), __fmul_rn(gv, inv_n)));
                dot[br][mt][h] += v * to_f(x[at]);
              }
            }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[br][mt][nt][f] = 0.f;
    }
  };

  // software pipeline: step it's products are issued, then step it + 1's
  // sigmoids, so the CUDA cores build while the tensor cores multiply
  static_assert(kStages >= 3, "the node pass builds one step ahead of its products");
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < total) load(it);
    else cp_async_commit();
  }
  if (total > 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    build(0);
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 3>();
    __syncthreads();   // m tile it built, step it + 1 staged; every warp done with step it - 1
    if (it + kStages - 1 < total) load(it + kStages - 1);
    else cp_async_commit();
    const int h0 = (it / nk) * kNodeCols;
    const T* xs = stage + (it % kStages) * S::kStage + S::kAdj;
    if (h0 + wn * 32 < HP) {   // warps past the padded columns have no products
#pragma unroll
      for (int kk = 0; kk < K; kk += 16)
#pragma unroll
        for (int br = 0; br < NB; ++br) {
          const T* mb = mtile + ((it % 2) * NB + br) * S::kM;
          warp_mma16<ROLE == 1, true>(
              acc[br], ROLE == 0 ? mb + wm * 32 * kMP + kk : mb + kk * kMP + wm * 32, kMP,
              xs + br * S::kX + kk * S::kXPitch + wn * 32, S::kXPitch, lane);
        }
    }
    if (it + 1 < total) build(it + 1);
    if (it % nk == nk - 1) epilogue(h0);
  }
  if (nk == 0)   // no edge: u = p = 0
    for (int h0 = 0; h0 < HP; h0 += kNodeCols) epilogue(h0);

  // the 4 lanes of a row, then the 4 column warps, in a fixed order
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = dot[br][mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int i = wm * 32 + mt * 16 + lane / 4 + h * 8;
        if (lane % 4 == 0) red[(wn * kBwdRows + i) * NB + br] = v;
      }
  __syncthreads();
  for (int e = tid; e < kBwdRows * NB; e += kThreads) {
    const int br = e / kBwdRows, i = e % kBwdRows;
    if (n0 + i >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) v += red[(w * kBwdRows + i) * NB + br];
    dots[(3 * br + ROLE) * plane + gN + n0 + i] = v;
  }
}

// pass 3: blockIdx.z picks the role (0 receivers, 1 senders)
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
bwd_node_kernel(const T* __restrict__ adj, const T* __restrict__ x0, const T* __restrict__ x1,
                const T* __restrict__ g0, const T* __restrict__ g1, const T* __restrict__ src,
                const T* __restrict__ dst, const float* __restrict__ stats,
                const T* __restrict__ xd, const T* __restrict__ gd, T* __restrict__ dx0,
                T* __restrict__ dx1, float* __restrict__ dots,
                const unsigned char* __restrict__ live, int B, int N, int H) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if (blockIdx.z == 0)
    bwd_node_role<T, M, 0>(bwd_smem, adj, x0, x1, g0, g1, src, dst, stats, xd, gd, dx0, dx1, dots,
                           live, B, N, H);
  else
    bwd_node_role<T, M, 1>(bwd_smem, adj, x0, x1, g0, g1, src, dst, stats, xd, gd, dx0, dx1, dots,
                           live, B, N, H);
}

// edge pass shared memory (elements of T unless named): the adj tile,
// kStages stages of NB (g, x) tile pairs, then f32 per-row / per-column
// factors and the reduction buffers
template <typename T, int NB>
struct EdgeSmem {
  static constexpr int K = EdgeK<T>::v;
  static constexpr int P = 16 / sizeof(T);
  static constexpr int kWarps = kEdgeTile / 32;                   // warps along a tile side
  static constexpr int kAdjPitch = kEdgeTile + P;
  static constexpr int kAdj = kEdgeTile * kAdjPitch;
  static constexpr int kPitch = K + P;
  static constexpr int kOp = kEdgeTile * kPitch;                  // one g or x tile
  static constexpr int kStage = 2 * NB * kOp;
  static constexpr int kVec = (2 + 3 * NB + 2 * kWarps) * kEdgeTile;   // floats
  static constexpr size_t kBytes = (kAdj + kStages * kStage) * sizeof(T) + kVec * sizeof(float);
};

// pass 4
template <typename T, int M>
__global__ void __launch_bounds__(kEdgeThreads)
bwd_edge_kernel(const T* __restrict__ adj, const T* __restrict__ x0, const T* __restrict__ x1,
                const T* __restrict__ g0, const T* __restrict__ g1, const T* __restrict__ src,
                const T* __restrict__ dst, const float* __restrict__ stats,
                const float* __restrict__ dots, const unsigned char* __restrict__ live,
                float* __restrict__ part_src, float* __restrict__ part_dst, int B, int N, int H) {
  constexpr int NB = Nb<M>::v, V = 16 / sizeof(T);
  using S = EdgeSmem<T, NB>;
  constexpr int K = S::K, W = S::kWarps;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* adjt = reinterpret_cast<T*>(bwd_smem);
  T* stage = adjt + S::kAdj;
  float* vsrc = reinterpret_cast<float*>(stage + kStages * S::kStage);   // src of the senders
  float* vdst = vsrc + kEdgeTile;                                  // dst of the receivers
  float* dis_r = vdst + kEdgeTile;                                 // [NB][tile]
  float* dis_s = dis_r + NB * kEdgeTile;
  float* t_s = dis_s + NB * kEdgeTile;
  float* red_r = t_s + NB * kEdgeTile;                             // [column warp][tile]
  float* red_c = red_r + W * kEdgeTile;                            // [row warp][tile]

  const int r0 = blockIdx.x * kEdgeTile, s0 = blockIdx.y * kEdgeTile, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / W, wn = warp % W;   // warp owns receivers wm*32.., senders wn*32..

  // a tile without an edge (the live map) has dpre = 0: its partial sums
  // are zeros, and nothing else is read
  if (!live_any(live, b, N, r0, kEdgeTile, s0, kEdgeTile)) {
    for (int i = tid; i < kEdgeTile; i += kEdgeThreads) {
      if (r0 + i < N) part_dst[((size_t)b * n_tiles(N) + blockIdx.y) * N + r0 + i] = 0.f;
      if (s0 + i < N) part_src[((size_t)b * n_tiles(N) + blockIdx.x) * N + s0 + i] = 0.f;
    }
    return;
  }
  const size_t plane = (size_t)B * N, gN = (size_t)b * N;
  const T* a = adj + gN * N;
  const T* gp[NB];
  const T* xp[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    gp[br] = rows_of(g0, g1, br, b, N, H);
    xp[br] = rows_of(x0, x1, br, b, N, H);
  }

  for (int i = tid; i < kEdgeTile; i += kEdgeThreads) {
    const int r = r0 + i, s = s0 + i;
    vsrc[i] = s < N ? to_f(src[gN + s]) : 0.f;
    vdst[i] = r < N ? to_f(dst[gN + r]) : 0.f;
#pragma unroll
    for (int br = 0; br < NB; ++br) {
      dis_r[br * kEdgeTile + i] = r < N ? stats[2 * br * plane + gN + r] : 0.f;
      float ds = 0.f, tv = 0.f;
      if (s < N) {
        ds = stats[2 * br * plane + gN + s];
        const float iv = stats[(2 * br + 1) * plane + gN + s];
        const float gu = dots[3 * br * plane + gN + s], px = dots[(3 * br + 1) * plane + gN + s];
        const float gx = dots[(3 * br + 2) * plane + gN + s];
        tv = -0.5f * (gu + px) * ds * ds * ds - gx * iv * iv;
      }
      dis_s[br * kEdgeTile + i] = ds;
      t_s[br * kEdgeTile + i] = tv;
    }
  }
  const bool vec_a = N % V == 0 && aligned16(adj);
  for (int c = tid; c < kEdgeTile * kEdgeTile / V; c += kEdgeThreads) {
    const int i = c / (kEdgeTile / V), j = (c % (kEdgeTile / V)) * V, r = r0 + i;
    copy16(adjt + i * S::kAdjPitch + j, r < N ? a + (size_t)r * N : a, s0 + j, r < N ? N : 0,
           vec_a);
  }
  bool vec_x = H % V == 0;
#pragma unroll
  for (int br = 0; br < NB; ++br) vec_x = vec_x && aligned16(gp[br]) && aligned16(xp[br]);
  auto load = [&](int it) {
    T* st = stage + (it % kStages) * S::kStage;
    const int h0 = it * K;
#pragma unroll
    for (int op = 0; op < 2 * NB; ++op) {   // op: 2 br + (0 g, 1 x)
      const T* base = op % 2 == 0 ? gp[op / 2] : xp[op / 2];
      for (int c = tid; c < kEdgeTile * K / V; c += kEdgeThreads) {
        const int i = c / (K / V), j = (c % (K / V)) * V;
        const int row = (op % 2 == 0 ? r0 : s0) + i;
        copy16(st + op * S::kOp + i * S::kPitch + j, row < N ? base + (size_t)row * H : base,
               h0 + j, row < N ? H : 0, vec_x);
      }
    }
    cp_async_commit();
  };

  float acc[NB][2][4][4];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[br][i][j][f] = 0.f;

  const int nh = (H + K - 1) / K;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {   // the first group carries the adj tile
    if (it < nh) load(it);
    else cp_async_commit();
  }
  for (int it = 0; it < nh; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < nh) load(it + kStages - 1);
    else cp_async_commit();
    const T* st = stage + (it % kStages) * S::kStage;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16)
#pragma unroll
      for (int br = 0; br < NB; ++br)
        warp_mma16<false, false>(acc[br], st + 2 * br * S::kOp + wm * 32 * S::kPitch + kk,
                                 S::kPitch, st + (2 * br + 1) * S::kOp + wn * 32 * S::kPitch + kk,
                                 S::kPitch, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (r0 == s0) {   // the self loops of a diagonal tile
    for (int i = tid; i < kEdgeTile; i += kEdgeThreads) adjt[i * S::kAdjPitch + i] = from_f<T>(0.f);
    __syncthreads();
  }

  // dm and dpre from the accumulators, with no branch: every factor is
  // finite (0 past the graph) and the edges that do not exist have av = 0;
  // a thread's rows and columns summed
  float rows[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, cols[4][2] = {};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm * 32 + mt * 16 + lane / 4 + h * 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = wn * 32 + nt * 8 + (lane % 4) * 2 + c;
          const float av = to_f(adjt[i * S::kAdjPitch + j]);
          const float sg = sigmoid(vsrc[j] + vdst[i]);
          float dm[NB];
#pragma unroll
          for (int br = 0; br < NB; ++br)
            dm[br] = acc[br][mt][nt][h * 2 + c] * dis_s[br * kEdgeTile + j] *
                         dis_r[br * kEdgeTile + i] + t_s[br * kEdgeTile + j];
          const float dw = NB == 2 ? dm[0] - dm[NB - 1] : dm[0];
          float dpre = dw * av * (sg * (1.0f - sg));
          if (M == kNeg) dpre = -dpre;
          rows[mt][h] += dpre;
          cols[nt][c] += dpre;
        }
    }
  // rows: the 4 lanes sharing a row, then the column warps; columns: the 8
  // lanes sharing a column, then the row warps; in a fixed order
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rows[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lane % 4 == 0) red_r[wn * kEdgeTile + wm * 32 + mt * 16 + lane / 4 + h * 8] = v;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = cols[nt][c];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane < 4) red_c[wm * kEdgeTile + wn * 32 + nt * 8 + lane * 2 + c] = v;
    }
  __syncthreads();
  if (tid < 2 * kEdgeTile) {
    const bool row = tid < kEdgeTile;
    const int i = row ? tid : tid - kEdgeTile;
    const float* red = row ? red_r : red_c;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) v += red[w * kEdgeTile + i];
    if (row && r0 + i < N)
      part_dst[((size_t)b * n_tiles(N) + blockIdx.y) * N + r0 + i] = v;
    else if (!row && s0 + i < N)
      part_src[((size_t)b * n_tiles(N) + blockIdx.x) * N + s0 + i] = v;
  }
}

// dsrc[b, s] = T(sum over receiver tiles), ddst[b, r] = T(sum over sender tiles)
template <typename T>
__global__ void bwd_finalize_kernel(const float* __restrict__ part_src,
                                    const float* __restrict__ part_dst,
                                    T* __restrict__ dsrc, T* __restrict__ ddst, int B, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * N) return;
  const size_t b = i / N, n = i % N;
  const int tiles = n_tiles(N);
  float vs = 0.f, vd = 0.f;
  for (int q = 0; q < tiles; ++q) {
    vs += part_src[(b * tiles + q) * N + n];
    vd += part_dst[(b * tiles + q) * N + n];
  }
  dsrc[i] = from_f<T>(vs);
  ddst[i] = from_f<T>(vd);
}

template <typename T, int M>
int launch_bwd(const void* adj, const void* x0, const void* x1, const void* src,
               const void* dst, const void* g0, const void* g1, void* dx0, void* dx1,
               void* dsrc, void* ddst, float* scratch, const float* fwd_stats,
               const unsigned char* fwd_live, int B, int N, int H, cudaStream_t stream) {
  constexpr int NB = Nb<M>::v;
  const BwdScratch sc = bwd_scratch(B, N, H, sizeof(T), NB);
  if ((fwd_stats == nullptr) != (fwd_live == nullptr)) return (int)cudaErrorInvalidValue;
  const float* stats = fwd_stats != nullptr ? fwd_stats : scratch;
  float* dots = scratch + sc.dots;
  float* part_src = scratch + sc.part_src;
  float* part_dst = scratch + sc.part_dst;
  T* xd = reinterpret_cast<T*>(scratch + sc.xd);
  T* gd = reinterpret_cast<T*>(scratch + sc.gd);
  unsigned char* own_live = reinterpret_cast<unsigned char*>(scratch + sc.live);
  const unsigned char* live = fwd_live != nullptr ? fwd_live : own_live;
  int err = 0;
  if (fwd_stats == nullptr &&
      (err = launch_degree<T, M>(adj, src, dst, scratch, own_live, B, N, stream)))
    return err;
  const T *a = static_cast<const T*>(adj), *x0_ = static_cast<const T*>(x0),
          *x1_ = static_cast<const T*>(x1), *g0_ = static_cast<const T*>(g0),
          *g1_ = static_cast<const T*>(g1), *s_ = static_cast<const T*>(src),
          *d_ = static_cast<const T*>(dst);
  const size_t plane = (size_t)B * N;
  const int warps = kThreads / 32;
  bwd_scale_kernel<T, M><<<(unsigned)((plane + warps - 1) / warps), kThreads, 0, stream>>>(
      x0_, x1_, g0_, g1_, stats, dots, xd, gd, B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const size_t node_smem = NodeSmem<T, NB>::bytes(N);
  cudaError_t e = cudaFuncSetAttribute(bwd_node_kernel<T, M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)node_smem);
  if (e != cudaSuccess) return (int)e;
  bwd_node_kernel<T, M><<<dim3(live_strips(N), B, 2), kThreads, node_smem,
                          stream>>>(a, x0_, x1_, g0_, g1_, s_, d_, stats, xd, gd,
                                    static_cast<T*>(dx0), static_cast<T*>(dx1), dots, live, B, N,
                                    H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  constexpr size_t edge_smem = EdgeSmem<T, NB>::kBytes;
  e = cudaFuncSetAttribute(bwd_edge_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)edge_smem);
  if (e != cudaSuccess) return (int)e;
  bwd_edge_kernel<T, M><<<dim3(n_tiles(N), n_tiles(N), B), kEdgeThreads, edge_smem, stream>>>(
      a, x0_, x1_, g0_, g1_, s_, d_, stats, dots, live, part_src, part_dst, B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bwd_finalize_kernel<T><<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(part_src, part_dst, static_cast<T*>(dsrc),
                                     static_cast<T*>(ddst), B, N);
  return (int)cudaGetLastError();
}

template <int M>
int launch_bwd_typed(int dtype, const void* adj, const void* x0, const void* x1,
                     const void* src, const void* dst, const void* g0, const void* g1,
                     void* dx0, void* dx1, void* dsrc, void* ddst, float* scratch,
                     const float* stats, const unsigned char* live, int B, int N, int H,
                     cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd<float, M>(adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc, ddst, scratch,
                                stats, live, B, N, H, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, M>(adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc, ddst,
                                        scratch, stats, live, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Row 4 in one launch: K17 and K17T in bf16 for graphs of up to 256 nodes.
//
// Replaces (cal_tpu/ops/pallas_gcn.py) _mm_kernel with transpose False (K17)
// and True (K17T), whose grid step holds one graph's [N, N] adjacency in VMEM.
// Contract: the plain modes above (the degree M's column sums in both).
//
// Bound on this card: bytes, adj + x + out (33.6 MB at B = 128, N = 256, H =
// 128: 0.0100 ms); the products (2.1 GFLOP) take a fifth of that on the
// tensor cores.  The two-pass path above reads adj twice.
// Design: a thread-block cluster of cs = ceil(N / 128) CTAs (1 or 2) takes a
// graph; CTA q owns output rows [128 q, 128 q + 128) with 16 warps.  The
// clusters are persistent: as many as fit at once (one CTA an SM), each
// walking the graphs b, b + G, ...  Per graph:
//   1. cp.async brings the CTA's adjacency slab into shared memory, the only
//      read of adj: K17 its 128 receiver rows [128, N]; K17T its 128 output
//      rows, which are adjacency columns, as an [N, 128] box of row pieces
//      (the column read is coalesced).  Two slab buffers: the next graph's
//      slab is in flight while this one is computed.
//   2. degrees: column sums of the slab on the tensor cores (a ones matrix
//      times the slab: counts sum exactly in f32), the diagonal subtracted.
//      K17 sums its 128 rows and every CTA adds all ranks' partial sums in
//      rank order, read over distributed shared memory; a K17T CTA holds
//      whole columns, so it has its own 128 degrees and reads the others'.
//      Every order is fixed: two calls give the same bits.
//   3. each CTA rounds its slab into the bf16 norm tile in place, 8 entries
//      a thread at a time (the diagonal and the padding 0).
//   4. x of the graph, whole, at a padded pitch for ldmatrix: issued by
//      cp.async once the last graph's products are done with the buffer, so
//      it lands during steps 2 and 3.
//   5. mma.sync m16n8k16 (bf16 in, f32 accumulate), warps of 32 rows x 32
//      columns; K17T feeds its [sender][row] slab through ldmatrix.trans.
//   6. the epilogue adds x_r / deg_r from shared memory, rounds to bf16,
//      stages the tile in the x buffer and writes 16-byte row pieces.
// H > 128 walks chunks of 128 features with the norm tile kept.  The norm
// rounding, the product order and the epilogue are the two-pass kernels':
// the outputs equal theirs bit for bit.  Shared memory: 209 KB (K17) / 212
// KB (K17T) at N = 256, which sets the limit.
// Measured and dropped on the way (H100): x multicast over the cluster (one
// bulk copy per 256-byte row into every CTA: ~6 us to deliver 96 KB, the
// issuing warp holding the rest back); forming the norm entries in the
// MMA's A fragments (four warps redo each entry: ALU-bound, slower than one
// pass through shared memory); CTAs of 64 rows (at N = 256 four-CTA
// clusters lost ~4k cycles a graph to skew at the degree exchange and 30
// clusters of 4 left 12 SMs idle; up to N = 512 they were no faster than the
// two-pass path).  Larger graphs, f32 and H that is not a multiple of 8 take
// the two-pass path (ops/fused_gcn.py: plain_cluster_size).
constexpr int kCRows = 128;                         // output rows per CTA
constexpr int kCThreads = kCRows * 4;               // 16 warps of 32 x 32 output tiles
constexpr int kMaxClusterN = 2 * kCRows;            // the largest graph of the path
constexpr int kCCols = 128;                         // feature columns per chunk
constexpr int kXLd = kCCols + 8;                    // x chunk pitch (bf16): 272 B

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// byte offsets of the cluster kernel's shared memory: f32 pub [2][pubn] (by
// graph parity: K17 the partial column sums of the CTA's rows [kp], K17T the
// degrees of its own columns [128]), dis (deg^-1/2 of every node, 0 past N
// [kp + 128]), inv (1/deg of the CTA's rows [128]); bf16 two slab buffers
// and the x chunk [kp][kXLd]
struct PlainSmem {
  int kp, la, pubn, slab_elems, pub, dis, inv, slab, xs, total;
  __host__ __device__ PlainSmem(int N, bool trans) {
    kp = pad16(N);
    la = trans ? kCRows + 8 : kp + 8;   // slab pitch: ldmatrix without bank conflicts
    pubn = trans ? kCRows : kp;
    slab_elems = trans ? kp * la : kCRows * la;
    pub = 0;
    dis = pub + 4 * 2 * pubn;
    inv = dis + 4 * (kp + kCRows);
    slab = inv + 4 * kCRows;
    xs = slab + 2 * 2 * slab_elems;
    total = xs + 2 * kp * kXLd;
  }
};

// every thread of the cluster: writes before it are visible to all after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// column sums of 16 columns [c0, c0 + 16) of a [k][column] bf16 tile over
// rows [0, rows16) (a multiple of 16) on the tensor cores: ones x tile.
// Lanes 0-3 end with columns c0 + 2 lane + {0, 1} in d[0][0..1] and c0 + 8 +
// 2 lane + {0, 1} in d[1][0..1].
__device__ __forceinline__ void column_sums16(float (&d)[2][4], const __nv_bfloat16* tile,
                                              int ld, int c0, int rows16, int lane) {
  const unsigned one2 = 0x3F803F80u;   // two bf16 ones
  const unsigned ones[4] = {one2, one2, one2, one2};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int f = 0; f < 4; ++f) d[h][f] = 0.f;
  for (int kk = 0; kk < rows16; kk += 16) {
    unsigned t[4];
    ldsm_x4_trans(t, tile + (kk + lane % 8 + ((lane / 8) % 2) * 8) * ld + c0 + (lane / 16) * 8);
    mma_bf16(d[0], ones, t[0], t[1]);
    mma_bf16(d[1], ones, t[2], t[3]);
  }
}

template <bool kTrans>
__global__ void __launch_bounds__(kCThreads, 1)
plain_cluster_kernel(const __nv_bfloat16* __restrict__ adj, const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ out, int B, int N, int H) {
  using bf16 = __nv_bfloat16;
  namespace cg = cooperative_groups;
  constexpr int R = kCRows, kT = kCThreads, kWarps = kT / 32;
  extern __shared__ __align__(16) unsigned char plain_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int r0 = q * R, rows = min(R, N - r0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // warp owns rows wm*32.., columns wn*32..
  const PlainSmem L(N, kTrans);
  const int kp = L.kp, la = L.la;
  float* pub = reinterpret_cast<float*>(plain_smem + L.pub);
  float* dis = reinterpret_cast<float*>(plain_smem + L.dis);
  float* inv = reinterpret_cast<float*>(plain_smem + L.inv);
  bf16* slabs = reinterpret_cast<bf16*>(plain_smem + L.slab);
  bf16* xs = reinterpret_cast<bf16*>(plain_smem + L.xs);
  const int G = gridDim.y, count = (B - (int)blockIdx.y + G - 1) / G;   // this cluster's graphs
  const int chunks = (H + kCCols - 1) / kCCols;
  const bool vec_a = N % 8 == 0 && aligned16(adj);

  for (int s = N + tid; s < kp + R; s += kT) dis[s] = 0.f;   // never written again

  // the cluster's graph i: this CTA's adjacency slab, zero past the graph
  auto load_slab = [&](int i) {
    const bf16* a = adj + (blockIdx.y + (size_t)i * G) * N * N;
    bf16* slab = slabs + (i % 2) * L.slab_elems;
    if constexpr (kTrans) {
      for (int c = tid; c < kp * (R / 8); c += kT) {
        const int s = c / (R / 8), j = (c % (R / 8)) * 8;
        copy16(slab + s * la + j, s < N ? a + (size_t)s * N + r0 : a, j, s < N ? rows : 0, vec_a);
      }
    } else {
      for (int c = tid; c < R * (kp / 8); c += kT) {
        const int rl = c / (kp / 8), j = (c % (kp / 8)) * 8;
        copy16(slab + rl * la + j, rl < rows ? a + (size_t)(r0 + rl) * N : a, j,
               rl < rows ? N : 0, vec_a);
      }
    }
    cp_async_commit();
  };
  // and its x chunk h0, zero past the graph and the chunk
  auto load_x = [&](int i, int h0) {
    const bf16* xb = x + (blockIdx.y + (size_t)i * G) * N * H + h0;
    const int w = min(kCCols, H - h0);
    for (int c = tid; c < kp * (kCCols / 8); c += kT) {
      const int s = c / (kCCols / 8), j = (c % (kCCols / 8)) * 8;
      copy16(xs + s * kXLd + j, s < N ? xb + (size_t)s * H : xb, j, s < N ? w : 0, true);
    }
    cp_async_commit();
  };

  // 2. degrees of the cluster's graph i from its slab into pub[i % 2]
  auto degrees = [&](int i) {
    const bf16* slab = slabs + (i % 2) * L.slab_elems;
    float* mine = pub + (i % 2) * L.pubn;
    if constexpr (kTrans) {
      if (warp < R / 16) {   // 16 own columns a warp, all rows
        float d[2][4];
        column_sums16(d, slab, la, warp * 16, kp, lane);
        if (lane < 4) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = warp * 16 + h * 8 + lane * 2 + e, r = r0 + cl;
              const float self = r < N ? __bfloat162float(slab[r * la + cl]) : 0.f;
              mine[cl] = __fadd_rn(__fsub_rn(d[h][e], self), 1.0f);
            }
        }
      }
    } else {
      for (int c0 = warp * 16; c0 < kp; c0 += 16 * kWarps) {   // over the CTA's rows
        float d[2][4];
        column_sums16(d, slab, la, c0, R, lane);
        if (lane < 4) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = c0 + h * 8 + lane * 2 + e;
              const float self =
                  s >= r0 && s < r0 + rows ? __bfloat162float(slab[(s - r0) * la + s]) : 0.f;
              mine[s] = __fsub_rn(d[h][e], self);
            }
        }
      }
    }
  };

  // cp.async groups, oldest first: slab i, x i, then slab i + 1, issued as
  // graph i starts (committed empty past the last graph)
  load_slab(0);
  load_x(0, 0);
  for (int i = 0; i < count; ++i) {
    const size_t b = blockIdx.y + (size_t)i * G;
    bf16* slab = slabs + (i % 2) * L.slab_elems;
    const float* mine = pub + (i % 2) * L.pubn;
    // 1. this graph's slab; the next graph's into the other buffer
    if (i + 1 < count) load_slab(i + 1);
    else cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    degrees(i);
    cluster_sync();   // every rank's sums are visible
    if constexpr (kTrans) {
      for (int s = tid; s < N; s += kT)
        dis[s] = rsqrtf(cluster.map_shared_rank(mine, s / R)[s % R]);
      if (tid < R) inv[tid] = 1.0f / mine[tid];
    } else {
      for (int s = tid; s < kp; s += kT) {
        float part[2];   // the ranks' sums, loads in flight together
#pragma unroll
        for (int p = 0; p < 2; ++p) part[p] = p < cs ? cluster.map_shared_rank(mine, p)[s] : 0.f;
        const float deg = (part[0] + part[1]) + 1.0f;   // rank order
        if (s < N) dis[s] = rsqrtf(deg);
        if (s >= r0 && s < r0 + R) inv[s - r0] = 1.0f / deg;
      }
    }
    __syncthreads();
    // 3. the norm tile in place, 8 entries at a time: K17 entry (row r0 + e,
    // sender j), K17T entry (sender e, row r0 + j) of M, both (m * dis_j) *
    // dis_e (M's sender factor first).  A thread keeps one 8-column piece
    // (its 8 factors in registers) and walks the slab's rows.
    {
      const int per = kTrans ? R / 8 : kp / 8;     // pieces per slab row (<= 32)
      const int groups = kT / per;                 // threads down a column of pieces
      if (tid < groups * per) {
        const int j0 = (tid % per) * 8, jb = kTrans ? r0 : 0;
        const float4 f0 = *reinterpret_cast<const float4*>(dis + jb + j0);
        const float4 f1 = *reinterpret_cast<const float4*>(dis + jb + j0 + 4);
        const float fj[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll 2
        for (int e = tid / per; e < (kTrans ? kp : R); e += groups) {
          bf16* p = slab + e * la + j0;
          const uint4 u = *reinterpret_cast<const uint4*>(p);
          const bf16* av = reinterpret_cast<const bf16*>(&u);
          const float fe = dis[kTrans ? e : r0 + e];
          const int self = kTrans ? e - r0 - j0 : r0 + e - j0;   // the diagonal's place, if in [0, 8)
          uint4 n8;
          unsigned* w8 = reinterpret_cast<unsigned*>(&n8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float a0 = 2 * j == self ? 0.f
                                           : __fmul_rn(__fmul_rn(__bfloat162float(av[2 * j]), fj[2 * j]), fe);
            const float a1 = 2 * j + 1 == self
                                 ? 0.f
                                 : __fmul_rn(__fmul_rn(__bfloat162float(av[2 * j + 1]), fj[2 * j + 1]), fe);
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(a0, a1);
            w8[j] = *reinterpret_cast<const unsigned*>(&v2);
          }
          *reinterpret_cast<uint4*>(p) = n8;
        }
      }
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const int h0 = ch * kCCols, w = min(kCCols, H - h0);
      if (ch > 0) load_x(i, h0);   // the buffer is free: the last chunk's epilogue synced
      if (ch == 0) cp_async_wait<1>();   // x i (slab i + 1 may fly)
      else cp_async_wait<0>();
      __syncthreads();
      // 5. the products
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.f;
      if (wn * 32 < w) {   // warps past the chunk's columns have no products
        for (int kk = 0; kk < kp; kk += 16)
          warp_mma16<kTrans, true>(acc, kTrans ? slab + kk * la + wm * 32 : slab + wm * 32 * la + kk,
                                   la, xs + kk * kXLd + wn * 32, kXLd, lane);
      }
      // 6. + x_r / deg_r, rounded to bf16; the tile through the x buffer's
      // first rows, stored in 16-byte row pieces
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + lane / 4 + h * 8;
          if (row >= rows) continue;
          const float iv = inv[row];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                xs + (r0 + row) * kXLd + wn * 32 + nt * 8 + (lane % 4) * 2));
            acc[mt][nt][2 * h] = __fadd_rn(acc[mt][nt][2 * h], __fmul_rn(xv.x, iv));
            acc[mt][nt][2 * h + 1] = __fadd_rn(acc[mt][nt][2 * h + 1], __fmul_rn(xv.y, iv));
          }
        }
      __syncthreads();   // every warp is done reading the chunk
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + lane / 4 + h * 8;
          if (row >= rows) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<__nv_bfloat162*>(xs + row * kXLd + wn * 32 + nt * 8 + (lane % 4) * 2) =
                __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      __syncthreads();
      for (int e = tid; e < rows * (w / 8); e += kT) {
        const int rl = e / (w / 8), c = (e % (w / 8)) * 8;
        *reinterpret_cast<uint4*>(out + (b * N + r0 + rl) * H + h0 + c) =
            *reinterpret_cast<const uint4*>(xs + rl * kXLd + c);
      }
      __syncthreads();   // the x buffer (and this slab buffer) are free
    }
    // 4. the next graph's x, landing while its slab turns into norms
    if (i + 1 < count) load_x(i + 1, 0);
  }
  cluster_sync();   // no peer reads this CTA's pub any more
}

// how a launch of the cluster kernel runs: its dynamic shared memory and the
// clusters that fit on the current device at once
struct PlainPlan {
  size_t smem;
  int clusters;
};

template <bool kTrans>
cudaError_t plain_plan(int N, int cluster, PlainPlan* plan, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  plan->smem = PlainSmem(N, kTrans).total;
  static std::atomic<int> cap[kMaxDevices];
  cudaError_t e = raise_smem((const void*)plain_cluster_kernel<kTrans>, cap, plan->smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(kCThreads, 1, 1);
  cfg->dynamicSmemBytes = plan->smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&plan->clusters, plain_cluster_kernel<kTrans>, cfg);
}

template <bool kTrans>
int launch_plain_cluster(const void* adj, const void* x, void* out, int B, int N, int H,
                         int cluster, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (N > kMaxClusterN || cluster != (N + kCRows - 1) / kCRows || H % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  PlainPlan plan;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = plain_plan<kTrans>(N, cluster, &plan, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  if (plan.clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(cluster, min(B, plan.clusters), 1);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, plain_cluster_kernel<kTrans>, static_cast<const bf16*>(adj),
                         static_cast<const bf16*>(x), static_cast<bf16*>(out), B, N, H);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// f32 scratch elements gcn_bwd_launch needs for a [B, N, H] batch of dtype
// (0 float32, 1 bfloat16) in mode (0 dual, 1 sigmoid, 2 1 - sigmoid).
extern "C" long long gcn_bwd_scratch_floats(int B, int N, int H, int dtype, int mode) {
  return (long long)bwd_scratch(B, N, H, dtype == 0 ? 4 : 2, mode == kDual ? 2 : 1).total;
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], x0/x1/g0/g1/dx0/dx1 [B,N,H], src/dst/dsrc/ddst [B,N].
// mode: 0 dual (branches 0 and 1), 1 sigmoid, 2 1 - sigmoid (branch 0 only;
// x1, g1, dx1 unread).  scratch: f32, gcn_bwd_scratch_floats(B, N, H, dtype,
// mode) elements, 16-byte aligned.  stats and live: both null, or the
// forward's f32 [2 branches, B, N] statistics and live map of these inputs
// (gcn_fwd_launch's), which spare the degree pass.
extern "C" int gcn_bwd_launch(const void* adj, const void* x0, const void* x1,
                              const void* src, const void* dst, const void* g0,
                              const void* g1, void* dx0, void* dx1, void* dsrc, void* ddst,
                              void* scratch, const void* stats, const void* live, int B, int N,
                              int H, int dtype, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const float* st = static_cast<const float*>(stats);
  const unsigned char* lv = static_cast<const unsigned char*>(live);
  if (B == 0 || N == 0) return 0;
  switch (mode) {
    case kDual:
      return launch_bwd_typed<kDual>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                     ddst, sc, st, lv, B, N, H, s);
    case kSig:
      return launch_bwd_typed<kSig>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                    ddst, sc, st, lv, B, N, H, s);
    case kNeg:
      return launch_bwd_typed<kNeg>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                    ddst, sc, st, lv, B, N, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], x0/x1/o0/o1 [B,N,H], src/dst [B,N].  mode: 0 dual (x0 -> o0
// with sigmoid, x1 -> o1 with 1 - sigmoid), 1 sigmoid, 2 1 - sigmoid, 3 plain
// (src, dst unread), 4 plain transposed; modes 1-4 read x0 and write o0 only.
// Writes stats, f32 [4, B, N] (dual) or [2, B, N], and live, the live map:
// [B, ceil(N / 64), ceil(N / 32)] bytes.
extern "C" int gcn_fwd_launch(const void* adj, const void* x0, const void* x1,
                              const void* src, const void* dst, void* o0, void* o1,
                              void* stats, void* live, int B, int N, int H, int dtype, int mode,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  unsigned char* lv = static_cast<unsigned char*>(live);
  if (B == 0 || N == 0 || H == 0) return 0;
  switch (mode) {
    case kDual: return launch_fwd<kDual>(dtype, adj, x0, x1, src, dst, o0, o1, st, lv, B, N, H, s);
    case kSig: return launch_fwd<kSig>(dtype, adj, x0, x1, src, dst, o0, o1, st, lv, B, N, H, s);
    case kNeg: return launch_fwd<kNeg>(dtype, adj, x0, x1, src, dst, o0, o1, st, lv, B, N, H, s);
    case kPlain:
      return launch_fwd<kPlain>(dtype, adj, x0, x1, src, dst, o0, o1, st, lv, B, N, H, s);
    case kPlainT:
      return launch_fwd<kPlainT>(dtype, adj, x0, x1, src, dst, o0, o1, st, lv, B, N, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K17 (transpose 0) or K17T (1) in one launch, bf16: adj [B,N,N], x/out
// [B,N,H] contiguous; N <= 256, cluster = ceil(N / 128) CTAs per graph, H a
// multiple of 8, x and out 16-byte aligned (else cudaErrorInvalidValue).
extern "C" int gcn_plain_cluster_launch(const void* adj, const void* x, void* out, int B, int N,
                                        int H, int transpose, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0 || H == 0) return 0;
  return transpose ? launch_plain_cluster<true>(adj, x, out, B, N, H, cluster, s)
                   : launch_plain_cluster<false>(adj, x, out, B, N, H, cluster, s);
}

// that launch's plan at N on the current device: plan[0] its dynamic shared
// memory (bytes), plan[1] the clusters resident at once
extern "C" int gcn_plain_cluster_plan(int N, int transpose, long long* plan) {
  PlainPlan p{};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int cluster = (N + kCRows - 1) / kCRows;
  const cudaError_t e = transpose ? plain_plan<true>(N, cluster, &p, &cfg, &attr)
                                  : plain_plan<false>(N, cluster, &p, &cfg, &attr);
  plan[0] = (long long)p.smem;
  plan[1] = p.clusters;
  return (int)e;
}
