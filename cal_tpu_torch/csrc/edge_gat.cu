// Edge-formulated dense multi-head GAT attention for Hopper (sm_90a): the
// per-batch edge index and the forward.  The backward is edge_gat_bwd.cu;
// the shared device code edge_gat.cuh.
//
// Replaces: cal_tpu/ops/pallas_gat_sparse.py::_fwd_kernel (_edge_gat_fwd_call,
// the forward of _edge_gat_core, reached by edge_gat_dense from the dense
// GATConvLayer at N >= 384).
//
// Contract.  edge_flat [E] int32 holds (g*N + r)*N + s per directed edge
// s -> r, sorted ascending; values >= B*N*N are padding.  Node v = g*N + r
// owns the run of slots e with v*N <= edge_flat[e] < (v+1)*N.  Slots with
// r == s are dropped and every node gets one analytic self term of weight 1
// (PyG 1.1.0: remove, then add); each duplicate slot is its own softmax term.
// Per head h (ti, tj [B*N, heads] f32; xh, out [B*N, heads*d] of type T):
//   pre_e  = ti[v,h] + tj[u,h] for the slot's sender u = g*N + s;
//   pre_v  = ti[v,h] + tj[v,h] (self);  score = max(pre, 0.2 pre)
//   m_v    = max of the row's scores and its self score; den_v = sum exp(score - m_v)
//   alpha  = exp(score - m_v) * (1 / den_v)
//   keep_e = philox4x32_10(counter e*heads + h, key (s0, s1))[0] >= thresh, (s0, s1)
//            the (low, high) words of the 64-bit seed, read from device memory;
//   keep_v = the same at counter 2^40 + v*heads + h (a disjoint range)
//   out_v  = scale (sum_e keep_e alpha_e xh_u + keep_v alpha_v xh_v)   (head h's columns)
// The forward also writes m_v and 1 / den_v of the nodes with slots, which
// the backward takes (edge_gat_bwd.cu header).
//
// Bound on this card: bytes.  At B = 128, N = 3,840, heads*d = 128 in bf16
// the forward must read xh (126 MB) and write out (126 MB) whole, padded
// rows included; ti and tj and the ~0.1 M live slots of a SYNREDDIT batch
// add little: 0.08 ms at 3.35 TB/s.  About 90% of the rows hold no slot.
//
// Design.  The batch's index (edge_index_launch, once a batch) lists the
// nodes with slots by size (edge_gat.cuh).  Two launches:
//  - the walk (persistent, its item count on the device): the heavy rows'
//    32-slot chunks first, then the light rows, a lane group each.  A group
//    reads its span's senders and their tj at once (K slots a lane), forms
//    the span's max and sum by group shuffles, the weights with their keep
//    bits, then walks the slots in order, kUnroll neighbour rows of 32
//    bytes a lane in flight (two: four took 40 more registers, one block an
//    SM, and 0.118 ms against 0.081; PERF.md §6).  A light row writes
//    out_v; a heavy row's chunk writes (m, l, acc) against its own max, and
//    the row's last chunk to arrive rescales them (online softmax), sums
//    them in chunk order and writes out_v;
//  - the stream: a node without slots has alpha_v = exp(0) * 1 = 1, so
//    out_v = keep_v scale xh_v: 32-byte vectors a lane, several nodes a warp,
//    no reduction; the weight is still formed from the logits (one expf a
//    node and head), so a non-finite logit propagates as in the plain twin,
//    and the bits are those of the one-warp-a-row kernel this replaced.
// The stream in the walk's launch, in turns with its items, was slower (its
// registers held the stream to one block an SM: 0.297 ms against 0.163).
// A light row sums its slots in slot order, as before; its statistics are
// summed in another order (a group's tree), and a heavy row in chunks, so a
// row with slots can differ from the earlier kernel in its last bits.
//
// The index: the receiver runs come from one pass over adjacent keys of the
// sorted list (a run starts where the node changes), the sender order from
// one stable sort of the keys (g*N + s)*N + r (torch.sort, in the wrapper)
// and the same pass over it; a second pass lists the light nodes (one
// warp-aggregated atomic a warp: the lists' order follows the schedule,
// which no result depends on) and the heavy rows' chunks.  No host
// synchronization.
#include "edge_gat.cuh"

namespace {

constexpr int kUnroll = 2;   // neighbour rows a group loads before their FMAs

// ---------------------------------------------------------------------------
// The per-batch index.

__device__ __forceinline__ int node_of(int key, int N, int total, int rows) {
  return key >= 0 && key < total ? key / N : rows;
}

// keys[i] = (g*N + s)*N + r of slot i (padding: B*N*N), the sender-major key
__global__ void edge_keys_kernel(const int* __restrict__ ef, int E, int N, int rows,
                                 int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int total = rows * N, nn = N * N, k = ef[i];
  keys[i] = k >= 0 && k < total ? ((k / nn) * N + k % N) * N + (k / N) % N : total;
}

// The run of each node in both orders (a run starts and ends where the node
// of adjacent keys changes), the receiver of each sender-order place and the
// sender-order place of each slot.
__global__ void edge_runs_kernel(const int* __restrict__ ef, const int* __restrict__ keyt,
                                 const long long* __restrict__ perm, int E, int N, int rows,
                                 int2* rrange, int2* srange, int* __restrict__ spos,
                                 int* __restrict__ srecv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int total = rows * N;
  const int v = node_of(ef[i], N, total, rows);
  if (v < rows) {
    if (i == 0 || node_of(ef[i - 1], N, total, rows) != v) rrange[v].x = i;
    if (i + 1 == E || node_of(ef[i + 1], N, total, rows) != v) rrange[v].y = i + 1;
  }
  const int kt = keyt[i];   // in [0, total]; total / N = rows
  const int u = kt / N;
  if (u < rows) {
    if (i == 0 || keyt[i - 1] / N != u) srange[u].x = i;
    if (i + 1 == E || keyt[i + 1] / N != u) srange[u].y = i + 1;
  }
  srecv[i] = u < rows ? (kt / (N * N)) * N + kt % N : -1;
  spos[(int)perm[i]] = i;
}

// One place a lane that asks, from one atomic a warp; every lane of the
// warp calls it.
__device__ __forceinline__ int append(int* count, bool pred) {
  const unsigned b = __ballot_sync(kFull, pred);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (b != 0u) {
    const int leader = __ffs(b) - 1;
    if (lane == leader) base = atomicAdd(count, __popc(b));
    base = __shfl_sync(kFull, base, leader);
  }
  return base + __popc(b & ((1u << lane) - 1u));
}

__device__ __forceinline__ void push_chunks(int2* list, int* count, int v, int len) {
  const int n = (len + kSpan - 1) / kSpan;
  const int p0 = atomicAdd(count, n);
  for (int c = 0; c < n; ++c) list[p0 + c] = make_int2(v, p0);
}

// At the first slot of each run: the node onto its light list, or its
// chunks onto its heavy list; a receiver without sender slots also onto the
// light sender list (the backward's sender pass writes its dtj and dxh).
__global__ void edge_lists_kernel(const int* __restrict__ ef, const int* __restrict__ keyt,
                                  int E, int N, int rows, const int2* __restrict__ rrange,
                                  const int2* __restrict__ srange, int* __restrict__ light_r,
                                  int2* __restrict__ heavy_r, int* __restrict__ light_s,
                                  int2* __restrict__ heavy_s, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < E;
  const int total = rows * N;
  const int v = in ? node_of(ef[i], N, total, rows) : rows;
  const bool rstart = v < rows && (i == 0 || node_of(ef[i - 1], N, total, rows) != v);
  int rlen = 0, vslen = 1;
  if (rstart) {
    const int2 rr = rrange[v], sr = srange[v];
    rlen = rr.y - rr.x;
    vslen = sr.y - sr.x;
  }
  const int u = in ? keyt[i] / N : rows;
  const bool sstart = u < rows && (i == 0 || keyt[i - 1] / N != u);
  int slen = 0;
  if (sstart) {
    const int2 sr = srange[u];
    slen = sr.y - sr.x;
  }
  int q = append(counts + 0, rstart && rlen <= kSpan);
  if (rstart && rlen <= kSpan) light_r[q] = v;
  q = append(counts + 2, sstart && slen <= kSpan);
  if (sstart && slen <= kSpan) light_s[q] = u;
  q = append(counts + 2, rstart && vslen == 0);
  if (rstart && vslen == 0) light_s[q] = v;
  if (rstart && rlen > kSpan) push_chunks(heavy_r, counts + 1, v, rlen);
  if (sstart && slen > kSpan) push_chunks(heavy_s, counts + 3, u, slen);
}

// ---------------------------------------------------------------------------
// Forward.

struct FwdArgs {
  const float* ti;
  const float* tj;
  const void* xh;
  const int* ef;
  void* out;
  float* stat_m;     // [rows, heads] m_v of the nodes with slots
  float* stat_inv;   // [rows, heads] 1 / den_v
  float* part_ml;    // [cap_h, 2 heads] a heavy chunk's (m, l)
  float* part_acc;   // [cap_h, hd] its sum of weight x xh_u (weights against its m)
  Index ix;
  int N, rows;
  const uint32_t* seed;   // the 64-bit dropout seed on the card, low word first
  uint32_t thresh;
  float scale;
};

// Node v over its slots [beg, end) (at most kSpan): a light row (c < 0)
// writes out_v and its statistics; chunk c of a heavy row writes its partial
// at place c and, arriving last of the row's n (places p0 on), merges them.
template <typename T, int HEADS, int HD>
__device__ __forceinline__ void fwd_span(const FwdArgs& a, const Lane& L, int v, int beg,
                                         int end, int c, int p0, int n) {
  using S = Shape<T, HEADS, HD>;
  constexpr int F = S::F, G = S::G, K = S::K, W = S::W;
  const T* __restrict__ xh = static_cast<const T*>(a.xh);
  const int r = v % a.N, gN = v - r, hl = L.gl / S::LPH;
  const long long vN = (long long)v * a.N;
  const bool light = c < 0;
  float tiv[HEADS], tjv[HEADS], self[HEADS];
  load_heads<HEADS>(a.ti + (size_t)v * HEADS, tiv);
  load_heads<HEADS>(a.tj + (size_t)v * HEADS, tjv);
#pragma unroll
  for (int h = 0; h < HEADS; ++h) self[h] = leaky(tiv[h] + tjv[h]);

  // this lane's slots beg + gl + k G: the sender (-1: none, or a self loop)
  // and the scores, then exp(score - m) and the weights
  int s[K];
  float p[K][HEADS];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = beg + L.gl + k * G;
    s[k] = -1;
    if (e < end) {
      const int sk = (int)((long long)a.ef[e] - vN);
      if (sk != r) s[k] = sk;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) t[h] = 0.f;
    if (s[k] >= 0) load_heads<HEADS>(a.tj + (size_t)(gN + s[k]) * HEADS, t);
#pragma unroll
    for (int h = 0; h < HEADS; ++h) p[k][h] = leaky(tiv[h] + t[h]);
  }
  float m[HEADS], l[HEADS], inv[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    m[h] = self[h];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (s[k] >= 0) m[h] = fmaxf(m[h], p[k][h]);
    m[h] = lanes_max<G>(m[h], L.mask);
    l[h] = light && L.gl == 0 ? expf(self[h] - m[h]) : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (s[k] >= 0) {
        p[k][h] = expf(p[k][h] - m[h]);
        l[h] += p[k][h];
      }
    l[h] = lanes_sum<G>(l[h], L.mask);
    inv[h] = light ? 1.f / l[h] : 1.f;
  }
  const float wscale = light ? a.scale : 1.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t e = (uint64_t)(beg + L.gl + k * G);
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
      p[k][h] = s[k] >= 0 && keep_at(e * HEADS + h, a.seed, a.thresh)
                    ? p[k][h] * inv[h] * wscale : 0.f;
  }

  float acc[F];
  if (light) {
    const float as = expf(pick(self, hl) - pick(m, hl)) * pick(inv, hl);
    const float ws = keep_at(kSelfCounter + (uint64_t)v * HEADS + hl, a.seed, a.thresh)
                         ? as * a.scale : 0.f;
    uint32_t xw[W];
    load_words<T, F>(xh + (size_t)v * HD + L.gl * F, xw);
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = ws * word_elem<T>(xw, i);
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = 0.f;
  }
  // the slots in order, slot k G + o owned by lane o
  const int cnt = end - beg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * G >= cnt) break;
    for (int o = 0; o < G && k * G + o < cnt; o += kUnroll) {
      int sj[kUnroll];
      float wj[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = L.base + min(o + u, G - 1);
        sj[u] = __shfl_sync(L.mask, s[k], src);
        wj[u] = 0.f;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          const float t = __shfl_sync(L.mask, p[k][h], src);
          if (h == hl) wj[u] = t;
        }
        if (o + u >= G || k * G + o + u >= cnt) sj[u] = -1;
      }
      uint32_t xw[kUnroll][W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (sj[u] >= 0) load_words<T, F>(xh + (size_t)(gN + sj[u]) * HD + L.gl * F, xw[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (sj[u] >= 0)
#pragma unroll
          for (int i = 0; i < F; ++i) acc[i] = fmaf(wj[u], word_elem<T>(xw[u], i), acc[i]);
    }
  }
  T* __restrict__ out = static_cast<T*>(a.out) + (size_t)v * HD + L.gl * F;
  if (light) {
    store_vec<T, F>(out, acc);
    if (L.gl == 0) {
      store_heads<HEADS>(a.stat_m + (size_t)v * HEADS, m);
      store_heads<HEADS>(a.stat_inv + (size_t)v * HEADS, inv);
    }
    return;
  }

  // a heavy chunk: its partial, then the row's merge by its last chunk
  if (L.gl == 0) {
    store_heads<HEADS>(a.part_ml + (size_t)c * 2 * HEADS, m);
    store_heads<HEADS>(a.part_ml + (size_t)c * 2 * HEADS + HEADS, l);
  }
  store_vec<float, F>(a.part_acc + (size_t)c * HD + L.gl * F, acc);
  if (!arrived_last(a.ix.arr_r, p0, n, L)) return;
  // the row's max and denominator over its chunks: the lanes take the
  // chunks in turn, then a group tree (a chain of n dependent loads a lane
  // made the hubs' merge the walk's longest path)
  float M[HEADS], den[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) M[h] = self[h];
  for (int q = L.gl; q < n; q += G) {
    float mq[HEADS];
    load_heads_cg<HEADS>(a.part_ml + (size_t)(p0 + q) * 2 * HEADS, mq);
#pragma unroll
    for (int h = 0; h < HEADS; ++h) M[h] = fmaxf(M[h], mq[h]);
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    M[h] = lanes_max<G>(M[h], L.mask);
    den[h] = L.gl == 0 ? expf(self[h] - M[h]) : 0.f;
  }
  for (int q = L.gl; q < n; q += G) {
    float mq[HEADS], lq[HEADS];
    load_heads_cg<HEADS>(a.part_ml + (size_t)(p0 + q) * 2 * HEADS, mq);
    load_heads_cg<HEADS>(a.part_ml + (size_t)(p0 + q) * 2 * HEADS + HEADS, lq);
#pragma unroll
    for (int h = 0; h < HEADS; ++h) den[h] = fmaf(lq[h], expf(mq[h] - M[h]), den[h]);
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h) inv[h] = 1.f / lanes_sum<G>(den[h], L.mask);
  const float Mh = pick(M, hl), ih = pick(inv, hl);
  const float as = expf(pick(self, hl) - Mh) * ih;
  const float ws = keep_at(kSelfCounter + (uint64_t)v * HEADS + hl, a.seed, a.thresh)
                       ? as * a.scale : 0.f;
  uint32_t xw[W];
  load_words<T, F>(xh + (size_t)v * HD + L.gl * F, xw);
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = ws * word_elem<T>(xw, i);
  // the accumulators in chunk order
  for (int q = 0; q < n; ++q) {
    const size_t at = (size_t)(p0 + q);
    const float f = expf(__ldcg(a.part_ml + at * 2 * HEADS + hl) - Mh) * ih * a.scale;
    const float4* pa = reinterpret_cast<const float4*>(a.part_acc + at * HD + L.gl * F);
#pragma unroll
    for (int i4 = 0; i4 < F / 4; ++i4) {
      const float4 t = __ldcg(pa + i4);
      acc[4 * i4] = fmaf(f, t.x, acc[4 * i4]);
      acc[4 * i4 + 1] = fmaf(f, t.y, acc[4 * i4 + 1]);
      acc[4 * i4 + 2] = fmaf(f, t.z, acc[4 * i4 + 2]);
      acc[4 * i4 + 3] = fmaf(f, t.w, acc[4 * i4 + 3]);
    }
  }
  store_vec<T, F>(out, acc);
  if (L.gl == 0) {
    store_heads<HEADS>(a.stat_m + (size_t)v * HEADS, M);
    store_heads<HEADS>(a.stat_inv + (size_t)v * HEADS, inv);
    a.ix.arr_r[p0] = 0;
  }
}

// The nodes with slots: heavy chunks first (their merges are the tail), then
// light rows, a lane group an item, over a persistent grid; the next item's
// list entry and span are loaded while this one is walked.  No
// __launch_bounds__ on the walks: with one, ptxas trades spills for
// occupancy in some instances (as csr_rows.cuh's walk).
template <typename T, int HEADS, int HD>
__global__ void edge_fwd_walk_kernel(const FwdArgs a) {
  using S = Shape<T, HEADS, HD>;
  const Lane L = lane_of<S::G>();
  const int nh = a.ix.counts[1], items = nh + a.ix.counts[0];
  int it = (blockIdx.x * kThreads + (int)threadIdx.x) / S::G, c = -1;
  const int stride = walk_stride(it, nh, items, gridDim.x * (kThreads / S::G));
  Chunk2 k = {0, 0, 0, 0, 0};
  if (it < items) k = walk_item(a.ix.heavy_r, a.ix.light_r, a.ix.rrange, nh, it, c);
  while (it < items) {
    const Chunk2 cur = k;
    const int cc = c, next = it + stride;
    if (next < items) k = walk_item(a.ix.heavy_r, a.ix.light_r, a.ix.rrange, nh, next, c);
    fwd_span<T, HEADS, HD>(a, L, cur.v, cur.beg, cur.end, cc, cur.p0, cur.n);
    it = next;
  }
}

// The nodes without slots: out_v = keep_v scale alpha_v xh_v, alpha_v =
// exp(score - score) (1, or NaN for a non-finite logit), a group a node.
template <typename T, int HEADS, int HD>
__global__ void __launch_bounds__(kThreads) edge_fwd_stream_kernel(const FwdArgs a) {
  using S = Shape<T, HEADS, HD>;
  constexpr int F = S::F;
  const Lane L = lane_of<S::G>();
  const int v = (blockIdx.x * kThreads + (int)threadIdx.x) / S::G;
  if (v >= a.rows) return;
  const int h = L.gl / S::LPH;
  const int2 rr = a.ix.rrange[v];
  const float sc = leaky(__ldg(a.ti + (size_t)v * HEADS + h) + __ldg(a.tj + (size_t)v * HEADS + h));
  uint32_t xw[S::W];
  load_words<T, F>(static_cast<const T*>(a.xh) + (size_t)v * HD + L.gl * F, xw);
  if (rr.y > rr.x) return;
  const float as = expf(sc - sc);
  const float ws = keep_at(kSelfCounter + (uint64_t)v * HEADS + h, a.seed, a.thresh)
                       ? as * a.scale : 0.f;
  float o[F];
#pragma unroll
  for (int i = 0; i < F; ++i) o[i] = ws * word_elem<T>(xw, i);
  store_vec<T, F>(static_cast<T*>(a.out) + (size_t)v * HD + L.gl * F, o);
}

template <typename T, int HEADS, int HD>
struct Fwd {
  static int run(const FwdArgs& a, cudaStream_t stream) {
    using S = Shape<T, HEADS, HD>;
    static const int blocks = persistent_blocks((const void*)edge_fwd_walk_kernel<T, HEADS, HD>);
    edge_fwd_walk_kernel<T, HEADS, HD><<<blocks, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long per_block = kThreads / S::G;
    edge_fwd_stream_kernel<T, HEADS, HD>
        <<<(unsigned)((a.rows + per_block - 1) / per_block), kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// keys [E] int32 <- the sender-major key of each slot of edge_flat [E]
// (int32, sorted; rows = B*N, B*N*N < 2^31).
extern "C" int edge_keys_launch(const void* edge_flat, int E, int N, int rows, void* keys,
                                void* stream) {
  if (E <= 0) return 0;
  edge_keys_kernel<<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(edge_flat), E,
                                                          N, rows, static_cast<int*>(keys));
  return (int)cudaGetLastError();
}

// The index of edge_flat from its keys sorted stably (keyt int32) and their
// slots (perm int64).  ix: the 11 pointers of edge_gat.cuh's Index, in its
// order; rrange, srange, counts and the arrival counters zeroed.
extern "C" int edge_index_launch(const void* edge_flat, const void* keyt, const void* perm, int E,
                                 int N, int rows, void* const* ix, void* stream) {
  if (E <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((E + kThreads - 1) / kThreads);
  const int* ef = static_cast<const int*>(edge_flat);
  const int* kt = static_cast<const int*>(keyt);
  edge_runs_kernel<<<grid, kThreads, 0, s>>>(
      ef, kt, static_cast<const long long*>(perm), E, N, rows, static_cast<int2*>(ix[0]),
      static_cast<int2*>(ix[1]), static_cast<int*>(ix[2]), static_cast<int*>(ix[3]));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_lists_kernel<<<grid, kThreads, 0, s>>>(
      ef, kt, E, N, rows, static_cast<const int2*>(ix[0]), static_cast<const int2*>(ix[1]),
      static_cast<int*>(ix[4]), static_cast<int2*>(ix[5]), static_cast<int*>(ix[6]),
      static_cast<int2*>(ix[7]), static_cast<int*>(ix[8]));
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (xh, out).  ti, tj [B*N, heads] f32; xh,
// out [B*N, hd], heads in {1, 2, 4, 8}, hd in {32, 64, 128, 256};
// edge_flat [E] int32 sorted, B*N*N < 2^31; ix as edge_index_launch built
// it; stat_m, stat_inv [B*N, heads] f32 (written for the nodes with slots);
// part_ml [cap_h, 2 heads] and part_acc [cap_h, hd] f32 scratch.  thresh =
// uint32(rate * 2^32), 0 for no dropout; seed: the 64-bit dropout seed on
// the card (8 bytes, the low word first; read only when thresh != 0);
// scale = 1 / (1 - rate).  All contiguous, 16-byte aligned.
extern "C" int edge_gat_fwd_launch(const void* ti, const void* tj, const void* xh,
                                   const void* edge_flat, void* const* ix, void* out,
                                   void* stat_m, void* stat_inv, void* part_ml, void* part_acc,
                                   int B, int N, int heads, int hd, int dtype, const void* seed,
                                   uint32_t thresh, float scale, void* stream) {
  const long long rows = (long long)B * N;
  if (rows == 0) return 0;
  if (bad_shape(heads, hd) || rows * N >= (1ll << 31) || (thresh != 0 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.ti = static_cast<const float*>(ti);
  a.tj = static_cast<const float*>(tj);
  a.xh = xh;
  a.ef = static_cast<const int*>(edge_flat);
  a.out = out;
  a.stat_m = static_cast<float*>(stat_m);
  a.stat_inv = static_cast<float*>(stat_inv);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.ix = index_from(ix);
  a.N = N;
  a.rows = (int)rows;
  a.seed = static_cast<const uint32_t*>(seed);
  a.thresh = thresh;
  a.scale = scale;
  return dispatch<Fwd>(dtype, heads, hd, a, static_cast<cudaStream_t>(stream));
}
