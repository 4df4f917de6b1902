// Shared CSR-row machinery of the sparse kernels (spmm.cu, gat_sparse.cu,
// coo_spmm.cu): the chunk split of graph.edge_csr, vector loads and stores of
// a lane's features, the coefficient SpMM walk that K2/K3, K11, K14, K19 and
// K9/K9T instantiate, and the per-row reduction of per-edge values that K21
// (a max), K1 / K13 (the sender degree), K5's and K10's sender sums and K6
// (both CSRs in one grid) instantiate (both walks: light rows by row,
// several a warp; heavy rows by chunk from a host-built list, each finished
// by its last chunk to arrive).  The list has a capacity fixed by the
// batch's edge budget (graph.heavy_capacity) and a live count in device
// memory (EdgeCsr.heavy_count): a grid is sized for the capacity, a kernel
// reads the count (live_heavy) and its items past the live ones return at
// once, so a launch captured in a CUDA graph walks whichever batch its
// buffers hold at each replay.  Included by each source; it is not a build
// target of its own.
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

// F values of type T at p (aligned to min(16, F * sizeof(T)) bytes, at least
// 8) as 32-bit words, and element f of such words as f32: load_vec in two
// steps, so that a row's registers stay narrow until its FMAs.
template <typename T, int F>
__device__ __forceinline__ void load_words(const T* __restrict__ p,
                                           uint32_t (&w)[F * sizeof(T) / 4]) {
  constexpr int kBytes = F * (int)sizeof(T);
  static_assert(kBytes % 8 == 0, "a lane loads 8 or 16 bytes at a time");
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  }
}

template <typename T>
__device__ __forceinline__ float word_elem(const uint32_t* w, int f) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[f]);
  else return __uint_as_float(f % 2 ? w[f / 2] & 0xffff0000u : w[f / 2] << 16);
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

// ---- coefficient SpMM over a CSR (K2/K3/K14 of spmm.cu, K11/K19 of
// coo_spmm.cu, K9/K9T of gat_sparse.cu)
//
// out_b[r] = sum over the live edges e of row r of cf_b[e] * x_b[nbr_e], for
// kBranches branches b; each feature's sum is f32, by fmaf in edge order from
// 0.  Real batches hold many rows of a few edges and a few rows of thousands
// (the REDDIT-shaped batch: 97.5% of its rows hold at most 4 edges, 201 rows
// more than 32), so the walk's unit is a lane group, not a warp:
//  - a group is G lanes of F features each (LightShape: 16-byte loads, or
//    the policy's kLaneBytes, where a head allows, G = H / F <= 32), so
//    32 / G groups a warp;
//  - a light row (one chunk: at most kGroup = 32 edges) is one group's item,
//    addressed by row: the group reads its ptr pair, then the metadata of up
//    to 32 edges at once (32 / G a lane), and writes the row through the
//    policy;
//  - a heavy row keeps graph.edge_csr's split into <= 64 chunks; its chunks,
//    listed on the host (EdgeCsr.heavy_chunks, its live prefix), are the
//    first items of the launch, each writing one f32 partial; the row's last chunk to finish
//    (an int arrival counter) sums its partials in chunk order and writes
//    the row, so every batch takes one launch and no pass visits all rows
//    (the counters, EdgeCsr.arrivals, are 0 again when the launch ends);
//    a chunk of masked-out edges alone (the padded run at node V-1) is not
//    walked by a policy whose liveness needs the mask (K2, K3, K14, K9);
//  - a group reads the metadata of kWindowEdges edges at once (a window)
//    and lists its live edges with a ballot, then loads the neighbour rows
//    of up to kInFlight / kBranches of them before their FMAs: registers,
//    not loads in flight, bound how many rows an SM keeps going.
// Every sum has one owner and one order and there are no float atomics: a
// result does not change between runs, and it equals the one-warp-a-chunk
// walk's bit for bit (the same fmaf order per feature, the same partials,
// summed in the same order).  Control flow is warp-uniform (__any_sync); a
// group whose edges are done idles.
//
// The policy P derives from CsrRows (perm null when edge i of the CSR is edge
// i) and holds x[kBranches] of element type Elem, partial ([C_h, kBranches, h]
// f32, in heavy_chunks order), h, optionally kHeads (coefficients per branch
// and edge; default 1), and:
//   kMaskedDead                   whether an edge whose edge_mask is off is
//       never live (then a heavy chunk of such edges alone is not walked);
//   Row row(int r)                                     the row's own state;
//   bool edge(int e, const Row&, int& s, float (&cf)[kBranches * kHeads])
//       whether edge e is live, and its neighbour s and coefficients
//       (cf[b * kHeads + hd]: branch b, head hd); without a branch, so that
//       a window's loads are in flight together (s and cf of a dead edge are
//       read and not used);
//   void write_row<F>(int r, int lane, const float (&acc)[kBranches][F])
//       the row's output from the F sums per branch of a lane of its group
//       (features lane * F on);
// and optionally (each off unless the policy says):
//   kLaneBytes                    bytes of x a lane loads (default 16);
//   kLateCoef                     one branch whose coefficients each lane forms
//       for its own head after the ballot, beside the neighbour row's load
//       (K9: a coefficient costs gathers, an exp and a hash, and an edge's
//       own lane would form all heads, for every slot): then the policy has
//       Row row(int r, int head) (the state of the lane's head), bool
//       edge(int e, const Row&, int& s) (liveness and neighbour only) and
//       float coef(int e, int s, const Row&);
//   static constexpr int min_blocks(int Q)  the blocks an SM the walk's
//       launch bounds ask for at H = 32 Q (above 1: csr_spmm_kernel_bounded).
// With kHeads > 1 a row's h features are kHeads heads of h / kHeads, each
// weighted by its own coefficient; a lane's F features lie in one head (a
// narrower load where a head holds fewer than 16 bytes).
//
// Bound: bytes: x [V, kBranches H] once (plus a neighbour row per live edge,
// mostly from L2), the output once, a few bytes of metadata per edge.  The
// walk's own limit is latency: a light row is a chain of dependent loads
// (ptr, metadata, neighbour rows, the self term, store), so the design keeps
// as many rows in flight as registers allow (32 / G a warp; launch bounds
// only where a policy's min_blocks asks for more blocks an SM: in general
// ptxas then trades spills for occupancy here).

// The CSR of a walk: graph.EdgeCsr on the device.
struct CsrRows {
  const int* ptr;
  const int* chunk_ptr;
  const int* chunk_row;
  const int* heavy_chunks;      // the chunks of the rows of more than one, ascending
  const uint8_t* heavy_masked;  // per heavy chunk: all its edges masked out
  const int* heavy_count;       // [1]: the live heavy chunks, a prefix of the list
  int* arrivals;                // per heavy chunk, 0 between launches: see csr_spmm_kernel
  const int* perm;              // null: edge i of the CSR is edge i; else edge perm[i]
  int heavy_cap, num_nodes;     // heavy_cap: the list's capacity, >= the live count
};

// The live heavy chunks of the CSR, read from device memory at the kernel's
// start (the host sizes the grid for heavy_cap).
__device__ __forceinline__ int live_heavy(const CsrRows& a) { return __ldg(a.heavy_count); }

// Whether the host-side arguments of a walk are sound.
inline bool csr_ok(const CsrRows& a) {
  return a.num_nodes > 0 && a.heavy_cap > 0 && a.heavy_count != nullptr;
}

template <typename P, typename = void>
struct HeadsOf {
  static constexpr int v = 1;
};
template <typename P>
struct HeadsOf<P, decltype(void(P::kHeads))> {
  static constexpr int v = P::kHeads;
};
template <typename P, typename = void>
struct LaneBytesOf {
  static constexpr int v = 16;
};
template <typename P>
struct LaneBytesOf<P, decltype(void(P::kLaneBytes))> {
  static constexpr int v = P::kLaneBytes;
};
// The blocks an SM that the walk asks of ptxas at H = 32 Q: a policy's
// min_blocks(Q), or 1 (no launch bounds: ptxas keeps its own register
// choice, which any bounds, even (256, 1), change).
template <typename P, typename = void>
struct MinBlocksOf {
  static constexpr int at(int) { return 1; }
};
template <typename P>
struct MinBlocksOf<P, decltype(void(P::min_blocks(1)))> {
  static constexpr int at(int q) { return P::min_blocks(q); }
};
template <typename P, typename = void>
struct LateCoefOf {
  static constexpr bool v = false;
};
template <typename P>
struct LateCoefOf<P, decltype(void(P::kLateCoef))> {
  static constexpr bool v = P::kLateCoef;
};

// The row state a lane hands the walk: P::row(r), or with kLateCoef
// P::row(r, head), the row's state for the head of the lane's features.
template <typename P>
__device__ __forceinline__ typename P::Row row_state(const P& a, int r, int head) {
  if constexpr (LateCoefOf<P>::v) return a.row(r, head);
  else return a.row(r);
}

constexpr int kInFlight = 2;     // neighbour-row loads (rows x branches) a group issues
                                 // before their FMAs
constexpr int kWindowEdges = 32;  // edges whose metadata a group reads at once

// A light row's lane group at H = 32 Q: F features a lane (kBytes bytes,
// or Q when more, or a head's width when less), G = H / F lanes.
template <typename T, int Q, int NH, int kBytes = 16>
struct LightShape {
  static constexpr int kWide = kBytes / (int)sizeof(T) > Q ? kBytes / (int)sizeof(T) : Q;
  static constexpr int F = kWide < 32 * Q / NH ? kWide : 32 * Q / NH;
  static constexpr int G = 32 * Q / F;
};

// A group's sums over the live edges at CSR positions [beg, end): acc[b][f]
// for its lane gl's F features (first lane of the group: base), windows of W
// edges a lane.  Every lane of the warp calls it.
template <typename P, int F, int G, int W, int U>
__device__ __forceinline__ void walk_edges(const P& a, int beg, int end,
                                           const typename P::Row& row, int gl, int base,
                                           float (&acc)[P::kBranches][F]) {
  constexpr int NB = P::kBranches;
  constexpr int NH = HeadsOf<P>::v;
  constexpr bool kLate = LateCoefOf<P>::v;
  constexpr int NC = kLate ? 1 : NB * NH;   // coefficients an owner lane forms per edge
  static_assert(!kLate || NB == 1, "a late coefficient is one branch's");
  using T = typename P::Elem;
  const unsigned gbits = G == 32 ? kFull : (1u << G) - 1u;
  const int head = gl * F / (a.h / NH);   // the head of the lane's features
  for (int w0 = beg; __any_sync(kFull, w0 < end); w0 += W * G) {
    int s_l[W], e_l[W];
    float cf_l[W][NC];
    bool live[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      // past the range a lane reads the range's last edge again (a valid
      // index, no branch), never live
      const int i = w0 + k * G + gl;
      const int ic = max(min(i, end - 1), 0);
      const int e = a.perm == nullptr ? ic : a.perm[ic];
      bool got;
      if constexpr (kLate) {
        got = a.edge(e, row, s_l[k]);
        e_l[k] = e;
      } else {
        got = a.edge(e, row, s_l[k], cf_l[k]);
      }
      live[k] = i < end && got;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      unsigned m = (__ballot_sync(kFull, live[k]) >> base) & gbits;
      while (__any_sync(kFull, m != 0)) {
        // the next U live edges of the group, in edge order
        bool ok[U];
        int s[U], e[U];
        float cf[U][NB];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ok[u] = m != 0;
          const int j = base + (ok[u] ? __ffs(m) - 1 : 0);
          m &= m - 1;
          s[u] = __shfl_sync(kFull, s_l[k], j);
          if constexpr (kLate) {
            e[u] = __shfl_sync(kFull, e_l[k], j);
          } else {
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              cf[u][b] = 0.0f;
#pragma unroll
              for (int hd = 0; hd < NH; ++hd) {
                const float v = __shfl_sync(kFull, cf_l[k][b * NH + hd], j);
                if (NH == 1 || hd == head) cf[u][b] = v;
              }
            }
          }
        }
        uint32_t xs[U][NB][F * sizeof(T) / 4];   // the rows as loaded, widened at their FMAs
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u])
#pragma unroll
            for (int b = 0; b < NB; ++b)
              load_words<T, F>(a.x[b] + (size_t)s[u] * a.h + gl * F, xs[u][b]);
        if constexpr (kLate)   // each lane its own head's coefficient, beside the rows' loads
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (ok[u]) cf[u][0] = a.coef(e[u], s[u], row);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u])
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int f = 0; f < F; ++f)
                acc[b][f] = fmaf(cf[u][b], word_elem<T>(xs[u][b], f), acc[b][f]);
      }
    }
  }
}

// A lane group's item on a walk over the CSR: items [0, nh) are the nh live
// chunks on the heavy list (i0: the place of the row's first chunk
// there, n: the row's chunks), the others the rows (a heavy row's own item
// idle).  The group walks CSR positions [beg, wend): all of a light row or
// a heavy chunk, nothing else; with skip_masked, nothing of a heavy chunk of
// masked-out edges alone either (masked).
struct CsrItem {
  int r, beg, end, wend, i0, n;
  bool heavy, light, masked;
};

__device__ __forceinline__ CsrItem csr_item(const CsrRows& a, int nh, int item,
                                            bool skip_masked) {
  CsrItem t;
  t.heavy = item < nh;
  t.r = item - nh;
  t.beg = t.end = t.i0 = t.n = 0;
  t.masked = false;
  if (t.heavy) {
    const int c = a.heavy_chunks[item];
    const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
    t.r = k.row;
    t.beg = k.beg;
    t.end = k.end;
    t.masked = skip_masked && a.heavy_masked[item];
    t.i0 = item - (c - a.chunk_ptr[k.row]);
    t.n = k.count;
  } else if (t.r < a.num_nodes) {
    t.beg = a.ptr[t.r];
    t.end = a.ptr[t.r + 1];
  }
  t.light = !t.heavy && t.r < a.num_nodes && t.end - t.beg <= kGroup;
  t.wend = (t.heavy && !t.masked) || t.light ? t.end : t.beg;
  return t;
}

// The end of an item whose group sums N values a row (K5's ddis_r, K10's
// dti) from each lane's acc: the group's sums; a light row's written to
// out[q][r] by the group's first lane; a heavy chunk's stored as its
// partials ([heavy_cap, N]), made visible and counted in arrivals[i0],
// and the row's last chunk to arrive sums the row's partials in chunk order
// (lane q value q), writes the row and sets the counter back to 0.  Every
// lane of the warp calls it.
template <int N, int G>
__device__ __forceinline__ void finish_item(const CsrRows& a, const CsrItem& t, int item,
                                            int gl, float (&acc)[N], float* __restrict__ out,
                                            float* __restrict__ partial) {
  static_assert(N <= G, "lane q of the group sums value q");
  const size_t V = a.num_nodes;
#pragma unroll
  for (int q = 0; q < N; ++q)
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc[q] += __shfl_xor_sync(kFull, acc[q], off);
  if (t.light && gl == 0)
#pragma unroll
    for (int q = 0; q < N; ++q) out[q * V + t.r] = acc[q];
  if (!__any_sync(kFull, t.heavy)) return;
  if (t.heavy && gl == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) partial[(size_t)item * N + q] = acc[q];
    __threadfence();
  }
  __syncwarp();
  int last = 0;
  if (t.heavy && gl == 0) last = atomicAdd(a.arrivals + t.i0, 1) == t.n - 1;
  if (__shfl_sync(kFull, last, (threadIdx.x & 31) - gl)) {
    __threadfence();
    if (gl < N) {
      float sum = 0.0f;
#pragma unroll 8
      for (int c = 0; c < t.n; ++c) sum += __ldcg(partial + (size_t)(t.i0 + c) * N + gl);
      out[gl * V + t.r] = sum;
    }
    if (gl == 0) a.arrivals[t.i0] = 0;
  }
}

// A heavy row's output from the partials of its n chunks at places [i0,
// i0 + n) of the list: their sum in chunk order, from 0, read from L2 (other
// SMs wrote them in this launch).  One partial at a time: the registers of
// a deeper pipeline would cost every row of the launch occupancy.
template <typename P, int F>
__device__ __forceinline__ void combine_row(const P& a, int r, int i0, int n, int gl) {
  constexpr int NB = P::kBranches;
  static_assert(F % 4 == 0, "partials are read as float4");
  float acc[NB][F] = {};
  for (int c = 0; c < n; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4* p = reinterpret_cast<const float4*>(
          a.partial + ((size_t)(i0 + c) * NB + b) * a.h + gl * F);
#pragma unroll
      for (int v = 0; v < F / 4; ++v) {
        const float4 t = __ldcg(p + v);
        acc[b][4 * v] += t.x;
        acc[b][4 * v + 1] += t.y;
        acc[b][4 * v + 2] += t.z;
        acc[b][4 * v + 3] += t.w;
      }
    }
  a.template write_row<F>(r, gl, acc);
}

// One item a lane group, 32 / G a warp: items [0, live_heavy) are the
// chunks on the heavy list (partial i for item i), the others the rows (a
// light row written through the policy, a heavy row's group idle).  Heavy
// chunks come first, so their longer walks start first.  A heavy chunk's
// group stores its partial, makes it visible (__threadfence) and counts
// itself in arrivals[i0], i0 the place of its row's first chunk; the group
// that counts last sums the row's partials and writes the row, then sets
// arrivals[i0] back to 0 for the next launch.  So one launch writes every
// row, and no float is summed atomically.
template <typename P, int Q>
__device__ __forceinline__ void csr_spmm_items(const P& a) {
  constexpr int NB = P::kBranches;
  using S = LightShape<typename P::Elem, Q, HeadsOf<P>::v, LaneBytesOf<P>::v>;
  constexpr int F = S::F, G = S::G;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  const int nh = live_heavy(a);
  if (first >= nh + a.num_nodes) return;
  const int gl = lane % G;
  const int item = first + lane / G;
  // a chunk of masked-out edges alone sums to +0 under a masked policy
  const CsrItem it = csr_item(a, nh, item, P::kMaskedDead);
  float acc[NB][F] = {};
  walk_edges<P, F, G, kWindowEdges / G, (kInFlight > NB ? kInFlight / NB : 1)>(
      a, it.beg, it.wend,
      row_state(a, min(it.r, a.num_nodes - 1), gl * F / (a.h / HeadsOf<P>::v)), gl, lane - gl,
      acc);
  if (it.light) a.template write_row<F>(it.r, gl, acc);
  if (!__any_sync(kFull, it.heavy)) return;
  if (it.heavy) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      store_vec<float, F>(a.partial + ((size_t)item * NB + b) * a.h + gl * F, acc[b]);
    __threadfence();
  }
  __syncwarp();
  int last = 0;
  if (it.heavy && gl == 0) last = atomicAdd(a.arrivals + it.i0, 1) == it.n - 1;
  if (__shfl_sync(kFull, last, lane - gl)) {
    __threadfence();
    combine_row<P, F>(a, it.r, it.i0, it.n, gl);
    if (gl == 0) a.arrivals[it.i0] = 0;
  }
}

template <typename P, int Q>
__global__ void csr_spmm_kernel(const P a) {
  csr_spmm_items<P, Q>(a);
}

// The same walk where the policy asks for MinBlocks blocks an SM.
template <typename P, int Q, int MinBlocks>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, MinBlocks)
csr_spmm_kernel_bounded(const P a) {
  csr_spmm_items<P, Q>(a);
}

template <typename P, int Q>
cudaError_t launch_csr_spmm_q(const P& a, cudaStream_t stream) {
  using S = LightShape<typename P::Elem, Q, HeadsOf<P>::v, LaneBytesOf<P>::v>;
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / S::G;
  constexpr int kMinBlocks = MinBlocksOf<P>::at(Q);
  const int blocks = (a.heavy_cap + a.num_nodes + kItemsPerBlock - 1) / kItemsPerBlock;
  if constexpr (kMinBlocks > 1)
    csr_spmm_kernel_bounded<P, Q, kMinBlocks><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  else
    csr_spmm_kernel<P, Q><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows aligned to a light lane's
// load (LightShape: min(16, F * sizeof(Elem)) bytes).
template <typename P>
cudaError_t launch_csr_spmm(const P& a, cudaStream_t stream) {
  if (!csr_ok(a)) return cudaErrorInvalidValue;
  switch (a.h / 32) {
    case 1: return launch_csr_spmm_q<P, 1>(a, stream);
    case 2: return launch_csr_spmm_q<P, 2>(a, stream);
    case 4: return launch_csr_spmm_q<P, 4>(a, stream);
    case 8: return launch_csr_spmm_q<P, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- per-row reductions of per-edge values (K21, K1 / K13, K5's and
// K10's sender sums, K6) -------------------------------------------------
//
// out[q][r] = init op v_q(e_1) op v_q(e_2) ... over the edges of row r, for
// `planes` f32 values v_q per edge, with an associative Op (K21: max from
// -1e30 over the receiver CSR; K5's ddis_s and K10's dtj: sums from 0 over
// the sender CSR of values stored edge-major, [E, planes]; K1 / K13 and K6:
// sums of values formed from the edge's inputs, K6 over both CSRs in one
// grid).  The values come from a policy R, a CsrRows with planes,
// skip_masked, out ([planes, num_nodes]), partial ([heavy_cap, planes])
// and
//   template <typename Op, int G> void lane_values(int q0, int beg, int end,
//       int row, int gl, float (&acc)[kPlaneBatch]) const
// which folds into acc[j] (from Op::kInit) the values of planes q0 + j at
// CSR positions beg + gl, beg + gl + G, ... below end of row `row`
// (RowReduce reads them from stored planes), and optionally kOwnStore with
//   void store(int q, int r, float v) const
// which writes row r's result v of plane q itself (K1 / K13: deg = 1 + v
// and dis = deg^-1/2 in the row's write; without it out[q][r] = v).  The
// unit is the walk's: a light row (one chunk, at most kGroup edges) is one
// item of a group of kReduceGroup lanes (8 rows a warp, as most rows of a
// real batch hold 1-4 edges); a heavy row's chunks (the live prefix of the
// host-built EdgeCsr.heavy_chunks, the padded run at node V-1 included unless
// skip_masked: a dead edge's value is then Op's identity) are the first
// warps' items, a warp each, and the row's last chunk to arrive
// (EdgeCsr.arrivals, 0 again when the launch ends) reduces the chunks'
// partials and writes the row.  One launch, no pass over all rows.
// RowReduce reads 16 bytes of a plane at a time where the planes allow
// (perm null, E % 4 == 0, 16-byte aligned), the loads of kPlaneBatch planes
// in flight together; edge-major values give a lane an edge's planes in one
// 16-byte load (4 planes), through perm too.  Every output has one owner
// and one order (lanes, then the group's shuffle tree; partials likewise):
// a sum on this walk is deterministic.
//
// Bound: bytes, 4 planes bytes per edge and per row, plus the CSR; the walk
// is latency: ptr, the values, the store, a chain per row.

constexpr int kReduceGroup = 4;   // lanes of a light row's group
constexpr int kPlaneBatch = 4;    // planes a lane reads together

template <typename R, typename = void>
struct OwnStoreOf {
  static constexpr bool v = false;
};
template <typename R>
struct OwnStoreOf<R, decltype(void(R::kOwnStore))> {
  static constexpr bool v = R::kOwnStore;
};

// Row r's result v of plane q: the policy's own store, or out[q][r].
template <typename R>
__device__ __forceinline__ void store_row(const R& a, int q, int r, float v) {
  if constexpr (OwnStoreOf<R>::v) a.store(q, r, v);
  else a.out[(size_t)q * a.num_nodes + r] = v;
}

// The values of stored planes.
struct RowReduce : CsrRows {
  const float* vals;   // [planes, num_edges] (edge_major: [num_edges, planes]): CSR
                       // position i reads edge i (perm null) or perm[i]
  int num_edges, planes;
  bool vec;            // perm null, num_edges % 4 == 0, vals 16-byte aligned: float4 loads
  bool edge_major;     // vals [num_edges, planes], 16-byte aligned
  bool skip_masked;    // a dead edge's value is Op's identity: a heavy chunk of
                       // masked-out edges alone (heavy_masked) is not read
  float* out;          // [planes, num_nodes]
  float* partial;      // [heavy_cap, planes]

  template <typename Op, int G>
  __device__ __forceinline__ void lane_values(int q0, int beg, int end, int, int gl,
                                              float (&acc)[kPlaneBatch]) const {
    if (vec) {
      for (int i = (beg & ~3) + 4 * gl; i < end; i += 4 * G) {
        float4 t[kPlaneBatch];
#pragma unroll
        for (int j = 0; j < kPlaneBatch; ++j)
          if (q0 + j < planes)
            t[j] = __ldg(reinterpret_cast<const float4*>(vals + (size_t)(q0 + j) * num_edges + i));
#pragma unroll
        for (int j = 0; j < kPlaneBatch; ++j) {
          if (q0 + j >= planes) continue;
          const float e[4] = {t[j].x, t[j].y, t[j].z, t[j].w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i + u >= beg && i + u < end) acc[j] = Op::apply(acc[j], e[u]);
        }
      }
    } else if (edge_major && planes % 4 == 0) {
      static_assert(kPlaneBatch == 4, "an edge's batch of planes is one float4");
      for (int i = beg + gl; i < end; i += G) {
        const size_t e = perm == nullptr ? i : perm[i];
        const float4 t = __ldg(reinterpret_cast<const float4*>(vals + e * planes + q0));
        acc[0] = Op::apply(acc[0], t.x);
        acc[1] = Op::apply(acc[1], t.y);
        acc[2] = Op::apply(acc[2], t.z);
        acc[3] = Op::apply(acc[3], t.w);
      }
    } else {
      for (int i = beg + gl; i < end; i += G) {
        const size_t e = perm == nullptr ? i : perm[i];
#pragma unroll
        for (int j = 0; j < kPlaneBatch; ++j)
          if (q0 + j < planes)
            acc[j] = Op::apply(acc[j], edge_major ? vals[e * planes + q0 + j]
                                                  : vals[(size_t)(q0 + j) * num_edges + e]);
      }
    }
  }
};

struct MaxOp {
  static constexpr float kInit = -1e30f;   // cal_tpu's init of tile_scatter_max
  __device__ static __forceinline__ float apply(float a, float b) { return fmaxf(a, b); }
};

struct SumOp {
  static constexpr float kInit = 0.0f;
  __device__ static __forceinline__ float apply(float a, float b) { return a + b; }
};

// acc[j] = the reduction of plane q0 + j over CSR positions [beg, end) of
// row `row` by the G lanes of a group (gl: the lane's place in it); every
// lane of the warp calls it, and each of a group's lanes ends with the
// group's result.
template <typename Op, int G, typename R>
__device__ __forceinline__ void reduce_span(const R& a, int q0, int beg, int end, int row,
                                            int gl, float (&acc)[kPlaneBatch]) {
#pragma unroll
  for (int j = 0; j < kPlaneBatch; ++j) acc[j] = Op::kInit;
  a.template lane_values<Op, G>(q0, beg, end, row, gl, acc);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < kPlaneBatch; ++j)
      acc[j] = Op::apply(acc[j], __shfl_xor_sync(kFull, acc[j], off));
}

// A heavy chunk, a warp: its partials, then, for the row's last chunk to
// arrive, the row from all of them.
template <typename Op, typename R>
__device__ __forceinline__ void reduce_heavy_chunk(const R& a, int item, int lane) {
  const int c = a.heavy_chunks[item];
  const Chunk k = chunk_of(c, a.ptr, a.chunk_ptr, a.chunk_row);
  const int i0 = item - (c - a.chunk_ptr[k.row]);   // the row's first chunk on the list
  const int end = a.skip_masked && a.heavy_masked[item] ? k.beg : k.end;
  for (int q0 = 0; q0 < a.planes; q0 += kPlaneBatch) {
    float acc[kPlaneBatch];
    reduce_span<Op, 32>(a, q0, k.beg, end, k.row, lane, acc);
#pragma unroll
    for (int j = 0; j < kPlaneBatch; ++j)
      if (lane == j && q0 + j < a.planes) a.partial[(size_t)item * a.planes + q0 + j] = acc[j];
  }
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(a.arrivals + i0, 1) == k.count - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  for (int q = 0; q < a.planes; ++q) {
    float m = Op::kInit;
    for (int j = lane; j < k.count; j += 32)
      m = Op::apply(m, __ldcg(a.partial + (size_t)(i0 + j) * a.planes + q));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = Op::apply(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) store_row(a, q, k.row, m);
  }
  if (lane == 0) a.arrivals[i0] = 0;
}

// The rows [32 / kReduceGroup w, 32 / kReduceGroup (w + 1)), a group each
// (a heavy row's group idles).
template <typename Op, typename R>
__device__ __forceinline__ void reduce_light_rows(const R& a, int w, int lane) {
  constexpr int G = kReduceGroup;
  const int first = w * (32 / G);
  if (first >= a.num_nodes) return;
  const int r = first + lane / G, gl = lane % G;
  int beg = 0, end = 0;
  if (r < a.num_nodes) {
    beg = a.ptr[r];
    end = a.ptr[r + 1];
  }
  const bool light = r < a.num_nodes && end - beg <= kGroup;
  if (!light) end = beg;
  for (int q0 = 0; q0 < a.planes; q0 += kPlaneBatch) {
    float acc[kPlaneBatch];
    reduce_span<Op, G>(a, q0, beg, end, min(r, a.num_nodes - 1), gl, acc);
    if (light && gl == 0)
#pragma unroll
      for (int j = 0; j < kPlaneBatch; ++j)
        if (q0 + j < a.planes) store_row(a, q0 + j, r, acc[j]);
  }
}

// The warps a reduction over one CSR takes: one a heavy chunk, then one a
// 32 / kReduceGroup rows.
__host__ __device__ __forceinline__ int light_warps(const CsrRows& c) {
  return (c.num_nodes + 32 / kReduceGroup - 1) / (32 / kReduceGroup);
}

// Warps [0, live_heavy) take the heavy chunks, a warp each; the next
// light_warps take the rows, 32 / kReduceGroup a warp; the grid's others
// (the heavy list's unused capacity) return.
template <typename Op, typename R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) csr_reduce_kernel(const R a) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int nh = live_heavy(a);
  if (warp < nh) reduce_heavy_chunk<Op>(a, warp, lane);
  else reduce_light_rows<Op>(a, warp - nh, lane);
}

template <typename Op, typename R>
cudaError_t launch_csr_reduce(const R& a, cudaStream_t stream) {
  if (!csr_ok(a) || a.planes <= 0) return cudaErrorInvalidValue;
  const int warps = a.heavy_cap + light_warps(a);
  csr_reduce_kernel<Op><<<(warps + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
