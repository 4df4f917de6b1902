// Coefficient SpMM kernels for Hopper (sm_90a): the weighted neighbour sum
// out[r] = sum_e coef[e] * x[s_e] over the receiver CSR (K11; per head, K19),
// the same kernel over the sender CSR for its x-gradient (K11T; K19T), the
// per-edge dot product of its coefficient gradient (K12; per head, K20), and
// the per-receiver max of per-edge value planes (K21).
//
// Replaces (cal_tpu/ops/pallas_spmm.py coo_spmm and coo_spmm_mh with their
// VJPs, and tile_scatter_max):
//   K11  _spmm_call on tiles_fwd (_coo_fwd)             -> coo_spmm_launch, heads 1, perm null
//   K11T _spmm_call on tiles_bwd (_coo_bwd, dx)         -> coo_spmm_launch, heads 1, perm given
//   K12  _sddmm_call on tiles_fwd (_coo_bwd, dcoef)     -> coo_sddmm_launch, heads 1
//   K19  _spmm_mh_call on tiles_fwd (_coo_mh_fwd)       -> coo_spmm_launch, heads > 1, perm null
//   K19T _spmm_mh_call on tiles_bwd (_coo_mh_bwd, dx)   -> coo_spmm_launch, heads > 1, perm given
//   K20  _sddmm_mh_call on tiles_fwd (_coo_mh_bwd)      -> coo_sddmm_launch, heads > 1
//   K21  tile_scatter_max (_tile_scatter_max_kernel)    -> segment_max_launch
//
// Contract (coo_spmm with a coefficient per edge and head, no loop
// manipulation; x rows hold `heads` heads of d = H / heads features, heads 1
// for K11/K11T/K12):
//   K11/K19:  out[r, h] = sum over e with r_e = r of coef[e, h] * x[s_e, h];
//   K11T/K19T: dx[s, h] = sum over e with s_e = s of coef[e, h] * g[r_e, h];
//   K12/K20:  dcoef[e, h] = <g[r_e, h], x[s_e, h]> for EVERY edge, dead ones
//             included (cal_tpu's tile plan holds every edge of the batch;
//             only its trailing [E + 1] pad entry is zeroed, which the port
//             does not have);
//   K21:      out[k, v] = max(-1e30, max over e with r_e = v of vals[k, e])
//             for K value planes in edge order, over every edge (the
//             callers set dead edges to -1e30; the kernel does not rely on it).
// Liveness is the coefficient alone: a self loop is an ordinary edge (sparse
// GIN passes coef = edge_mask; sparse GAT zeroes its dead and self-loop
// edges), and no index is ever compared.  K11/K19 skip edges whose
// coefficients are all 0 (their product is 0 for finite features), so the
// padded run at node V-1 costs one coefficient read per edge and head.
//
// Rounding: x and g are read in their stored dtype (f32 or bf16, each its
// own in K12/K20); coefficients, products and sums are f32, and outputs are
// f32 ([V, H] for K11/K19, [E, heads] for K12/K20, [K, V] for K21).  The
// wrappers in ops/coo_spmm.py round nothing; callers round a [V, H] result
// once to the model dtype.  On bf16 tile plans cal_tpu also rounds each
// product coef * x to bf16 before the receiver sum (and g to bf16 in the
// VJP): exact for GIN's 0/1 coefficients on bf16 features, not for a general
// coefficient.
//
// Design.  K11/K11T/K19/K19T are csr_rows.cuh's coefficient SpMM walk
// (csr_spmm_kernel, as K2/K3/K14 in csrc/spmm.cu) with the CooSpmm policy: a
// light row (<= 32 edges) is one lane group's item (16-byte loads, 32 / G
// rows a warp), addressed by row; the chunks of a heavier row (a hub, the
// padded run) are items from the host-built list, each writing an f32
// partial that a pass over the heavy rows alone sums in chunk order.  A
// group reads a window's coefficients and neighbours at once, a ballot lists
// the edges with a nonzero coefficient, and it loads up to kInFlight
// neighbour rows before their FMAs, each feature weighted by the coefficient
// of the head it belongs to (a lane's features lie in one head).  The padded
// run at node V-1 holds coefficient 0: its edges cost a coefficient read
// each (K11 sums whatever is nonzero) and no neighbour row.  K12/K20 are
// one launch over the same items of the receiver CSR (csr_item, heavy
// chunks first), each a lane group's: kLaneFeatures features of x and of g
// a lane (16 bytes of x in bf16, 32 in f32; G = H / F lanes, at H = 128 two
// items a warp), kept narrow in either dtype, as registers bound the items
// in flight.  The group loads g[r] beside its first window's sender ids,
// reads kWindowEdges sender ids at once, loads the x rows of up to
// kInFlight edges before their dot products, reduces each over the lanes of
// its head and hands it to the edge's own lane, so a window's values leave
// in one coalesced store (4 * heads bytes an edge).  An edge whose sender equals
// the previous edge's within the item (a ballot a window, carried across
// windows) takes that edge's values with no load and no reduction: a chunk
// of the padded run (one sender, V-1) costs one dot product and its
// stores, and nothing assumes it (any run of equal senders, or none).
// K12/K20 write one value an edge, so no item finishes another's sum: no
// partial, no arrival counter, nothing shared with another launch.  K21 is
// csr_rows.cuh's per-row reduction (csr_reduce_kernel) with MaxOp over the
// receiver CSR, in one launch: a light row is one 4-lane group's item (16-
// byte loads of 4 planes at once, 8 rows a warp); a heavy row's chunks (the
// padded run's 62 included: K21 reads whatever the caller put there) are a
// warp's each, and the row's last chunk to arrive takes the max of the
// chunks' partials.  No float atomics: a result does not change between
// runs, and a max is exact in any order, so K21 equals its twin bit for bit.
//
// Bound: bytes.  K11/K19 read x [V, H] once (plus a neighbour row per live
// edge, mostly from L2), 4 + 4 * heads bytes of metadata per edge (4 more
// through perm) and write f32 [V, H]; K12/K20 read x and g [V, H] once (x
// again per edge whose sender differs from the previous edge's, mostly from
// L2), 4 bytes of sender per edge and the CSR, and write 4 * heads bytes per
// edge; K21 reads 4 K bytes per edge and writes 4 K per node.  H FMAs per
// edge are far below the FMA floor.  The walks' own limit is latency: a
// light row is a chain of dependent loads (ptr, senders, x rows, store).
//
// Built by cal_tpu_torch/kernels/build.py with nvcc -arch sm_90a into a
// plain C shared library (no PyTorch headers); the wrappers in
// ops/coo_spmm.py allocate every output and scratch buffer and pass
// PyTorch's stream.

#include "csr_rows.cuh"

namespace {

// ---- K11 / K11T, K19 / K19T: coefficient SpMM over a CSR ---------------

// The csr_spmm_kernel policy of K11 (NH = 1) and K19: one branch, NH
// coefficients per edge, liveness and coefficients from coef alone, the f32
// row written as summed.
template <typename T, int NH>
struct CooSpmm : CsrRows {
  using Elem = T;
  static constexpr int kBranches = 1;
  static constexpr int kHeads = NH;
  static constexpr bool kMaskedDead = false;   // liveness is the coefficient
  const T* x[1];        // [V, H]: x (K11/K19) or the cotangent g (K11T/K19T)
  const float* coef;    // [E, NH], edge order
  const int* nbr;       // senders (receiver CSR) or receivers (sender CSR)
  float* out;           // [V, H]
  float* partial;       // [heavy_cap, H]
  int h;

  struct Row {};

  __device__ __forceinline__ Row row(int) const { return Row{}; }

  __device__ __forceinline__ bool edge(int e, const Row&, int& s, float (&cf)[NH]) const {
    bool live = false;
#pragma unroll
    for (int hd = 0; hd < NH; ++hd) {
      cf[hd] = coef[(size_t)e * NH + hd];
      live |= cf[hd] != 0.0f;
    }
    s = nbr[e];
    return live;
  }

  template <int F>
  __device__ __forceinline__ void write_row(int r, int lane, const float (&acc)[1][F]) const {
    store_vec<float, F>(out + (size_t)r * h + lane * F, acc[0]);
  }
};

template <typename T, int NH>
cudaError_t spmm_typed(const void* x, const float* coef, const int* nbr, const CsrRows& csr,
                       int h, float* out, float* partial, cudaStream_t stream) {
  CooSpmm<T, NH> a;
  static_cast<CsrRows&>(a) = csr;
  a.x[0] = static_cast<const T*>(x);
  a.coef = coef;
  a.nbr = nbr;
  a.out = out;
  a.partial = partial;
  a.h = h;
  return launch_csr_spmm(a, stream);
}

template <typename T>
cudaError_t spmm_heads(int heads, const void* x, const float* coef, const int* nbr,
                       const CsrRows& csr, int h, float* out, float* partial,
                       cudaStream_t stream) {
  switch (heads) {
#define CASE(NH) \
  case NH: return spmm_typed<T, NH>(x, coef, nbr, csr, h, out, partial, stream);
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// ---- K12 / K20: per-edge dot products over the receiver CSR's items -----

// The receiver CSR (graph.EdgeCsr's; its arrival counters unused) and the
// operands of one call.
template <typename TX, typename TG>
struct Sddmm : CsrRows {
  const TX* x;          // [V, H]
  const TG* g;          // [V, H]: the cotangent of K11's (K19's) output
  const int* senders;   // receiver CSR order = edge order
  float* dcoef;         // [E, NH], edge order
  int h;
};

constexpr int kSddmmBlocks = 2;       // blocks an SM (__launch_bounds__)
constexpr int kLaneFeatures = 8;      // features of x and of g a lane loads (16 or 32 bytes of x)

// An item's lane group at H = 32 Q: kLaneFeatures features a lane (or Q
// when more, or a head's width when less), G = H / F lanes, 32 / G items a
// warp (LightShape).
template <typename TX, int NH, int Q>
using SddmmShape = LightShape<TX, Q, NH, kLaneFeatures * (int)sizeof(TX)>;

// dcoef of CSR positions [beg, end) of receiver row rr by the G lanes of a
// group (gl: the lane's place, base: its first lane), F features of g[rr]
// and of each x row a lane.  Windows of kWindowEdges positions, position
// k G + gl of a window in the lane's slot k: the window's senders in one
// coalesced load; a position whose sender equals the previous position's
// (within the span, across windows too) is a duplicate and takes that
// position's values; the others' x rows are loaded, U at a time before
// their products, each product reduced over the lanes of its head, and
// every lane takes the values of the positions it holds; then the window's
// values leave in one store a slot, NH floats an edge.  Every lane of the
// warp calls it (a group past its span idles).
template <typename TX, typename TG, int NH, int Q, int F, int G, int U>
__device__ __forceinline__ void sddmm_span(const Sddmm<TX, TG>& a, int beg, int end, int rr,
                                           int gl, int base) {
  constexpr int W = kWindowEdges / G;     // a window's positions a lane
  constexpr int kLph = 32 * Q / NH / F;   // lanes of one head
  constexpr int kWords = F * sizeof(TX) / 4;
  const unsigned gbits = G == 32 ? kFull : (1u << G) - 1u;
  float gr[F];
  load_vec<TG, F>(a.g + (size_t)rr * a.h + gl * F, gr);
  int last_s = -1;       // the sender of the previous window's last position (none at first)
  float last[NH] = {};   // and its values
  for (int w0 = beg; __any_sync(kFull, w0 < end); w0 += kWindowEdges) {
    int s_l[W];          // -1 past the span
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = w0 + k * G + gl;
      s_l[k] = i < end ? __ldg(a.senders + i) : -1;
    }
    // bit p: position p takes its own dot product
    unsigned fresh = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int up = __shfl_up_sync(kFull, s_l[k], 1, G);
      const int wrap = k == 0 ? last_s : __shfl_sync(kFull, s_l[k > 0 ? k - 1 : 0], base + G - 1);
      const bool need = s_l[k] >= 0 && s_l[k] != (gl == 0 ? wrap : up);
      fresh |= ((__ballot_sync(kFull, need) >> base) & gbits) << (k * G);
    }
    // each position's source: the last fresh position at or before it
    // (-1: the previous window's last position)
    int src[W];
    float val[W][NH];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const unsigned below = fresh & ((2u << (k * G + gl)) - 1u);
      src[k] = below ? 31 - __clz(below) : -1;
#pragma unroll
      for (int hd = 0; hd < NH; ++hd) val[k][hd] = last[hd];
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      unsigned m = (fresh >> (k * G)) & gbits;
      while (__any_sync(kFull, m != 0)) {
        // the next U fresh positions of slot k: their x rows loaded, then
        // their dot products with g[rr]
        bool ok[U];
        int pos[U];
        uint32_t xs[U][kWords];   // the rows as loaded, widened at their FMAs
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ok[u] = m != 0;
          const int j = ok[u] ? __ffs(m) - 1 : 0;
          m &= m - 1;
          pos[u] = k * G + j;
          const int s = __shfl_sync(kFull, s_l[k], base + j);
          if (ok[u]) load_words<TX, F>(a.x + (size_t)s * a.h + gl * F, xs[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.0f;
          if (ok[u])
#pragma unroll
            for (int f = 0; f < F; ++f) p = fmaf(gr[f], word_elem<TX>(xs[u], f), p);
#pragma unroll
          for (int off = kLph / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
          float t[NH];
#pragma unroll
          for (int hd = 0; hd < NH; ++hd)
            t[hd] = NH == 1 ? p : __shfl_sync(kFull, p, base + hd * kLph);
#pragma unroll
          for (int kk = k; kk < W; ++kk)   // a source lies at or before its positions
            if (ok[u] && src[kk] == pos[u])
#pragma unroll
              for (int hd = 0; hd < NH; ++hd) val[kk][hd] = t[hd];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int i = w0 + k * G + gl;
      if (i < end) store_vec<float, NH>(a.dcoef + (size_t)i * NH, val[k]);
    }
    last_s = __shfl_sync(kFull, s_l[W - 1], base + G - 1);
#pragma unroll
    for (int hd = 0; hd < NH; ++hd) last[hd] = __shfl_sync(kFull, val[W - 1][hd], base + G - 1);
  }
}

// One item a lane group, 32 / G a warp, as csr_spmm_kernel: items [0,
// live_heavy) the chunks on the heavy list, the others the rows (a heavy
// row's own item idle).  Each item writes its own edges: no partial, no
// counter.
template <typename TX, typename TG, int NH, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kSddmmBlocks)
coo_sddmm_kernel(const Sddmm<TX, TG> a) {
  using S = SddmmShape<TX, NH, Q>;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / S::G);
  const int nh = live_heavy(a);
  if (first >= nh + a.num_nodes) return;
  const int gl = lane % S::G;
  const CsrItem it = csr_item(a, nh, first + lane / S::G, /*skip_masked=*/false);
  sddmm_span<TX, TG, NH, Q, S::F, S::G, kInFlight>(a, it.beg, it.wend, min(it.r, a.num_nodes - 1),
                                                   gl, lane - gl);
}

template <typename TX, typename TG, int NH, int Q>
cudaError_t sddmm_q(const Sddmm<TX, TG>& a, cudaStream_t stream) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * 32 / SddmmShape<TX, NH, Q>::G;
  const int items = a.heavy_cap + a.num_nodes;
  coo_sddmm_kernel<TX, TG, NH, Q><<<(items + kItemsPerBlock - 1) / kItemsPerBlock,
                                    kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TG, int NH>
cudaError_t sddmm_width(const Sddmm<TX, TG>& a, cudaStream_t stream) {
  switch (a.h / 32) {
    case 1: return sddmm_q<TX, TG, NH, 1>(a, stream);
    case 2: return sddmm_q<TX, TG, NH, 2>(a, stream);
    case 4: return sddmm_q<TX, TG, NH, 4>(a, stream);
    case 8: return sddmm_q<TX, TG, NH, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TG>
cudaError_t sddmm_typed(int heads, const void* x, const void* g, const int* senders,
                        const CsrRows& csr, int h, float* dcoef, cudaStream_t stream) {
  Sddmm<TX, TG> a;
  static_cast<CsrRows&>(a) = csr;
  a.x = static_cast<const TX*>(x);
  a.g = static_cast<const TG*>(g);
  a.senders = senders;
  a.dcoef = dcoef;
  a.h = h;
  switch (heads) {
    case 1: return sddmm_width<TX, TG, 1>(a, stream);
    case 2: return sddmm_width<TX, TG, 2>(a, stream);
    case 4: return sddmm_width<TX, TG, 4>(a, stream);
    case 8: return sddmm_width<TX, TG, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t sddmm_by_g(int g_dtype, int heads, const void* x, const void* g, const int* senders,
                       const CsrRows& csr, int h, float* dcoef, cudaStream_t stream) {
  if (g_dtype == 0) return sddmm_typed<TX, float>(heads, x, g, senders, csr, h, dcoef, stream);
  if (g_dtype == 1)
    return sddmm_typed<TX, __nv_bfloat16>(heads, x, g, senders, csr, h, dcoef, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K11 / K11T (heads 1), K19 / K19T (heads 2, 4 or 8).  dtype of x: 0 =
// float32, 1 = bfloat16.  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x rows
// aligned as launch_csr_spmm says; coef [E, heads] f32.  Forward (K11/K19):
// perm null, nbr = senders, the receiver CSR.  Transposed (K11T/K19T): perm
// = the sender CSR's perm, nbr = receivers, the sender CSR, x = the
// cotangent.  The CSR is graph.EdgeCsr's (heavy_chunks, heavy_masked and
// arrivals of heavy_cap entries, the live count heavy_count on the card);
// arrivals are 0 before the launch and after it.  Writes out [V, H] f32;
// partial holds heavy_cap * h floats.
int coo_spmm_launch(const void* x, int dtype, const float* coef, int heads, const int* nbr,
                    const int* perm, const int* ptr, const int* chunk_ptr,
                    const int* chunk_row, const int* heavy_chunks, const uint8_t* heavy_masked,
                    int heavy_cap, const int* heavy_count, int* arrivals, int num_nodes, int h,
                    float* out, float* partial, cudaStream_t stream) {
  if (h <= 0 || h % 32) return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked, heavy_count,
                    arrivals, perm, heavy_cap, num_nodes};
  if (dtype == 0) return (int)spmm_heads<float>(heads, x, coef, nbr, csr, h, out, partial, stream);
  if (dtype == 1)
    return (int)spmm_heads<__nv_bfloat16>(heads, x, coef, nbr, csr, h, out, partial, stream);
  return (int)cudaErrorInvalidValue;
}

// K12 (heads 1), K20 (heads 2, 4 or 8).  x_dtype, g_dtype: 0 = float32, 1 =
// bfloat16 (each its own).  h % 32 == 0 and h / 32 in {1, 2, 4, 8}; x and g
// rows aligned to a lane's load (SddmmShape: min(16, F * sizeof) bytes
// each).  The receiver CSR as coo_spmm_launch takes it, without its
// arrival counters (each item writes its own edges), over the
// receiver-sorted senders.  Writes dcoef [E, heads] f32 in edge order.
int coo_sddmm_launch(const void* x, int x_dtype, const void* g, int g_dtype, int heads,
                     const int* senders, const int* ptr, const int* chunk_ptr,
                     const int* chunk_row, const int* heavy_chunks,
                     const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                     int num_nodes, int h, float* dcoef, cudaStream_t stream) {
  if (num_nodes <= 0 || heavy_cap <= 0 || h <= 0 || h % 32)
    return (int)cudaErrorInvalidValue;
  const CsrRows csr{ptr,  chunk_ptr, chunk_row, heavy_chunks, heavy_masked, heavy_count,
                    nullptr, nullptr, heavy_cap, num_nodes};
  if (x_dtype == 0)
    return (int)sddmm_by_g<float>(g_dtype, heads, x, g, senders, csr, h, dcoef, stream);
  if (x_dtype == 1)
    return (int)sddmm_by_g<__nv_bfloat16>(g_dtype, heads, x, g, senders, csr, h, dcoef, stream);
  return (int)cudaErrorInvalidValue;
}

// K21.  vals [planes, E] f32 in edge order; the receiver CSR as
// coo_spmm_launch takes it (heavy_masked unread: every edge is walked).
// Writes out [planes, V] f32; partial holds heavy_cap * planes floats.
int segment_max_launch(const float* vals, int num_edges, int planes, const int* ptr,
                       const int* chunk_ptr, const int* chunk_row, const int* heavy_chunks,
                       const uint8_t* heavy_masked, int heavy_cap, const int* heavy_count,
                       int* arrivals, int num_nodes, float* out, float* partial,
                       cudaStream_t stream) {
  RowReduce a;
  static_cast<CsrRows&>(a) = CsrRows{ptr,      chunk_ptr, chunk_row,      heavy_chunks,
                                     heavy_masked, heavy_count, arrivals, nullptr, heavy_cap,
                                     num_nodes};
  a.vals = vals;
  a.num_edges = num_edges;
  a.planes = planes;
  a.vec = num_edges % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  a.edge_major = false;
  a.skip_masked = false;   // K21 reads whatever the caller put there
  a.out = out;
  a.partial = partial;
  return (int)launch_csr_reduce<MaxOp>(a, stream);
}

}  // extern "C"
