// Flash-style dense multi-head GAT attention, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: cal_tpu/ops/pallas_gat.py::_fwd_kernel and ::_bwd_kernel (the
// custom VJP of _flash_core, reached by flash_gat_dense_flat /
// flash_gat_dense).
//
// Contract, per graph b, head h, receiver r and sender s (all arithmetic in
// f32; counts and xh of type T, ti/tj/m/den/g f32, layouts [B, N, heads] and
// [B, N, heads * d]):
//   ceff   = counts[r,s] with the diagonal forced to 1 (analytic self loop)
//   pre    = ti[r] + tj[s];  l = max(pre, 0.2 pre)
//   m_r    = max over cells with ceff > 0 of l   (masked: never a non-edge)
//   num    = exp(l - m_r) * ceff;  den_r = sum_s num;  alpha = num * (1/den_r)
//   keep   = philox4x32_10(counter (lo, hi, 0, 0), key (s0, s1))[0] >= thresh,
//            for the cell index ((b*heads + h)*N + r)*N + s = hi*2^32 + lo,
//            (s0, s1) the two 32-bit words of the 64-bit seed, which the
//            kernels read from a device buffer (see seed_word)
//   out_r  = scale * sum_s keep * alpha * xh_s[h*d:(h+1)*d]
// Backward, with c = scale, alpha recomputed from m and den:
//   da     = keep * (g_r . xh_s);  t_r = sum_s da * alpha
//   dpre   = (pre >= 0 ? 1 : 0.2) * alpha * (da - t_r)
//   dti_r  = c sum_s dpre;  dtj_s = c sum_r dpre;  dxh_s = T(c sum_r keep alpha g_r)
//
// Bound on this card: what a call must do is read the counts plane once,
// the xh (and g) planes and the per-head vectors once, write the outputs
// once, and multiply on the live cells only (ceff > 0: 1.6% of the plane
// on the synthetic batches).  At B=128, N=256, heads=4, d=32 the forward
// moves ~44 MB in bf16 (0.013 ms at 3.35 TB/s) against 2 * live * heads * d
// products (34 MFLOP for a batch's 131,376 live cells), so bytes bound
// both kernels in both dtypes.  The kernels run at 5x (forward) and 9x
// (backward) that bound: each row is a chain of dependent loads (counts,
// then tj, then the gathered rows), so the warps in flight set the pace.
//
// Design: every step after the counts read runs on the live cells alone.
// A warp owns a row (the forward and the backward's receiver kernel: a
// receiver; the sender kernel: a sender) and takes its cells in chunks of
// 256.  A chunk streams in 16 bytes a lane, and its live cells (ceff > 0,
// the diagonal always live) are compacted into a list in shared memory
// (popcounts and a warp prefix scan; the list keeps ascending cell order
// and holds at most one chunk, so any density and any N run).  Everything
// after that touches the list only: the max, the denominator, the keep
// bits, alpha, the gathers of xh (or g) rows and the sums.  A warp owns
// every head of its row: ceff and the live test are shared by the heads,
// and a lane's 4 columns of a gathered row belong to one head (a head
// takes a power of two of lanes, so its dot products are a shuffle
// butterfly).  Per (cell, head) scalars are formed by "pair lanes" (lane =
// entry * hp + head) and handed to the column lanes through a small
// per-warp buffer.  More than 32 heads, or 128 column slots, run as head
// groups, one launch each, each reading the counts again (a group holds up
// to 16 heads of d <= 32, or 4 of d = 128).  Each kernel is held to 64
// registers (four blocks an SM): more warps in flight beat the few spills
// the cap costs.
// - Forward: one read of the counts.  A row whose live cells fit one list
//   (every row at N <= 256) takes its max, then its denominator, then sums
//   alpha xh_s in ascending sender order, alpha = exp(l - m) * ceff * (1 /
//   den) as the parent formed it.  A longer row folds its list in when the
//   next chunk would overflow it and carries (m, den, out) online, rescaled
//   by exp(m_old - m_new).  A row whose only live cell is its diagonal (a
//   padded node) costs a copy: m = l, den = 1, out = scale * keep * xh_r.
// - Backward: two launches, the counts read once in each.  The receiver
//   kernel forms da for each live cell and head from the row's g
//   (registers) and the gathered xh_s, writes dti, and hands the sender
//   kernel a 16-byte record (ti, m, 1 / den, t) per (receiver, head), since
//   the column sums need every t_r of their receivers first.  The sender
//   kernel (a block reads a tile of 8 senders' columns, a thread a row, 16
//   bytes each, and ballots give each sender its live receivers) gathers
//   g_r per live cell, forms da again from it (d products a head) and sums
//   dtj and dxh = sum keep alpha g_r in ascending receiver order.  One
//   block per graph with a barrier between the phases would keep da in
//   shared memory, but a graph's live cells and its senders' sums do not
//   fit a block at every density and N, and the second dot costs d FMAs a
//   cell on rows the sender side gathers anyway.
// Every sum has one owner and one order: no atomics, the same bits every
// run.  m keeps the parent's bits (a max), and so does dxh where it is
// handed the same m and den (the parent's fmaf chain in the parent's
// order); den, out, dti and dtj add in another order than the parent's.
// Non-finite inputs: a non-finite xh_s (or g_r) of a cell with ceff == 0
// no longer reaches out_r (or the backward): the parent multiplied it by
// 0, this kernel never reads it.  Dropped live cells still multiply by 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;      // cells of a row (a column) that one list holds: 32 lanes x kPer
constexpr int kPer = 8;          // cells a lane reads of a chunk: 16 bytes of bf16
constexpr int kPairs = 64;       // (cell, head) pairs a batch, two a lane
// Blocks an SM must hold, which caps a kernel's registers (65,536 / (256
// blocks)): the kernels wait on chains of dependent loads, and a warp more
// in flight beats the few spills the cap costs.
constexpr int kFwdBlocks = 4, kRowBlocks = 4, kColBlocks = 4;
constexpr int kMaxGroups = 4;    // 32-lane column groups a lane keeps: 128 slots of 4 columns
constexpr int kMaxHeadDim = 128;
constexpr float kNegSlope = 0.2f;
constexpr float kBigNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kChunk, "the sender kernel reads a chunk a thread a row");
static_assert(kWarps == kPer, "the sender kernel gives each of a tile's senders a warp");

__device__ __forceinline__ float leaky(float x) { return fmaxf(x, kNegSlope * x); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Philox-4x32-10 (Salmon et al., SC'11): the first output word for the
// counter (lo, hi, 0, 0) under the key (k0, k1)
__device__ __forceinline__ uint32_t philox_bits(uint64_t cell, uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)cell, c1 = (uint32_t)(cell >> 32), c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// keep bit of one cell; thresh == 0 keeps every cell (no dropout)
__device__ __forceinline__ bool keep_cell(uint64_t cell, uint32_t s0, uint32_t s1,
                                          uint32_t thresh) {
  return thresh == 0 || philox_bits(cell, s0, s1) >= thresh;
}

// A launch's head group [h0, h0 + hg) and its lane plan, the same in every
// lane.  Column slot q = lane + 32 k holds columns 4 (q % lph) .. + 3 of
// group head q / lph; pair lane (entry jl = lane / hp, head hl = lane % hp).
struct Geo {
  int N, heads, d, hd;   // hd = heads * d: the row stride of xh, g, out and dxh
  int h0, hg;
  int lph;               // lanes a head's columns take: a power of two >= ceil(d / 4)
  int hp;                // pair lanes an entry takes: a power of two >= hg
  int xvec;              // d % 4 == 0: a slot's 4 columns are one aligned vector
  int cvec;              // the counts rows' 8-cell pieces are 16-byte aligned
};

struct Args {
  const float* ti;
  const float* tj;
  const void* counts;
  const void* xh;
  const float* m;        // backward: the forward's statistics
  const float* den;
  const float* g;        // backward: the cotangent of out
  float* out;            // forward: out, m and den
  float* m_out;
  float* den_out;
  float* dti;            // backward: dti, dtj, dxh and the receivers' records
  float* dtj;
  void* dxh;
  float4* rec;           // (ti, m, 1 / den, t) of each (receiver, head): receiver to sender kernel
  Geo geo;
  const uint32_t* seed;  // the 64-bit dropout seed: words (s0, s1) = (low, high), on the card
  uint32_t thresh;
  float scale;
};

// A word of the dropout seed, read from device memory, so a captured launch
// (a CUDA graph) takes the seed that the host wrote before each replay.  No
// read without dropout (thresh 0), where the wrapper may pass no buffer.
__device__ __forceinline__ uint32_t seed_word(const Args& a, int i) {
  return a.thresh ? __ldg(a.seed + i) : 0u;
}

// A lane's column slots: the row offset of its 4 columns, how many exist
// (0 where the slot is padding) and their group head.
template <int KG>
struct Cols {
  int off[KG], n[KG], head[KG];
  bool lead[KG];         // the first lane of its head's lph lanes
};

template <int KG>
__device__ __forceinline__ Cols<KG> cols_of(const Geo& g, int lane) {
  Cols<KG> c;
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    const int slot = lane + 32 * k, h = slot / g.lph, c0 = (slot % g.lph) * 4;
    const bool ok = h < g.hg && c0 < g.d;
    c.head[k] = ok ? h : 0;
    c.n[k] = ok ? min(4, g.d - c0) : 0;
    c.off[k] = ok ? (g.h0 + h) * g.d + c0 : 0;
    c.lead[k] = ok && c0 == 0;
  }
  return c;
}

// the n (<= 4) columns at p as f32, 0 past n; one vector load where allowed
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float (&v)[4]) {
  if (vec && n == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? __ldg(p + q) : 0.f;
  }
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float (&v)[4]) {
  if (vec && n == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf_lo(t.x), v[1] = bf_hi(t.x), v[2] = bf_lo(t.y), v[3] = bf_hi(t.y);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n ? to_f(p[q]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int n, bool vec, const float (&v)[4]) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) p[q] = v[q];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, bool vec, const float (&v)[4]) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<uint32_t*>(&lo);
    t.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) p[q] = __float2bfloat16(v[q]);
  }
}

// the 8 counts at p as f32, 0 past n (n <= 0 reads nothing); 16-byte loads
// where the row allows them
__device__ __forceinline__ void load8(const float* p, int n, bool vec, float (&c)[kPer]) {
  if (vec && n >= kPer) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    c[0] = a.x, c[1] = a.y, c[2] = a.z, c[3] = a.w, c[4] = b.x, c[5] = b.y, c[6] = b.z,
    c[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) c[i] = i < n ? __ldg(p + i) : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, bool vec,
                                      float (&c)[kPer]) {
  if (vec && n >= kPer) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    c[0] = bf_lo(t.x), c[1] = bf_hi(t.x), c[2] = bf_lo(t.y), c[3] = bf_hi(t.y);
    c[4] = bf_lo(t.z), c[5] = bf_hi(t.z), c[6] = bf_lo(t.w), c[7] = bf_hi(t.w);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) c[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// sum / max over the lanes of one pair head (the lanes equal mod hp)
__device__ __forceinline__ float heads_sum(float v, int hp) {
  for (int o = 16; o >= hp; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float heads_max(float v, int hp) {
  for (int o = 16; o >= hp; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// sum over the lph lanes of one column head (an aligned power-of-two group)
__device__ __forceinline__ float group_sum(float v, int lph) {
  for (int o = lph >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Warp prefix scan of the lanes' live counts: returns this lane's offset,
// total = the warp's count.
__device__ __forceinline__ int live_offset(unsigned live, int lane, int& total) {
  const int cnt = __popc(live);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - cnt;
}

__device__ __forceinline__ void list_put(unsigned live, int first, const float (&ce)[kPer],
                                         int* ls, float* lc, int pos) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (live >> i & 1u) {
      ls[pos] = first + i;
      lc[pos] = ce[i];
      ++pos;
    }
}

// Rows gathered at once, kept as f32: more where a lane keeps fewer columns.
__host__ __device__ constexpr int rows_at_once(int kg) { return kg == 1 ? 4 : kg == 2 ? 2 : 1; }

// the lane's columns of rows ls[j0 .. j0 + G) (those below n) of a plane
// whose rows are hd apart
template <typename T, int KG, int G>
__device__ __forceinline__ void gather(float (&x)[G][KG][4], const T* plane, int hd,
                                       const int* ls, int j0, int n, const Cols<KG>& cl,
                                       bool vec) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    if (j0 + u >= n) break;
    const T* p = plane + (size_t)ls[j0 + u] * hd;
#pragma unroll
    for (int k = 0; k < KG; ++k) load4(p + cl.off[k], cl.n[k], vec, x[u][k]);
  }
}

// the live cells of a chunk (cells c0 + 8 lane + i) of row r; the diagonal
// is forced to 1
__device__ __forceinline__ unsigned chunk_live(int c0, int lane, int r, int N,
                                               float (&ce)[kPer]) {
  const int s = c0 + kPer * lane;
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (s + i == r) ce[i] = 1.f;
    if (s + i < N && ce[i] > 0.f) live |= 1u << i;
  }
  return live;
}

// ---------------------------------------------------------------------------
// Forward.  Grid (ceil(N / 8), B): a warp a receiver, every head of the
// launch's group.  Writes out, m and den.
template <typename T, int KG>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
flash_fwd_kernel(const Args a) {
  constexpr int G = rows_at_once(KG);
  __shared__ int ls_[kWarps][kChunk];      // the list: senders
  __shared__ float lc_[kWarps][kChunk];    //           and their ceff
  __shared__ float wb_[kWarps][kPairs];    // a batch's keep * alpha by (entry, head)
  const Geo g = a.geo;
  const uint32_t s0 = seed_word(a, 0), s1 = seed_word(a, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  int* ls = ls_[warp];
  float* lc = lc_[warp];
  float* wb = wb_[warp];
  const int N = g.N, heads = g.heads, hp = g.hp, jstep = 32 / hp, eb = kPairs / hp;
  const size_t bn = (size_t)b * N;
  const T* cnt = static_cast<const T*>(a.counts) + bn * N;
  const T* xplane = static_cast<const T*>(a.xh) + bn * g.hd;
  const int jl = lane / hp, hl = lane % hp;
  const bool hv = hl < g.hg;
  const int hgl = g.h0 + (hv ? hl : 0);
  const float* tjb = a.tj + bn * heads + hgl;          // tj of sender s: tjb[s * heads]
  const Cols<KG> cl = cols_of<KG>(g, lane);
  const int r = blockIdx.x * kWarps + warp;
  if (r >= N) return;                      // warp-uniform; the kernel has no block barrier
  const float tir = hv ? a.ti[(bn + r) * heads + hgl] : 0.f;
  const uint64_t rowcell = (((uint64_t)b * heads + hgl) * N + r) * N;
  float* orow = a.out + (bn + r) * g.hd;
  float acc[KG][4];
#pragma unroll
  for (int k = 0; k < KG; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  float mrun = kBigNeg, drun = 0.f;
  bool first = true;
  int n = 0;

  // One pass over the list: (m, den) and the sums; `last` ends the row.
  // Exact when the row is one list: alpha = exp(l - m) * ceff * (1 / den);
  // else the online form, (m, den, acc) rescaled by exp(m_old - m_new).
  auto flush = [&](bool last) {
    const bool exact = first && last;
    float mx = kBigNeg;
    if (hv)
      for (int j = jl; j < n; j += jstep)
        mx = fmaxf(mx, leaky(tir + tjb[(size_t)ls[j] * heads]));
    mx = heads_max(mx, hp);
    const float mnew = fmaxf(mrun, mx);
    if (exact && n == 1) {               // the diagonal alone: a copy of xh_r
      float wd = 0.f;
      if (hv && jl == 0) {
        wd = keep_cell(rowcell + r, s0, s1, a.thresh) ? 1.f : 0.f;
        a.m_out[(bn + r) * heads + hgl] = mnew;
        a.den_out[(bn + r) * heads + hgl] = 1.f;
      }
      const T* xr = xplane + (size_t)r * g.hd;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float wk = __shfl_sync(kFull, wd, cl.head[k]);
        float v[4];
        load4(xr + cl.off[k], cl.n[k], g.xvec, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = a.scale * fmaf(wk, v[q], 0.f);
        store4(orow + cl.off[k], cl.n[k], g.xvec, v);
      }
      return;
    }
    float dl = 0.f;
    if (hv)
      for (int j = jl; j < n; j += jstep)
        dl += expf(leaky(tir + tjb[(size_t)ls[j] * heads]) - mnew) * lc[j];
    dl = heads_sum(dl, hp);
    const float fac = first ? 0.f : expf(mrun - mnew);
    const float dnew = first ? dl : fmaf(drun, fac, dl);
    const float inv = 1.f / dnew;
    if (!first) {
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float f = __shfl_sync(kFull, fac, cl.head[k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] *= f;
      }
    }
    for (int jb = 0; jb < n; jb += eb) {
      const int nb = min(eb, n - jb);
#pragma unroll
      for (int i = 0; i < kPairs / 32; ++i) {
        const int j = jl + jstep * i;
        if (j >= nb) break;
        float wv = 0.f;
        const int s = ls[jb + j];
        if (hv && keep_cell(rowcell + s, s0, s1, a.thresh)) {
          const float e = expf(leaky(tir + tjb[(size_t)s * heads]) - mnew);
          wv = exact ? e * lc[jb + j] * inv : e * lc[jb + j];
        }
        wb[j * hp + hl] = wv;
      }
      __syncwarp();
      for (int jj = 0; jj < nb; jj += G) {
        float xa[G][KG][4];
        gather(xa, xplane, g.hd, ls, jb + jj, n, cl, g.xvec);
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (jj + u >= nb) break;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            const float wv = wb[(jj + u) * hp + cl.head[k]];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(wv, xa[u][k][q], acc[k][q]);
          }
        }
      }
      __syncwarp();
    }
    mrun = mnew;
    drun = dnew;
    if (last) {
      if (hv && jl == 0) {
        a.m_out[(bn + r) * heads + hgl] = mnew;
        a.den_out[(bn + r) * heads + hgl] = dnew;
      }
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float f = exact ? a.scale : a.scale * __shfl_sync(kFull, inv, cl.head[k]);
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = exact ? f * acc[k][q] : acc[k][q] * f;
        store4(orow + cl.off[k], cl.n[k], g.xvec, v);
      }
    }
  };

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    float ce[kPer];
    load8(cnt + (size_t)r * N + c0 + kPer * lane, N - c0 - kPer * lane, g.cvec, ce);
    const unsigned live = chunk_live(c0, lane, r, N, ce);
    int total;
    const int off = live_offset(live, lane, total);
    if (n + total > kChunk) {            // the list is full: fold it in, start anew
      flush(false);
      first = false;
      n = 0;
    }
    list_put(live, c0 + kPer * lane, ce, ls, lc, n + off);
    n += total;
    __syncwarp();
  }
  flush(true);
}

// ---------------------------------------------------------------------------
// Backward, receiver kernel.  Grid as the forward's: a warp a receiver.
// Per head: t_r = sum da alpha and dti_r; with lk = (pre >= 0 ? 1 : 0.2),
// sum_s dpre = u - t w for u = sum lk alpha da and w = sum lk alpha.
template <typename T, int KG>
__global__ void __launch_bounds__(kThreads, kRowBlocks)
flash_bwd_row_kernel(const Args a) {
  constexpr int G = rows_at_once(KG), R = kPairs / 32;
  __shared__ int ls_[kWarps][kChunk];
  __shared__ float lc_[kWarps][kChunk];
  __shared__ float db_[kWarps][kPairs];    // a batch's g_r . xh_s by (entry, head)
  const Geo g = a.geo;
  const uint32_t s0 = seed_word(a, 0), s1 = seed_word(a, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  int* ls = ls_[warp];
  float* lc = lc_[warp];
  float* db = db_[warp];
  const int N = g.N, heads = g.heads, hp = g.hp, jstep = 32 / hp, eb = kPairs / hp;
  const size_t bn = (size_t)b * N;
  const T* cnt = static_cast<const T*>(a.counts) + bn * N;
  const T* xplane = static_cast<const T*>(a.xh) + bn * g.hd;
  const int jl = lane / hp, hl = lane % hp;
  const bool hv = hl < g.hg;
  const int hgl = g.h0 + (hv ? hl : 0);
  const float* tjb = a.tj + bn * heads + hgl;
  const Cols<KG> cl = cols_of<KG>(g, lane);
  const int r = blockIdx.x * kWarps + warp;
  if (r >= N) return;
  const size_t rk = (bn + r) * heads + hgl;
  const float tir = hv ? a.ti[rk] : 0.f;
  const float mr = hv ? a.m[rk] : 0.f;
  const float inv = hv ? 1.f / a.den[rk] : 0.f;
  const uint64_t rowcell = (((uint64_t)b * heads + hgl) * N + r) * N;
  float gv[KG][4];
#pragma unroll
  for (int k = 0; k < KG; ++k) load4(a.g + (bn + r) * g.hd + cl.off[k], cl.n[k], g.xvec, gv[k]);
  float t = 0.f, u = 0.f, wsum = 0.f;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    float ce[kPer];
    load8(cnt + (size_t)r * N + c0 + kPer * lane, N - c0 - kPer * lane, g.cvec, ce);
    const unsigned live = chunk_live(c0, lane, r, N, ce);
    int n;
    const int off = live_offset(live, lane, n);
    __syncwarp();                        // the previous list is consumed
    list_put(live, c0 + kPer * lane, ce, ls, lc, off);
    __syncwarp();
    for (int jb = 0; jb < n; jb += eb) {
      const int nb = min(eb, n - jb);
      float pa[R], pl[R];                // alpha and lk alpha of the lane's pairs
      bool pk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = jl + jstep * i;
        pa[i] = pl[i] = 0.f;
        pk[i] = false;
        if (j >= nb || !hv) continue;
        const int s = ls[jb + j];
        const float pre = tir + tjb[(size_t)s * heads];
        pa[i] = expf(leaky(pre) - mr) * (lc[jb + j] * inv);
        pl[i] = pre >= 0.f ? pa[i] : kNegSlope * pa[i];
        pk[i] = keep_cell(rowcell + s, s0, s1, a.thresh);
      }
      for (int jj = 0; jj < nb; jj += G) {
        float xa[G][KG][4];
        gather(xa, xplane, g.hd, ls, jb + jj, n, cl, g.xvec);
#pragma unroll
        for (int v = 0; v < G; ++v) {
          if (jj + v >= nb) break;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            float p = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) p = fmaf(gv[k][q], xa[v][k][q], p);
            p = group_sum(p, g.lph);
            if (cl.lead[k]) db[(jj + v) * hp + cl.head[k]] = p;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = jl + jstep * i;
        if (j >= nb || !hv) continue;
        const float da = pk[i] ? db[j * hp + hl] : 0.f;
        t = fmaf(da, pa[i], t);
        u = fmaf(da, pl[i], u);
        wsum += pl[i];
      }
      __syncwarp();
    }
  }
  t = heads_sum(t, hp);
  u = heads_sum(u, hp);
  wsum = heads_sum(wsum, hp);
  if (hv && jl == 0) {
    a.rec[rk] = make_float4(tir, mr, inv, t);
    a.dti[rk] = a.scale * (u - t * wsum);
  }
}

// ---------------------------------------------------------------------------
// Backward, sender kernel.  Grid (ceil(N / 8), B): a block a tile of 8
// senders, warp q sender st + q.  Per chunk of 256 receivers, thread i
// reads row r0 + i's 8 cells of the tile (16 bytes in bf16) and the ballots
// give each sender its live receivers; warp q lists them in ascending
// order and sums dtj_s and dxh_s over them.
template <typename T, int KG>
__global__ void __launch_bounds__(kThreads, kColBlocks)
flash_bwd_col_kernel(const Args a) {
  constexpr int G = rows_at_once(KG), R = kPairs / 32;
  __shared__ unsigned bm[kPer][kWarps];    // [sender of the tile][32-receiver word]
  __shared__ float cv[kChunk][kPer + 1];   // ceff of the chunk's cells of the tile
  __shared__ int lr_[kWarps][kChunk];
  __shared__ float lc_[kWarps][kChunk];
  __shared__ float wb_[kWarps][kPairs];    // keep * alpha by (entry, head)
  __shared__ float db_[kWarps][kPairs];    // g_r . xh_s by (entry, head)
  const Geo g = a.geo;
  const uint32_t s0 = seed_word(a, 0), s1 = seed_word(a, 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.y;
  int* lr = lr_[warp];
  float* lc = lc_[warp];
  float* wb = wb_[warp];
  float* db = db_[warp];
  const int N = g.N, heads = g.heads, hp = g.hp, jstep = 32 / hp, eb = kPairs / hp;
  const size_t bn = (size_t)b * N;
  const T* cnt = static_cast<const T*>(a.counts) + bn * N;
  const float* gplane = a.g + bn * g.hd;
  const int jl = lane / hp, hl = lane % hp;
  const bool hv = hl < g.hg;
  const int hgl = g.h0 + (hv ? hl : 0);
  const uint64_t hcell = ((uint64_t)b * heads + hgl) * N;
  const Cols<KG> cl = cols_of<KG>(g, lane);
  const int st = blockIdx.x * kPer, s = st + warp;
  const bool sv = s < N;
  const float tjs = sv && hv ? a.tj[(bn + s) * heads + hgl] : 0.f;
  float xv[KG][4], acc[KG][4];
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    load4(static_cast<const T*>(a.xh) + (bn + (sv ? s : 0)) * g.hd + cl.off[k],
          sv ? cl.n[k] : 0, g.xvec, xv[k]);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  }
  float dtj = 0.f;
  for (int r0 = 0; r0 < N; r0 += kChunk) {
    const int r = r0 + tid;
    float ce[kPer];
    load8(cnt + (size_t)(r < N ? r : 0) * N + st, r < N ? N - st : 0, g.cvec, ce);
    __syncthreads();                     // the previous chunk's bits are consumed
    {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (st + i == r) ce[i] = 1.f;
        cv[tid][i] = ce[i];
        const unsigned word = __ballot_sync(kFull, r < N && st + i < N && ce[i] > 0.f);
        if (lane == 0) bm[i][warp] = word;
      }
    }
    __syncthreads();
    const unsigned word = lane < kWarps ? bm[warp][lane] : 0u;
    int n;
    int pos = live_offset(word, lane, n);
    for (unsigned x = word; x; x &= x - 1u) {
      const int rl = 32 * lane + __ffs(x) - 1;
      lr[pos] = r0 + rl;
      lc[pos] = cv[rl][warp];
      ++pos;
    }
    __syncwarp();
    if (!sv) continue;
    for (int jb = 0; jb < n; jb += eb) {
      const int nb = min(eb, n - jb);
      float pa[R], pp[R], pt[R];
      bool pk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = jl + jstep * i;
        pa[i] = pp[i] = pt[i] = 0.f;
        pk[i] = false;
        if (j >= nb) continue;
        float ad = 0.f;
        if (hv) {
          const int r = lr[jb + j];
          const float4 rr = a.rec[(bn + r) * heads + hgl];   // (ti, m, 1 / den, t)
          pp[i] = rr.x + tjs;
          pa[i] = expf(leaky(pp[i]) - rr.y) * (lc[jb + j] * rr.z);
          pt[i] = rr.w;
          pk[i] = keep_cell((hcell + r) * N + s, s0, s1, a.thresh);
          ad = pk[i] ? pa[i] : 0.f;
        }
        wb[j * hp + hl] = ad;
      }
      __syncwarp();
      for (int jj = 0; jj < nb; jj += G) {
        float ga[G][KG][4];
        gather(ga, gplane, g.hd, lr, jb + jj, n, cl, g.xvec);
#pragma unroll
        for (int v = 0; v < G; ++v) {
          if (jj + v >= nb) break;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            const float wv = wb[(jj + v) * hp + cl.head[k]];
            float p = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[k][q] = fmaf(wv, ga[v][k][q], acc[k][q]);
              p = fmaf(ga[v][k][q], xv[k][q], p);
            }
            p = group_sum(p, g.lph);
            if (cl.lead[k]) db[(jj + v) * hp + cl.head[k]] = p;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = jl + jstep * i;
        if (j >= nb || !hv) continue;
        const float da = pk[i] ? db[j * hp + hl] : 0.f;
        const float ds = pa[i] * (da - pt[i]);
        dtj += pp[i] >= 0.f ? ds : kNegSlope * ds;
      }
      __syncwarp();
    }
  }
  dtj = heads_sum(dtj, hp);
  if (!sv) return;
  if (hv && jl == 0) a.dtj[(bn + s) * heads + hgl] = a.scale * dtj;
  T* dxh = static_cast<T*>(a.dxh) + (bn + s) * g.hd;
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = a.scale * acc[k][q];
    store4(dxh + cl.off[k], cl.n[k], g.xvec, v);
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The launches' head groups: each holds at most 32 heads and 128 column
// slots (kMaxGroups lanes' worth), so a lane keeps at most 16 columns.
bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the launches' vector flags: rows of 4 columns (d % 4 == 0) on 16-byte
// aligned planes, counts rows of 16-byte pieces
template <typename T, typename Launch>
int by_groups(const Args& a, int B, int N, int heads, int d, Launch launch) {
  const int lph = pow2_at_least((d + 3) / 4);
  const int hg_max = min(32, 32 * kMaxGroups / lph);
  const int vec = 16 / (int)sizeof(T);
  const bool xvec = d % 4 == 0 && aligned(a.xh, 16) && aligned(a.g, 16) && aligned(a.out, 16) &&
                    aligned(a.dxh, 16);
  for (int h0 = 0; h0 < heads; h0 += hg_max) {
    Geo g;
    g.N = N, g.heads = heads, g.d = d, g.hd = heads * d, g.h0 = h0;
    g.hg = min(hg_max, heads - h0);
    g.lph = lph, g.hp = pow2_at_least(g.hg);
    g.xvec = xvec, g.cvec = N % vec == 0 && aligned(a.counts, 16);
    const int kg = (g.hg * lph + 31) / 32;
    dim3 grid((N + kWarps - 1) / kWarps, B);
    const int err = launch(g, kg, grid);
    if (err != 0) return err;
  }
  return 0;
}

#define FLASH_KERNEL_TABLE(NAME)                                                     \
  template <typename T>                                                              \
  int launch_##NAME(int kg, dim3 grid, const Args& a, cudaStream_t stream) {         \
    switch (kg) {                                                                    \
      case 1: NAME<T, 1><<<grid, kThreads, 0, stream>>>(a); break;                   \
      case 2: NAME<T, 2><<<grid, kThreads, 0, stream>>>(a); break;                   \
      case 3: NAME<T, 3><<<grid, kThreads, 0, stream>>>(a); break;                   \
      case 4: NAME<T, 4><<<grid, kThreads, 0, stream>>>(a); break;                   \
      default: return (int)cudaErrorInvalidValue;                                    \
    }                                                                                \
    return (int)cudaGetLastError();                                                  \
  }

FLASH_KERNEL_TABLE(flash_fwd_kernel)
FLASH_KERNEL_TABLE(flash_bwd_row_kernel)
FLASH_KERNEL_TABLE(flash_bwd_col_kernel)

template <typename T>
int fwd(Args a, int B, int N, int heads, int d, cudaStream_t stream) {
  return by_groups<T>(a, B, N, heads, d, [&](const Geo& g, int kg, dim3 grid) {
    a.geo = g;
    return launch_flash_fwd_kernel<T>(kg, grid, a, stream);
  });
}

template <typename T>
int bwd(Args a, int B, int N, int heads, int d, cudaStream_t stream) {
  return by_groups<T>(a, B, N, heads, d, [&](const Geo& g, int kg, dim3 grid) {
    a.geo = g;
    const int err = launch_flash_bwd_row_kernel<T>(kg, grid, a, stream);
    return err != 0 ? err : launch_flash_bwd_col_kernel<T>(kg, grid, a, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (counts, xh); ti/tj/out/m/den f32.
// ti, tj, m, den [B, N, heads]; counts [B, N, N]; xh, out [B, N, heads * d];
// all contiguous.  d <= 128.  thresh = uint32(rate * 2^32), 0 for no dropout;
// seed: the 64-bit dropout seed on the card (8 bytes, little-endian: the low
// word s0 first), read by the kernels, null allowed when thresh is 0;
// scale = 1 / (1 - rate).
extern "C" int flash_gat_fwd_launch(const void* ti, const void* tj, const void* counts,
                                    const void* xh, void* out, void* m, void* den, int B,
                                    int N, int heads, int d, int dtype, const void* seed,
                                    uint32_t thresh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0 || heads == 0 || d == 0) return 0;
  if (d > kMaxHeadDim || B > 65535) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.ti = static_cast<const float*>(ti), a.tj = static_cast<const float*>(tj);
  a.counts = counts, a.xh = xh;
  a.out = static_cast<float*>(out), a.m_out = static_cast<float*>(m);
  a.den_out = static_cast<float*>(den);
  a.seed = static_cast<const uint32_t*>(seed), a.thresh = thresh, a.scale = scale;
  if (thresh != 0 && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd<float>(a, B, N, heads, d, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(a, B, N, heads, d, st);
  return (int)cudaErrorInvalidValue;
}

// As flash_gat_fwd_launch; g [B, N, heads * d] f32 (cotangent of out), m and
// den the forward's; dti, dtj [B, N, heads] f32; dxh of the dtype;
// t_scratch f32 [B, N, heads, 4], 16-byte aligned: each (receiver, head)'s
// (ti, m, 1 / den, t), from the receiver to the sender kernel.
extern "C" int flash_gat_bwd_launch(const void* ti, const void* tj, const void* counts,
                                    const void* xh, const void* m, const void* den,
                                    const void* g, void* dti, void* dtj, void* dxh,
                                    void* t_scratch, int B, int N, int heads, int d, int dtype,
                                    const void* seed, uint32_t thresh, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0 || heads == 0 || d == 0) return 0;
  if (d > kMaxHeadDim || B > 65535) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.ti = static_cast<const float*>(ti), a.tj = static_cast<const float*>(tj);
  a.counts = counts, a.xh = xh;
  a.m = static_cast<const float*>(m), a.den = static_cast<const float*>(den);
  a.g = static_cast<const float*>(g);
  a.dti = static_cast<float*>(dti), a.dtj = static_cast<float*>(dtj);
  a.rec = static_cast<float4*>(t_scratch), a.dxh = dxh;
  a.seed = static_cast<const uint32_t*>(seed), a.thresh = thresh, a.scale = scale;
  if (thresh != 0 && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return bwd<float>(a, B, N, heads, d, st);
  if (dtype == 1) return bwd<__nv_bfloat16>(a, B, N, heads, d, st);
  return (int)cudaErrorInvalidValue;
}
