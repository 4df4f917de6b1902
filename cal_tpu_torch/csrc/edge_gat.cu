// Edge-formulated dense multi-head GAT attention, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: cal_tpu/ops/pallas_gat_sparse.py::_fwd_kernel and ::_bwd_kernel
// (_edge_gat_fwd_call and _edge_gat_bwd, the custom VJP of _edge_gat_core,
// reached by edge_gat_dense from the dense GATConvLayer at N >= 384).
//
// Contract.  edge_flat [E] int32 holds (g*N + r)*N + s per directed edge
// s -> r, sorted ascending; values >= B*N*N are padding.  Row v = g*N + r
// owns the run of slots e with v*N <= edge_flat[e] < (v+1)*N.  Slots with
// r == s are dropped and every row gets one analytic self term of weight 1
// (PyG 1.1.0: remove, then add); each duplicate slot is its own softmax term.
// Per head h (ti, tj, dti, dtj [B*N, heads] f32; xh, out, g, dxh [B*N,
// heads*d] of type T; everything else f32):
//   pre_e  = ti[v,h] + tj[u,h] for the slot's sender u = g*N + s;
//   pre_v  = ti[v,h] + tj[v,h] (self);  score = max(pre, 0.2 pre)
//   m_v    = max of the row's scores and its self score; den_v = sum exp(score - m_v)
//   alpha  = exp(score - m_v) * (1 / den_v)
//   keep_e = philox4x32_10(counter e*heads + h, key (s0, s1))[0] >= thresh;
//   keep_v = the same at counter 2^40 + v*heads + h (a disjoint range)
//   out_v  = scale (sum_e keep_e alpha_e xh_u + keep_v alpha_v xh_v)   (head h's columns)
// Backward, with c = scale and g_v the cotangent of out_v:
//   da_e   = c keep_e (g_v . xh_u)_h;  da_v = c keep_v (g_v . xh_v)_h
//   t_v    = sum_e alpha_e da_e + alpha_v da_v
//   dpre   = (pre >= 0 ? 1 : 0.2) alpha (da - t_v)
//   dti_v  = sum_e dpre_e + dpre_v;   dtj_u = sum_{e: sender u} dpre_e + dpre_u
//   dxh_u  = T(sum_{e: sender u} c keep_e alpha_e g_{r_e} + c keep_u alpha_u g_u)
//
// Bound on this card: bytes.  At B=128, N=3,840, heads*d=128 in bf16 the
// forward must read xh (126 MB) and write out (126 MB) whole, padded rows
// included; ti and tj (7.9 MB each) and the ~0.1 M live edges of a
// SYNREDDIT batch add little: 0.08 ms at 3.35 TB/s.  The backward reads xh
// and g and writes dxh: 0.12 ms.  The arithmetic (a dot product of d terms
// per edge and head) is small beside that; the mean SYNREDDIT graph fills
// ~10% of N, so most rows hold only their self term.
// Design: one warp per receiver row, which owns every sum of the row (no
// atomics anywhere).  A binary search per row (row_ptr_kernel) turns the
// sorted list into row pointers.  The forward takes the row's softmax
// statistics in one online (max, sum) pass with a lane per edge, then walks
// the row's edges in chunks of 32: each lane forms its edge's weights (keep
// bits included) into shared memory, and the warp accumulates weight x xh
// rows with each lane owning heads*d/32 consecutive columns, so every xh row
// is read with one coalesced warp load.  Rows without edges (padded nodes,
// empty graphs) write their self term.  The backward is the port's
// receiver-then-sender pattern: a row kernel recomputes the statistics, forms
// da per edge (warp dot products of g_v with xh_u), t_v and dti_v, and writes
// per-edge f32 columns dpre and c keep alpha plus the self terms; a sender
// kernel walks the edges in sender order (a permutation sorted by the
// wrapper) and sums dtj and dxh, one warp per sender.  The keep bits are
// recomputed from the slot index, so the backward replays the forward's mask.
// Tensor cores and a persistent schedule are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 8;
constexpr float kNegSlope = 0.2f;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kSelfCounter = 1ull << 40;

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

__device__ __forceinline__ float leaky(float x) { return fmaxf(x, kNegSlope * x); }

// Philox-4x32-10 (Salmon et al., SC'11): the first output word for the
// counter (lo, hi, 0, 0) under the key (k0, k1), as csrc/flash_gat.cu
__device__ __forceinline__ uint32_t philox_bits(uint64_t ctr, uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0, c3 = 0;
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

// keep bit of one (slot, head) or (row, head) counter; thresh 0 keeps all
__device__ __forceinline__ bool keep_at(uint64_t ctr, uint32_t s0, uint32_t s1,
                                        uint32_t thresh) {
  return thresh == 0 || philox_bits(ctr, s0, s1) >= thresh;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// sum over the lph lanes (a power of two) that hold one head's columns
__device__ __forceinline__ float group_sum(float v, int lph) {
  for (int o = lph >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// CPL consecutive values of type T (16-, 8- or narrower vector loads) as f32
template <typename T, int CPL>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float (&v)[CPL]) {
  constexpr int kBytes = CPL * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[q * kPer + i] = to_f(t[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = to_f(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void store_cols(T* __restrict__ p, const float (&v)[CPL]) {
  constexpr int kBytes = CPL * (int)sizeof(T);
  alignas(16) T t[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) t[i] = from_f<T>(v[i]);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q)
      reinterpret_cast<uint4*>(p)[q] = reinterpret_cast<const uint4*>(t)[q];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) p[i] = t[i];
  }
}

// ptr[v] = first slot e with keys[e] >= v*N, for v in [0, rows]: the row
// pointers of a sorted key list (rows = B*N, keys < 2^31)
__global__ void row_ptr_kernel(const int* __restrict__ keys, int E, int N, int rows,
                               int* __restrict__ ptr) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > rows) return;
  const long long target = (long long)v * N;
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)keys[mid] < target) lo = mid + 1; else hi = mid;
  }
  ptr[v] = lo;
}

// Per-row prologue shared by the forward and the backward row kernel.
struct Row {
  int v, r, gN, e0, e1;
  long long vN;
  float ti[kMaxHeads], self_pre[kMaxHeads], m[kMaxHeads], inv[kMaxHeads];
};

// The row's receiver half of the scores and its self scores, then the
// softmax statistics over its edge run and self term: one online (max, sum)
// pass with a lane per edge, combined across the warp.  m and inv (the
// reciprocal denominator) come out equal in every lane.
__device__ __forceinline__ void row_stats(Row& w, const float* __restrict__ ti,
                                          const float* __restrict__ tj,
                                          const int* __restrict__ ef, int heads, int lane) {
  float l[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const bool on = h < heads;
    w.ti[h] = on ? ti[(size_t)w.v * heads + h] : 0.f;
    w.self_pre[h] = on ? w.ti[h] + tj[(size_t)w.v * heads + h] : 0.f;
    w.m[h] = leaky(w.self_pre[h]);
    l[h] = lane == 0 ? 1.f : 0.f;          // the self term, counted once
  }
  for (int e = w.e0 + lane; e < w.e1; e += 32) {
    const int s = (int)((long long)ef[e] - w.vN);
    if (s == w.r) continue;
    const float* tjs = tj + (size_t)(w.gN + s) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h >= heads) break;
      const float sc = leaky(w.ti[h] + tjs[h]);
      if (sc > w.m[h]) {
        l[h] = l[h] * expf(w.m[h] - sc) + 1.f;
        w.m[h] = sc;
      } else {
        l[h] += expf(sc - w.m[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, w.m[h], o);
      const float l2 = __shfl_xor_sync(kFull, l[h], o);
      const float mm = fmaxf(w.m[h], m2);
      l[h] = l[h] * expf(w.m[h] - mm) + l2 * expf(m2 - mm);
      w.m[h] = mm;
    }
    w.inv[h] = 1.f / l[h];
  }
}

__device__ __forceinline__ bool open_row(Row& w, const int* __restrict__ ptr, int rows, int N,
                                         int warp) {
  w.v = blockIdx.x * kWarps + warp;
  if (w.v >= rows) return false;
  w.r = w.v % N;
  w.gN = w.v - w.r;
  w.vN = (long long)w.v * N;
  w.e0 = ptr[w.v];
  w.e1 = ptr[w.v + 1];
  return true;
}

// ---------------------------------------------------------------------------
// Forward.  One warp per row; grid ceil(B*N / kWarps).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
edge_gat_fwd_kernel(const float* __restrict__ ti, const float* __restrict__ tj,
                    const T* __restrict__ xh, const int* __restrict__ ef,
                    const int* __restrict__ ptr, T* __restrict__ out, int rows, int N,
                    int heads, uint32_t s0, uint32_t s1, uint32_t thresh, float scale) {
  __shared__ float w_s[kWarps][32][kMaxHeads];   // the chunk's edge weights
  __shared__ int src_s[kWarps][32];              // the chunk's senders (-1: none)
  constexpr int kHd = 32 * CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Row w;
  if (!open_row(w, ptr, rows, N, warp)) return;
  row_stats(w, ti, tj, ef, heads, lane);
  const int hl = lane * CPL / (kHd / heads);      // the head of this lane's columns

  float ws = 0.f;                                 // self weight of this lane's head
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h)
    if (h == hl) {
      const float a = expf(leaky(w.self_pre[h]) - w.m[h]) * w.inv[h];
      ws = keep_at(kSelfCounter + (uint64_t)w.v * heads + h, s0, s1, thresh) ? a * scale : 0.f;
    }
  float acc[CPL], x[CPL];
  load_cols<T, CPL>(xh + (size_t)w.v * kHd + lane * CPL, x);
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = ws * x[i];

  for (int base = w.e0; base < w.e1; base += 32) {
    const int e = base + lane;
    int s = -1;
    if (e < w.e1) {
      s = (int)((long long)ef[e] - w.vN);
      if (s == w.r) s = -1;
    }
    if (s >= 0) {
      const float* tjs = tj + (size_t)(w.gN + s) * heads;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h >= heads) break;
        const float a = expf(leaky(w.ti[h] + tjs[h]) - w.m[h]) * w.inv[h];
        w_s[warp][lane][h] =
            keep_at((uint64_t)e * heads + h, s0, s1, thresh) ? a * scale : 0.f;
      }
    }
    src_s[warp][lane] = s;
    __syncwarp();
    const int cnt = min(32, w.e1 - base);
    for (int j = 0; j < cnt; ++j) {
      const int sj = src_s[warp][j];
      if (sj < 0) continue;
      const float wj = w_s[warp][j][hl];
      load_cols<T, CPL>(xh + (size_t)(w.gN + sj) * kHd + lane * CPL, x);
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = fmaf(wj, x[i], acc[i]);
    }
    __syncwarp();
  }
  store_cols<T, CPL>(out + (size_t)w.v * kHd + lane * CPL, acc);
}

// ---------------------------------------------------------------------------
// Backward, receiver side.  One warp per row.  Writes dti and the self terms
// dpre_v (dself) and c keep_v alpha_v (wself), [B*N, heads], and per slot
// dpre_e (de) and c keep_e alpha_e (we), [E, heads] (zeros on self-loop
// slots).  de holds da_e between the two edge passes; each slot is written
// and read back by the same lane.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
edge_gat_bwd_row_kernel(const float* __restrict__ ti, const float* __restrict__ tj,
                        const T* __restrict__ xh, const T* __restrict__ g,
                        const int* __restrict__ ef, const int* __restrict__ ptr,
                        float* __restrict__ dti, float* __restrict__ dself,
                        float* __restrict__ wself, float* de, float* __restrict__ we,
                        int rows, int N, int heads, uint32_t s0, uint32_t s1, uint32_t thresh,
                        float scale) {
  __shared__ float a_s[kWarps][32][kMaxHeads];   // the chunk's alpha (before dropout)
  __shared__ unsigned k_s[kWarps][32];           // the chunk's keep bits, one per head
  __shared__ int src_s[kWarps][32];
  constexpr int kHd = 32 * CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Row w;
  if (!open_row(w, ptr, rows, N, warp)) return;
  row_stats(w, ti, tj, ef, heads, lane);
  const int lph = (kHd / heads) / CPL;           // lanes per head

  float gr[CPL], x[CPL];
  load_cols<T, CPL>(g + (size_t)w.v * kHd + lane * CPL, gr);
  load_cols<T, CPL>(xh + (size_t)w.v * kHd + lane * CPL, x);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) q = fmaf(gr[i], x[i], q);
  q = group_sum(q, lph);
  float a_self[kMaxHeads], da_self[kMaxHeads], w_self[kMaxHeads], t[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const float dot = __shfl_sync(kFull, q, (h * lph) & 31);
    const bool k = h < heads &&
                   keep_at(kSelfCounter + (uint64_t)w.v * heads + h, s0, s1, thresh);
    a_self[h] = expf(leaky(w.self_pre[h]) - w.m[h]) * w.inv[h];
    da_self[h] = k ? scale * dot : 0.f;
    w_self[h] = k ? scale * a_self[h] : 0.f;
    t[h] = a_self[h] * da_self[h];
  }

  // pass 1: da per slot (stashed in de by the slot's lane) and t
  for (int base = w.e0; base < w.e1; base += 32) {
    const int e = base + lane;
    int s = -1;
    unsigned kb = 0;
    if (e < w.e1) {
      s = (int)((long long)ef[e] - w.vN);
      if (s == w.r) s = -1;
    }
    if (s >= 0) {
      const float* tjs = tj + (size_t)(w.gN + s) * heads;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h >= heads) break;
        a_s[warp][lane][h] = expf(leaky(w.ti[h] + tjs[h]) - w.m[h]) * w.inv[h];
        if (keep_at((uint64_t)e * heads + h, s0, s1, thresh)) kb |= 1u << h;
      }
    }
    src_s[warp][lane] = s;
    k_s[warp][lane] = kb;
    __syncwarp();
    float da_own[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) da_own[h] = 0.f;
    const int cnt = min(32, w.e1 - base);
    for (int j = 0; j < cnt; ++j) {
      const int sj = src_s[warp][j];
      if (sj < 0) continue;
      load_cols<T, CPL>(xh + (size_t)(w.gN + sj) * kHd + lane * CPL, x);
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) p = fmaf(gr[i], x[i], p);
      p = group_sum(p, lph);
      const unsigned kbj = k_s[warp][j];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        const float dot = __shfl_sync(kFull, p, (h * lph) & 31);
        if (h >= heads) continue;
        const float da = (kbj >> h) & 1u ? scale * dot : 0.f;
        t[h] = fmaf(a_s[warp][j][h], da, t[h]);
        if (lane == j) da_own[h] = da;
      }
    }
    if (s >= 0)
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < heads) de[(size_t)e * heads + h] = da_own[h];
    __syncwarp();
  }

  // pass 2: dpre and c keep alpha per slot, dti
  float dti_l[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dti_l[h] = 0.f;
  for (int e = w.e0 + lane; e < w.e1; e += 32) {
    const int s = (int)((long long)ef[e] - w.vN);
    float* de_e = de + (size_t)e * heads;
    float* we_e = we + (size_t)e * heads;
    if (s == w.r) {
      for (int h = 0; h < heads; ++h) de_e[h] = we_e[h] = 0.f;
      continue;
    }
    const float* tjs = tj + (size_t)(w.gN + s) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h >= heads) break;
      const float pre = w.ti[h] + tjs[h];
      const float a = expf(leaky(pre) - w.m[h]) * w.inv[h];
      const float ds = a * (de_e[h] - t[h]);
      const float dp = pre >= 0.f ? ds : kNegSlope * ds;
      de_e[h] = dp;
      we_e[h] = keep_at((uint64_t)e * heads + h, s0, s1, thresh) ? scale * a : 0.f;
      dti_l[h] += dp;
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const float sum = warp_sum(dti_l[h]);
    if (lane == 0 && h < heads) {
      const float ds = a_self[h] * (da_self[h] - t[h]);
      const float dp = w.self_pre[h] >= 0.f ? ds : kNegSlope * ds;
      const size_t at = (size_t)w.v * heads + h;
      dti[at] = sum + dp;
      dself[at] = dp;
      wself[at] = w_self[h];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, sender side.  One warp per sender u over its slots in sender
// order (keyt: the sorted keys (g*N + s)*N + r, perm: their slots, sptr: row
// pointers over keyt): dtj_u = sum de + dself_u; dxh_u = sum we g_r + wself_u g_u.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
edge_gat_bwd_col_kernel(const T* __restrict__ g, const int* __restrict__ keyt,
                        const int* __restrict__ perm, const int* __restrict__ sptr,
                        const float* __restrict__ de, const float* __restrict__ we,
                        const float* __restrict__ dself, const float* __restrict__ wself,
                        float* __restrict__ dtj, T* __restrict__ dxh, int rows, int N,
                        int heads) {
  __shared__ int r_s[kWarps][32], e_s[kWarps][32];
  constexpr int kHd = 32 * CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= rows) return;
  const int s = u % N, gN = u - s;
  const long long uN = (long long)u * N;
  const int k0 = sptr[u], k1 = sptr[u + 1];
  const int hl = lane * CPL / (kHd / heads);

  float acc[CPL], x[CPL];
  load_cols<T, CPL>(g + (size_t)u * kHd + lane * CPL, x);
  const float ws = wself[(size_t)u * heads + hl];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = ws * x[i];
  float dtj_l[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dtj_l[h] = 0.f;

  for (int base = k0; base < k1; base += 32) {
    const int k = base + lane;
    if (k < k1) {
      const int e = perm[k];
      r_s[warp][lane] = (int)((long long)keyt[k] - uN);
      e_s[warp][lane] = e;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < heads) dtj_l[h] += de[(size_t)e * heads + h];
    }
    __syncwarp();
    const int cnt = min(32, k1 - base);
    for (int j = 0; j < cnt; ++j) {
      const float wj = we[(size_t)e_s[warp][j] * heads + hl];
      if (wj == 0.f) continue;                   // dropped or a self-loop slot
      load_cols<T, CPL>(g + (size_t)(gN + r_s[warp][j]) * kHd + lane * CPL, x);
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = fmaf(wj, x[i], acc[i]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const float sum = warp_sum(dtj_l[h]);
    if (lane == 0 && h < heads) dtj[(size_t)u * heads + h] = sum + dself[(size_t)u * heads + h];
  }
  store_cols<T, CPL>(dxh + (size_t)u * kHd + lane * CPL, acc);
}

int row_ptr(const int* keys, int E, int N, int rows, int* ptr, cudaStream_t stream) {
  row_ptr_kernel<<<(unsigned)((rows + 1 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      keys, E, N, rows, ptr);
  return (int)cudaGetLastError();
}

unsigned row_blocks(int rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

template <typename T, int CPL>
int launch_fwd(const void* ti, const void* tj, const void* xh, const int* ef, int E, int* ptr,
               void* out, int rows, int N, int heads, uint32_t s0, uint32_t s1,
               uint32_t thresh, float scale, cudaStream_t stream) {
  int err = row_ptr(ef, E, N, rows, ptr, stream);
  if (err != 0) return err;
  edge_gat_fwd_kernel<T, CPL><<<row_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const float*>(ti), static_cast<const float*>(tj), static_cast<const T*>(xh),
      ef, ptr, static_cast<T*>(out), rows, N, heads, s0, s1, thresh, scale);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
int launch_bwd(const void* ti, const void* tj, const void* xh, const void* g, const int* ef,
               const int* keyt, const int* perm, int E, int* ptr, int* sptr, float* scratch,
               void* dti, void* dtj, void* dxh, int rows, int N, int heads, uint32_t s0,
               uint32_t s1, uint32_t thresh, float scale, cudaStream_t stream) {
  const size_t slots = (size_t)E * heads, nodes = (size_t)rows * heads;
  float* de = scratch;
  float* we = de + slots;
  float* dself = we + slots;
  float* wself = dself + nodes;
  int err = row_ptr(ef, E, N, rows, ptr, stream);
  if (err == 0) err = row_ptr(keyt, E, N, rows, sptr, stream);
  if (err != 0) return err;
  edge_gat_bwd_row_kernel<T, CPL><<<row_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const float*>(ti), static_cast<const float*>(tj), static_cast<const T*>(xh),
      static_cast<const T*>(g), ef, ptr, static_cast<float*>(dti), dself, wself, de, we, rows,
      N, heads, s0, s1, thresh, scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  edge_gat_bwd_col_kernel<T, CPL><<<row_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(g), keyt, perm, sptr, de, we, dself, wself,
      static_cast<float*>(dtj), static_cast<T*>(dxh), rows, N, heads);
  return (int)cudaGetLastError();
}

// columns per lane (heads * d / 32) as a template argument
template <typename T, typename... A>
int fwd_by_width(int hd, A... args) {
  switch (hd) {
    case 32: return launch_fwd<T, 1>(args...);
    case 64: return launch_fwd<T, 2>(args...);
    case 128: return launch_fwd<T, 4>(args...);
    case 256: return launch_fwd<T, 8>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename... A>
int bwd_by_width(int hd, A... args) {
  switch (hd) {
    case 32: return launch_bwd<T, 1>(args...);
    case 64: return launch_bwd<T, 2>(args...);
    case 128: return launch_bwd<T, 4>(args...);
    case 256: return launch_bwd<T, 8>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int heads, int hd) {
  return heads < 1 || heads > kMaxHeads || (heads & (heads - 1)) != 0 || hd % heads != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xh, out).  ti, tj [B*N, heads] f32;
// xh, out [B*N, hd] with hd = heads * d in {32, 64, 128, 256} and heads a
// power of two <= 8; edge_flat [E] int32 sorted, B*N*N < 2^31; ptr int32
// scratch of B*N + 1.  thresh = uint32(rate * 2^32), 0 for no dropout; (s1,
// s0) the 64-bit dropout seed; scale = 1 / (1 - rate).  All contiguous,
// 16-byte aligned.
extern "C" int edge_gat_fwd_launch(const void* ti, const void* tj, const void* xh,
                                   const void* edge_flat, int E, void* ptr, void* out, int B,
                                   int N, int heads, int hd, int dtype, uint32_t s0,
                                   uint32_t s1, uint32_t thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * N;
  if (rows == 0) return 0;
  if (bad_shape(heads, hd) || rows * N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int* ef = static_cast<const int*>(edge_flat);
  int* p = static_cast<int*>(ptr);
  if (dtype == 0)
    return fwd_by_width<float>(hd, ti, tj, xh, ef, E, p, out, (int)rows, N, heads, s0, s1,
                               thresh, scale, s);
  if (dtype == 1)
    return fwd_by_width<__nv_bfloat16>(hd, ti, tj, xh, ef, E, p, out, (int)rows, N, heads, s0,
                                       s1, thresh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As edge_gat_fwd_launch; g [B*N, hd] of the dtype (cotangent of out);
// keyt [E] int32: the sorted sender-major keys (g*N + s)*N + r (padding
// B*N*N), perm [E] int32 their slots; ptr, sptr int32 scratch of B*N + 1;
// scratch f32 of 2 * E * heads + 2 * B * N * heads.  dti, dtj [B*N, heads]
// f32, dxh [B*N, hd] of the dtype.
extern "C" int edge_gat_bwd_launch(const void* ti, const void* tj, const void* xh,
                                   const void* g, const void* edge_flat, const void* keyt,
                                   const void* perm, int E, void* ptr, void* sptr,
                                   void* scratch, void* dti, void* dtj, void* dxh, int B, int N,
                                   int heads, int hd, int dtype, uint32_t s0, uint32_t s1,
                                   uint32_t thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * N;
  if (rows == 0) return 0;
  if (bad_shape(heads, hd) || rows * N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int* ef = static_cast<const int*>(edge_flat);
  const int* kt = static_cast<const int*>(keyt);
  const int* pm = static_cast<const int*>(perm);
  int* p = static_cast<int*>(ptr);
  int* sp = static_cast<int*>(sptr);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return bwd_by_width<float>(hd, ti, tj, xh, g, ef, kt, pm, E, p, sp, sc, dti, dtj, dxh,
                               (int)rows, N, heads, s0, s1, thresh, scale, s);
  if (dtype == 1)
    return bwd_by_width<__nv_bfloat16>(hd, ti, tj, xh, g, ef, kt, pm, E, p, sp, sc, dti, dtj,
                                       dxh, (int)rows, N, heads, s0, s1, thresh, scale, s);
  return (int)cudaErrorInvalidValue;
}
