// Edge-formulated dense multi-head GAT attention for Hopper (sm_90a): the
// backward.  Contract, index and the walk's unit: edge_gat.cu and
// edge_gat.cuh.
//
// Replaces: cal_tpu/ops/pallas_gat_sparse.py::_bwd_kernel (_edge_gat_bwd,
// the custom VJP of _edge_gat_core).
//
// With c = scale and g_v the cotangent of out_v, per head:
//   da_e   = c keep_e (g_v . xh_u)_h;  da_v = c keep_v (g_v . xh_v)_h
//   t_v    = sum_e alpha_e da_e + alpha_v da_v
//   dpre   = (pre >= 0 ? 1 : 0.2) alpha (da - t_v)
//   dti_v  = sum_e dpre_e + dpre_v;   dtj_u = sum_{e: sender u} dpre_e + dpre_u
//   dxh_u  = T(sum_{e: sender u} c keep_e alpha_e g_{r_e} + c keep_u alpha_u g_u)
// alpha from the forward's statistics (m_v, 1 / den_v of the nodes with
// slots), handed over by the autograd Function; the keep bits are drawn
// again from the slot and node counters, so the mask is the forward's.
//
// Bound on this card: bytes.  At B = 128, N = 3,840, heads*d = 128 in bf16
// it must read xh and g and write dxh whole (126 MB a plane): 0.12 ms at
// 3.35 TB/s; the live slots add little.
//
// Design: four launches over the batch's index.
//  1. receivers (persistent; heavy chunks, then light rows, a lane group
//     each): the span's senders, pre and alpha at once (K slots a lane),
//     then the slots in order, two neighbour rows in flight, each slot's
//     per-head dot with g_v summed over a head's lanes and handed to the
//     slot's lane; t by a group tree; a light row then writes dpre_e and c
//     keep_e alpha_e per slot into the f32 columns de, we [E, heads], kept
//     in sender order (the index maps each slot to its place), so that the
//     sender pass reads them in order; and dti_v, dpre_v, c keep_v alpha_v.
//     A heavy chunk stashes da_e in de and its sum of alpha da; the row's
//     last chunk sums t and writes the row's self terms;
//  2. heavy rows' chunks (a warp each, a lane a slot): dpre_e from the
//     stashed da_e and t_v; the row's last chunk sums dti_v;
//  3. senders (persistent; heavy sender chunks, then light senders and the
//     receivers without sender slots): dtj_u from de, dxh_u = the self term
//     plus we x g_r over the sender's places in order (a zero weight, a
//     dropped or self-loop slot, skipped), four g rows in flight; a heavy
//     sender's last chunk sums its chunks' partials in chunk order;
//  4. the nodes without slots either way (a stream): dti = dtj = dpre_v = 0
//     (NaN for a non-finite logit: alpha_v = exp(score - score)) and dxh_v =
//     keep_v c alpha_v g_v, 32-byte vectors a lane, no reduction, the bits
//     of the one-warp-a-row kernels this replaced.
// The per-slot columns are kept: they carry dpre and the dropped weights
// from the receiver walk to the sender walk, which reads them in order and
// took 0.025 ms of the backward's 0.230 on the first SYNREDDIT batch
// (PERF.md §6); without them it would draw each keep bit and form
// each alpha and dpre again per (slot, head), needing the receiver's t.
#include "edge_gat.cuh"

namespace {

constexpr int kUnrollR = 2;   // neighbour rows in flight in the receiver walk
constexpr int kUnrollS = 4;   // cotangent rows in flight in the sender walk

struct BwdArgs {
  const float* ti;
  const float* tj;
  const void* xh;
  const void* g;
  const int* ef;
  const float* stat_m;     // [rows, heads] the forward's m_v of the nodes with slots
  const float* stat_inv;   // [rows, heads] its 1 / den_v
  float* dti;
  float* dtj;
  void* dxh;
  float* de;       // [E, heads] by sender-order place: dpre_e (da_e for a heavy row, in between)
  float* we;       // [E, heads] c keep_e alpha_e
  float* dself;    // [rows, heads] dpre_v of the nodes with slots
  float* wself;    // [rows, heads] c keep_v alpha_v of the nodes with slots
  float* part_t;   // [cap_h, heads] a heavy receiver chunk's sum of alpha da
  float* row_t;    // [cap_h, heads] a heavy row's t_v, at its first place
  float* part_d;   // [cap_h, heads] a heavy receiver chunk's sum of dpre
  float* part_s;   // [cap_h, heads] a heavy sender chunk's sum of dpre
  float* part_x;   // [cap_h, hd] a heavy sender chunk's sum of weight x g
  Index ix;
  int N, rows;
  const uint32_t* seed;   // the 64-bit dropout seed on the card, low word first
  uint32_t thresh;
  float scale;
};

// Receiver v over its slots [beg, end) (at most kSpan); c < 0: a light row,
// else chunk c of a heavy row whose n chunks take places p0 on.
template <typename T, int HEADS, int HD>
__device__ __forceinline__ void recv_span(const BwdArgs& a, const Lane& L, int v, int beg,
                                          int end, int c, int p0, int n) {
  using S = Shape<T, HEADS, HD>;
  constexpr int F = S::F, G = S::G, K = S::K, W = S::W, LPH = S::LPH;
  const T* __restrict__ xh = static_cast<const T*>(a.xh);
  const int r = v % a.N, gN = v - r, hl = L.gl / LPH;
  const long long vN = (long long)v * a.N;
  float tiv[HEADS], m[HEADS], inv[HEADS];
  load_heads<HEADS>(a.ti + (size_t)v * HEADS, tiv);
  load_heads<HEADS>(a.stat_m + (size_t)v * HEADS, m);
  load_heads<HEADS>(a.stat_inv + (size_t)v * HEADS, inv);
  const float sp = pick(tiv, hl) + __ldg(a.tj + (size_t)v * HEADS + hl);
  // the lane's columns of g_v and xh_v, its head's self dot and self terms
  uint32_t gw[W], xw[W];
  load_words<T, F>(static_cast<const T*>(a.g) + (size_t)v * HD + L.gl * F, gw);
  load_words<T, F>(xh + (size_t)v * HD + L.gl * F, xw);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < F; ++i) q = fmaf(word_elem<T>(gw, i), word_elem<T>(xw, i), q);
  q = lanes_sum<LPH>(q, L.mask);
  const float as = expf(leaky(sp) - pick(m, hl)) * pick(inv, hl);
  const bool ks = keep_at(kSelfCounter + (uint64_t)v * HEADS + hl, a.seed, a.thresh);
  const float das = ks ? a.scale * q : 0.f;

  // this lane's slots beg + gl + k G: sender (-1: none, or a self loop),
  // sender-order place (-1: none), alpha, keep and sign bits by head
  int s[K], pl[K];
  unsigned kb[K], sg[K];
  float al[K][HEADS], da[K][HEADS];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = beg + L.gl + k * G;
    s[k] = pl[k] = -1;
    if (e < end) {
      const int sk = (int)((long long)a.ef[e] - vN);
      pl[k] = a.ix.spos[e];
      if (sk != r) s[k] = sk;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t e = (uint64_t)(beg + L.gl + k * G);
    float t[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) t[h] = 0.f;
    if (s[k] >= 0) load_heads<HEADS>(a.tj + (size_t)(gN + s[k]) * HEADS, t);
    kb[k] = sg[k] = 0u;
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      const float pre = tiv[h] + t[h];
      al[k][h] = s[k] >= 0 ? expf(leaky(pre) - m[h]) * inv[h] : 0.f;
      da[k][h] = 0.f;
      if (pre >= 0.f) sg[k] |= 1u << h;
      if (s[k] >= 0 && keep_at(e * HEADS + h, a.seed, a.thresh)) kb[k] |= 1u << h;
    }
  }
  // da per slot: the slots in order, slot k G + o owned by lane o
  const int cnt = end - beg;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * G >= cnt) break;
    for (int o = 0; o < G && k * G + o < cnt; o += kUnrollR) {
      int sj[kUnrollR];
      unsigned kbj[kUnrollR];
#pragma unroll
      for (int u = 0; u < kUnrollR; ++u) {
        const int src = L.base + min(o + u, G - 1);
        sj[u] = __shfl_sync(L.mask, s[k], src);
        kbj[u] = __shfl_sync(L.mask, kb[k], src);
        if (o + u >= G || k * G + o + u >= cnt) sj[u] = -1;
      }
      uint32_t xr[kUnrollR][W];
#pragma unroll
      for (int u = 0; u < kUnrollR; ++u)
        if (sj[u] >= 0) load_words<T, F>(xh + (size_t)(gN + sj[u]) * HD + L.gl * F, xr[u]);
#pragma unroll
      for (int u = 0; u < kUnrollR; ++u) {
        float dot = 0.f;
        if (sj[u] >= 0)
#pragma unroll
          for (int i = 0; i < F; ++i) dot = fmaf(word_elem<T>(gw, i), word_elem<T>(xr[u], i), dot);
        dot = lanes_sum<LPH>(dot, L.mask);
        const float dl = (kbj[u] >> hl) & 1u ? a.scale * dot : 0.f;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          const float t = __shfl_sync(L.mask, dl, L.base + h * LPH);
          if (L.gl == o + u) da[k][h] = t;
        }
      }
    }
  }
  float t[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(al[k][h], da[k][h], acc);
    t[h] = lanes_sum<G>(acc, L.mask);
  }
  const float tself = as * das;   // alpha_v da_v of the lane's head
  const bool light = c < 0;
  if (light) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) t[h] += __shfl_sync(L.mask, tself, L.base + h * LPH);
  }

  // per slot: dpre_e and c keep_e alpha_e (a heavy chunk stashes da_e)
  float dsum[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) dsum[h] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (pl[k] < 0) continue;
    float dp[HEADS], w[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      dp[h] = w[h] = 0.f;
      if (s[k] < 0) continue;
      if (light) {
        const float ds = al[k][h] * (da[k][h] - t[h]);
        dp[h] = (sg[k] >> h) & 1u ? ds : kNegSlope * ds;
        dsum[h] += dp[h];
      } else {
        dp[h] = da[k][h];
      }
      w[h] = (kb[k] >> h) & 1u ? a.scale * al[k][h] : 0.f;
    }
    store_heads<HEADS>(a.de + (size_t)pl[k] * HEADS, dp);
    store_heads<HEADS>(a.we + (size_t)pl[k] * HEADS, w);
  }
  const size_t at = (size_t)v * HEADS + hl;
  if (light) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) dsum[h] = lanes_sum<G>(dsum[h], L.mask);
    const float dss = as * (das - pick(t, hl));
    const float dps = sp >= 0.f ? dss : kNegSlope * dss;
    if (L.gl % LPH == 0) {
      a.dti[at] = pick(dsum, hl) + dps;
      a.dself[at] = dps;
      a.wself[at] = ks ? a.scale * as : 0.f;
    }
    return;
  }
  // a heavy chunk: its sum of alpha da; the row's last chunk sums t_v (the
  // self term first) and writes the self terms, for pass 2
  if (L.gl == 0) store_heads<HEADS>(a.part_t + (size_t)c * HEADS, t);
  if (!arrived_last(a.ix.arr_r, p0, n, L)) return;
  float tr[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) tr[h] = 0.f;
  for (int qq = L.gl; qq < n; qq += G) {   // the lanes take the chunks in turn
    float tq[HEADS];
    load_heads_cg<HEADS>(a.part_t + (size_t)(p0 + qq) * HEADS, tq);
#pragma unroll
    for (int h = 0; h < HEADS; ++h) tr[h] += tq[h];
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
    tr[h] = __shfl_sync(L.mask, tself, L.base + h * LPH) + lanes_sum<G>(tr[h], L.mask);
  const float dss = as * (das - pick(tr, hl));
  const float dps = sp >= 0.f ? dss : kNegSlope * dss;
  if (L.gl % LPH == 0) {
    a.dself[at] = dps;
    a.wself[at] = ks ? a.scale * as : 0.f;
  }
  if (L.gl == 0) {
    store_heads<HEADS>(a.row_t + (size_t)p0 * HEADS, tr);
    a.ix.arr_r[p0] = 0;
  }
}

template <typename T, int HEADS, int HD>
__global__ void edge_bwd_recv_kernel(const BwdArgs a) {
  using S = Shape<T, HEADS, HD>;
  const Lane L = lane_of<S::G>();
  const int nh = a.ix.counts[1], items = nh + a.ix.counts[0];
  // the next item's list entry and span are loaded while this one is walked
  int it = (blockIdx.x * kThreads + (int)threadIdx.x) / S::G, c = -1;
  const int stride = walk_stride(it, nh, items, gridDim.x * (kThreads / S::G));
  Chunk2 k = {0, 0, 0, 0, 0};
  if (it < items) k = walk_item(a.ix.heavy_r, a.ix.light_r, a.ix.rrange, nh, it, c);
  while (it < items) {
    const Chunk2 cur = k;
    const int cc = c, next = it + stride;
    if (next < items) k = walk_item(a.ix.heavy_r, a.ix.light_r, a.ix.rrange, nh, next, c);
    recv_span<T, HEADS, HD>(a, L, cur.v, cur.beg, cur.end, cc, cur.p0, cur.n);
    it = next;
  }
}

// Pass 2: a heavy row's chunks, a warp each, a lane a slot: dpre_e from the
// stashed da_e and the row's t_v; the last chunk sums dti_v in chunk order.
template <int HEADS>
__global__ void __launch_bounds__(kThreads) edge_bwd_heavy_kernel(const BwdArgs a) {
  const Lane L = lane_of<32>();
  const int nh = a.ix.counts[1];
  const int stride = gridDim.x * (kThreads / 32);
  for (int c = (blockIdx.x * kThreads + (int)threadIdx.x) / 32; c < nh; c += stride) {
    const Chunk2 k = heavy_item(a.ix.heavy_r, a.ix.rrange, c);
    const int r = k.v % a.N, gN = k.v - r;
    const long long vN = (long long)k.v * a.N;
    float dsum[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) dsum[h] = 0.f;
    const int e = k.beg + L.gl;
    if (e < k.end) {
      const int sk = (int)((long long)a.ef[e] - vN);
      if (sk != r) {
        const int p = a.ix.spos[e];
        float tiv[HEADS], m[HEADS], inv[HEADS], tr[HEADS], tjs[HEADS], da[HEADS];
        load_heads<HEADS>(a.ti + (size_t)k.v * HEADS, tiv);
        load_heads<HEADS>(a.stat_m + (size_t)k.v * HEADS, m);
        load_heads<HEADS>(a.stat_inv + (size_t)k.v * HEADS, inv);
        load_heads<HEADS>(a.row_t + (size_t)k.p0 * HEADS, tr);
        load_heads<HEADS>(a.tj + (size_t)(gN + sk) * HEADS, tjs);
        load_heads_cg<HEADS>(a.de + (size_t)p * HEADS, da);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          const float pre = tiv[h] + tjs[h];
          const float al = expf(leaky(pre) - m[h]) * inv[h];
          const float ds = al * (da[h] - tr[h]);
          dsum[h] = pre >= 0.f ? ds : kNegSlope * ds;
        }
        store_heads<HEADS>(a.de + (size_t)p * HEADS, dsum);
      }
    }
#pragma unroll
    for (int h = 0; h < HEADS; ++h) dsum[h] = lanes_sum<32>(dsum[h], L.mask);
    if (L.gl == 0) store_heads<HEADS>(a.part_d + (size_t)c * HEADS, dsum);
    if (!arrived_last(a.ix.arr_r, k.p0, k.n, L)) continue;
    float d[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) d[h] = 0.f;
    for (int q = L.gl; q < k.n; q += 32) {   // the lanes take the chunks in turn
      float dq[HEADS];
      load_heads_cg<HEADS>(a.part_d + (size_t)(k.p0 + q) * HEADS, dq);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) d[h] += dq[h];
    }
#pragma unroll
    for (int h = 0; h < HEADS; ++h) d[h] = lanes_sum<32>(d[h], L.mask);
    if (L.gl == 0) {
      float ds[HEADS];
      load_heads<HEADS>(a.dself + (size_t)k.v * HEADS, ds);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) d[h] += ds[h];
      store_heads<HEADS>(a.dti + (size_t)k.v * HEADS, d);
      a.ix.arr_r[k.p0] = 0;
    }
  }
}

// Sender u over its sender-order places [beg, end) (at most kSpan; none for
// a receiver without sender slots); c < 0: a light sender, else chunk c of a
// heavy sender whose n chunks take places p0 on.
template <typename T, int HEADS, int HD>
__device__ __forceinline__ void send_span(const BwdArgs& a, const Lane& L, int u, int beg,
                                          int end, int c, int p0, int n) {
  using S = Shape<T, HEADS, HD>;
  constexpr int F = S::F, G = S::G, K = S::K, W = S::W, LPH = S::LPH;
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const int hl = L.gl / LPH;
  const size_t at = (size_t)u * HEADS + hl;
  // u's self terms: the receiver pass's, or, for a node without receiver
  // slots, alpha_u = exp(score - score) and dpre_u = 0 (as pass 4)
  const int2 rr = a.ix.rrange[u];
  const bool rlive = rr.y > rr.x;
  float dsu, wsu;
  if (rlive) {
    dsu = __ldg(a.dself + at);
    wsu = __ldg(a.wself + at);
  } else {
    const float sp = __ldg(a.ti + at) + __ldg(a.tj + at);
    const float sc = leaky(sp);
    const float as = expf(sc - sc);
    const float ds = as * (0.f - as * 0.f);
    dsu = sp >= 0.f ? ds : kNegSlope * ds;
    wsu = keep_at(kSelfCounter + (uint64_t)at, a.seed, a.thresh) ? a.scale * as : 0.f;
  }
  // dtj: the dpre of this lane's places, summed over the group
  float ds[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) ds[h] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int pos = beg + L.gl + k * G;
    if (pos < end) {
      float d[HEADS];
      load_heads<HEADS>(a.de + (size_t)pos * HEADS, d);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) ds[h] += d[h];
    }
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h) ds[h] = lanes_sum<G>(ds[h], L.mask);
  // dxh: the self term, then weight x g_r over the places in order
  const bool light = c < 0;
  float acc[F];
  uint32_t gw[W];
  if (light) {
    load_words<T, F>(g + (size_t)u * HD + L.gl * F, gw);
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = wsu * word_elem<T>(gw, i);
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = 0.f;
  }
  const int cnt = end - beg;
  for (int j0 = 0; j0 < cnt; j0 += kUnrollS) {
    int rj[kUnrollS];
    float wj[kUnrollS];
#pragma unroll
    for (int q = 0; q < kUnrollS; ++q) {
      const bool ok = j0 + q < cnt;
      rj[q] = ok ? __ldg(a.ix.srecv + beg + j0 + q) : 0;
      wj[q] = ok ? __ldg(a.we + (size_t)(beg + j0 + q) * HEADS + hl) : 0.f;
    }
    uint32_t gr[kUnrollS][W];
#pragma unroll
    for (int q = 0; q < kUnrollS; ++q)
      if (wj[q] != 0.f) load_words<T, F>(g + (size_t)rj[q] * HD + L.gl * F, gr[q]);
#pragma unroll
    for (int q = 0; q < kUnrollS; ++q)
      if (wj[q] != 0.f)
#pragma unroll
        for (int i = 0; i < F; ++i) acc[i] = fmaf(wj[q], word_elem<T>(gr[q], i), acc[i]);
  }
  T* __restrict__ dxh = static_cast<T*>(a.dxh) + (size_t)u * HD + L.gl * F;
  if (light) {
    store_vec<T, F>(dxh, acc);
    if (L.gl % LPH == 0) {
      a.dtj[at] = pick(ds, hl) + dsu;
      if (!rlive) a.dti[at] = dsu;
    }
    return;
  }
  if (L.gl == 0) store_heads<HEADS>(a.part_s + (size_t)c * HEADS, ds);
  store_vec<float, F>(a.part_x + (size_t)c * HD + L.gl * F, acc);
  if (!arrived_last(a.ix.arr_s, p0, n, L)) return;
  // dtj: the lanes take the chunks in turn, then a group tree; dxh: the
  // chunks in order
#pragma unroll
  for (int h = 0; h < HEADS; ++h) ds[h] = 0.f;
  for (int q = L.gl; q < n; q += G) {
    float dq[HEADS];
    load_heads_cg<HEADS>(a.part_s + (size_t)(p0 + q) * HEADS, dq);
#pragma unroll
    for (int h = 0; h < HEADS; ++h) ds[h] += dq[h];
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h) ds[h] = lanes_sum<G>(ds[h], L.mask);
  load_words<T, F>(g + (size_t)u * HD + L.gl * F, gw);
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = wsu * word_elem<T>(gw, i);
  for (int q = 0; q < n; ++q) {
    const float4* px =
        reinterpret_cast<const float4*>(a.part_x + (size_t)(p0 + q) * HD + L.gl * F);
#pragma unroll
    for (int i4 = 0; i4 < F / 4; ++i4) {
      const float4 t = __ldcg(px + i4);
      acc[4 * i4] += t.x;
      acc[4 * i4 + 1] += t.y;
      acc[4 * i4 + 2] += t.z;
      acc[4 * i4 + 3] += t.w;
    }
  }
  store_vec<T, F>(dxh, acc);
  if (L.gl % LPH == 0) {
    a.dtj[at] = pick(ds, hl) + dsu;
    if (!rlive) a.dti[at] = dsu;
  }
  if (L.gl == 0) a.ix.arr_s[p0] = 0;
}

template <typename T, int HEADS, int HD>
__global__ void edge_bwd_send_kernel(const BwdArgs a) {
  using S = Shape<T, HEADS, HD>;
  const Lane L = lane_of<S::G>();
  const int nh = a.ix.counts[3], items = nh + a.ix.counts[2];
  // the next item's list entry and span are loaded while this one is walked
  int it = (blockIdx.x * kThreads + (int)threadIdx.x) / S::G, c = -1;
  const int stride = walk_stride(it, nh, items, gridDim.x * (kThreads / S::G));
  Chunk2 k = {0, 0, 0, 0, 0};
  if (it < items) k = walk_item(a.ix.heavy_s, a.ix.light_s, a.ix.srange, nh, it, c);
  while (it < items) {
    const Chunk2 cur = k;
    const int cc = c, next = it + stride;
    if (next < items) k = walk_item(a.ix.heavy_s, a.ix.light_s, a.ix.srange, nh, next, c);
    send_span<T, HEADS, HD>(a, L, cur.v, cur.beg, cur.end, cc, cur.p0, cur.n);
    it = next;
  }
}

// Pass 4: the nodes without slots either way, a group a node.
template <typename T, int HEADS, int HD>
__global__ void __launch_bounds__(kThreads) edge_bwd_stream_kernel(const BwdArgs a) {
  using S = Shape<T, HEADS, HD>;
  constexpr int F = S::F;
  const Lane L = lane_of<S::G>();
  const int v = (blockIdx.x * kThreads + (int)threadIdx.x) / S::G;
  if (v >= a.rows) return;
  const int h = L.gl / S::LPH;
  const size_t at = (size_t)v * HEADS + h;
  const int2 rr = a.ix.rrange[v], sr = a.ix.srange[v];
  const float sp = __ldg(a.ti + at) + __ldg(a.tj + at);
  uint32_t gw[S::W];
  load_words<T, F>(static_cast<const T*>(a.g) + (size_t)v * HD + L.gl * F, gw);
  if (rr.y > rr.x || sr.y > sr.x) return;
  const float sc = leaky(sp);
  const float as = expf(sc - sc);
  const float ds = as * (0.f - as * 0.f);
  const float dp = sp >= 0.f ? ds : kNegSlope * ds;
  const float ws = keep_at(kSelfCounter + (uint64_t)at, a.seed, a.thresh) ? a.scale * as
                                                                                : 0.f;
  float o[F];
#pragma unroll
  for (int i = 0; i < F; ++i) o[i] = ws * word_elem<T>(gw, i);
  store_vec<T, F>(static_cast<T*>(a.dxh) + (size_t)v * HD + L.gl * F, o);
  if (L.gl % S::LPH == 0) {
    a.dti[at] = dp;
    a.dtj[at] = dp;
  }
}

template <typename T, int HEADS, int HD>
struct Bwd {
  static int run(const BwdArgs& a, cudaStream_t stream) {
    using S = Shape<T, HEADS, HD>;
    static const int recv = persistent_blocks((const void*)edge_bwd_recv_kernel<T, HEADS, HD>);
    static const int heavy = persistent_blocks((const void*)edge_bwd_heavy_kernel<HEADS>);
    static const int send = persistent_blocks((const void*)edge_bwd_send_kernel<T, HEADS, HD>);
    edge_bwd_recv_kernel<T, HEADS, HD><<<recv, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    edge_bwd_heavy_kernel<HEADS><<<heavy, kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    edge_bwd_send_kernel<T, HEADS, HD><<<send, kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long per_block = kThreads / S::G;
    edge_bwd_stream_kernel<T, HEADS, HD>
        <<<(unsigned)((a.rows + per_block - 1) / per_block), kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
};

size_t r4(size_t n) { return (n + 3) / 4 * 4; }

}  // namespace

// As edge_gat_fwd_launch; g [B*N, hd] of the dtype (cotangent of out);
// stat_m, stat_inv the forward's statistics; scratch f32 of
// 2 r4(E heads) + 2 r4(B N heads) + 4 r4(cap_h heads) + r4(cap_h hd), r4
// rounding up to a multiple of 4 (ops/edge_gat.py _bwd_scratch).  dti, dtj
// [B*N, heads] f32, dxh [B*N, hd] of the dtype.
extern "C" int edge_gat_bwd_launch(const void* ti, const void* tj, const void* xh,
                                   const void* g, const void* edge_flat, void* const* ix,
                                   const void* stat_m, const void* stat_inv, void* scratch,
                                   void* dti, void* dtj, void* dxh, int E, int cap_h, int B,
                                   int N, int heads, int hd, int dtype, const void* seed,
                                   uint32_t thresh, float scale, void* stream) {
  const long long rows = (long long)B * N;
  if (rows == 0) return 0;
  if (bad_shape(heads, hd) || rows * N >= (1ll << 31) || (thresh != 0 && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.ti = static_cast<const float*>(ti);
  a.tj = static_cast<const float*>(tj);
  a.xh = xh;
  a.g = g;
  a.ef = static_cast<const int*>(edge_flat);
  a.stat_m = static_cast<const float*>(stat_m);
  a.stat_inv = static_cast<const float*>(stat_inv);
  a.dti = static_cast<float*>(dti);
  a.dtj = static_cast<float*>(dtj);
  a.dxh = dxh;
  float* p = static_cast<float*>(scratch);
  const size_t slots = r4((size_t)E * heads), nodes = r4((size_t)rows * heads),
               part = r4((size_t)cap_h * heads);
  a.de = p;
  a.we = a.de + slots;
  a.dself = a.we + slots;
  a.wself = a.dself + nodes;
  a.part_t = a.wself + nodes;
  a.row_t = a.part_t + part;
  a.part_d = a.row_t + part;
  a.part_s = a.part_d + part;
  a.part_x = a.part_s + part;
  a.ix = index_from(ix);
  a.N = N;
  a.rows = (int)rows;
  a.seed = static_cast<const uint32_t*>(seed);
  a.thresh = thresh;
  a.scale = scale;
  return dispatch<Bwd>(dtype, heads, hd, a, static_cast<cudaStream_t>(stream));
}
