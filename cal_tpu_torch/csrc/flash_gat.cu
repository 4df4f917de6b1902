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
//            for the cell index ((b*heads + h)*N + r)*N + s = hi*2^32 + lo
//   out_r  = scale * sum_s keep * alpha * xh_s[h*d:(h+1)*d]
// Backward, with c = scale, alpha recomputed from m and den:
//   da     = keep * (g_r . xh_s);  t_r = sum_s da * alpha
//   dpre   = (pre >= 0 ? 1 : 0.2) * alpha * (da - t_r)
//   dti_r  = c sum_s dpre;  dtj_s = c sum_r dpre;  dxh_s = T(c sum_r keep alpha g_r)
//
// Bound on this card: at B=128, N=256, heads=4, d=32 the forward moves
// ~44 MB in bf16 (0.013 ms at 3.35 TB/s) against 2.1 GFLOP of products and
// 34 M exponentials; the products run here in full f32 on the CUDA cores
// (0.032 ms at 67 TFLOP/s), which makes them the bound.
// Design: no [N, N] score plane reaches device memory.  The forward runs one
// block per (head, 32 receivers, graph): a warp per row takes the masked max
// and then the denominator over all senders (two passes over the counts
// row, the second mostly from L1/L2), then the block walks the senders in
// chunks of 64, rebuilds keep * alpha for the 32 x 64 chunk in shared memory
// and accumulates alpha x xh in registers (4 rows x ceil(d / 32) x 32
// columns a thread, the column groups a template argument).  The backward
// needs row sums (t, dti) and column sums (dtj, dxh): a row kernel (one
// block per head, 32 receivers, graph) forms g . xh for each cell from
// shared memory and reduces t and dti per row in one sweep, and writes t; a
// column kernel (one block per head, 32 senders, graph) recomputes alpha and
// g . xh per cell, reduces dtj per column and accumulates dxh = sum_r
// alpha_drop g_r in registers.
// Every sum has one owner: no atomics, no partial planes, the same bits
// every run.
// Tensor cores (mma.sync in bf16) and a single-pass softmax are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // receivers (forward, row kernel) or senders (column kernel)
constexpr int kChunk = 64;       // senders (forward, row kernel) or receivers (column kernel)
constexpr int kMaxGroups = 4;    // column groups of 32 a thread keeps: head width d <= 128
constexpr float kNegSlope = 0.2f;
constexpr float kBigNeg = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ceff of cell (r, s) of one graph's counts
template <typename T>
__device__ __forceinline__ float ceff_of(const T* cnt, int r, int s, int N) {
  return r == s ? 1.f : to_f(cnt[(size_t)r * N + s]);
}

// ---------------------------------------------------------------------------
// Forward.  Grid (heads, ceil(N / kTile), B).  Shared memory: tj of the head
// [N], keep * alpha of the chunk [kTile][kChunk], xh of the chunk [kChunk][d].
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ ti, const float* __restrict__ tj,
                 const T* __restrict__ counts, const T* __restrict__ xh,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ den_out, int N, int heads, int d, uint32_t s0,
                 uint32_t s1, uint32_t thresh, float scale) {
  extern __shared__ float smem[];
  float* tj_s = smem;                       // [N]
  float* p = tj_s + N;                      // [kTile][kChunk]
  float* xs = p + kTile * kChunk;           // [kChunk][d]
  __shared__ float ti_s[kTile], m_s[kTile], inv_s[kTile];

  const int h = blockIdx.x, r0 = blockIdx.y * kTile, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = heads * d;
  const size_t bn = (size_t)b * N;
  const T* cnt = counts + bn * N;
  for (int s = tid; s < N; s += kThreads) tj_s[s] = tj[(bn + s) * heads + h];
  if (tid < kTile) ti_s[tid] = r0 + tid < N ? ti[(bn + r0 + tid) * heads + h] : 0.f;
  __syncthreads();

  // row statistics, one warp per row
  for (int i = warp; i < kTile; i += kWarps) {
    const int r = r0 + i;
    if (r >= N) {
      if (lane == 0) m_s[i] = inv_s[i] = 0.f;
      continue;
    }
    const float tir = ti_s[i];
    float mx = kBigNeg;
    for (int s = lane; s < N; s += 32)
      if (ceff_of(cnt, r, s, N) > 0.f) mx = fmaxf(mx, leaky(tir + tj_s[s]));
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < N; s += 32) {
      const float c = ceff_of(cnt, r, s, N);
      if (c > 0.f) den += expf(leaky(tir + tj_s[s]) - mx) * c;
    }
    den = warp_sum(den);
    if (lane == 0) {
      m_s[i] = mx;
      inv_s[i] = 1.f / den;
      m_out[(bn + r) * heads + h] = mx;
      den_out[(bn + r) * heads + h] = den;
    }
  }

  // out rows warp + kWarps * i, columns lane + 32 * k
  float acc[kTile / kWarps][NG];
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i)
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[i][k] = 0.f;
  const uint64_t cell0 = ((uint64_t)b * heads + h) * N;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    __syncthreads();                        // row stats ready / previous chunk consumed
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int i = e / kChunk, j = e % kChunk, r = r0 + i, s = c0 + j;
      float a = 0.f;
      if (r < N && s < N) {
        const float c = ceff_of(cnt, r, s, N);
        if (c > 0.f && keep_cell((cell0 + r) * N + s, s0, s1, thresh))
          a = expf(leaky(ti_s[i] + tj_s[s]) - m_s[i]) * c * inv_s[i];
      }
      p[e] = a;
    }
    for (int e = tid; e < kChunk * d; e += kThreads) {
      const int j = e / d, col = e % d, s = c0 + j;
      xs[e] = s < N ? to_f(xh[(bn + s) * hd + h * d + col]) : 0.f;
    }
    __syncthreads();
    const int len = min(kChunk, N - c0);
    for (int j = 0; j < len; ++j) {
      float xv[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int col = lane + 32 * k;
        xv[k] = col < d ? xs[j * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTile / kWarps; ++i) {
        const float a = p[(warp + kWarps * i) * kChunk + j];
#pragma unroll
        for (int k = 0; k < NG; ++k) acc[i][k] = fmaf(a, xv[k], acc[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i) {
    const int r = r0 + warp + kWarps * i;
    if (r >= N) continue;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int col = lane + 32 * k;
      if (col < d) out[(bn + r) * hd + h * d + col] = scale * acc[i][k];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, row kernel.  Grid (heads, ceil(N / kTile), B).  Per receiver r:
// t_r, dti_r.  Shared memory: tj [N], g rows [kTile][d + 1], xh chunk
// [kChunk][d + 1] (the odd stride spreads the dot products over the banks).
// Thread tid owns row i = tid / 8 and the chunk's senders tid % 8 + 8 jj.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_row_kernel(const float* __restrict__ ti, const float* __restrict__ tj,
                     const T* __restrict__ counts, const T* __restrict__ xh,
                     const float* __restrict__ m, const float* __restrict__ den,
                     const float* __restrict__ g, float* __restrict__ dti,
                     float* __restrict__ t_out, int N, int heads, int d, uint32_t s0,
                     uint32_t s1, uint32_t thresh, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* tj_s = smem;                       // [N]
  float* gs = tj_s + N;                     // [kTile][ld]
  float* xs = gs + kTile * ld;              // [kChunk][ld]

  const int h = blockIdx.x, r0 = blockIdx.y * kTile, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hd = heads * d;
  const size_t bn = (size_t)b * N;
  const T* cnt = counts + bn * N;
  for (int s = tid; s < N; s += kThreads) tj_s[s] = tj[(bn + s) * heads + h];
  for (int e = tid; e < kTile * d; e += kThreads) {
    const int i = e / d, col = e % d, r = r0 + i;
    gs[i * ld + col] = r < N ? g[(bn + r) * hd + h * d + col] : 0.f;
  }
  const int i = tid / 8, q = tid % 8, r = r0 + i;
  const bool live = r < N;
  const float tir = live ? ti[(bn + r) * heads + h] : 0.f;
  const float mr = live ? m[(bn + r) * heads + h] : 0.f;
  const float inv = live ? 1.f / den[(bn + r) * heads + h] : 0.f;
  const uint64_t rowcell = ((((uint64_t)b * heads + h) * N) + r) * N;
  // one sweep: with lk = (pre >= 0 ? 1 : 0.2), sum_s dpre = sum_s lk alpha da
  // - t sum_s lk alpha, so t, u = sum lk alpha da and w = sum lk alpha are
  // reduced together and dti = c (u - t w)
  float t = 0.f, u = 0.f, w = 0.f;
  constexpr int kPer = kChunk / 8;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    __syncthreads();                        // g rows ready / previous chunk consumed
    for (int e = tid; e < kChunk * d; e += kThreads) {
      const int j = e / d, col = e % d, s = c0 + j;
      xs[j * ld + col] = s < N ? to_f(xh[(bn + s) * hd + h * d + col]) : 0.f;
    }
    __syncthreads();
    float dot[kPer];
#pragma unroll
    for (int jj = 0; jj < kPer; ++jj) dot[jj] = 0.f;
    for (int col = 0; col < d; ++col) {
      const float gv = gs[i * ld + col];
#pragma unroll
      for (int jj = 0; jj < kPer; ++jj)
        dot[jj] = fmaf(gv, xs[(q + 8 * jj) * ld + col], dot[jj]);
    }
    if (!live) continue;
#pragma unroll
    for (int jj = 0; jj < kPer; ++jj) {
      const int s = c0 + q + 8 * jj;
      if (s >= N) continue;
      const float c = ceff_of(cnt, r, s, N);
      if (!(c > 0.f)) continue;
      const float pre = tir + tj_s[s];
      const float alpha = expf(leaky(pre) - mr) * (c * inv);
      const float lka = pre >= 0.f ? alpha : kNegSlope * alpha;
      const float da = keep_cell(rowcell + s, s0, s1, thresh) ? dot[jj] : 0.f;
      t = fmaf(da, alpha, t);
      u = fmaf(da, lka, u);
      w += lka;
    }
  }
  // the 8 threads of a row are 8 neighbouring lanes
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, o);
    u += __shfl_xor_sync(0xffffffffu, u, o);
    w += __shfl_xor_sync(0xffffffffu, w, o);
  }
  if (live && q == 0) {
    t_out[(bn + r) * heads + h] = t;
    dti[(bn + r) * heads + h] = scale * (u - t * w);
  }
}

// ---------------------------------------------------------------------------
// Backward, column kernel.  Grid (heads, ceil(N / kTile), B).  Per sender s:
// dtj_s and dxh_s.  Shared memory: xh of the tile's senders [kTile][d + 1],
// g rows of the chunk [kChunk][d + 1], keep * alpha of the chunk
// [kChunk][kTile + 1], the chunk's receiver terms (ti, m, 1/den, t) and the
// dtj reduction [kWarps][kTile].  Cell phase: thread tid owns sender
// q = tid % 32 and receivers tid / 32 + 8 ii; product phase: senders
// warp + 8 i, columns lane + 32 k.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_col_kernel(const float* __restrict__ ti, const float* __restrict__ tj,
                     const T* __restrict__ counts, const T* __restrict__ xh,
                     const float* __restrict__ m, const float* __restrict__ den,
                     const float* __restrict__ g, const float* __restrict__ t_in,
                     float* __restrict__ dtj, T* __restrict__ dxh, int N, int heads, int d,
                     uint32_t s0, uint32_t s1, uint32_t thresh, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* xs = smem;                         // [kTile][ld]
  float* gs = xs + kTile * ld;              // [kChunk][ld]
  float* ad = gs + kChunk * ld;             // [kChunk][kTile + 1]
  float* rv = ad + kChunk * (kTile + 1);    // [4][kChunk]: ti, m, 1/den, t
  float* red = rv + 4 * kChunk;             // [kWarps][kTile]

  const int h = blockIdx.x, st = blockIdx.y * kTile, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = heads * d;
  const size_t bn = (size_t)b * N;
  const T* cnt = counts + bn * N;
  for (int e = tid; e < kTile * d; e += kThreads) {
    const int j = e / d, col = e % d, s = st + j;
    xs[j * ld + col] = s < N ? to_f(xh[(bn + s) * hd + h * d + col]) : 0.f;
  }
  const int q = lane, s = st + q;
  const bool live = s < N;
  const float tjs = live ? tj[(bn + s) * heads + h] : 0.f;
  const uint64_t cell0 = ((uint64_t)b * heads + h) * N;
  float dtj_acc = 0.f;
  float acc[kTile / kWarps][NG];
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i)
#pragma unroll
    for (int k = 0; k < NG; ++k) acc[i][k] = 0.f;
  constexpr int kPer = kChunk / kWarps;
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    __syncthreads();                        // xs ready / previous chunk consumed
    for (int e = tid; e < kChunk * d; e += kThreads) {
      const int i = e / d, col = e % d, r = c0 + i;
      gs[i * ld + col] = r < N ? g[(bn + r) * hd + h * d + col] : 0.f;
    }
    if (tid < kChunk) {
      const int r = c0 + tid;
      const bool ok = r < N;
      const size_t k = (bn + r) * heads + h;
      rv[tid] = ok ? ti[k] : 0.f;
      rv[kChunk + tid] = ok ? m[k] : 0.f;
      rv[2 * kChunk + tid] = ok ? 1.f / den[k] : 0.f;
      rv[3 * kChunk + tid] = ok ? t_in[k] : 0.f;
    }
    __syncthreads();
    float dot[kPer];
#pragma unroll
    for (int ii = 0; ii < kPer; ++ii) dot[ii] = 0.f;
    for (int col = 0; col < d; ++col) {
      const float xv = xs[q * ld + col];
#pragma unroll
      for (int ii = 0; ii < kPer; ++ii)
        dot[ii] = fmaf(gs[(warp + kWarps * ii) * ld + col], xv, dot[ii]);
    }
#pragma unroll
    for (int ii = 0; ii < kPer; ++ii) {
      const int i = warp + kWarps * ii, r = c0 + i;
      float a_drop = 0.f;
      if (live && r < N) {
        const float c = ceff_of(cnt, r, s, N);
        if (c > 0.f) {
          const float pre = rv[i] + tjs;
          const float alpha = expf(leaky(pre) - rv[kChunk + i]) * (c * rv[2 * kChunk + i]);
          const bool keep = keep_cell((cell0 + r) * N + s, s0, s1, thresh);
          const float da = keep ? dot[ii] : 0.f;
          a_drop = keep ? alpha : 0.f;
          const float ds = alpha * (da - rv[3 * kChunk + i]);
          dtj_acc += pre >= 0.f ? ds : kNegSlope * ds;
        }
      }
      ad[i * (kTile + 1) + q] = a_drop;
    }
    __syncthreads();
    const int len = min(kChunk, N - c0);
    for (int j = 0; j < len; ++j) {
      float gv[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int col = lane + 32 * k;
        gv[k] = col < d ? gs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTile / kWarps; ++i) {
        const float a = ad[j * (kTile + 1) + warp + kWarps * i];
#pragma unroll
        for (int k = 0; k < NG; ++k) acc[i][k] = fmaf(a, gv[k], acc[i][k]);
      }
    }
  }
  red[warp * kTile + q] = dtj_acc;
  __syncthreads();
  if (tid < kTile && st + tid < N) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * kTile + tid];
    dtj[(bn + st + tid) * heads + h] = scale * sum;
  }
#pragma unroll
  for (int i = 0; i < kTile / kWarps; ++i) {
    const int sj = st + warp + kWarps * i;
    if (sj >= N) continue;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int col = lane + 32 * k;
      if (col < d) dxh[(bn + sj) * hd + h * d + col] = from_f<T>(scale * acc[i][k]);
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int NG>
int launch_fwd(const void* ti, const void* tj, const void* counts, const void* xh, void* out,
               void* m, void* den, int B, int N, int heads, int d, uint32_t s0, uint32_t s1,
               uint32_t thresh, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)N + kTile * kChunk + (size_t)kChunk * d) * sizeof(float);
  int err = set_smem(flash_fwd_kernel<T, NG>, smem);
  if (err != 0) return err;
  dim3 grid(heads, (N + kTile - 1) / kTile, B);
  flash_fwd_kernel<T, NG><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(ti), static_cast<const float*>(tj),
      static_cast<const T*>(counts), static_cast<const T*>(xh), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(den), N, heads, d, s0, s1, thresh, scale);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int launch_bwd(const void* ti, const void* tj, const void* counts, const void* xh,
               const void* m, const void* den, const void* g, void* dti, void* dtj, void* dxh,
               void* t_scratch, int B, int N, int heads, int d, uint32_t s0, uint32_t s1,
               uint32_t thresh, float scale, cudaStream_t stream) {
  const int ld = d + 1;
  const size_t smem_row = ((size_t)N + (size_t)(kTile + kChunk) * ld) * sizeof(float);
  const size_t smem_col = ((size_t)(kTile + kChunk) * ld + kChunk * (kTile + 1) + 4 * kChunk +
                           kWarps * kTile) * sizeof(float);
  int err = set_smem(flash_bwd_row_kernel<T>, smem_row);
  if (err != 0) return err;
  if ((err = set_smem(flash_bwd_col_kernel<T, NG>, smem_col)) != 0) return err;
  dim3 grid(heads, (N + kTile - 1) / kTile, B);
  const float* ti_ = static_cast<const float*>(ti);
  const float* tj_ = static_cast<const float*>(tj);
  const T* c_ = static_cast<const T*>(counts);
  const T* x_ = static_cast<const T*>(xh);
  const float* m_ = static_cast<const float*>(m);
  const float* d_ = static_cast<const float*>(den);
  const float* g_ = static_cast<const float*>(g);
  float* t_ = static_cast<float*>(t_scratch);
  flash_bwd_row_kernel<T><<<grid, kThreads, smem_row, stream>>>(
      ti_, tj_, c_, x_, m_, d_, g_, static_cast<float*>(dti), t_, N, heads, d, s0, s1, thresh,
      scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  flash_bwd_col_kernel<T, NG><<<grid, kThreads, smem_col, stream>>>(
      ti_, tj_, c_, x_, m_, d_, g_, t_, static_cast<float*>(dtj), static_cast<T*>(dxh), N,
      heads, d, s0, s1, thresh, scale);
  return (int)cudaGetLastError();
}

// the kernels' column groups of 32 (NG = ceil(d / 32)) as a template
// argument, so a thread keeps and multiplies only the columns that exist
template <typename T, typename... A>
int fwd_by_groups(int d, A... args) {
  switch ((d + 31) / 32) {
    case 1: return launch_fwd<T, 1>(args...);
    case 2: return launch_fwd<T, 2>(args...);
    case 3: return launch_fwd<T, 3>(args...);
    case 4: return launch_fwd<T, 4>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename... A>
int bwd_by_groups(int d, A... args) {
  switch ((d + 31) / 32) {
    case 1: return launch_bwd<T, 1>(args...);
    case 2: return launch_bwd<T, 2>(args...);
    case 3: return launch_bwd<T, 3>(args...);
    case 4: return launch_bwd<T, 4>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (counts, xh); ti/tj/out/m/den f32.
// ti, tj, m, den [B, N, heads]; counts [B, N, N]; xh, out [B, N, heads * d];
// all contiguous.  d <= 128.  thresh = uint32(rate * 2^32), 0 for no dropout;
// (s1, s0) the 64-bit dropout seed; scale = 1 / (1 - rate).
extern "C" int flash_gat_fwd_launch(const void* ti, const void* tj, const void* counts,
                                    const void* xh, void* out, void* m, void* den, int B,
                                    int N, int heads, int d, int dtype, uint32_t s0,
                                    uint32_t s1, uint32_t thresh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0 || heads == 0 || d == 0) return 0;
  if (d > 32 * kMaxGroups) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return fwd_by_groups<float>(d, ti, tj, counts, xh, out, m, den, B, N, heads, d, s0, s1,
                                thresh, scale, s);
  if (dtype == 1)
    return fwd_by_groups<__nv_bfloat16>(d, ti, tj, counts, xh, out, m, den, B, N, heads, d, s0,
                                        s1, thresh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_gat_fwd_launch; g [B, N, heads * d] f32 (cotangent of out), m and
// den the forward's; dti, dtj [B, N, heads] f32; dxh of the dtype;
// t_scratch f32 [B, N, heads].
extern "C" int flash_gat_bwd_launch(const void* ti, const void* tj, const void* counts,
                                    const void* xh, const void* m, const void* den,
                                    const void* g, void* dti, void* dtj, void* dxh,
                                    void* t_scratch, int B, int N, int heads, int d, int dtype,
                                    uint32_t s0, uint32_t s1, uint32_t thresh, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || N == 0 || heads == 0 || d == 0) return 0;
  if (d > 32 * kMaxGroups) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_by_groups<float>(d, ti, tj, counts, xh, m, den, g, dti, dtj, dxh, t_scratch, B,
                                N, heads, d, s0, s1, thresh, scale, s);
  if (dtype == 1)
    return bwd_by_groups<__nv_bfloat16>(d, ti, tj, counts, xh, m, den, g, dti, dtj, dxh,
                                        t_scratch, B, N, heads, d, s0, s1, thresh, scale, s);
  return (int)cudaErrorInvalidValue;
}
