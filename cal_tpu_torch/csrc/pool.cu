// Sorted segment sum (sparse global_add_pool) for Hopper (sm_90a): K4, and
// its backward, the row gather K7.
//
// K4 replaces cal_tpu/ops/pallas_pool.py _pool_call (_pool_fwd_kernel), the
// forward of mxu_pool: x [V, H] (f32 or bf16) -> out [G1, H] f32 with
// out[g] = sum of the rows v with node_graph[v] == g, summed in f32.  Padded
// nodes carry node_graph == G1 - 1 (the trash segment), which the caller
// drops.  The TPU kernel multiplies a one-hot of node_graph into an f32
// block resident across the grid; here node_graph is non-decreasing (the
// packer lays each graph's nodes out contiguously, padding last), so the
// rows of segment g are one range [lower_bound(g), lower_bound(g + 1)).
//
// Design: the rows are cut into runs of kRun = 32, one a warp, kFwdWarps
// warps a block: the grid depends on V alone (496 blocks at V = 31,744), not
// on the widest segment, and no search precedes the first load.  A warp
// issues the loads of its run's rows first (16 bytes a lane, a row on L / 32
// lanes, 32 / L rows an instruction, 8 words a lane in flight: half the run
// in bf16 at H = 128, 4 KB a warp; 16 words, at more registers a lane, ran
// slower), with them one coalesced load of the run's node_graph ids (one a
// lane) and the ids either side of it.
// A ballot of the id changes gives the run's segments; the warp folds each
// segment's rows in f32 in row order and adds its lanes' sums by a fixed
// butterfly.  A segment wholly inside the run has one owner, the warp, which
// writes its row of out.  A segment that spans runs (the trash segment,
// REDDIT's graphs of up to 3,800 rows, most graphs of a serving batch) gets
// one f32 partial from each run it touches, in a slot of that run; each such
// run then adds to arrivals[g] a term (its run + 1 where the segment starts,
// 1 in the middle, -run where it ends) whose sum is 0 only once every run has
// come, so the last to come, whichever it is, knows it and, once its own
// rows are folded, adds the partials from L2 in a fixed order (the first and
// last run are left in span[g]): its whole warp, 16 partial rows a lane in
// flight, a lane group a residue of the run index, then a fixed butterfly.
// The counters are 0 between launches with no reset.  No float atomics:
// two calls give the same bits.  Segments without rows are written as zeros
// by the warp whose run holds the id change that skips them (or the first or
// last run).  One launch.  Bound: bytes, one read of x (8 MB at V = 31,744,
// H = 128 bf16) and node_graph; the partials add ~2 x 512 B a run, read
// back from L2.
//
// K7 replaces cal_tpu/ops/pallas_pool.py _mxu_pool_bwd (_pool_bwd_kernel):
// dx[v] = dpooled[node_graph[v]] for dpooled [G1, H] f32, rounded once to
// x's dtype (the trash row's gradient is zero: the caller sliced it off).
// The TPU kernel multiplies the one-hot of node_graph with dpooled resident
// in VMEM; here it is a row gather whose bound is bytes: one write of dx [V,
// H] (8 MB at the canonical batch in bf16) and one read of node_graph.
// Design: a warp takes a run of kRun = 32 rows: one coalesced load of their
// node_graph ids (one a lane), then each store instruction writes 512
// contiguous bytes of dx, 16 bytes a lane (in bf16 at H = 128 a row is 16
// lanes, so 2 rows an instruction), the ids handed round by shuffles.
// node_graph is sorted in every caller (the packer lays graphs out
// contiguously), so each lane keeps its slice of the current dpooled row in
// registers and reloads it (from L2: G1 x H x 4 = 66 KB) only when its
// row's id changes; the check makes any node_graph right.  So a warp keeps
// its stores independent of each other, where one warp a row chained a
// node_graph load, the dpooled load and an 8-byte store a lane.  A block
// takes 8 runs: 124 blocks at V = 31,744, which runs of 16 rows (twice the
// warps) did not beat (PERF.md).
//
// Built by cal_tpu_torch/kernels/build.py (plain C interface, ctypes); the
// wrapper ops/pool.py allocates the output and passes PyTorch's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRun = 32;        // rows a warp takes (K4 and K7): one node_graph id a lane
constexpr int kFwdWarps = 2;    // K4's warps a block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

// The 16-byte words of a lane's row slice as floats.
template <typename T, int F>
__device__ __forceinline__ void add_word(const uint4& u, float* acc) {
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] += to_f(t[j]);
}

// K4: one warp a run of kRun rows (the header gives the design).  part
// [runs, 2, H] f32 holds a run's partials (slot 0: the segment it continues
// from the run before, slot 1: the one it starts and hands on), span [G1, 2]
// the first and last run of each spanning segment, arrivals [G1] zeros.
template <typename T, int H>
__global__ void __launch_bounds__(kFwdWarps * 32)
pool_kernel(const T* __restrict__ x, const int* __restrict__ node_graph, int num_nodes,
            int num_segments, float* __restrict__ out, float* __restrict__ part,
            int* __restrict__ span, int* __restrict__ arrivals) {
  constexpr int F = 16 / (int)sizeof(T);   // elements a lane loads at once: 16 bytes
  constexpr int L = H / F;                 // 16-byte words a row
  constexpr int LC = L < 32 ? L : 32;      // lanes a row
  constexpr int NW = L / LC;               // words a lane loads a row
  constexpr int RPW = 32 / LC;             // rows a load instruction reads
  constexpr int UW = 8 / NW;               // rows a lane keeps in flight: 8 words
  constexpr int U = UW < kRun / RPW ? UW : kRun / RPW;
  constexpr int kBatch = RPW * U;          // rows a batch of loads covers
  const int lane = threadIdx.x & 31;
  const int sub = lane / LC, col = lane % LC;
  const int run = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  const int v0 = run * kRun;
  if (v0 >= num_nodes) return;
  const int nrows = min(kRun, num_nodes - v0);
  const T* xr = x + (size_t)v0 * H;

  uint4 buf[U][NW];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * RPW + sub;
      if (k < nrows) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          buf[u][w] = __ldg(reinterpret_cast<const uint4*>(xr + (size_t)k * H) + col + w * LC);
      }
    }
  };
  load(0);
  const int id = lane < nrows ? __ldg(node_graph + v0 + lane) : -1;
  const int prev = v0 > 0 ? __ldg(node_graph + v0 - 1) : -1;
  const int next = v0 + kRun < num_nodes ? __ldg(node_graph + v0 + kRun) : -1;
  const int up = __shfl_up_sync(kFull, id, 1);
  const unsigned heads = __ballot_sync(kFull, lane < nrows && (lane == 0 || id != up));

  // segments without rows: the ids an id change skips, those before the
  // first row and after the last
  auto zero_rows = [&](int lo, int hi) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)lo * H);
    for (int i = lane; i < (hi - lo) * (H / 4); i += 32) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  const int glo = (lane == 0 ? prev : up) + 1, ghi = min(id, num_segments);
  for (unsigned gaps = __ballot_sync(kFull, (heads >> lane & 1) && ghi > glo); gaps;
       gaps &= gaps - 1) {
    const int s = __ffs(gaps) - 1;
    zero_rows(__shfl_sync(kFull, glo, s), __shfl_sync(kFull, ghi, s));
  }
  if (v0 + nrows == num_nodes) {
    const int last = __shfl_sync(kFull, id, nrows - 1);
    if (last + 1 < num_segments) zero_rows(max(last + 1, 0), num_segments);
  }

  float acc[NW][F];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[w][f] = 0.0f;

  // the sum of the segment in rows [lo, hi) of the run, taken by every lane:
  // written, or left as a partial (and the segment noted in fin when this
  // run is the last to arrive)
  int fin0 = 0, fin1 = 0, nfin = 0;      // the segments this run finishes
  auto flush = [&](int lo, int hi) {
#pragma unroll
    for (int off = LC; off < 32; off <<= 1)
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int f = 0; f < F; ++f) acc[w][f] += __shfl_xor_sync(kFull, acc[w][f], off);
    const int g = __shfl_sync(kFull, id, lo);
    if ((unsigned)g >= (unsigned)num_segments) return;
    const bool in = lo == 0 && prev == g;        // continued from the run before
    const bool on = hi == nrows && next == g;    // continued by the run after
    float* o = out + (size_t)g * H;
    if (!in && !on) {
      if (sub == 0)
#pragma unroll
        for (int w = 0; w < NW; ++w) store_vec<float, F>(o + (col + w * LC) * F, acc[w]);
      return;
    }
    if (lane == 0) {
      if (!in) span[2 * g] = run;
      if (!on) span[2 * g + 1] = run;
    }
    if (sub == 0) {
      float* p = part + ((size_t)run * 2 + (in ? 0 : 1)) * H;
#pragma unroll
      for (int w = 0; w < NW; ++w) store_vec<float, F>(p + (col + w * LC) * F, acc[w]);
      __threadfence();
    }
    __syncwarp();
    const int c = !in ? run + 1 : (on ? 1 : -run);
    int last = 0;
    if (lane == 0) last = atomicAdd(arrivals + g, c) == -c;
    if (__shfl_sync(kFull, last, 0)) {
      if (nfin == 0) fin0 = g; else fin1 = g;
      ++nfin;
    }
  };

  int seg = 0;                             // first row of the segment being summed
#pragma unroll 1
  for (int base = 0; base < nrows; base += kBatch) {
    if (base > 0) load(base);
    const int bend = min(base + kBatch, nrows);
    for (int lo = base;;) {
      const unsigned later = lo >= 31 ? 0u : heads & (kFull << (lo + 1));
      const int hi = later ? min(__ffs(later) - 1, bend) : bend;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = base + u * RPW + sub;
        if (k >= lo && k < hi)
#pragma unroll
          for (int w = 0; w < NW; ++w) add_word<T, F>(buf[u][w], acc[w]);
      }
      if (hi == nrows || (heads >> hi & 1)) {
        flush(seg, hi);
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int f = 0; f < F; ++f) acc[w][f] = 0.0f;
        seg = hi;
      }
      if (hi == bend) break;
      lo = hi;
    }
  }

  // the segments this run finishes: their partials' sum in run order, the
  // warp's lanes on PRPW partial rows an instruction, up to 16 words a lane
  // in flight, added by a fixed butterfly
  constexpr int PF = H / 4;                 // float4 words a partial row
  constexpr int PLC = PF < 32 ? PF : 32;    // lanes a partial row
  constexpr int PNW = PF / PLC;             // words a lane a partial row
  constexpr int PRPW = 32 / PLC;            // partial rows an instruction
  constexpr int PU = 16 / PNW;              // partial rows a lane has in flight
  const int psub = lane / PLC, pcol = lane % PLC;
  const float4* part4 = reinterpret_cast<const float4*>(part);
  if (nfin) __threadfence();
  for (int i = 0; i < nfin; ++i) {
    const int g = i == 0 ? fin0 : fin1;
    const int a = __ldcg(span + 2 * g), n = __ldcg(span + 2 * g + 1) - a + 1;
    float4 s[PNW];
#pragma unroll
    for (int w = 0; w < PNW; ++w) s[w] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n; j0 += PRPW * PU) {
      float4 q[PU][PNW];
#pragma unroll
      for (int u = 0; u < PU; ++u) {
        const int j = j0 + u * PRPW + psub;   // partial row j: run a + j, slot 1 for j = 0
        if (j < n)
#pragma unroll
          for (int w = 0; w < PNW; ++w)
            q[u][w] = __ldcg(part4 + ((size_t)(a + j) * 2 + (j == 0)) * PF + pcol + w * PLC);
      }
#pragma unroll
      for (int u = 0; u < PU; ++u)
        if (j0 + u * PRPW + psub < n)
#pragma unroll
          for (int w = 0; w < PNW; ++w) {
            s[w].x += q[u][w].x; s[w].y += q[u][w].y; s[w].z += q[u][w].z; s[w].w += q[u][w].w;
          }
    }
#pragma unroll
    for (int off = PLC; off < 32; off <<= 1)
#pragma unroll
      for (int w = 0; w < PNW; ++w) {
        s[w].x += __shfl_xor_sync(kFull, s[w].x, off);
        s[w].y += __shfl_xor_sync(kFull, s[w].y, off);
        s[w].z += __shfl_xor_sync(kFull, s[w].z, off);
        s[w].w += __shfl_xor_sync(kFull, s[w].w, off);
      }
    if (psub == 0)
#pragma unroll
      for (int w = 0; w < PNW; ++w)
        reinterpret_cast<float4*>(out + (size_t)g * H)[pcol + w * PLC] = s[w];
  }
}

template <typename T, int H>
cudaError_t launch_h(const void* x, const int* node_graph, int num_nodes, int num_segments,
                     float* out, float* part, int* span, int* arrivals, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kFwdWarps * kRun;
  pool_kernel<T, H><<<(num_nodes + kRowsPerBlock - 1) / kRowsPerBlock, kFwdWarps * 32, 0,
                      stream>>>(static_cast<const T*>(x), node_graph, num_nodes, num_segments,
                                out, part, span, arrivals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const int* node_graph, int num_nodes, int h,
                   int num_segments, float* out, float* part, int* span, int* arrivals,
                   cudaStream_t stream) {
  switch (h) {
    case 32: return launch_h<T, 32>(x, node_graph, num_nodes, num_segments, out, part, span,
                                    arrivals, stream);
    case 64: return launch_h<T, 64>(x, node_graph, num_nodes, num_segments, out, part, span,
                                    arrivals, stream);
    case 128: return launch_h<T, 128>(x, node_graph, num_nodes, num_segments, out, part, span,
                                      arrivals, stream);
    case 256: return launch_h<T, 256>(x, node_graph, num_nodes, num_segments, out, part, span,
                                      arrivals, stream);
    default: return cudaErrorInvalidValue;
  }
}
constexpr int kBwdWarps = 8;    // K7's warps a block

template <typename T, int H>
__global__ void __launch_bounds__(kBwdWarps * 32)
pool_bwd_kernel(const float* __restrict__ dpooled, const int* __restrict__ node_graph,
                int num_nodes, T* __restrict__ dx) {
  constexpr int F = 16 / (int)sizeof(T);   // elements a lane stores at once: 16 bytes
  constexpr int L = H / F;                 // 16-byte words a row
  constexpr int LC = L < 32 ? L : 32;      // lanes a row
  constexpr int NW = L / LC;               // words a lane stores a row
  constexpr int RPW = 32 / LC;             // rows a store instruction writes
  const int lane = threadIdx.x & 31;
  const int sub = lane / LC, col = lane % LC;
  const int v0 = (blockIdx.x * kBwdWarps + (threadIdx.x >> 5)) * kRun;
  if (v0 >= num_nodes) return;
  const int ids = v0 + lane < num_nodes ? __ldg(node_graph + v0 + lane) : 0;
  int cur = -1;                            // the id of the dpooled slice in d
  float d[NW][F];
#pragma unroll 4
  for (int j = 0; j < kRun; j += RPW) {
    const int k = j + sub;                 // this lane's row: v0 + k
    const int g = __shfl_sync(0xffffffffu, ids, k);
    if (v0 + k < num_nodes) {
      if (g != cur) {
        cur = g;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          load_vec<float, F>(dpooled + (size_t)g * H + (col + w * LC) * F, d[w]);
      }
#pragma unroll
      for (int w = 0; w < NW; ++w)
        store_vec<T, F>(dx + (size_t)(v0 + k) * H + (col + w * LC) * F, d[w]);
    }
  }
}

template <typename T, int H>
cudaError_t launch_bwd_h(const float* dpooled, const int* node_graph, int num_nodes, void* dx,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = kBwdWarps * kRun;
  pool_bwd_kernel<T, H><<<(num_nodes + kRowsPerBlock - 1) / kRowsPerBlock, kBwdWarps * 32, 0,
                          stream>>>(dpooled, node_graph, num_nodes, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const float* dpooled, const int* node_graph, int num_nodes, int h,
                       void* dx, cudaStream_t stream) {
  switch (h) {
    case 32: return launch_bwd_h<T, 32>(dpooled, node_graph, num_nodes, dx, stream);
    case 64: return launch_bwd_h<T, 64>(dpooled, node_graph, num_nodes, dx, stream);
    case 128: return launch_bwd_h<T, 128>(dpooled, node_graph, num_nodes, dx, stream);
    case 256: return launch_bwd_h<T, 256>(dpooled, node_graph, num_nodes, dx, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4.  dtype: 0 = float32, 1 = bfloat16; h in {32, 64, 128, 256}; x [V, H]
// 16-byte aligned; node_graph [V] int32, non-decreasing, in [0, G1); out
// [G1, H] f32; scratch part [ceil(V / 32), 2, H] f32 and span [G1, 2] int32
// (no need to clear); arrivals [G1] int32, zeros, left zeros.
int pool_launch(const void* x, int dtype, const int* node_graph, int num_nodes, int h,
                int num_segments, float* out, float* part, int* span, int* arrivals,
                cudaStream_t stream) {
  if (num_segments <= 0 || num_nodes <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, node_graph, num_nodes, h, num_segments, out, part,
                                      span, arrivals, stream);
  if (dtype == 0)
    return (int)launch<float>(x, node_graph, num_nodes, h, num_segments, out, part, span,
                              arrivals, stream);
  return (int)cudaErrorInvalidValue;
}

// K7.  dtype (of dx): 0 = float32, 1 = bfloat16; h in {32, 64, 128, 256};
// dpooled [G1, H] f32 and dx [V, H], both 16-byte aligned; node_graph [V]
// int32 in [0, G1), in any order (sorted is fastest).
int pool_bwd_launch(const float* dpooled, const int* node_graph, int num_nodes, int h,
                    int dtype, void* dx, cudaStream_t stream) {
  if (num_nodes <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(dpooled, node_graph, num_nodes, h, dx, stream);
  if (dtype == 0) return (int)launch_bwd<float>(dpooled, node_graph, num_nodes, h, dx, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
