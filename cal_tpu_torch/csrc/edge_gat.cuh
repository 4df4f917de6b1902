// Shared device code of the edge-formulated dense GAT kernels (edge_gat.cu:
// the per-batch edge index and the forward; edge_gat_bwd.cu: the backward).
// Included by both sources; it is not a build target of its own.
//
// The walk's unit is csr_rows.cuh's: a lane group of G lanes covers a node's
// heads * d columns, F consecutive columns a lane (32 bytes where a head is
// that wide), so 32 / G nodes a warp.  A row (or a sender) of at most kSpan
// slots is light: one group walks it, addressed by node from the index's
// list.  A heavier one is cut into kSpan-slot chunks, each a group's item,
// listed in the index with the place of the row's first chunk; each chunk
// writes a partial there, and the row's last chunk to arrive (an int counter
// at that place, 0 between launches) merges the partials in chunk order and
// writes the row.  No float is summed atomically: every sum has one owner
// and one order, so two calls give the same bits.  Control flow is uniform
// within a group, and every shuffle names the group's lanes only.
#pragma once

#include <math.h>

#include "csr_rows.cuh"

namespace {

constexpr int kSpan = kGroup;        // 32 slots: = cal_tpu_torch.ops.edge_gat.SPAN
constexpr int kThreads = 256;
constexpr float kNegSlope = 0.2f;
constexpr uint64_t kSelfCounter = 1ull << 40;

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

// keep bit of one (slot, head) or (node, head) counter under the 64-bit
// seed at ``seed`` in device memory (seed[0] its low word, the key's k0),
// read here, so a captured launch (a CUDA graph) takes the seed that the
// host wrote there before each replay; thresh 0 keeps all and reads nothing
__device__ __forceinline__ bool keep_at(uint64_t ctr, const uint32_t* seed, uint32_t thresh) {
  return thresh == 0 || philox_bits(ctr, __ldg(seed), __ldg(seed + 1)) >= thresh;
}

// The columns of a node at heads * d = HD: F a lane (16 bytes of T twice, or
// a head's d when narrower), G = HD / F lanes a node, LPH lanes a head, K
// slots a lane over a kSpan-slot span, W 32-bit words of a lane's columns.
template <typename T, int HEADS, int HD>
struct Shape {
  static constexpr int D = HD / HEADS;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int F = 2 * kVec < D ? 2 * kVec : D;
  static constexpr int G = HD / F;
  static constexpr int LPH = D / F;
  static constexpr int K = kSpan / G;
  static constexpr int W = F * (int)sizeof(T) / 4;
  static_assert(G >= 1 && G <= 32 && K >= 1 && LPH >= 1, "a node's columns fit a warp");
};

// A lane's place in its group: gl, the group's first lane in the warp and
// the mask of the group's lanes.
struct Lane {
  int gl, base;
  unsigned mask;
};

template <int G>
__device__ __forceinline__ Lane lane_of() {
  const int lane = threadIdx.x & 31;
  Lane l;
  l.gl = lane & (G - 1);
  l.base = lane - l.gl;
  l.mask = G == 32 ? kFull : ((1u << G) - 1u) << l.base;
  return l;
}

// sum / max over the N lanes (a power of two, aligned) that hold v
template <int N>
__device__ __forceinline__ float lanes_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

template <int N>
__device__ __forceinline__ float lanes_max(float v, unsigned mask) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

// a[h] for a head h known only at run time, without indexing registers
template <int H>
__device__ __forceinline__ float pick(const float (&a)[H], int h) {
  float r = a[0];
#pragma unroll
  for (int i = 1; i < H; ++i)
    if (i == h) r = a[i];
  return r;
}

// the H per-head f32 values of one node or slot (p aligned to min(16, 4 H) bytes)
template <int H>
__device__ __forceinline__ void load_heads(const float* __restrict__ p, float (&v)[H]) {
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (H == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// the same for values other SMs wrote in this launch (read from L2)
template <int H>
__device__ __forceinline__ void load_heads_cg(const float* p, float (&v)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) v[h] = __ldcg(p + h);
}

template <int H>
__device__ __forceinline__ void store_heads(float* __restrict__ p, const float (&v)[H]) {
  store_vec<float, H>(p, v);
}

// The per-batch edge index on the device (ops/edge_gat.py EdgeIndex): node
// ranges of both orders, the slot -> sender-order map, the receiver of each
// sender-order place, the light and heavy item lists with their counts, and
// the arrival counters of the heavy rows (receiver and sender side).
struct Index {
  const int2* rrange;   // [rows] (first, end) slot of node v as receiver; (0, 0): none
  const int2* srange;   // [rows] (first, end) sender-order place of node u as sender
  const int* spos;      // [E] the sender-order place of slot e
  const int* srecv;     // [E] the receiver node at sender-order place p (-1: padding)
  const int* light_r;   // [counts[0]] nodes of 1..kSpan receiver slots
  const int2* heavy_r;  // [counts[1]] (node, place of its first chunk) per receiver chunk
  const int* light_s;   // [counts[2]] nodes of 1..kSpan sender slots, and live receivers of none
  const int2* heavy_s;  // [counts[3]] as heavy_r over sender runs
  const int* counts;
  int* arr_r;           // [cap_h] arrival counters at a heavy row's first place
  int* arr_s;
};

__host__ inline Index index_from(void* const* p) {
  Index ix;
  ix.rrange = static_cast<const int2*>(p[0]);
  ix.srange = static_cast<const int2*>(p[1]);
  ix.spos = static_cast<const int*>(p[2]);
  ix.srecv = static_cast<const int*>(p[3]);
  ix.light_r = static_cast<const int*>(p[4]);
  ix.heavy_r = static_cast<const int2*>(p[5]);
  ix.light_s = static_cast<const int*>(p[6]);
  ix.heavy_s = static_cast<const int2*>(p[7]);
  ix.counts = static_cast<const int*>(p[8]);
  ix.arr_r = static_cast<int*>(p[9]);
  ix.arr_s = static_cast<int*>(p[10]);
  return ix;
}

// A heavy item: chunk c of node v, whose chunks take places [p0, p0 + n) of
// the list; its slots (or sender-order places) [beg, end).
struct Chunk2 {
  int v, p0, n, beg, end;
};

__device__ __forceinline__ Chunk2 heavy_item(const int2* __restrict__ list,
                                             const int2* __restrict__ range, int c) {
  const int2 hc = list[c];
  const int2 rr = range[hc.x];
  Chunk2 k;
  k.v = hc.x;
  k.p0 = hc.y;
  k.n = (rr.y - rr.x + kSpan - 1) / kSpan;
  k.beg = rr.x + (c - hc.y) * kSpan;
  k.end = min(k.beg + kSpan, rr.y);
  return k;
}

// The step between a persistent walk's items for group g of the grid's
// groups: with fewer heavy chunks than groups, group g < nh walks heavy
// chunk g alone and the others share the light nodes, so a hub's chunks
// and their merge run beside the light rows, not before a full share of
// them (round robin over all groups, the walk took the two parts' times
// added: PERF.md §6); else round robin.
__device__ __forceinline__ int walk_stride(int g, int nh, int items, int groups) {
  if (nh >= groups) return groups;
  return g < nh ? items : groups - nh;
}

// Item it of a walk's list (heavy chunks, then light nodes): its node and
// span, c = it for a heavy chunk, else -1.
__device__ __forceinline__ Chunk2 walk_item(const int2* __restrict__ heavy,
                                            const int* __restrict__ light,
                                            const int2* __restrict__ range, int nh, int it,
                                            int& c) {
  Chunk2 k = {0, 0, 0, 0, 0};
  c = -1;
  if (it < nh) {
    k = heavy_item(heavy, range, it);
    c = it;
  } else {
    k.v = light[it - nh];
    const int2 rr = range[k.v];
    k.beg = rr.x;
    k.end = rr.y;
  }
  return k;
}

// Whether this group's chunk arrived last of the row's n at arrivals[p0]:
// the chunk's partial stores are made visible first.  Group-uniform result.
__device__ __forceinline__ bool arrived_last(int* arrivals, int p0, int n, const Lane& L) {
  __threadfence();
  __syncwarp(L.mask);
  int last = 0;
  if (L.gl == 0) last = atomicAdd(arrivals + p0, 1) == n - 1;
  last = __shfl_sync(L.mask, last, L.base);
  if (last) __threadfence();
  return last != 0;
}

// The resident blocks of a kernel at kThreads a block on every SM: the grid
// of a persistent launch, whose item count lives on the device.  Callers
// keep it in a static of their own instance.
__host__ inline int persistent_blocks(const void* kern) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, 0);
  return sms * (per > 0 ? per : 1);
}

__host__ inline bool bad_shape(int heads, int hd) {
  return (heads != 1 && heads != 2 && heads != 4 && heads != 8) ||
         (hd != 32 && hd != 64 && hd != 128 && hd != 256);
}

// f(T, HEADS, HD) for the run-time dtype (0 f32, 1 bf16), heads and width
template <template <typename, int, int> class L, typename... A>
int dispatch(int dtype, int heads, int hd, A... args) {
#define EDGE_GAT_HD(T, H)                                   \
  switch (hd) {                                             \
    case 32: return L<T, H, 32>::run(args...);              \
    case 64: return L<T, H, 64>::run(args...);              \
    case 128: return L<T, H, 128>::run(args...);            \
    case 256: return L<T, H, 256>::run(args...);            \
  }                                                         \
  return (int)cudaErrorInvalidValue;
#define EDGE_GAT_HEADS(T)                                   \
  switch (heads) {                                          \
    case 1: { EDGE_GAT_HD(T, 1) }                           \
    case 2: { EDGE_GAT_HD(T, 2) }                           \
    case 4: { EDGE_GAT_HD(T, 4) }                           \
    case 8: { EDGE_GAT_HD(T, 8) }                           \
  }                                                         \
  return (int)cudaErrorInvalidValue;
  if (dtype == 0) { EDGE_GAT_HEADS(float) }
  if (dtype == 1) { EDGE_GAT_HEADS(__nv_bfloat16) }
#undef EDGE_GAT_HEADS
#undef EDGE_GAT_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace
