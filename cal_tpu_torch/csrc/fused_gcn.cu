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
// Bound on this card: bytes in bf16 (adj + the x and out planes, ~50 MB for
// the dual mode at B=128, N=256, H=128, against 4.3 GFLOP of products); in
// f32 the products on the CUDA cores (no tensor cores, to keep full f32) are
// the bound.
// Design: a degree pass (one block per 32 columns of a graph, 8 row groups
// reduced in shared memory) writes deg^-1/2 and 1/deg of each branch to a
// [2 * branches, B, N] f32 scratch.  The aggregate is a row-tiled product: one
// block per (64 rows of one graph, 128 feature columns) walks the senders in
// steps of 32, builds each branch's norm tile from adj/src/dst in shared memory
// (the weights and the [N, N] products never reach device memory) and stages
// the x tiles.  bf16 runs the products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate: exactly the contract's rounding), each
// of 8 warps owning 32 rows x 32 columns of every branch; the sender factors
// (src, deg^-1/2) sit in shared memory for the whole block, and the next
// step's adjacency and x chunks are loaded into registers while the current
// step's products run (plain-T reads the adjacency down a column, one element
// at a time).  f32 keeps full f32 FMA on the CUDA cores, 4 rows x 8 columns
// per branch and thread, without that prefetch.  The modes are compile-time:
// a single-branch mode runs half the dual mode's products and no sigmoid.
// The adjacency is read twice (degree pass and aggregate) and x once per row
// tile, mostly from L2; TMA, deeper pipelines and wgmma are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
    float m[NB];
    weigh<M == kPlainT ? kPlain : M>(to_f(a[(size_t)r * N + s]),
                                     edge_sigmoid<T, M>(srcb, dstb, r, s), m);
#pragma unroll
    for (int br = 0; br < NB; ++br)
      nv[br] = round_t<T>(__fmul_rn(__fmul_rn(m[br], dis[br][s]), dis[br][r]));
  }
}

constexpr int kDegCols = 32, kDegGroups = kThreads / kDegCols;

// stats layout: [2 br] deg^-1/2, [2 br + 1] 1/deg of branch br, each [B, N].
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
degree_kernel(const T* __restrict__ adj, const T* __restrict__ src,
              const T* __restrict__ dst, float* __restrict__ stats, int B, int N) {
  constexpr int NB = Nb<M>::v;
  __shared__ float part[NB][kDegGroups][kDegCols];
  const int b = blockIdx.y;
  const int tx = threadIdx.x % kDegCols, ty = threadIdx.x / kDegCols;
  const int s = blockIdx.x * kDegCols + tx;
  const T* a = adj + (size_t)b * N * N;
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;
  float sum[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) sum[br] = 0.f;
  if (s < N) {
    for (int r = ty; r < N; r += kDegGroups) {
      if (r == s) continue;
      float m[NB];
      weigh<M>(to_f(a[(size_t)r * N + s]), edge_sigmoid<T, M>(srcb, dstb, r, s), m);
#pragma unroll
      for (int br = 0; br < NB; ++br) sum[br] += m[br];
    }
  }
#pragma unroll
  for (int br = 0; br < NB; ++br) part[br][ty][tx] = sum[br];
  __syncthreads();
  if (ty != 0 || s >= N) return;
  const size_t plane = (size_t)B * N, i = (size_t)b * N + s;
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    for (int g = 1; g < kDegGroups; ++g) sum[br] += part[br][g][tx];
    const float deg = sum[br] + 1.0f;
    stats[2 * br * plane + i] = rsqrtf(deg);
    stats[(2 * br + 1) * plane + i] = 1.0f / deg;
  }
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

// f32: full-f32 FMA on the CUDA cores.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
aggregate_fma_kernel(const T* __restrict__ adj, const T* __restrict__ x0,
                     const T* __restrict__ x1, const T* __restrict__ src,
                     const T* __restrict__ dst, const float* __restrict__ stats,
                     T* __restrict__ o0, T* __restrict__ o1, int B, int N, int H) {
  constexpr int NB = Nb<M>::v;
  extern __shared__ float smem[];
  float* xs = smem;                           // [NB][kStep][kCols]
  float* ns = xs + NB * kStep * kCols;        // [NB][kRows][kStep + 1]

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 + i; cols tx*4 + j and 64 + tx*4 + j

  const T* x[NB];
  const float* dis[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    x[br] = rows_of(x0, x1, br, b, N, H);
    dis[br] = plane_of(stats, 2 * br, b, B, N);
  }
  const T* a = adj + (size_t)b * N * N;
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;

  float acc[NB][4][8];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[br][i][j] = 0.f;

  for (int s0 = 0; s0 < N; s0 += kStep) {
    for (int i = tid; i < kStep * kCols; i += kThreads) {
      const int k = i / kCols, c = i % kCols;
      const int s = s0 + k, col = h0 + c;
      const bool ok = s < N && col < H;
#pragma unroll
      for (int br = 0; br < NB; ++br)
        xs[br * kStep * kCols + i] = ok ? to_f(x[br][(size_t)s * H + col]) : 0.f;
    }
    for (int i = tid; i < kRows * kStep; i += kThreads) {
      const int rr = i / kStep, k = i % kStep;
      float nv[NB];
      norm_of<T, M>(a, srcb, dstb, dis, r0 + rr, s0 + k, N, nv);
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
            acc[br][i][j], __fmul_rn(to_f(x[br][at]), plane_of(stats, 2 * br + 1, b, B, N)[r])));
    }
  }
}

// bf16: tensor-core products (mma.sync m16n8k16, f32 accumulate).
constexpr int kALd = kStep + 8;   // norm tile row pitch (bf16), 80 B: ldmatrix without bank conflicts
constexpr int kBLd = kCols + 8;   // x tile row pitch (bf16), 272 B

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

template <int M>
__global__ void __launch_bounds__(kThreads, 2)
aggregate_mma_kernel(const __nv_bfloat16* __restrict__ adj,
                     const __nv_bfloat16* __restrict__ x0,
                     const __nv_bfloat16* __restrict__ x1,
                     const __nv_bfloat16* __restrict__ src,
                     const __nv_bfloat16* __restrict__ dst,
                     const float* __restrict__ stats, __nv_bfloat16* __restrict__ o0,
                     __nv_bfloat16* __restrict__ o1, int B, int N, int H) {
  using bf16 = __nv_bfloat16;
  constexpr int NB = Nb<M>::v;
  constexpr bool kLogits = M != kPlain && M != kPlainT;
  extern __shared__ float fs[];                          // per sender: src, dis of each branch
  __shared__ __align__(16) bf16 As[NB][kRows * kALd];   // norm tiles [row][sender]
  __shared__ __align__(16) bf16 Bs[NB][kStep * kBLd];   // x tiles [sender][column]

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // warp owns rows wm*32.., columns wn*32..

  // the output planes and 1/deg are formed in the epilogue only (registers)
  const bf16* xb[NB];
  const float* dis[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    xb[br] = rows_of(x0, x1, br, b, N, H);
    dis[br] = plane_of(stats, 2 * br, b, B, N);
  }
  const bf16* a = adj + (size_t)b * N * N;
  const bf16* srcb = src + (size_t)b * N;
  const bf16* dstb = dst + (size_t)b * N;
  const bool vec_x =
      H % 8 == 0 && ((reinterpret_cast<uintptr_t>(x0) |
                      reinterpret_cast<uintptr_t>(NB == 2 ? x1 : x0)) % 16) == 0;
  const bool vec_a = M != kPlainT && N % 8 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < N; i += kThreads) {
    if constexpr (kLogits) fs[i] = to_f(srcb[i]);
#pragma unroll
    for (int br = 0; br < NB; ++br) fs[(1 + br) * N + i] = dis[br][i];
  }
  // each thread builds 8 senders of one row of the norm tiles
  const int rr = tid / 4, g = tid % 4, r = r0 + rr;
  const bool row_ok = r < N;
  const float dst_r = kLogits && row_ok ? to_f(dstb[r]) : 0.f;
  float dis_r[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) dis_r[br] = row_ok ? dis[br][r] : 0.f;

  // the next step's adjacency and x chunks travel in registers while the
  // current step's products run
  uint4 areg, xreg[2 * NB];
  auto load = [&](int s0) {
    const int s = s0 + g * 8;
    if (row_ok && vec_a && s < N) {
      areg = *reinterpret_cast<const uint4*>(a + (size_t)r * N + s);
    } else {
      alignas(16) bf16 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = M == kPlainT ? (size_t)(s + j) * N + r : (size_t)r * N + s + j;
        t[j] = (row_ok && s + j < N) ? a[at] : zero;
      }
      areg = *reinterpret_cast<const uint4*>(t);
    }
#pragma unroll
    for (int j = 0; j < 2 * NB; ++j) {
      const int idx = tid + (j % 2) * kThreads;
      const int k = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
      const int sk = s0 + k, col = h0 + c;
      const bf16* xp = xb[j / 2] + (size_t)sk * H + col;
      if (vec_x && sk < N && col + 8 <= H) {
        xreg[j] = *reinterpret_cast<const uint4*>(xp);
      } else {
        alignas(16) bf16 t[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) t[q] = (sk < N && col + q < H) ? xp[q] : zero;
        xreg[j] = *reinterpret_cast<const uint4*>(t);
      }
    }
  };
  auto store = [&](int s0) {
    const bf16* av = reinterpret_cast<const bf16*>(&areg);
    alignas(16) bf16 n8[NB][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + g * 8 + j;
      float nv[NB];
#pragma unroll
      for (int br = 0; br < NB; ++br) nv[br] = 0.f;
      if (row_ok && s < N && s != r) {
        float m[NB];
        weigh<M == kPlainT ? kPlain : M>(__bfloat162float(av[j]),
                                         kLogits ? sigmoid(fs[s] + dst_r) : 0.f, m);
#pragma unroll
        for (int br = 0; br < NB; ++br) {
          const float dis_s = fs[(1 + br) * N + s];
          // (m * dis_sender) * dis_receiver; the sender of plain-T's entry is r
          nv[br] = M == kPlainT ? __fmul_rn(__fmul_rn(m[br], dis_r[br]), dis_s)
                                : __fmul_rn(__fmul_rn(m[br], dis_s), dis_r[br]);
        }
      }
#pragma unroll
      for (int br = 0; br < NB; ++br) n8[br][j] = __float2bfloat16(nv[br]);
    }
#pragma unroll
    for (int br = 0; br < NB; ++br)
      *reinterpret_cast<uint4*>(&As[br][rr * kALd + g * 8]) =
          *reinterpret_cast<const uint4*>(n8[br]);
#pragma unroll
    for (int j = 0; j < 2 * NB; ++j) {
      const int idx = tid + (j % 2) * kThreads;
      const int k = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[j / 2][k * kBLd + c]) = xreg[j];
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

  load(0);
  __syncthreads();   // sender factors staged
  for (int s0 = 0; s0 < N; s0 += kStep) {
    store(s0);
    __syncthreads();
    if (s0 + kStep < N) load(s0 + kStep);
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
#pragma unroll
      for (int br = 0; br < NB; ++br) {
        unsigned af[2][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(af[mt], &As[br][(wm * 32 + mt * 16 + lane % 16) * kALd + kk + (lane / 16) * 8]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned t[4];
          ldsm_x4_trans(t, &Bs[br][(kk + lane % 8 + ((lane / 8) % 2) * 8) * kBLd +
                                   wn * 32 + np * 16 + (lane / 16) * 8]);
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
    __syncthreads();
  }

#pragma unroll
  for (int br = 0; br < NB; ++br) {
    const float* inv = plane_of(stats, 2 * br + 1, b, B, N);
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
          const float xv = __bfloat162float(xb[br][at]);
          out[at] = __float2bfloat16(__fadd_rn(acc[br][mt][nt][f], __fmul_rn(xv, inv[r])));
        }
  }
}

template <typename T, int M>
int launch_degree(const void* adj, const void* src, const void* dst, float* stats,
                  int B, int N, cudaStream_t stream) {
  // plain-T's degree is plain's: M's column sums
  constexpr int MD = M == kPlainT ? kPlain : M;
  dim3 grid((N + kDegCols - 1) / kDegCols, B);
  degree_kernel<T, MD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(adj), static_cast<const T*>(src), static_cast<const T*>(dst),
      stats, B, N);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd_f32(const void* adj, const void* x0, const void* x1, const void* src,
                   const void* dst, void* o0, void* o1, float* stats, int B, int N, int H,
                   cudaStream_t stream) {
  constexpr int NB = Nb<M>::v;
  int err = launch_degree<float, M>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const size_t smem = NB * (kStep * kCols + kRows * (kStep + 1)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(aggregate_fma_kernel<float, M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  aggregate_fma_kernel<float, M><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(adj), static_cast<const float*>(x0),
      static_cast<const float*>(x1), static_cast<const float*>(src),
      static_cast<const float*>(dst), stats, static_cast<float*>(o0),
      static_cast<float*>(o1), B, N, H);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd_bf16(const void* adj, const void* x0, const void* x1, const void* src,
                    const void* dst, void* o0, void* o1, float* stats, int B, int N, int H,
                    cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int NB = Nb<M>::v;
  int err = launch_degree<bf16, M>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const size_t smem = (1 + NB) * (size_t)N * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(aggregate_mma_kernel<M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  aggregate_mma_kernel<M><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(adj), static_cast<const bf16*>(x0),
      static_cast<const bf16*>(x1), static_cast<const bf16*>(src),
      static_cast<const bf16*>(dst), stats, static_cast<bf16*>(o0),
      static_cast<bf16*>(o1), B, N, H);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fwd(int dtype, const void* adj, const void* x0, const void* x1, const void* src,
               const void* dst, void* o0, void* o1, float* stats, int B, int N, int H,
               cudaStream_t stream) {
  if (dtype == 0) return launch_fwd_f32<M>(adj, x0, x1, src, dst, o0, o1, stats, B, N, H, stream);
  if (dtype == 1) return launch_fwd_bf16<M>(adj, x0, x1, src, dst, o0, o1, stats, B, N, H, stream);
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
// Bound on this card at B=128, N=256, H=128: three products per branch, 12.9
// GFLOP for the dual mode.  In bf16 the 67 MB of traffic bound it (0.020 ms;
// the products at the tensor cores' bf16 rate take 0.013 ms); in f32 the
// products on the CUDA cores do (0.19 ms).  This version runs the products
// with f32 FMA on the CUDA cores in both dtypes, so bf16 cannot come near its
// bound.
// Design: t_s needs the whole column product p_s and row product u_s, and
// dsrc needs column sums over every receiver, so the work is split into
// passes (the TPU kernel holds a whole [N, N] graph in VMEM instead):
//   1. the forward's degree pass (deg^-1/2 and 1/deg of each branch);
//   2. a node pass, one block per 32 nodes of a graph: for its nodes both
//      as receivers (u, rows of m) and as senders (p, columns of m) it
//      rebuilds each branch's m tiles from adj/src/dst in shared memory,
//      runs the two products per branch with f32 FMA, writes dx, and reduces
//      the three per-node dot products into t (an f32 [2, B, N] scratch);
//   3. an edge pass, one block per 64 x 64 (receiver, sender) tile: G of each
//      branch by f32 FMA, then dm and dpre in registers, row sums and
//      column sums of the tile into f32 partial planes;
//   4. a finalize pass summing the partial planes and casting once.
// No atomics: the sums are deterministic.  The [N, N] intermediates never
// reach device memory.  Tensor cores (mma.sync/wgmma) are later work.

constexpr int kNodeRows = 32;   // nodes per block (node pass)
constexpr int kNodeCols = 128;  // feature columns per chunk (node pass)
constexpr int kNodeK = 16;      // neighbours per step (node pass)
constexpr int kEdgeTile = 64;   // receivers x senders per block (edge pass)
constexpr int kEdgeK = 16;      // feature columns per step (edge pass)

__host__ __device__ __forceinline__ int n_tiles(int N) {
  return (N + kEdgeTile - 1) / kEdgeTile;
}

// each branch's m[r, s] (f32, as the forward builds it), rounded to T
template <typename T, int M>
__device__ __forceinline__ void m_of(const T* a, const T* srcb, const T* dstb, int r, int s,
                                     int N, float (&m)[Nb<M>::v]) {
#pragma unroll
  for (int br = 0; br < Nb<M>::v; ++br) m[br] = 0.f;
  if (r < N && s < N && r != s) {
    weigh<M>(to_f(a[(size_t)r * N + s]), edge_sigmoid<T, M>(srcb, dstb, r, s), m);
#pragma unroll
    for (int br = 0; br < Nb<M>::v; ++br) m[br] = round_t<T>(m[br]);
  }
}

// two blocks an SM: at most 128 registers a thread
template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 2)
bwd_node_kernel(const T* __restrict__ adj, const T* __restrict__ x0,
                const T* __restrict__ x1, const T* __restrict__ g0,
                const T* __restrict__ g1, const T* __restrict__ src,
                const T* __restrict__ dst, const float* __restrict__ stats,
                T* __restrict__ dx0, T* __restrict__ dx1, float* __restrict__ tvec,
                int B, int N, int H) {
  constexpr int NB = Nb<M>::v;
  __shared__ float mrow[NB][kNodeRows][kNodeK + 1];   // m[n0 + i, k0 + k]
  __shared__ float mcol[NB][kNodeRows][kNodeK + 1];   // m[k0 + k, n0 + i]
  __shared__ __align__(16) float xd[NB][kNodeK][kNodeCols];   // T(dis_k x_k)
  __shared__ __align__(16) float gd[NB][kNodeK][kNodeCols];   // T(dis_k g_k)

  const int n0 = blockIdx.x * kNodeRows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*2 + i; cols tx*4 + j and 64 + tx*4 + j
  const T* x[NB];
  const T* g[NB];
  T* dx[NB];
  const float* dis[NB];
  const float* inv[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    x[br] = rows_of(x0, x1, br, b, N, H);
    g[br] = rows_of(g0, g1, br, b, N, H);
    dx[br] = rows_of(dx0, dx1, br, b, N, H);
    dis[br] = plane_of(stats, 2 * br, b, B, N);
    inv[br] = plane_of(stats, 2 * br + 1, b, B, N);
  }
  const T* a = adj + (size_t)b * N * N;
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;

  float gu[NB][2], pxs[NB][2], gx[NB][2];   // [branch][row] partial dot products
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i) gu[br][i] = pxs[br][i] = gx[br][i] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kNodeCols) {
    float u[NB][2][8], p[NB][2][8];
#pragma unroll
    for (int br = 0; br < NB; ++br)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) u[br][i][j] = p[br][i][j] = 0.f;

    for (int k0 = 0; k0 < N; k0 += kNodeK) {
      for (int e = tid; e < kNodeRows * kNodeK; e += kThreads) {
        const int i = e / kNodeK, k = e % kNodeK;
        float m[NB];
        m_of<T, M>(a, srcb, dstb, n0 + i, k0 + k, N, m);
#pragma unroll
        for (int br = 0; br < NB; ++br) mrow[br][i][k] = m[br];
        m_of<T, M>(a, srcb, dstb, k0 + k, n0 + i, N, m);
#pragma unroll
        for (int br = 0; br < NB; ++br) mcol[br][i][k] = m[br];
      }
      for (int e = tid; e < NB * kNodeK * kNodeCols; e += kThreads) {
        const int br = e / (kNodeK * kNodeCols), rem = e % (kNodeK * kNodeCols);
        const int k = rem / kNodeCols, c = rem % kNodeCols;
        const int nk = k0 + k, col = h0 + c;
        float xv = 0.f, gv = 0.f;
        if (nk < N && col < H) {
          const size_t at = (size_t)nk * H + col;
          xv = round_t<T>(__fmul_rn(to_f(x[br][at]), dis[br][nk]));
          gv = round_t<T>(__fmul_rn(to_f(g[br][at]), dis[br][nk]));
        }
        xd[br][k][c] = xv;
        gd[br][k][c] = gv;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kNodeK; ++k) {
#pragma unroll
        for (int br = 0; br < NB; ++br) {
          const float4 x0v = *reinterpret_cast<const float4*>(&xd[br][k][tx * 4]);
          const float4 x1v = *reinterpret_cast<const float4*>(&xd[br][k][64 + tx * 4]);
          const float4 g0v = *reinterpret_cast<const float4*>(&gd[br][k][tx * 4]);
          const float4 g1v = *reinterpret_cast<const float4*>(&gd[br][k][64 + tx * 4]);
          const float xv[8] = {x0v.x, x0v.y, x0v.z, x0v.w, x1v.x, x1v.y, x1v.z, x1v.w};
          const float gv[8] = {g0v.x, g0v.y, g0v.z, g0v.w, g1v.x, g1v.y, g1v.z, g1v.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float ar = mrow[br][ty * 2 + i][k], ac = mcol[br][ty * 2 + i][k];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              u[br][i][j] = fmaf(ar, xv[j], u[br][i][j]);
              p[br][i][j] = fmaf(ac, gv[j], p[br][i][j]);
            }
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int br = 0; br < NB; ++br)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + ty * 2 + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
          if (col >= H) continue;
          const size_t at = (size_t)n * H + col;
          const float gv = to_f(g[br][at]), xv = to_f(x[br][at]);
          const float pv = p[br][i][j];
          dx[br][at] = from_f<T>(
              __fadd_rn(__fmul_rn(pv, dis[br][n]), __fmul_rn(gv, inv[br][n])));
          gu[br][i] += gv * u[br][i][j];
          pxs[br][i] += pv * xv;
          gx[br][i] += gv * xv;
        }
      }
  }

  // the 16 lanes of a half warp share a row: reduce, then one lane writes t
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float vu = gu[br][i], vp = pxs[br][i], vx = gx[br][i];
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        vu += __shfl_xor_sync(0xffffffffu, vu, off);
        vp += __shfl_xor_sync(0xffffffffu, vp, off);
        vx += __shfl_xor_sync(0xffffffffu, vx, off);
      }
      const int n = n0 + ty * 2 + i;
      if (tx == 0 && n < N) {
        const float d = dis[br][n], iv = inv[br][n];
        tvec[(br * (size_t)B + b) * N + n] = -0.5f * (vu + vp) * d * d * d - vx * iv * iv;
      }
    }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
bwd_edge_kernel(const T* __restrict__ adj, const T* __restrict__ x0,
                const T* __restrict__ x1, const T* __restrict__ g0,
                const T* __restrict__ g1, const T* __restrict__ src,
                const T* __restrict__ dst, const float* __restrict__ stats,
                const float* __restrict__ tvec, float* __restrict__ part_src,
                float* __restrict__ part_dst, int B, int N, int H) {
  constexpr int NB = Nb<M>::v;
  __shared__ __align__(16) float gs[NB][kEdgeK][kEdgeTile];   // g[r0 + i, h0 + k]
  __shared__ __align__(16) float xs[NB][kEdgeK][kEdgeTile];   // x[s0 + j, h0 + k]
  __shared__ float colsum[kThreads / 16][kEdgeTile];

  const int r0 = blockIdx.x * kEdgeTile, s0 = blockIdx.y * kEdgeTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4 + i, columns tx*4 + j
  const T* x[NB];
  const T* g[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    x[br] = rows_of(x0, x1, br, b, N, H);
    g[br] = rows_of(g0, g1, br, b, N, H);
  }

  float acc[NB][4][4];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[br][i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kEdgeK) {
    for (int e = tid; e < NB * kEdgeK * kEdgeTile; e += kThreads) {
      const int br = e / (kEdgeK * kEdgeTile), rem = e % (kEdgeK * kEdgeTile);
      const int k = rem / kEdgeTile, i = rem % kEdgeTile;
      const int col = h0 + k;
      const int r = r0 + i, s = s0 + i;
      gs[br][k][i] = (r < N && col < H) ? to_f(g[br][(size_t)r * H + col]) : 0.f;
      xs[br][k][i] = (s < N && col < H) ? to_f(x[br][(size_t)s * H + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kEdgeK; ++k) {
#pragma unroll
      for (int br = 0; br < NB; ++br) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[br][k][ty * 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&xs[br][k][tx * 4]);
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[br][i][j] = fmaf(ga[i], xa[j], acc[br][i][j]);
      }
    }
    __syncthreads();
  }

  const float* dis[NB];
  const float* tv[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
    dis[br] = plane_of(stats, 2 * br, b, B, N);
    tv[br] = plane_of(tvec, br, b, B, N);
  }
  const T* a = adj + (size_t)b * N * N;
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;
  float rows[4] = {0.f, 0.f, 0.f, 0.f}, cols[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      float dpre = 0.f;
      if (r < N && s < N && r != s) {
        const float av = to_f(a[(size_t)r * N + s]);
        const float sg = sigmoid(to_f(srcb[s]) + to_f(dstb[r]));
        float dm[NB];
#pragma unroll
        for (int br = 0; br < NB; ++br)
          dm[br] = acc[br][i][j] * dis[br][s] * dis[br][r] + tv[br][s];
        const float dw = NB == 2 ? dm[0] - dm[NB - 1] : dm[0];
        dpre = dw * av * (sg * (1.0f - sg));
        if (M == kNeg) dpre = -dpre;
      }
      rows[i] += dpre;
      cols[j] += dpre;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = rows[i];
#pragma unroll
    for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int r = r0 + ty * 4 + i;
    if (tx == 0 && r < N) part_dst[((size_t)b * n_tiles(N) + blockIdx.y) * N + r] = v;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) colsum[ty][tx * 4 + j] = cols[j];
  __syncthreads();
  if (tid < kEdgeTile && s0 + tid < N) {
    float v = 0.f;
    for (int q = 0; q < kThreads / 16; ++q) v += colsum[q][tid];
    part_src[((size_t)b * n_tiles(N) + blockIdx.x) * N + s0 + tid] = v;
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

// scratch (f32): stats [4, B, N] | t [2, B, N] | part_src, part_dst [B, tiles, N]
// (the dual mode's sizes; a single branch uses the first half of stats and t)
size_t bwd_scratch_floats(int B, int N) {
  return (size_t)B * N * (6 + 2 * (size_t)n_tiles(N));
}

template <typename T, int M>
int launch_bwd(const void* adj, const void* x0, const void* x1, const void* src,
               const void* dst, const void* g0, const void* g1, void* dx0, void* dx1,
               void* dsrc, void* ddst, float* scratch, int B, int N, int H,
               cudaStream_t stream) {
  const size_t plane = (size_t)B * N;
  float* stats = scratch;
  float* tvec = stats + 4 * plane;
  float* part_src = tvec + 2 * plane;
  float* part_dst = part_src + plane * n_tiles(N);
  int err = launch_degree<T, M>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const T *a = static_cast<const T*>(adj), *x0_ = static_cast<const T*>(x0),
          *x1_ = static_cast<const T*>(x1), *g0_ = static_cast<const T*>(g0),
          *g1_ = static_cast<const T*>(g1), *s_ = static_cast<const T*>(src),
          *d_ = static_cast<const T*>(dst);
  bwd_node_kernel<T, M><<<dim3((N + kNodeRows - 1) / kNodeRows, B), kThreads, 0, stream>>>(
      a, x0_, x1_, g0_, g1_, s_, d_, stats, static_cast<T*>(dx0), static_cast<T*>(dx1), tvec,
      B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bwd_edge_kernel<T, M><<<dim3(n_tiles(N), n_tiles(N), B), kThreads, 0, stream>>>(
      a, x0_, x1_, g0_, g1_, s_, d_, stats, tvec, part_src, part_dst, B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bwd_finalize_kernel<T><<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(part_src, part_dst, static_cast<T*>(dsrc),
                                     static_cast<T*>(ddst), B, N);
  return (int)cudaGetLastError();
}

template <int M>
int launch_bwd_typed(int dtype, const void* adj, const void* x0, const void* x1,
                     const void* src, const void* dst, const void* g0, const void* g1,
                     void* dx0, void* dx1, void* dsrc, void* ddst, float* scratch, int B,
                     int N, int H, cudaStream_t s) {
  if (dtype == 0)
    return launch_bwd<float, M>(adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc, ddst, scratch,
                                B, N, H, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, M>(adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc, ddst,
                                        scratch, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f32 scratch elements gcn_bwd_launch needs for a [B, N] batch.
extern "C" long long gcn_bwd_scratch_floats(int B, int N) {
  return (long long)bwd_scratch_floats(B, N);
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], x0/x1/g0/g1/dx0/dx1 [B,N,H], src/dst/dsrc/ddst [B,N].
// mode: 0 dual (branches 0 and 1), 1 sigmoid, 2 1 - sigmoid (branch 0 only;
// x1, g1, dx1 unread).  scratch: f32, gcn_bwd_scratch_floats(B, N) elements.
extern "C" int gcn_bwd_launch(const void* adj, const void* x0, const void* x1,
                              const void* src, const void* dst, const void* g0,
                              const void* g1, void* dx0, void* dx1, void* dsrc, void* ddst,
                              void* scratch, int B, int N, int H, int dtype, int mode,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (B == 0 || N == 0) return 0;
  switch (mode) {
    case kDual:
      return launch_bwd_typed<kDual>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                     ddst, sc, B, N, H, s);
    case kSig:
      return launch_bwd_typed<kSig>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                    ddst, sc, B, N, H, s);
    case kNeg:
      return launch_bwd_typed<kNeg>(dtype, adj, x0, x1, src, dst, g0, g1, dx0, dx1, dsrc,
                                    ddst, sc, B, N, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], x0/x1/o0/o1 [B,N,H], src/dst [B,N].  mode: 0 dual (x0 -> o0
// with sigmoid, x1 -> o1 with 1 - sigmoid), 1 sigmoid, 2 1 - sigmoid, 3 plain
// (src, dst unread), 4 plain transposed; modes 1-4 read x0 and write o0 only.
// stats: f32 scratch [4, B, N] (dual) or [2, B, N].
extern "C" int gcn_fwd_launch(const void* adj, const void* x0, const void* x1,
                              const void* src, const void* dst, void* o0, void* o1,
                              void* stats, int B, int N, int H, int dtype, int mode,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (B == 0 || N == 0 || H == 0) return 0;
  switch (mode) {
    case kDual: return launch_fwd<kDual>(dtype, adj, x0, x1, src, dst, o0, o1, st, B, N, H, s);
    case kSig: return launch_fwd<kSig>(dtype, adj, x0, x1, src, dst, o0, o1, st, B, N, H, s);
    case kNeg: return launch_fwd<kNeg>(dtype, adj, x0, x1, src, dst, o0, o1, st, B, N, H, s);
    case kPlain: return launch_fwd<kPlain>(dtype, adj, x0, x1, src, dst, o0, o1, st, B, N, H, s);
    case kPlainT:
      return launch_fwd<kPlainT>(dtype, adj, x0, x1, src, dst, o0, o1, st, B, N, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
