// Both masked causal GCN convs of the causal models, forward, for Hopper
// (sm_90a).
//
// Replaces: cal_tpu/ops/pallas_gcn.py::_att_dual_fwd_kernel
// (fused_gcn_dense_att_dual forward).
//
// Contract, per graph b (all internal arithmetic in f32, inputs of type T):
//   w[r,s]  = sigmoid(src[s] + dst[r])             src: sender, dst: receiver
//   mc      = a_off * w,  mo = a_off - mc           a_off = adj with zero diagonal
//   deg_s   = 1 + sum_r m[r,s]   (SENDER degree, a column sum), per branch
//   norm    = T((m[r,s] * deg_s^-1/2) * deg_r^-1/2)  rounded to T like the TPU kernel
//   out_r   = T(sum_s norm[r,s] * x[s,:]  +  x[r,:] / deg_r)   sum accumulated in f32
// for (xc, mc) -> oc and (xo, mo) -> oo.
//
// Bound on this card: bytes in bf16 (adj + xc + xo + oc + oo, ~50 MB at
// B=128, N=256, H=128, against 4.3 GFLOP of products); in f32 the products
// on the CUDA cores (no tensor cores, to keep full f32) are the bound.
// Design: a degree pass (one block per 32 columns of a graph, 8 row groups
// reduced in shared memory) writes deg^-1/2 and 1/deg of both branches to a
// [4, B, N] f32 scratch.  The aggregate is a row-tiled product: one block per
// (64 rows of one graph, 128 feature columns) walks the senders in steps of
// 32, builds both branches' norm tiles from adj/src/dst in shared memory (the
// weights and the [N, N] products never reach device memory) and stages both
// x tiles.  bf16 runs the products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate: exactly the contract's rounding), each
// of 8 warps owning 32 rows x 32 columns of both branches; the sender
// factors (src, deg^-1/2) sit in shared memory for the whole block, and the
// next step's adjacency and x chunks are loaded into registers while the
// current step's products run.  f32 keeps full f32 FMA on the CUDA cores,
// 4 rows x 8 columns x 2 branches per thread, without that prefetch.
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

// m[r, s] of both branches, each scaled to norm and rounded to T
template <typename T>
__device__ __forceinline__ void norm_pair(const T* a, const T* srcb, const T* dstb,
                                          const float* dis_c, const float* dis_o,
                                          int r, int s, int N, float& nc, float& no) {
  nc = no = 0.f;
  if (r < N && s < N && r != s) {
    const float av = to_f(a[(size_t)r * N + s]);
    const float mc = __fmul_rn(av, sigmoid(to_f(srcb[s]) + to_f(dstb[r])));
    const float mo = __fsub_rn(av, mc);
    nc = round_t<T>(__fmul_rn(__fmul_rn(mc, dis_c[s]), dis_c[r]));
    no = round_t<T>(__fmul_rn(__fmul_rn(mo, dis_o[s]), dis_o[r]));
  }
}

constexpr int kDegCols = 32, kDegGroups = kThreads / kDegCols;

// stats layout: [0] dis_c, [1] inv_c, [2] dis_o, [3] inv_o, each [B, N].
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_degree_kernel(const T* __restrict__ adj, const T* __restrict__ src,
                   const T* __restrict__ dst, float* __restrict__ stats, int B, int N) {
  __shared__ float part[2][kDegGroups][kDegCols];
  const int b = blockIdx.y;
  const int tx = threadIdx.x % kDegCols, ty = threadIdx.x / kDegCols;
  const int s = blockIdx.x * kDegCols + tx;
  const T* a = adj + (size_t)b * N * N;
  const T* dstb = dst + (size_t)b * N;
  float sum_c = 0.f, sum_o = 0.f;
  if (s < N) {
    const float src_s = to_f(src[(size_t)b * N + s]);
    for (int r = ty; r < N; r += kDegGroups) {
      if (r == s) continue;
      const float av = to_f(a[(size_t)r * N + s]);
      const float mc = __fmul_rn(av, sigmoid(src_s + to_f(dstb[r])));
      sum_c += mc;
      sum_o += __fsub_rn(av, mc);
    }
  }
  part[0][ty][tx] = sum_c;
  part[1][ty][tx] = sum_o;
  __syncthreads();
  if (ty != 0 || s >= N) return;
  for (int g = 1; g < kDegGroups; ++g) {
    sum_c += part[0][g][tx];
    sum_o += part[1][g][tx];
  }
  const float deg_c = sum_c + 1.0f, deg_o = sum_o + 1.0f;
  const size_t plane = (size_t)B * N, i = (size_t)b * N + s;
  stats[i] = rsqrtf(deg_c);
  stats[plane + i] = 1.0f / deg_c;
  stats[2 * plane + i] = rsqrtf(deg_o);
  stats[3 * plane + i] = 1.0f / deg_o;
}

// f32: full-f32 FMA on the CUDA cores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_aggregate_fma_kernel(const T* __restrict__ adj, const T* __restrict__ xc,
                      const T* __restrict__ xo, const T* __restrict__ src,
                      const T* __restrict__ dst, const float* __restrict__ stats,
                      T* __restrict__ oc, T* __restrict__ oo, int B, int N, int H) {
  extern __shared__ float smem[];
  float* xs_c = smem;                        // [kStep][kCols]
  float* xs_o = xs_c + kStep * kCols;        // [kStep][kCols]
  float* ns_c = xs_o + kStep * kCols;        // [kRows][kStep + 1]
  float* ns_o = ns_c + kRows * (kStep + 1);  // [kRows][kStep + 1]

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 + i; cols tx*4 + j and 64 + tx*4 + j

  const size_t plane = (size_t)B * N;
  const float* dis_c = stats + (size_t)b * N;
  const float* dis_o = stats + 2 * plane + (size_t)b * N;
  const T* a = adj + (size_t)b * N * N;
  const T* xcb = xc + (size_t)b * N * H;
  const T* xob = xo + (size_t)b * N * H;
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;

  float acc_c[4][8], acc_o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_c[i][j] = acc_o[i][j] = 0.f;

  for (int s0 = 0; s0 < N; s0 += kStep) {
    for (int i = tid; i < kStep * kCols; i += kThreads) {
      const int k = i / kCols, c = i % kCols;
      const int s = s0 + k, col = h0 + c;
      const bool ok = s < N && col < H;
      xs_c[i] = ok ? to_f(xcb[(size_t)s * H + col]) : 0.f;
      xs_o[i] = ok ? to_f(xob[(size_t)s * H + col]) : 0.f;
    }
    for (int i = tid; i < kRows * kStep; i += kThreads) {
      const int rr = i / kStep, k = i % kStep;
      float nc, no;
      norm_pair<T>(a, srcb, dstb, dis_c, dis_o, r0 + rr, s0 + k, N, nc, no);
      ns_c[rr * (kStep + 1) + k] = nc;
      ns_o[rr * (kStep + 1) + k] = no;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kStep; ++k) {
      float ac[4], ao[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ac[i] = ns_c[(ty * 4 + i) * (kStep + 1) + k];
        ao[i] = ns_o[(ty * 4 + i) * (kStep + 1) + k];
      }
      const float4 c0 = *reinterpret_cast<const float4*>(xs_c + k * kCols + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(xs_c + k * kCols + 64 + tx * 4);
      const float4 o0 = *reinterpret_cast<const float4*>(xs_o + k * kCols + tx * 4);
      const float4 o1 = *reinterpret_cast<const float4*>(xs_o + k * kCols + 64 + tx * 4);
      const float bc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float bo[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_c[i][j] = fmaf(ac[i], bc[j], acc_c[i][j]);
          acc_o[i][j] = fmaf(ao[i], bo[j], acc_o[i][j]);
        }
    }
    __syncthreads();
  }

  const float* inv_c = stats + plane + (size_t)b * N;
  const float* inv_o = stats + 3 * plane + (size_t)b * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= H) continue;
      const size_t at = (size_t)r * H + col;
      const float xcv = to_f(xcb[at]), xov = to_f(xob[at]);
      oc[(size_t)b * N * H + at] = from_f<T>(__fadd_rn(acc_c[i][j], __fmul_rn(xcv, inv_c[r])));
      oo[(size_t)b * N * H + at] = from_f<T>(__fadd_rn(acc_o[i][j], __fmul_rn(xov, inv_o[r])));
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

__global__ void __launch_bounds__(kThreads, 2)
dual_aggregate_mma_kernel(const __nv_bfloat16* __restrict__ adj,
                          const __nv_bfloat16* __restrict__ xc,
                          const __nv_bfloat16* __restrict__ xo,
                          const __nv_bfloat16* __restrict__ src,
                          const __nv_bfloat16* __restrict__ dst,
                          const float* __restrict__ stats, __nv_bfloat16* __restrict__ oc,
                          __nv_bfloat16* __restrict__ oo, int B, int N, int H) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float fs[];                         // per sender: src, dis_c, dis_o
  __shared__ __align__(16) bf16 As[2][kRows * kALd];   // norm tiles [row][sender]
  __shared__ __align__(16) bf16 Bs[2][kStep * kBLd];   // x tiles [sender][column]

  const int r0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // warp owns rows wm*32.., columns wn*32..

  const size_t plane = (size_t)B * N;
  const float* dis_c = stats + (size_t)b * N;
  const float* dis_o = stats + 2 * plane + (size_t)b * N;
  const bf16* a = adj + (size_t)b * N * N;
  const bf16* xb[2] = {xc + (size_t)b * N * H, xo + (size_t)b * N * H};
  const bf16* srcb = src + (size_t)b * N;
  const bf16* dstb = dst + (size_t)b * N;
  const bool vec_x =
      H % 8 == 0 && ((reinterpret_cast<uintptr_t>(xc) | reinterpret_cast<uintptr_t>(xo)) % 16) == 0;
  const bool vec_a = N % 8 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < N; i += kThreads) {
    fs[i] = to_f(srcb[i]);
    fs[N + i] = dis_c[i];
    fs[2 * N + i] = dis_o[i];
  }
  // each thread builds 8 senders of one row of the norm tiles
  const int rr = tid / 4, g = tid % 4, r = r0 + rr;
  const bool row_ok = r < N;
  const float dst_r = row_ok ? to_f(dstb[r]) : 0.f;
  const float dc_r = row_ok ? dis_c[r] : 0.f, do_r = row_ok ? dis_o[r] : 0.f;

  // the next step's adjacency and x chunks travel in registers while the
  // current step's products run
  uint4 areg, xreg[4];
  auto load = [&](int s0) {
    const int s = s0 + g * 8;
    if (row_ok && vec_a && s < N) {
      areg = *reinterpret_cast<const uint4*>(a + (size_t)r * N + s);
    } else {
      alignas(16) bf16 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = (row_ok && s + j < N) ? a[(size_t)r * N + s + j] : zero;
      areg = *reinterpret_cast<const uint4*>(t);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    alignas(16) bf16 nc8[8], no8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = s0 + g * 8 + j;
      float nc = 0.f, no = 0.f;
      if (row_ok && s < N && s != r) {
        const float ax = __bfloat162float(av[j]);
        const float mc = __fmul_rn(ax, sigmoid(fs[s] + dst_r));
        const float mo = __fsub_rn(ax, mc);
        nc = __fmul_rn(__fmul_rn(mc, fs[N + s]), dc_r);
        no = __fmul_rn(__fmul_rn(mo, fs[2 * N + s]), do_r);
      }
      nc8[j] = __float2bfloat16(nc);
      no8[j] = __float2bfloat16(no);
    }
    *reinterpret_cast<uint4*>(&As[0][rr * kALd + g * 8]) = *reinterpret_cast<const uint4*>(nc8);
    *reinterpret_cast<uint4*>(&As[1][rr * kALd + g * 8]) = *reinterpret_cast<const uint4*>(no8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + (j % 2) * kThreads;
      const int k = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[j / 2][k * kBLd + c]) = xreg[j];
    }
  };

  float acc[2][2][4][4];   // [branch][m tile][n tile][fragment]
#pragma unroll
  for (int br = 0; br < 2; ++br)
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
      for (int br = 0; br < 2; ++br) {
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

  const float* inv[2] = {stats + plane + (size_t)b * N, stats + 3 * plane + (size_t)b * N};
  bf16* out[2] = {oc + (size_t)b * N * H, oo + (size_t)b * N * H};
#pragma unroll
  for (int br = 0; br < 2; ++br)
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
          out[br][at] = __float2bfloat16(
              __fadd_rn(acc[br][mt][nt][f], __fmul_rn(xv, inv[br][r])));
        }
}

template <typename T>
int launch_degree(const void* adj, const void* src, const void* dst, float* stats,
                  int B, int N, cudaStream_t stream) {
  dim3 grid((N + kDegCols - 1) / kDegCols, B);
  dual_degree_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(adj), static_cast<const T*>(src), static_cast<const T*>(dst),
      stats, B, N);
  return (int)cudaGetLastError();
}

int launch_f32(const void* adj, const void* xc, const void* xo, const void* src,
               const void* dst, void* oc, void* oo, float* stats, int B, int N, int H,
               cudaStream_t stream) {
  int err = launch_degree<float>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const size_t smem = (2 * kStep * kCols + 2 * kRows * (kStep + 1)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dual_aggregate_fma_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  dual_aggregate_fma_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(adj), static_cast<const float*>(xc),
      static_cast<const float*>(xo), static_cast<const float*>(src),
      static_cast<const float*>(dst), stats, static_cast<float*>(oc),
      static_cast<float*>(oo), B, N, H);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* adj, const void* xc, const void* xo, const void* src,
                const void* dst, void* oc, void* oo, float* stats, int B, int N, int H,
                cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  int err = launch_degree<bf16>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const size_t smem = 3 * (size_t)N * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dual_aggregate_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kRows - 1) / kRows, B, (H + kCols - 1) / kCols);
  dual_aggregate_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(adj), static_cast<const bf16*>(xc),
      static_cast<const bf16*>(xo), static_cast<const bf16*>(src),
      static_cast<const bf16*>(dst), stats, static_cast<bf16*>(oc),
      static_cast<bf16*>(oo), B, N, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (VJP) of both masked convs, for Hopper (sm_90a).
//
// Replaces: cal_tpu/ops/pallas_gcn.py::_att_dual_bwd_kernel (the custom VJP
// of fused_gcn_dense_att_dual, launched by _att_dual_bwd).
//
// Contract, per graph and branch (m, x, g) = (mc, xc, gc) and (mo, xo, go),
// with deg, dis = deg^-1/2 and inv = 1/deg of the forward:
//   p_s  = sum_r T(m_rs) * T(dis_r g_r)     dx_s = T(dis_s p_s + inv_s g_s)
//   u_r  = sum_s T(m_rs) * T(dis_s x_s)
//   t_n  = -1/2 dis_n^3 (g_n.u_n + p_n.x_n) - (g_n.x_n) inv_n^2
//   G_rs = g_r . x_s                        dm_rs = dis_r dis_s G_rs + t_s
//   dpre = (dm_c - dm_o) a_off sigma (1 - sigma)
//   dsrc_s = T(sum_r dpre_rs),  ddst_r = T(sum_s dpre_rs)
// Products take T-valued inputs and accumulate in f32 (exact products for
// bf16); t, dm and dpre stay f32, as in the TPU kernel.
//
// Bound on this card at B=128, N=256, H=128: three products per branch, 12.9
// GFLOP.  In bf16 the 67 MB of traffic bound it (0.020 ms; the products at
// the tensor cores' bf16 rate take 0.013 ms); in f32 the products on the
// CUDA cores do (0.19 ms).  This version runs the products with f32 FMA on
// the CUDA cores in both dtypes, so bf16 cannot come near its bound.
// Design: t_s needs the whole column product p_s and row product u_s, and
// dsrc needs column sums over every receiver, so the work is split into
// passes (the TPU kernel holds a whole [N, N] graph in VMEM instead):
//   1. the forward's degree pass (deg^-1/2 and 1/deg of both branches);
//   2. a node pass, one block per 32 nodes of a graph: for its nodes both
//      as receivers (u, rows of m) and as senders (p, columns of m) it
//      rebuilds both branches' m tiles from adj/src/dst in shared memory,
//      runs the four products with f32 FMA, writes dx, and reduces the
//      three per-node dot products into t (an f32 [2, B, N] scratch);
//   3. an edge pass, one block per 64 x 64 (receiver, sender) tile: G of both
//      branches by f32 FMA, then dm and dpre in registers, row sums and
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

// both branches' m[r, s] (f32, as the forward builds it), rounded to T
template <typename T>
__device__ __forceinline__ void m_pair(const T* a, const T* srcb, const T* dstb, int r, int s,
                                       int N, float& mc, float& mo) {
  mc = mo = 0.f;
  if (r < N && s < N && r != s) {
    const float av = to_f(a[(size_t)r * N + s]);
    const float c = __fmul_rn(av, sigmoid(to_f(srcb[s]) + to_f(dstb[r])));
    mc = round_t<T>(c);
    mo = round_t<T>(__fsub_rn(av, c));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_bwd_node_kernel(const T* __restrict__ adj, const T* __restrict__ xc,
                     const T* __restrict__ xo, const T* __restrict__ gc,
                     const T* __restrict__ go, const T* __restrict__ src,
                     const T* __restrict__ dst, const float* __restrict__ stats,
                     T* __restrict__ dxc, T* __restrict__ dxo, float* __restrict__ tvec,
                     int B, int N, int H) {
  __shared__ float mrow[2][kNodeRows][kNodeK + 1];   // m[n0 + i, k0 + k]
  __shared__ float mcol[2][kNodeRows][kNodeK + 1];   // m[k0 + k, n0 + i]
  __shared__ __align__(16) float xd[2][kNodeK][kNodeCols];   // T(dis_k x_k)
  __shared__ __align__(16) float gd[2][kNodeK][kNodeCols];   // T(dis_k g_k)

  const int n0 = blockIdx.x * kNodeRows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*2 + i; cols tx*4 + j and 64 + tx*4 + j
  const size_t plane = (size_t)B * N;
  const float* dis[2] = {stats + (size_t)b * N, stats + 2 * plane + (size_t)b * N};
  const float* inv[2] = {stats + plane + (size_t)b * N, stats + 3 * plane + (size_t)b * N};
  const T* a = adj + (size_t)b * N * N;
  const T* x[2] = {xc + (size_t)b * N * H, xo + (size_t)b * N * H};
  const T* g[2] = {gc + (size_t)b * N * H, go + (size_t)b * N * H};
  T* dx[2] = {dxc + (size_t)b * N * H, dxo + (size_t)b * N * H};
  const T* srcb = src + (size_t)b * N;
  const T* dstb = dst + (size_t)b * N;

  float gu[2][2], px[2][2], gx[2][2];   // [branch][row] partial dot products
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i) gu[br][i] = px[br][i] = gx[br][i] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kNodeCols) {
    float u[2][2][8], p[2][2][8];
#pragma unroll
    for (int br = 0; br < 2; ++br)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) u[br][i][j] = p[br][i][j] = 0.f;

    for (int k0 = 0; k0 < N; k0 += kNodeK) {
      for (int e = tid; e < kNodeRows * kNodeK; e += kThreads) {
        const int i = e / kNodeK, k = e % kNodeK;
        float mc, mo;
        m_pair<T>(a, srcb, dstb, n0 + i, k0 + k, N, mc, mo);
        mrow[0][i][k] = mc;
        mrow[1][i][k] = mo;
        m_pair<T>(a, srcb, dstb, k0 + k, n0 + i, N, mc, mo);
        mcol[0][i][k] = mc;
        mcol[1][i][k] = mo;
      }
      for (int e = tid; e < 2 * kNodeK * kNodeCols; e += kThreads) {
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
        for (int br = 0; br < 2; ++br) {
          const float4 x0 = *reinterpret_cast<const float4*>(&xd[br][k][tx * 4]);
          const float4 x1 = *reinterpret_cast<const float4*>(&xd[br][k][64 + tx * 4]);
          const float4 g0 = *reinterpret_cast<const float4*>(&gd[br][k][tx * 4]);
          const float4 g1 = *reinterpret_cast<const float4*>(&gd[br][k][64 + tx * 4]);
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
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
    for (int br = 0; br < 2; ++br)
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
          dx[br][at] = from_f<T>(__fadd_rn(__fmul_rn(pv, dis[br][n]), __fmul_rn(gv, inv[br][n])));
          gu[br][i] += gv * u[br][i][j];
          px[br][i] += pv * xv;
          gx[br][i] += gv * xv;
        }
      }
  }

  // the 16 lanes of a half warp share a row: reduce, then one lane writes t
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float vu = gu[br][i], vp = px[br][i], vx = gx[br][i];
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        vu += __shfl_xor_sync(0xffffffffu, vu, off);
        vp += __shfl_xor_sync(0xffffffffu, vp, off);
        vx += __shfl_xor_sync(0xffffffffu, vx, off);
      }
      const int n = n0 + ty * 2 + i;
      if (tx == 0 && n < N) {
        const float d = dis[br][n], iv = inv[br][n];
        tvec[br * plane + (size_t)b * N + n] =
            -0.5f * (vu + vp) * d * d * d - vx * iv * iv;
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_bwd_edge_kernel(const T* __restrict__ adj, const T* __restrict__ xc,
                     const T* __restrict__ xo, const T* __restrict__ gc,
                     const T* __restrict__ go, const T* __restrict__ src,
                     const T* __restrict__ dst, const float* __restrict__ stats,
                     const float* __restrict__ tvec, float* __restrict__ part_src,
                     float* __restrict__ part_dst, int B, int N, int H) {
  __shared__ __align__(16) float gs[2][kEdgeK][kEdgeTile];   // g[r0 + i, h0 + k]
  __shared__ __align__(16) float xs[2][kEdgeK][kEdgeTile];   // x[s0 + j, h0 + k]
  __shared__ float colsum[kThreads / 16][kEdgeTile];

  const int r0 = blockIdx.x * kEdgeTile, s0 = blockIdx.y * kEdgeTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4 + i, columns tx*4 + j
  const size_t plane = (size_t)B * N;
  const T* g[2] = {gc + (size_t)b * N * H, go + (size_t)b * N * H};
  const T* x[2] = {xc + (size_t)b * N * H, xo + (size_t)b * N * H};

  float acc[2][4][4];
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[br][i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kEdgeK) {
    for (int e = tid; e < 2 * kEdgeK * kEdgeTile; e += kThreads) {
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
      for (int br = 0; br < 2; ++br) {
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

  const float* dis_c = stats + (size_t)b * N;
  const float* dis_o = stats + 2 * plane + (size_t)b * N;
  const float* t_c = tvec + (size_t)b * N;
  const float* t_o = tvec + plane + (size_t)b * N;
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
        const float dmc = acc[0][i][j] * dis_c[s] * dis_c[r] + t_c[s];
        const float dmo = acc[1][i][j] * dis_o[s] * dis_o[r] + t_o[s];
        dpre = (dmc - dmo) * av * (sg * (1.0f - sg));
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
__global__ void dual_bwd_finalize_kernel(const float* __restrict__ part_src,
                                         const float* __restrict__ part_dst,
                                         T* __restrict__ dsrc, T* __restrict__ ddst,
                                         int B, int N) {
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
size_t bwd_scratch_floats(int B, int N) {
  return (size_t)B * N * (6 + 2 * (size_t)n_tiles(N));
}

template <typename T>
int launch_bwd(const void* adj, const void* xc, const void* xo, const void* src,
               const void* dst, const void* gc, const void* go, void* dxc, void* dxo,
               void* dsrc, void* ddst, float* scratch, int B, int N, int H,
               cudaStream_t stream) {
  const size_t plane = (size_t)B * N;
  float* stats = scratch;
  float* tvec = stats + 4 * plane;
  float* part_src = tvec + 2 * plane;
  float* part_dst = part_src + plane * n_tiles(N);
  int err = launch_degree<T>(adj, src, dst, stats, B, N, stream);
  if (err != 0) return err;
  const T *a = static_cast<const T*>(adj), *xc_ = static_cast<const T*>(xc),
          *xo_ = static_cast<const T*>(xo), *gc_ = static_cast<const T*>(gc),
          *go_ = static_cast<const T*>(go), *s_ = static_cast<const T*>(src),
          *d_ = static_cast<const T*>(dst);
  dual_bwd_node_kernel<T><<<dim3((N + kNodeRows - 1) / kNodeRows, B), kThreads, 0, stream>>>(
      a, xc_, xo_, gc_, go_, s_, d_, stats, static_cast<T*>(dxc), static_cast<T*>(dxo),
      tvec, B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dual_bwd_edge_kernel<T><<<dim3(n_tiles(N), n_tiles(N), B), kThreads, 0, stream>>>(
      a, xc_, xo_, gc_, go_, s_, d_, stats, tvec, part_src, part_dst, B, N, H);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dual_bwd_finalize_kernel<T><<<(unsigned)((plane + kThreads - 1) / kThreads), kThreads, 0,
                                stream>>>(part_src, part_dst, static_cast<T*>(dsrc),
                                          static_cast<T*>(ddst), B, N);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 scratch elements dual_gcn_bwd_launch needs for a [B, N] batch.
extern "C" long long dual_gcn_bwd_scratch_floats(int B, int N) {
  return (long long)bwd_scratch_floats(B, N);
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], xc/xo/gc/go/dxc/dxo [B,N,H], src/dst/dsrc/ddst [B,N].
// scratch: f32, dual_gcn_bwd_scratch_floats(B, N) elements.
extern "C" int dual_gcn_bwd_launch(const void* adj, const void* xc, const void* xo,
                                   const void* src, const void* dst, const void* gc,
                                   const void* go, void* dxc, void* dxo, void* dsrc,
                                   void* ddst, void* scratch, int B, int N, int H,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (B == 0 || N == 0) return 0;
  if (dtype == 0)
    return launch_bwd<float>(adj, xc, xo, src, dst, gc, go, dxc, dxo, dsrc, ddst, sc, B, N, H, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(adj, xc, xo, src, dst, gc, go, dxc, dxo, dsrc, ddst, sc,
                                     B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; every tensor is contiguous of that type:
// adj [B,N,N], xc/xo/oc/oo [B,N,H], src/dst [B,N].  stats: f32 scratch [4,B,N].
extern "C" int dual_gcn_fwd_launch(const void* adj, const void* xc, const void* xo,
                                   const void* src, const void* dst, void* oc, void* oo,
                                   void* stats, int B, int N, int H, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (B == 0 || N == 0 || H == 0) return 0;
  if (dtype == 0) return launch_f32(adj, xc, xo, src, dst, oc, oo, st, B, N, H, s);
  if (dtype == 1) return launch_bf16(adj, xc, xo, src, dst, oc, oo, st, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}
