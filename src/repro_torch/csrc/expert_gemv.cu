// Fused few-token expert FFN (batched GEMV), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `expert_ffn_gemv`
// (src/repro/kernels/expert_gemv/expert_gemv.py:44, body `_kernel` :25),
// which `cold_expert_ffn` (expert_gemv/ops.py:23) vmaps over experts.
// For each expert e and its T tokens x[e] [T, D]:
//   g = x W1, u = x W3 (fp32 sums), h = (silu(g) * u) cast to x's dtype,
//   y = h W2 (fp32 sums), cast to x's dtype.
//
// What bounds it on the H100: the weight bytes. T is at most the decode
// group width, so every weight element is used for a handful of FMAs;
// the least time is 3 * D * F * 2 bytes per expert over 3.35 TB/s. This
// kernel runs ~17x above that, and why is not known yet: staging W2 in
// shared memory to coalesce phase 2's strided read gained 4-5%, and
// issuing 8 rows of loads per thread in phase 1 made bf16 slower
// (PERF.md, findings).
// Design: ONE launch for all experts of a tier, grid (expert, F-split),
// each block owning a `bf`-wide panel of F (bf <= 64; F % bf == 0, the
// ops layer zero-pads F otherwise). Every weight element is read exactly
// once. Phase 1: 256 threads = 64 panel columns x 4 D-groups accumulate
// x W1 and x W3 for up to 8 tokens at a time in registers (tokens staged
// as fp32 in shared memory), then sum the 4 D-groups in a fixed order.
// Phase 2: each thread owns output columns d and sums h W2 over the
// panel; the fp32 partial goes to scratch [splits, E, T, D]. A second
// kernel adds the splits in split order (no atomics, so fp32 results do
// not change from run to run) and casts. Weights are addressed through
// strides, so W1/W3/W2 may be views of a tier buffer [n, 3, D, F] with
// the down matrix stored transposed, as the serving path keeps them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBF = 64;
constexpr int kDGroups = kThreads / kMaxBF;  // 4
constexpr int kTT = 8;                       // tokens per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct WStrides {  // element strides of one weight operand: [e, row, col]
  long long e, r, c;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gemv_panel_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ w3,
    const T* __restrict__ w2, float* __restrict__ part, int E, int T_, int D, int F,
    int bf, WStrides s1, WStrides s3, WStrides s2) {
  extern __shared__ float smem[];
  float* x_s = smem;                              // [T, D]
  float* red_s = x_s + (size_t)T_ * D;            // [2, kDGroups, kTT, kMaxBF]
  float* h_s = red_s + 2 * kDGroups * kTT * kMaxBF;  // [T, kMaxBF]
  const int e = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int f0 = split * bf;
  const T* xe = x + (size_t)e * T_ * D;
  for (int i = tid; i < T_ * D; i += kThreads) x_s[i] = to_f(xe[i]);
  __syncthreads();

  const T* w1e = w1 + e * s1.e;
  const T* w3e = w3 + e * s3.e;
  const int fi = tid % kMaxBF, dg = tid / kMaxBF;
  for (int t0 = 0; t0 < T_; t0 += kTT) {
    const int tn = min(kTT, T_ - t0);
    float g[kTT] = {}, u[kTT] = {};
    if (fi < bf) {
      const long long c1 = (long long)(f0 + fi) * s1.c, c3 = (long long)(f0 + fi) * s3.c;
      for (int d = dg; d < D; d += kDGroups) {
        const float a = to_f(w1e[d * s1.r + c1]);
        const float b = to_f(w3e[d * s3.r + c3]);
#pragma unroll
        for (int t = 0; t < kTT; ++t) {
          if (t < tn) {
            const float xv = x_s[(t0 + t) * D + d];
            g[t] += xv * a;
            u[t] += xv * b;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTT; ++t) {
      red_s[((0 * kDGroups + dg) * kTT + t) * kMaxBF + fi] = g[t];
      red_s[((1 * kDGroups + dg) * kTT + t) * kMaxBF + fi] = u[t];
    }
    __syncthreads();
    for (int i = tid; i < tn * bf; i += kThreads) {
      const int t = i / bf, f = i % bf;
      float gs = 0.f, us = 0.f;
      for (int q = 0; q < kDGroups; ++q) {  // fixed order
        gs += red_s[((0 * kDGroups + q) * kTT + t) * kMaxBF + f];
        us += red_s[((1 * kDGroups + q) * kTT + t) * kMaxBF + f];
      }
      const float silu = gs / (1.f + expf(-gs));
      h_s[(t0 + t) * kMaxBF + f] = to_f(from_f<T>(silu * us));  // h in x's dtype
    }
    __syncthreads();
  }

  // phase 2: partial y[t, d] over this F panel
  const T* w2e = w2 + e * s2.e;
  float* pe = part + ((size_t)split * E + e) * T_ * D;
  for (int d = tid; d < D; d += kThreads) {
    float y[kTT];
    for (int t0 = 0; t0 < T_; t0 += kTT) {
      const int tn = min(kTT, T_ - t0);
#pragma unroll
      for (int t = 0; t < kTT; ++t) y[t] = 0.f;
      for (int f = 0; f < bf; ++f) {
        const float wv = to_f(w2e[(long long)(f0 + f) * s2.r + (long long)d * s2.c]);
#pragma unroll
        for (int t = 0; t < kTT; ++t)
          if (t < tn) y[t] += h_s[(t0 + t) * kMaxBF + f] * wv;
      }
      for (int t = 0; t < tn; ++t) pe[(size_t)(t0 + t) * D + d] = y[t];
    }
  }
}

template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ part, T* __restrict__ y,
                                     int splits, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];  // split order
    y[i] = from_f<T>(s);
  }
}

size_t smem_bytes(int T_, int D) {
  return sizeof(float) * ((size_t)T_ * D + 2 * kDGroups * kTT * kMaxBF + (size_t)T_ * kMaxBF);
}

template <typename T>
int launch(const void* x, const void* w1, const void* w3, const void* w2, void* part,
           void* y, int E, int T_, int D, int F, int bf, WStrides s1, WStrides s3,
           WStrides s2, cudaStream_t stream) {
  const size_t smem = smem_bytes(T_, D);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = F / bf;
  dim3 grid(E, splits);
  gemv_panel_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w3),
      static_cast<const T*>(w2), static_cast<float*>(part), E, T_, D, F, bf, s1, s3, s2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)E * T_ * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_splits_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                     static_cast<T*>(y), splits, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t expert_ffn_gemv_smem(int tokens, int d_model) { return smem_bytes(tokens, d_model); }

// x [E, T, D] and y [E, T, D] contiguous; part is fp32 scratch of
// (F / bf) * E * T * D elements. Weight element (e, row, col) of W1/W3
// ([D, F]) and W2 ([F, D]) sits at base + e*s_e + row*s_r + col*s_c.
// bf <= 64 must divide F. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
int expert_ffn_gemv(const void* x, const void* w1, const void* w3, const void* w2,
                    void* part, void* y, int E, int T_, int D, int F, int bf,
                    long long s1e, long long s1r, long long s1c, long long s3e,
                    long long s3r, long long s3c, long long s2e, long long s2r,
                    long long s2c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WStrides a{s1e, s1r, s1c}, b{s3e, s3r, s3c}, c{s2e, s2r, s2c};
  if (dtype == 0)
    return launch<float>(x, w1, w3, w2, part, y, E, T_, D, F, bf, a, b, c, s);
  return launch<__nv_bfloat16>(x, w1, w3, w2, part, y, E, T_, D, F, bf, a, b, c, s);
}

}  // extern "C"
