// Grouped expert GEMM driven by a tile -> expert table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_gemm`
// (src/repro/kernels/moe_gemm/moe_gemm.py:34, body `_kernel` :24): rows
// of x [M, K] are sorted by expert and every expert's group is padded to
// a multiple of `bm` rows, so row tile m (bm rows) multiplies the [K, N]
// weight panel of expert tile_expert[m]. Sums are fp32; the output is
// cast to x's dtype.
//
// The weight is addressed through strides, so the serving path never
// copies a tier buffer [n, 3, D, F]: the gate|up GEMM reads the two
// [D, F] matrices of a slot as one [D, 2F] panel (columns n >= n_half
// jump by `half_stride` elements), and the down GEMM reads the stored
// [D, F] matrix as [F, D] (k stride 1, n stride F).
//
// What bounds it on the H100: operations. Prefill tiers multiply
// n_slots * round_up(rows * C, 128) rows by 1024 x 1024 and 1024 x 512
// panels, about 3e6 FLOP per row per layer, far above the ~295 FLOP/byte
// ridge. Design (simple first): a classic shared-memory tiled GEMM on
// the CUDA cores in fp32, 64 x 64 output tiles, k-steps of 16, 256
// threads each holding a 4 x 4 block of accumulators (columns tx + 16j so
// the shared-memory reads of a warp are conflict-free). One block never
// straddles two experts because 64 divides bm. Tensor-core tiles
// (wgmma with TMA loads) are the work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(256) moe_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ tile_expert,
    T* __restrict__ out, int M, int K, int N, int bm, long long stride_e,
    long long stride_k, long long stride_n, int n_half, long long half_stride) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const T* we = w + (long long)tile_expert[row0 / bm] * stride_e;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += 256) {  // x tile, k fastest (coalesced)
      const int m = i / kBK, kk = i % kBK;
      const int row = row0 + m, k = k0 + kk;
      xs[kk][m] = (row < M && k < K) ? to_f(x[(long long)row * K + k]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += 256) {  // w tile, unit-stride dim fastest
      int n, kk;
      if (stride_k == 1) { n = i / kBK; kk = i % kBK; }
      else { n = i % kBN; kk = i / kBN; }
      const int col = col0 + n, k = k0 + kk;
      float v = 0.f;
      if (col < N && k < K) {
        const long long cn = col < n_half ? (long long)col * stride_n
                                          : half_stride + (long long)(col - n_half) * stride_n;
        v = to_f(we[(long long)k * stride_k + cn]);
      }
      ws[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < N) out[(long long)row * N + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* te, void* out, int M, int K, int N,
           int bm, long long se, long long sk, long long sn, int n_half, long long hs,
           cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  moe_gemm_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(te),
      static_cast<T*>(out), M, K, N, bm, se, sk, sn, n_half, hs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] contiguous; out [M, N] contiguous; w addressed by strides (in
// elements): w[e, k, n] = w + e*stride_e + k*stride_k + col(n), col(n) =
// n*stride_n for n < n_half, else half_stride + (n - n_half)*stride_n.
// M must be a multiple of bm and bm a multiple of 64. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError().
int moe_gemm(const void* x, const void* w, const void* tile_expert, void* out, int M,
             int K, int N, int bm, long long stride_e, long long stride_k,
             long long stride_n, int n_half, long long half_stride, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, tile_expert, out, M, K, N, bm, stride_e, stride_k, stride_n,
                         n_half, half_stride, s);
  return launch<__nv_bfloat16>(x, w, tile_expert, out, M, K, N, bm, stride_e, stride_k,
                               stride_n, n_half, half_stride, s);
}

}  // extern "C"
