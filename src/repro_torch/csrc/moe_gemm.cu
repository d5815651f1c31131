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
// What bounds it on the H100. At the serving shapes every tier slot's
// group is padded to one 128-row tile, so each weight element read feeds
// 128 rows: 128 operations per weight byte, below the card's ~295 bf16
// ridge. The kernel is bound by streaming the weights once (deepseek's
// hot tier, 25 slots of [5120 x 3072], is 786 MB per gate|up call: 0.23
// ms at 3.35 TB/s), so its job is to keep HBM busy.
//
// bf16 design (tensor cores). A block covers BM rows by BN columns: BM =
// 128, two consumer warpgroups of 64 rows, or BM = 64 and one warpgroup
// when 128 does not divide bm, so a block never spans two experts. One
// producer warp keeps a ring of kStages shared-memory stages in flight by
// TMA (hopper_mma.cuh), each the [BM, 64] x tile and the [64, BN] weight
// tile, the weight as BN / 64 boxes of 64 x 64 so that every 64-column
// chunk of a gate|up pair picks its own half. The weight's tensor map is
// 4-D and built from its strides by the wrapper
// (kernels/moe_gemm/kernel.py:tma_weight_map): (n, k, half, expert) when
// stride_n == 1 (gate|up: B MN-major, wgmma TransB = 1), (k, n, half,
// expert) when stride_k == 1 (the down GEMM's transposed view: B
// K-major). A consumer waits for a stage, issues four m64nBNk16 wgmmas
// from shared memory, keeps that group in flight and releases the stage
// before it. Ragged K and N edges come from TMA's zero fill; the epilogue
// rounds the fp32 accumulators to bf16 and stores them masked. At c_pad =
// 128 (one row tile per slot) each weight element is read by exactly one
// block.
//
// BN (64 or 128) is the wrapper's choice (kernel.py:pick_bn): 128 unless
// that leaves fewer blocks than the card has SMs. Granite's hot tier (8
// slots, N = 1024) gives 64 blocks at 128 on 132 SMs, so it runs at 64
// (128 blocks, two per SM fit); deepseek's (25 slots, N = 3072 / 5120)
// gives 600 / 1000 blocks at 128, 4.5 / 7.6 waves.
//
// fp32 keeps the CUDA-core kernel below: on the tensor cores fp32 would
// run as TF32, which breaks the serving smoke test's fp32 card-vs-CPU
// token identity and the 1e-4 tolerance. The wrapper picks the route by
// dtype. It is a shared-memory tiled GEMM, 64 x 64 output tiles, k-steps
// of 16, 256 threads each holding a 4 x 4 block of accumulators (columns
// tx + 16j so the shared-memory reads of a warp are conflict-free).
#include "hopper_mma.cuh"

namespace {

using hopper::Wgmma;

// ------------------------------------------------ bf16: wgmma + TMA ring
constexpr int kBK = 64;                // k per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kBoxBytes = 64 * 64 * 2;  // one 64 x 64 weight box

template <int BM, int BN>
struct GemmSmem {
  static constexpr int a_bytes = BM * kBK * 2;
  static constexpr int b_bytes = BN * kBK * 2;
  static constexpr int bytes = kStages * (a_bytes + b_bytes) + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, int N, int r, int c, float v0,
                                           float v1) {
  __nv_bfloat16* p = out + (size_t)r * N + c;
  if ((N & 1) == 0) {  // c is even, so c < N means c + 1 < N
    if (c < N) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < N) p[0] = __float2bfloat16(v0);
    if (c + 1 < N) p[1] = __float2bfloat16(v1);
  }
}

template <int BM, int BN, bool KMajorB>
__global__ void __launch_bounds__(BM / 64 * 128 + 32) moe_gemm_bf16_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const int* __restrict__ tile_expert, __nv_bfloat16* __restrict__ out, int M, int N, int K,
    int bm, int n_half) {
  using S = GemmSmem<BM, BN>;
  constexpr int kWG = BM / 64;  // consumer warpgroups
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* a_s = smem;                          // kStages x [BM][64]
  uint8_t* b_s = smem + kStages * S::a_bytes;   // kStages x BN/64 boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kStages * S::b_bytes);
  uint64_t* empty = full + kStages;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWG * 128) {  // producer warp: one thread issues every load
    if (tid == kWG * 128) {
      const int e = tile_expert[row0 / bm];
      const int n_boxes = min(BN / 64, (N - col0 + 63) / 64);  // boxes past N: not loaded
      const uint32_t bytes = S::a_bytes + n_boxes * kBoxBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        hopper::tma_load_2d(a_s + s * S::a_bytes, &x_map, &full[s], kt * kBK, row0);
        for (int j = 0; j < n_boxes; ++j) {
          const int n = col0 + 64 * j;
          const int half = n >= n_half ? 1 : 0;
          const int nn = n - half * n_half;
          uint8_t* dst = b_s + s * S::b_bytes + j * kBoxBytes;
          if (KMajorB)
            hopper::tma_load_4d(dst, &w_map, &full[s], kt * kBK, nn, half, e);
          else
            hopper::tma_load_4d(dst, &w_map, &full[s], nn, kt * kBK, half, e);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = a_s + s * S::a_bytes + wg * 64 * 128;
    const uint8_t* b = b_s + s * S::b_bytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = hopper::desc_k_major<128>(a + kk * 32);
      const uint64_t db = KMajorB ? hopper::desc_k_major<128>(b + kk * 32)
                                  : hopper::desc_mn_major<128>(b + kk * 16 * 128, kBoxBytes);
      Wgmma<BN, KMajorB ? 0 : 1>::ss(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();  // the previous stage's group is done: release it
    if (kt > 0 && tid % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int r = row0 + wg * 64 + warp * 16 + lane / 4;
  if (r >= M) return;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = col0 + 8 * i + 2 * (lane % 4);
    store_pair(out, N, r, c, acc[4 * i], acc[4 * i + 1]);
    store_pair(out, N, r + 8, c, acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int BM, int BN, bool KMajorB>
int launch_bf16(const CUtensorMap& x_map, const CUtensorMap& w_map, const int* te,
                __nv_bfloat16* out, int M, int N, int K, int bm, int n_half,
                cudaStream_t stream) {
  using S = GemmSmem<BM, BN>;
  auto kernel = moe_gemm_bf16_kernel<BM, BN, KMajorB>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, M / BM);
  kernel<<<grid, BM / 64 * 128 + 32, S::bytes, stream>>>(x_map, w_map, te, out, M, N, K, bm,
                                                         n_half);
  return (int)cudaGetLastError();
}

template <int BM>
int dispatch_bn(int bn, bool k_major, const CUtensorMap& xm, const CUtensorMap& wm,
                const int* te, __nv_bfloat16* out, int M, int N, int K, int bm, int n_half,
                cudaStream_t s) {
  if (bn == 128)
    return k_major ? launch_bf16<BM, 128, true>(xm, wm, te, out, M, N, K, bm, n_half, s)
                   : launch_bf16<BM, 128, false>(xm, wm, te, out, M, N, K, bm, n_half, s);
  return k_major ? launch_bf16<BM, 64, true>(xm, wm, te, out, M, N, K, bm, n_half, s)
                 : launch_bf16<BM, 64, false>(xm, wm, te, out, M, N, K, bm, n_half, s);
}

// ------------------------------------------------- fp32: CUDA-core tiles
constexpr int kBM = 64, kBN = 64, kBK32 = 16;

__global__ void __launch_bounds__(256) moe_gemm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ tile_expert,
    float* __restrict__ out, int M, int K, int N, int bm, long long stride_e,
    long long stride_k, long long stride_n, int n_half, long long half_stride) {
  __shared__ float xs[kBK32][kBM + 1];
  __shared__ float ws[kBK32][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const float* we = w + (long long)tile_expert[row0 / bm] * stride_e;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    for (int i = tid; i < kBM * kBK32; i += 256) {  // x tile, k fastest (coalesced)
      const int m = i / kBK32, kk = i % kBK32;
      const int row = row0 + m, k = k0 + kk;
      xs[kk][m] = (row < M && k < K) ? x[(long long)row * K + k] : 0.f;
    }
    for (int i = tid; i < kBN * kBK32; i += 256) {  // w tile, unit-stride dim fastest
      int n, kk;
      if (stride_k == 1) { n = i / kBK32; kk = i % kBK32; }
      else { n = i % kBN; kk = i / kBN; }
      const int col = col0 + n, k = k0 + kk;
      float v = 0.f;
      if (col < N && k < K) {
        const long long cn = col < n_half ? (long long)col * stride_n
                                          : half_stride + (long long)(col - n_half) * stride_n;
        v = we[(long long)k * stride_k + cn];
      }
      ws[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
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
      if (col < N) out[(long long)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// fp32. x [M, K] contiguous; out [M, N] contiguous; w addressed by
// strides (in elements): w[e, k, n] = w + e*stride_e + k*stride_k +
// col(n), col(n) = n*stride_n for n < n_half, else half_stride + (n -
// n_half)*stride_n. M must be a multiple of bm and bm a multiple of 64.
// Returns cudaGetLastError().
int moe_gemm_f32(const void* x, const void* w, const void* tile_expert, void* out, int M,
                 int K, int N, int bm, long long stride_e, long long stride_k,
                 long long stride_n, int n_half, long long half_stride, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  moe_gemm_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(tile_expert), static_cast<float*>(out), M, K, N, bm, stride_e,
      stride_k, stride_n, n_half, half_stride);
  return (int)cudaGetLastError();
}

// bf16. x [M, K] contiguous with K*2 a multiple of 16 bytes; out [M, N]
// contiguous. The weight is the 4-D tensor at `w` with dims `w_dims`
// (innermost first: (n_half, K, halves, E) when k_major == 0, (K, n_half,
// halves, E) when k_major == 1) and byte strides `w_strides` of dims
// 1..3; output column n < n_half reads half 0, column n >= n_half half 1
// at n - n_half. bn is 64 or 128; n_half a multiple of 64 when halves is
// 2. `device` is the operands' device. Returns 0, a cudaError_t, or
// hopper::kErrTensorMap + a CUresult.
int moe_gemm_bf16(const void* x, const void* w, const void* tile_expert, void* out, int M,
                  int K, int N, int bm, int bn, int k_major,
                  const unsigned long long* w_dims, const unsigned long long* w_strides,
                  int n_half, int device, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (const int e = hopper::bind_device(device)) return e;
  const int block_m = bm % 128 == 0 ? 128 : 64;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t x_strides[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {kBK, (uint32_t)block_m};
  int r = hopper::encode_bf16_map(&x_map, x, 2, x_dims, x_strides, x_box, 128);
  if (r != 0) return r;
  const uint32_t w_box[4] = {64, 64, 1, 1};
  r = hopper::encode_bf16_map(&w_map, w, 4, reinterpret_cast<const uint64_t*>(w_dims),
                              reinterpret_cast<const uint64_t*>(w_strides), w_box, 128);
  if (r != 0) return r;
  const int* te = static_cast<const int*>(tile_expert);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 128)
    return dispatch_bn<128>(bn, k_major != 0, x_map, w_map, te, o, M, N, K, bm, n_half, s);
  return dispatch_bn<64>(bn, k_major != 0, x_map, w_map, te, o, M, N, K, bm, n_half, s);
}

}  // extern "C"
