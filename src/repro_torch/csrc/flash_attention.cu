// Blockwise online-softmax (flash) attention over dense [BH, S, dh]
// tensors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:66, body `_kernel`
// :22), reached through its entry point `mha` (ops.py:24).
//
// What it computes: o = softmax(q k^T * dh^-0.5) v per (batch*head), with
// the causal mask aligning the queries to the END of the keys (query i
// sees key j iff j <= i + sk - sq) and masked scores set to NEG_INF =
// -1e30. Softmax is online in fp32 with the denominator clamped at 1e-30;
// P is rounded to the value dtype before the PV product (the TPU kernel's
// `p.astype(v.dtype)`), sums are fp32, output is in the query dtype.
// Non-causal attention walks every key.
//
// What bounds it on the H100: at the shapes it is timed at (S = 512 and
// 8192, dh = 64 and 128) the score and PV products, 4*dh operations per
// visible (query, key) pair, against the bytes of q, k, v and o read or
// written once. On the tensor cores that would be far above the ridge; this
// first version runs them on CUDA cores in fp32, so it is bound by
// shared-memory reads and FMA issue, well above its bound.
//
// Design. Grid (bh, tile of kRows = 64 query rows). The block stages its
// query rows in fp32 shared memory, then walks key tiles of 32, stopping
// after the last tile a causal row of this block can see (tiles past the
// diagonal are skipped, as on the TPU) and masking the ragged end of the
// keys itself, so no length has to divide a tile (the TPU version asserts
// divisibility). K is staged padded to dh + 1 columns so 32 lanes reading
// 32 keys hit 32 banks. Each warp owns 8 query rows for the whole walk:
// lane j scores key j for its rows, the warp reduces max and sum by
// shuffles, and for the PV product each lane owns dh/32 output columns,
// the fp32 accumulator and the softmax state staying in registers. The
// TPU's tile sizes bq / bk shape VMEM blocks; they have no meaning here
// and the wrapper does not pass them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr int kMaxColsPerLane = 4;            // dh <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  float* q_s = smem;                    // [kRows, dh]
  float* k_s = q_s + kRows * dh;        // [kTile, dh + 1]
  float* v_s = k_s + kTile * (dh + 1);  // [kTile, dh]
  float* p_s = v_s + kTile * dh;        // [kRows, kTile] P in the value dtype

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = sk - sq;  // query i sits at key position i + shift
  const T* qb = q + (size_t)bh * sq * dh;
  const T* kb = k + (size_t)bh * sk * dh;
  const T* vb = v + (size_t)bh * sk * dh;

  for (int i = tid; i < kRows * dh; i += kThreads) {
    const int row = row0 + i / dh;
    q_s[i] = row < sq ? to_f(qb[(size_t)row * dh + i % dh]) : 0.f;
  }
  // keys any row of this block can see
  int n_keys = sk;
  if (causal) n_keys = max(0, min(sk, min(sq, row0 + kRows) + shift));

  const int my_row0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int tile_n = min(kTile, n_keys - t0);
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int i = tid; i < tile_n * dh; i += kThreads) {
      const int j = i / dh, d = i % dh;
      const size_t src = (size_t)(t0 + j) * dh + d;
      k_s[j * (dh + 1) + d] = to_f(kb[src]);
      v_s[i] = to_f(vb[src]);
    }
    __syncthreads();

    const bool walked = lane < tile_n;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    if (walked) {
      const float* kj = k_s + lane * (dh + 1);
      const float* q0 = q_s + my_row0 * dh;
      for (int d = 0; d < dh; ++d) {
        const float kd = kj[d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[i] += q0[i * dh + d] * kd;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float si = -INFINITY;  // not walked: no part in max or sum
      if (walked) {
        si = s[i] * scale;
        if (causal && t0 + lane > row0 + my_row0 + i + shift) si = kNegInf;
      }
      float tmax = si;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      const float p = walked ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      p_s[(my_row0 + i) * kTile + lane] = to_f(from_f<T>(p));  // P in the value dtype
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < tile_n; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = p_s[(my_row0 + i) * kTile + j];
      const float* vj = v_s + j * dh;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c) {
        const int col = lane + 32 * c;
        if (col < dh) {
          const float vv = vj[col];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][c] += pj[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + my_row0 + i;
    if (row >= sq) continue;
    T* o = out + ((size_t)bh * sq + row) * dh;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) {
      const int col = lane + 32 * c;
      if (col < dh) o[col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

size_t smem_bytes(int dh) {
  return sizeof(float) *
         ((size_t)kRows * dh + kTile * (dh + 1) + (size_t)kTile * dh + kRows * kTile);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int sq,
           int sk, int dh, int causal, float scale, cudaStream_t stream) {
  if (BH == 0 || sq == 0) return 0;
  const size_t smem = smem_bytes(dh);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (sq + kRows - 1) / kRows);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, dh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs at head width dh.
size_t flash_attention_smem(int dh) { return smem_bytes(dh); }

// Widest head the kernel's per-lane accumulator holds.
int flash_attention_max_head_dim() { return 32 * kMaxColsPerLane; }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* out, int BH,
                    int sq, int sk, int dh, int causal, float scale, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, BH, sq, sk, dh, causal, scale, s);
  return launch<__nv_bfloat16>(q, k, v, out, BH, sq, sk, dh, causal, scale, s);
}

}  // extern "C"
