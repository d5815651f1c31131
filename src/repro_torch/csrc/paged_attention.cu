// Paged GQA attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_prefill_gqa`
// (src/repro/kernels/paged_attention/paged_attention.py:105, body
// `_gqa_kernel` :58); decode is its chunk-of-1 case (`paged_decode_gqa`
// :153), so one kernel serves both serving phases.
//
// What it computes: for each row b and KV head h, the C*G queries of a
// chunk (query row r = c*G + g sits at absolute position past[b] + c)
// attend causally (key position <= query position) over the row's keys,
// which live in pool blocks named by tables[b, :]. Softmax is online in
// fp32 with NEG_INF = -1e30 for masked keys and the denominator clamped
// at 1e-30; P is rounded to the value dtype before the PV product (the
// TPU kernel's `p.astype(v.dtype)`), sums are fp32, output is in the
// query dtype. Skip rule (as on the TPU): logical block j is walked iff
// j == 0 or j*bs <= past + len - 1, so all-pad rows (len 0) and dead rows
// (all-trash tables) still read block 0 and produce a finite output.
//
// What bounds it on the H100: the bytes of K/V read (decode reads every
// walked block of every row once per KV head; C*G <= 64 queries per head
// is far below the ~295 FLOP/byte where the tensor cores would bound).
// Design: grid (row, kv head); each block walks its row's keys in tiles
// of 32 keys, first reading the tile's 32/bs table entries into shared
// memory, then staging the K/V tile in fp32 shared memory (K padded to
// hd+1 columns so 32 lanes reading 32 keys hit 32 banks). One warp owns
// one query row at a time: lane j scores key j, the warp reduces max and
// sum by shuffles, and for the PV product each lane owns hd/32 output
// columns. Per-row online-softmax state (m, l, acc) lives in shared
// memory so any C*G fits. K/V are read once per (row, kv head): the
// GQA sharing of the TPU kernel. Simple first; TMA / wgmma tiles are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // keys per tile (one per lane)
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_gqa_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ tables,
    const int* __restrict__ past_len, const int* __restrict__ lengths,
    T* __restrict__ out, int C, int Kv, int G, int hd, int bs, int nb,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int R = C * G;
  float* q_s = smem;                       // [R, hd]
  float* acc_s = q_s + R * hd;             // [R, hd]
  float* m_s = acc_s + R * hd;             // [R]
  float* l_s = m_s + R;                    // [R]
  float* k_s = l_s + R;                    // [kTile, hd + 1]
  float* v_s = k_s + kTile * (hd + 1);     // [kTile, hd]
  float* pw_s = v_s + kTile * hd;          // [nwarps, kTile] P per warp
  int* off_s = reinterpret_cast<int*>(pw_s + (kThreads / 32) * kTile);  // [kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int past = past_len[b];
  const int last = past + lengths[b] - 1;  // last real query position
  const int last_block = last >= 0 ? last / bs : 0;
  const int walk_blocks = min(nb, last_block + 1);  // >= 1: block 0 always runs
  const int n_keys = walk_blocks * bs;

  // queries of (b, :, h, :, :) -> q_s[r = c*G + g]
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int c = r / G, g = r % G;
    q_s[i] = to_f(q[(((size_t)b * C + c) * Kv + h) * G * hd + (size_t)g * hd + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int* row_table = tables + (size_t)b * nb;
  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int tile_n = min(kTile, n_keys - t0);
    __syncthreads();  // previous tile fully consumed
    if (tid < tile_n) {  // table entries of this tile -> element offsets
      const int t = t0 + tid;
      const long long bid = row_table[t / bs];
      off_s[tid] = (int)(((bid * bs + t % bs) * Kv + h));
    }
    __syncthreads();
    for (int i = tid; i < tile_n * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const size_t src = (size_t)off_s[j] * hd + d;
      k_s[j * (hd + 1) + d] = to_f(pool_k[src]);
      v_s[j * hd + d] = to_f(pool_v[src]);
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      const int qpos = past + r / G;
      const bool walked = lane < tile_n;
      float s = -INFINITY;  // not walked: no part in max or sum
      if (walked) {
        float dot = 0.f;
        const float* qr = q_s + r * hd;
        const float* kj = k_s + lane * (hd + 1);
        for (int d = 0; d < hd; ++d) dot += qr[d] * kj[d];
        s = dot * scale;
        if (t0 + lane > qpos) s = kNegInf;
      }
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tmax);
      const float p = walked ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_prev - m_new);
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      float* pw = pw_s + warp * kTile;
      pw[lane] = to_f(from_f<T>(p));  // P in the value dtype
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = acc_s[r * hd + d] * alpha;
        for (int j = 0; j < tile_n; ++j) a += pw[j] * v_s[j * hd + d];
        acc_s[r * hd + d] = a;
      }
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int c = r / G, g = r % G;
    out[(((size_t)b * C + c) * Kv + h) * G * hd + (size_t)g * hd + d] =
        from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t smem_bytes(int R, int hd) {
  return sizeof(float) * ((size_t)2 * R * hd + 2 * R + kTile * (hd + 1) + kTile * hd +
                          (kThreads / 32) * kTile) +
         sizeof(int) * kTile;
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* tables,
           const void* past, const void* lengths, void* out, int B, int C,
           int Kv, int G, int hd, int bs, int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(C * G, hd);
  cudaError_t e = cudaFuncSetAttribute(paged_gqa_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, Kv);
  paged_gqa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const int*>(tables), static_cast<const int*>(past),
      static_cast<const int*>(lengths), static_cast<T*>(out), C, Kv, G, hd, bs, nb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for C*G query rows of width hd (the
// wrapper rejects shapes above the 227 KB a block may use).
size_t paged_prefill_gqa_smem(int rows, int hd) { return smem_bytes(rows, hd); }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int paged_prefill_gqa(const void* q, const void* pool_k, const void* pool_v,
                      const void* tables, const void* past_len, const void* lengths,
                      void* out, int B, int C, int Kv, int G, int hd, int bs, int nb,
                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, tables, past_len, lengths, out, B, C, Kv, G,
                         hd, bs, nb, scale, s);
  return launch<__nv_bfloat16>(q, pool_k, pool_v, tables, past_len, lengths, out, B, C,
                               Kv, G, hd, bs, nb, scale, s);
}

}  // extern "C"
