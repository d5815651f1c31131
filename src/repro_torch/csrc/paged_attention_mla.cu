// Absorbed MLA paged attention over block-table latent pools, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_prefill_mla`
// (src/repro/kernels/paged_attention/paged_attention.py:219, body
// `_mla_kernel` :168); decode is its chunk-of-1 case (`paged_decode_mla`
// :269), so one kernel serves both serving phases.
//
// What it computes: for each row b, the C*H query rows of a chunk (query
// row i = c*H + h sits at absolute position past[b] + c) attend causally
// over the row's latent keys, which live in pool blocks named by
// tables[b, :]: score = (q_lat . ckv + q_rope . krope) * scale, with
// NEG_INF = -1e30 for keys past the query's position; online softmax in
// fp32 with the denominator clamped at 1e-30; the value read stays in
// latent space, o_lat = softmax . ckv, with P kept in fp32 (unlike the GQA
// kernel, nothing is rounded to the pool dtype). q and the output are
// fp32; the pools are fp32 or bf16 and are read as fp32. Skip rule (as on
// the TPU): logical block j is walked iff j == 0 or j*bs <= past + len - 1,
// so all-pad rows (len 0) and dead rows (all-trash tables) still read
// block 0 and produce a finite output.
//
// What bounds it on the H100: at decode, the bytes of the fp32 queries and
// outputs (C*H rows of r + rd in, r out) outweigh the latents; at a 32-token
// prefill chunk, bytes and fp32 operations are of one size (2*(r+rd+r) per
// query row and visible key, on CUDA cores: the math is specified in fp32).
//
// Design. The TPU kernel keeps all C*H query rows of a sequence row in one
// program (an 8 MB fp32 accumulator at C=32, H=128, r=512). A Hopper block
// has 227 KB, so the grid is (row b, tile of kRows = 32 query rows). The
// block stages its 32 query rows [q_lat | q_rope] in fp32 shared memory
// (74 KB at r + rd = 576), then walks the row's keys in tiles of 32: the
// tile's table entries into shared memory, then the tile's latent keys
// [ckv | krope] in fp32 (padded to r + rd + 1 columns, so 32 lanes reading
// 32 keys hit 32 banks). Each warp owns 4 query rows for the whole walk:
// lane j scores key j for its 4 rows, the warp reduces max and sum by
// shuffles, and for the PV product each lane owns r/32 latent columns of
// each row, the fp32 accumulator (4 x 16 values at r = 512) and the
// softmax state staying in registers. The staged ckv columns serve as the
// values, so the latents are read once per (row b, row tile).
//
// The cost of that tiling: all H heads of a sequence row share one latent
// stream (MLA is MQA-like), and each of the C*H/32 row tiles re-reads it:
// 4 times per decode step at H = 128, 128 times per 32-token chunk. The
// latents are small next to the fp32 queries, so this is not yet the
// limit; 64-row wgmma tiles over all heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr int kMaxColsPerLane = 16;           // r <= 32 * 16 = 512
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) paged_mla_kernel(
    const float* __restrict__ q_lat, const float* __restrict__ q_rope,
    const T* __restrict__ pool_ckv, const T* __restrict__ pool_krope,
    const int* __restrict__ tables, const int* __restrict__ past_len,
    const int* __restrict__ lengths, float* __restrict__ out, int C, int H,
    int r, int rd, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int n_rows = C * H;
  const int w = r + rd;   // score width
  const int kw = w + 1;   // padded key row in shared memory
  float* q_s = smem;                   // [kRows, w]
  float* k_s = q_s + kRows * w;        // [kTile, w + 1]: ckv | krope
  float* p_s = k_s + kTile * kw;       // [kRows, kTile] P of the tile
  int* off_s = reinterpret_cast<int*>(p_s + kRows * kTile);  // [kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int past = past_len[b];
  const int last = past + lengths[b] - 1;  // last real query position
  const int last_block = last >= 0 ? last / bs : 0;
  const int n_keys = min(nb, last_block + 1) * bs;  // block 0 always runs

  // this block's query rows [q_lat | q_rope]; rows past C*H are zeros
  for (int i = tid; i < kRows * w; i += kThreads) {
    const int rr = i / w, d = i % w;
    const int row = row0 + rr;
    float v = 0.f;
    if (row < n_rows) {
      const size_t qr = (size_t)b * n_rows + row;
      v = d < r ? q_lat[qr * r + d] : q_rope[qr * rd + (d - r)];
    }
    q_s[i] = v;
  }

  const int my_row0 = warp * kRowsPerWarp;  // within the block
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxColsPerLane];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = past + (row0 + my_row0 + i) / H;
#pragma unroll
    for (int k = 0; k < kMaxColsPerLane; ++k) acc[i][k] = 0.f;
  }

  const int* row_table = tables + (size_t)b * nb;
  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int tile_n = min(kTile, n_keys - t0);
    __syncthreads();  // previous tile fully consumed (and q_s written)
    if (tid < tile_n) {  // table entries of this tile -> pool token slots
      const int t = t0 + tid;
      off_s[tid] = row_table[t / bs] * bs + t % bs;
    }
    __syncthreads();
    for (int i = tid; i < tile_n * w; i += kThreads) {
      const int j = i / w, d = i % w;
      const size_t slot = (size_t)off_s[j];
      k_s[j * kw + d] =
          d < r ? to_f(pool_ckv[slot * r + d]) : to_f(pool_krope[slot * rd + (d - r)]);
    }
    __syncthreads();

    const bool walked = lane < tile_n;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    if (walked) {
      const float* kj = k_s + lane * kw;
      const float* q0 = q_s + my_row0 * w;
      for (int d = 0; d < w; ++d) {
        const float kd = kj[d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[i] += q0[i * w + d] * kd;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      // not walked: no part in max or sum
      float si = -INFINITY;
      if (walked) si = (t0 + lane > qpos[i]) ? kNegInf : s[i] * scale;
      float tmax = si;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      const float p = walked ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
      p_s[(my_row0 + i) * kTile + lane] = p;  // P stays fp32
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) acc[i][k] *= alpha;
    }
    __syncwarp();
    // PV in latent space: lane owns columns lane + 32k of its warp's rows
    for (int j = 0; j < tile_n; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = p_s[(my_row0 + i) * kTile + j];
      const float* vj = k_s + j * kw;
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < r) {
          const float v = vj[c];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][k] += pj[i] * v;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + my_row0 + i;
    if (row >= n_rows) continue;
    float* o = out + ((size_t)b * n_rows + row) * r;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int k = 0; k < kMaxColsPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < r) o[c] = acc[i][k] / denom;
    }
  }
}

size_t smem_bytes(int r, int rd) {
  const size_t w = (size_t)r + rd;
  return sizeof(float) * (kRows * w + kTile * (w + 1) + (size_t)kRows * kTile) +
         sizeof(int) * kTile;
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* pool_ckv,
           const void* pool_krope, const void* tables, const void* past,
           const void* lengths, void* out, int B, int C, int H, int r, int rd,
           int bs, int nb, float scale, cudaStream_t stream) {
  if (B == 0 || C * H == 0) return 0;
  const size_t smem = smem_bytes(r, rd);
  cudaError_t e = cudaFuncSetAttribute(paged_mla_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C * H + kRows - 1) / kRows);
  paged_mla_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const T*>(pool_ckv), static_cast<const T*>(pool_krope),
      static_cast<const int*>(tables), static_cast<const int*>(past),
      static_cast<const int*>(lengths), static_cast<float*>(out), C, H, r, rd, bs, nb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for latent width r and rope width rd.
size_t paged_prefill_mla_smem(int r, int rd) { return smem_bytes(r, rd); }

// Widest latent the kernel's per-lane accumulator holds.
int paged_prefill_mla_max_rank() { return 32 * kMaxColsPerLane; }

// Pool dtype: 0 = float32, 1 = bfloat16 (q and out are float32).
// Returns cudaGetLastError().
int paged_prefill_mla(const void* q_lat, const void* q_rope, const void* pool_ckv,
                      const void* pool_krope, const void* tables, const void* past_len,
                      const void* lengths, void* out, int B, int C, int H, int r, int rd,
                      int bs, int nb, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths,
                         out, B, C, H, r, rd, bs, nb, scale, s);
  return launch<__nv_bfloat16>(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len,
                               lengths, out, B, C, H, r, rd, bs, nb, scale, s);
}

}  // extern "C"
