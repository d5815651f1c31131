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
// What bounds it on the H100: the bytes of K/V read (each walked key once
// per (row, KV head)); C*G <= 64 queries per head is far below the ~295
// FLOP/byte where the tensor cores would bound. At the serving shapes
// (a few rows, tens of keys) a call is latency-bound: the table read,
// the gather and two products in a row.
//
// bf16 design (tensor cores, hopper_mma.cuh): grid (row, KV head, query
// tile of 64 rows x key split). One warpgroup owns the tile: the C*G
// query rows of (row, head) are one 64-row wgmma A operand (more rows
// take more tiles). Keys go in tiles of 64, gathered from the pool's
// bs-token blocks through the block table by 16-byte cp.async copies
// straight into the 128-byte swizzled layout wgmma reads (32-byte rows
// for the 16-wide heads of the smoke configs), two tiles in flight (the next tile's gather overlaps this tile's math).
// Per tile: S = Q K^T (m64n64k16, both K-major), the online softmax on
// the accumulator fragment (as flash_attention.cu), P rounded to bf16
// in registers as the A operand of O += P V (m64n{hd}k16, V MN-major).
// Keys past the last one any row of the tile can see are not walked
// (exact: they would be masked); keys past the row's walk take no part
// in max or sum. Long key ranges split across blocks (flash-decoding,
// key_splits.cuh): the wrapper sizes the grid's splits from the table
// width (the lengths live on the device), each block divides the key
// tiles its row actually walks, and an ordered fp32 combine merges the
// splits. A decode step of B*Kv = 32 pairs over a long cache so still
// fills the SMs; one split writes the output directly.
//
// fp32 keeps the CUDA-core kernel (TF32 would break the fp32 token
// identity with the CPU): grid (row, kv head, tile of up to 64 query
// rows: a whole-suffix bucket of 64 tokens x G 4 at hd 128 does not fit
// one block's shared memory; each query row's arithmetic is the same in
// any tile); key tiles of 32 staged in fp32 shared memory (K padded to
// hd+1 columns); one warp scores one query row at a time, lane j key j;
// per-row (m, l, acc) in shared memory.
#include "hopper_mma.cuh"
#include "key_splits.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------ fp32: CUDA-core kernel
constexpr int kTile = 32;      // keys per tile (one per lane)
constexpr int kThreads = 128;  // 4 warps
constexpr int kF32Rows = 64;   // query rows per block

__global__ void __launch_bounds__(kThreads) paged_gqa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ pool_k,
    const float* __restrict__ pool_v, const int* __restrict__ tables,
    const int* __restrict__ past_len, const int* __restrict__ lengths,
    float* __restrict__ out, int C, int Kv, int G, int hd, int bs, int nb,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kF32Rows;     // this block's first query row
  const int R = min(C * G - r0, kF32Rows);  // and its row count
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

  // queries of (b, :, h, :, :) -> q_s[r], query row r0 + r = c*G + g
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = r0 + i / hd, d = i % hd;
    const int c = r / G, g = r % G;
    q_s[i] = q[(((size_t)b * C + c) * Kv + h) * G * hd + (size_t)g * hd + d];
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
      k_s[j * (hd + 1) + d] = pool_k[src];
      v_s[j * hd + d] = pool_v[src];
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      const int qpos = past + (r0 + r) / G;
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
      pw[lane] = p;
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
    const int r = r0 + i / hd, d = i % hd;
    const int c = r / G, g = r % G;
    out[(((size_t)b * C + c) * Kv + h) * G * hd + (size_t)g * hd + d] =
        acc_s[i] / fmaxf(l_s[i / hd], 1e-30f);
  }
}

// Shared memory of one block of the fp32 kernel for `rows` query rows of
// a (row, kv head) pair: at most kF32Rows of them a block.
size_t f32_smem_bytes(int rows, int hd) {
  const size_t R = rows < kF32Rows ? rows : kF32Rows;
  return sizeof(float) * (2 * R * hd + 2 * R + kTile * (hd + 1) + kTile * hd +
                          (kThreads / 32) * kTile) +
         sizeof(int) * kTile;
}

int launch_f32(const void* q, const void* pk, const void* pv, const void* tables,
               const void* past, const void* lengths, void* out, int B, int C, int Kv,
               int G, int hd, int bs, int nb, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(C * G, hd);
  cudaError_t e = cudaFuncSetAttribute(paged_gqa_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, Kv, (C * G + kF32Rows - 1) / kF32Rows);
  paged_gqa_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pk),
      static_cast<const float*>(pv), static_cast<const int*>(tables),
      static_cast<const int*>(past), static_cast<const int*>(lengths),
      static_cast<float*>(out), C, Kv, G, hd, bs, nb, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------- bf16: wgmma over cp.async key tiles
constexpr int kRows = 64;   // query rows per block: one warpgroup's wgmma M
constexpr int kKeys = 64;   // keys per tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct GqaCfg {
  // swizzled row bytes: a 16-wide head (a smoke config's) is one 32-byte row
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int chunk = 64 * SW;                    // 64 rows of SW bytes
  static constexpr int tile = 64 * HD * 2;                 // [64, HD] = HD*2/SW chunks
  static constexpr int smem = tile * 5 + 1024;             // Q + 2 x (K, V)
};

// Gather one [64, HD] tile of rows into the swizzled layout at `dst`.
// Row j reads `src_of(j)` (an element pointer, or nullptr: zero-fill;
// the copy is then given `any`, a valid address it reads nothing of).
template <int HD, typename SrcOf>
__device__ __forceinline__ void gather_tile(uint32_t dst, SrcOf src_of,
                                            const __nv_bfloat16* any, int tid) {
  using C = GqaCfg<HD>;
  constexpr int kPieces = HD * 2 / 16;  // 16-byte pieces per row
  for (int i = tid; i < 64 * kPieces; i += kMmaThreads) {
    const int j = i / kPieces, piece = i % kPieces;
    const int c = piece / (C::SW / 16), p = piece % (C::SW / 16);
    const __nv_bfloat16* src = src_of(j);
    hopper::cp_async16(dst + hopper::swz<C::SW>(j, c, p), src ? src + piece * 8 : any,
                       src != nullptr);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1) paged_gqa_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ pool_k,
    const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ tables,
    const int* __restrict__ past_len, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_ml,
    int C, int Kv, int G, int bs, int nb, int n_rt, float scale) {
  using Cfg = GqaCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);
  uint8_t* k_s = q_s + Cfg::tile;  // 2 tiles
  uint8_t* v_s = k_s + 2 * Cfg::tile;
  const int b = blockIdx.x, h = blockIdx.y, rt = blockIdx.z % n_rt, split = blockIdx.z / n_rt;
  const int splits = gridDim.z / n_rt;
  const int R = C * G, row0 = rt * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int B = gridDim.x;

  const int past = past_len[b];
  const int last = past + lengths[b] - 1;
  const int walk_blocks = min(nb, (last >= 0 ? last / bs : 0) + 1);
  // keys walked for the row, cut at the last position a row of this tile
  // sees (later keys would all be masked: exact to skip)
  const int c_max = min(C - 1, (min(R, row0 + kRows) - 1) / G);
  const int n_keys = min(walk_blocks * bs, past + c_max + 1);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int2 span = key_splits::tiles(n_tiles, split, splits);
  const int t_begin = span.x, t_end = span.y;

  const int* row_table = tables + (size_t)b * nb;
  auto key_src = [&](const __nv_bfloat16* pool, int t) -> const __nv_bfloat16* {
    if (t >= n_keys) return nullptr;
    const long long blk = row_table[t / bs];
    return pool + ((blk * bs + t % bs) * Kv + h) * HD;
  };
  auto load_kv = [&](int t, int buf) {
    const int t0 = t * kKeys;
    gather_tile<HD>(hopper::smem_u32(k_s + buf * Cfg::tile),
                    [&](int j) { return key_src(pool_k, t0 + j); }, pool_k, tid);
    gather_tile<HD>(hopper::smem_u32(v_s + buf * Cfg::tile),
                    [&](int j) { return key_src(pool_v, t0 + j); }, pool_v, tid);
  };

  const int r_lo = warp * 16 + lane / 4;  // tile rows r_lo and r_lo + 8
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (t_begin < t_end) {
    gather_tile<HD>(hopper::smem_u32(q_s), [&](int j) -> const __nv_bfloat16* {
      const int r = row0 + j;
      if (r >= R) return nullptr;
      return q + (((size_t)b * C + r / G) * Kv + h) * G * HD + (size_t)(r % G) * HD;
    }, q, tid);
    load_kv(t_begin, 0);
    hopper::cp_async_commit();
  }
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = past + (row0 + r_lo + 8 * hh) / G;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();
    const uint8_t* kt = k_s + buf * Cfg::tile;
    const uint8_t* vt = v_s + buf * Cfg::tile;

    float sc[32];  // S = Q K^T, m64n64 (the first k step overwrites it)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk * 32 / Cfg::SW) * Cfg::chunk + (kk * 32) % Cfg::SW;
      hopper::Wgmma<64, 0>::ss(sc, hopper::desc_k_major<Cfg::SW>(q_s + off),
                               hopper::desc_k_major<Cfg::SW>(kt + off), kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // sc[4i + 2hh + j]: row r_lo + 8hh, key t*64 + 8i + 2*(lane%4) + j
    const int key0 = t * kKeys + 2 * (lane % 4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + 8 * i + j;
          float v = sc[4 * i + 2 * hh + j] * scale;
          if (key >= n_keys) v = -INFINITY;  // not walked: no part in max or sum
          else if (key > qpos[hh]) v = kNegInf;
          sc[4 * i + 2 * hh + j] = v;
          mx[hh] = fmaxf(mx[hh], v);
        }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f((sc[4 * i + 2 * hh + j] - m[hh]) * kLog2e);
          sc[4 * i + 2 * hh + j] = p;
          ps[hh] += p;
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 1);
      ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 2);
      l[hh] = l[hh] * alpha[hh] + ps[hh];
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    // P in bf16 as the A operand: k step j holds keys 16j .. 16j + 15,
    // the accumulator's chunks 2j and 2j + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        pa[j][w] = hopper::pack_bf16x2(sc[8 * j + 2 * w], sc[8 * j + 2 * w + 1]);

    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::Wgmma<HD, 1>::rs(o, pa[j], hopper::desc_mn_major<Cfg::SW>(vt + j * 16 * Cfg::SW,
                                                                        Cfg::chunk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncthreads();  // this buffer is read: the next iteration may refill it
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + r_lo + 8 * hh;
    if (r >= R) continue;
    if (part_o == nullptr) {
      const float denom = fmaxf(l[hh], 1e-30f);
      __nv_bfloat16* orow = out + (((size_t)b * C + r / G) * Kv + h) * G * HD +
                            (size_t)(r % G) * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * (lane % 4)) =
            __floats2bfloat162_rn(o[4 * i + 2 * hh] / denom, o[4 * i + 2 * hh + 1] / denom);
    } else {  // split partial [split, b, h, r]: o [HD], (m, l)
      const size_t idx = (((size_t)split * B + b) * Kv + h) * R + r;
      float* po = part_o + idx * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<float2*>(po + 8 * i + 2 * (lane % 4)) =
            make_float2(o[4 * i + 2 * hh], o[4 * i + 2 * hh + 1]);
      if (lane % 4 == 0) {
        part_ml[2 * idx] = m[hh];
        part_ml[2 * idx + 1] = l[hh];
      }
    }
  }
}

// Where the combine writes row (b, h, r): out [B, C, Kv, G, hd].
struct GqaOutRow {
  __nv_bfloat16* out;
  int C, Kv, G, hd;
  __device__ __nv_bfloat16* operator()(size_t row) const {
    const int R = C * G;
    const int r = row % R, h = (row / R) % Kv;
    const size_t b = row / ((size_t)R * Kv);
    return out + ((b * C + r / G) * Kv + h) * G * hd + (size_t)(r % G) * hd;
  }
};

template <int HD>
int launch_bf16(const void* q, const void* pk, const void* pv, const void* tables,
                const void* past, const void* lengths, void* out, void* part_o,
                void* part_ml, int B, int C, int Kv, int G, int bs, int nb, int splits,
                float scale, cudaStream_t stream) {
  using Cfg = GqaCfg<HD>;
  static cudaError_t attr = cudaFuncSetAttribute(
      paged_gqa_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_rt = (C * G + kRows - 1) / kRows;
  dim3 grid(B, Kv, n_rt * splits);
  float* po = splits > 1 ? static_cast<float*>(part_o) : nullptr;
  paged_gqa_bf16_kernel<HD><<<grid, kMmaThreads, Cfg::smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(tables),
      static_cast<const int*>(past), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), po, static_cast<float*>(part_ml), C, Kv, G, bs, nb,
      n_rt, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  key_splits::combine_kernel<<<B * Kv * C * G, HD < 128 ? HD : 128, 0, stream>>>(
      po, static_cast<const float*>(part_ml), splits, B * Kv * C * G, HD,
      GqaOutRow{static_cast<__nv_bfloat16*>(out), C, Kv, G, HD});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block of the fp32 kernel needs for C*G query rows of
// width hd, 64 rows a block at most (the wrapper rejects shapes above the
// 227 KB a block may use).
size_t paged_prefill_gqa_smem(int rows, int hd) { return f32_smem_bytes(rows, hd); }

// Keys per bf16 key tile (the unit the splits are counted in).
int paged_prefill_gqa_key_tile() { return kKeys; }

// dtype: 0 = float32, 1 = bfloat16 (hd in {16, 64, 128}). bf16 with
// splits > 1 needs part_o (splits * B * Kv * C*G * hd floats) and part_ml
// (splits * B * Kv * C*G * 2 floats) scratch. Returns 0 or a cudaError_t.
int paged_prefill_gqa(const void* q, const void* pool_k, const void* pool_v,
                      const void* tables, const void* past_len, const void* lengths,
                      void* out, void* part_o, void* part_ml, int B, int C, int Kv, int G,
                      int hd, int bs, int nb, int splits, float scale, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch_f32(q, pool_k, pool_v, tables, past_len, lengths, out, B, C, Kv, G, hd,
                      bs, nb, scale, s);
  switch (hd) {
    case 16: return launch_bf16<16>(q, pool_k, pool_v, tables, past_len, lengths, out, part_o,
                                    part_ml, B, C, Kv, G, bs, nb, splits, scale, s);
    case 64: return launch_bf16<64>(q, pool_k, pool_v, tables, past_len, lengths, out, part_o,
                                    part_ml, B, C, Kv, G, bs, nb, splits, scale, s);
    case 128: return launch_bf16<128>(q, pool_k, pool_v, tables, past_len, lengths, out,
                                      part_o, part_ml, B, C, Kv, G, bs, nb, splits, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
