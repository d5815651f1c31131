// Absorbed MLA paged attention over block-table latent pools, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_prefill_mla`
// (src/repro/kernels/paged_attention/paged_attention.py:219, body
// `_mla_kernel` :173); decode is its chunk-of-1 case (`paged_decode_mla`
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
// outputs (C*H rows of r + rd in, r out) outweigh the latents; at a
// 32-token prefill chunk, bytes and fp32-exact operations are of one size.
//
// bf16 pools: tensor cores with split-bf16 operands. The function is
// specified in fp32, so neither q nor P may be rounded to bf16 once (that
// alone misses the fp32 tolerance by a factor of hundreds at deepseek's
// widths). Each is split into bf16 terms instead, x = hi + mid + lo with
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid). q takes
// three terms, which hold all 24 significant bits of an fp32 q (two miss
// 1e-5 at deepseek's widths). P takes two, which carry it to 16
// significant bits: the one bf16 rounding the output sees (worst error
// at deepseek's decode by the CPU emulation `paged_prefill_mla_split` of
// ref.py: 0.43 of 1e-5 with two P terms, 0.25 with three). The latents
// are bf16 already, so every product of a term with a latent is exact in
// fp32, and wgmma sums them into fp32 accumulators.
//
// Design. A cluster of two CTAs (one warpgroup each, on two SMs) owns
// 64 query rows (one wgmma M tile; at H = 128 that is 64 heads of one
// chunk position) and splits the 576 score columns: rank 0 holds latent
// columns [0, 256), rank 1 [256, 512) and the rope columns (rd <= 64),
// each as 64-column chunks of 128-byte swizzled rows; a narrower latent
// is zero-padded to 512. Each CTA stages its columns of the 64 query
// rows once, as three bf16 terms (120 KB at deepseek's widths: the
// whole q would not fit one SM beside a key tile), then walks the row's
// keys in tiles of 64, gathered from the 4-token pool blocks by 16-byte
// cp.async copies straight into the swizzled layout (two tiles in
// flight). Per tile each CTA computes its partial S over its columns
// (m64n64k16, 3 q terms x 16 or 20 k steps), writes it into its peer's
// shared memory with st.async, which completes on the peer's mbarrier,
// waits on its own for the peer's partial and adds it to its own (fp32
// addition commutes, so both CTAs hold the same S, the same softmax and
// the same P); a second mbarrier, which the peer arrives on remotely
// once it has read, guards the buffer against the next tile's write.
// The online softmax runs on the accumulator fragment; P goes to
// registers as two bf16 terms, the A operand of O += P . ckv, whose B
// operand is the same latent tile read MN-major: each CTA accumulates
// its own 256 output columns (64 x 256 fp32: 128 registers a thread).
// Each latent leaves HBM once per (row tile, key split) and serves as
// key and value. Keys past the last position a row of the tile can see
// are not walked (exact: they would be masked). Long tables split the
// keys over clusters (flash-decoding, key_splits.cuh) with an ordered
// fp32 combine.
//
// fp32 pools keep the CUDA-core kernel: grid (row b, tile of kRows = 32
// query rows); the block stages its query rows [q_lat | q_rope] in fp32
// shared memory, walks the keys in tiles of 32 staged as fp32 (padded to
// r + rd + 1 columns), each warp owning 4 query rows, lane j scoring key j,
// the PV accumulator (4 x 16 values at r = 512) in registers.
#include <cooperative_groups.h>

#include "hopper_mma.cuh"
#include "key_splits.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------ fp32: CUDA-core kernel
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr int kMaxColsPerLane = 16;           // r <= 32 * 16 = 512
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads, 1) paged_mla_kernel(
    const float* __restrict__ q_lat, const float* __restrict__ q_rope,
    const float* __restrict__ pool_ckv, const float* __restrict__ pool_krope,
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
      k_s[j * kw + d] = d < r ? pool_ckv[slot * r + d] : pool_krope[slot * rd + (d - r)];
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

int launch(const void* q_lat, const void* q_rope, const void* pool_ckv,
           const void* pool_krope, const void* tables, const void* past,
           const void* lengths, void* out, int B, int C, int H, int r, int rd,
           int bs, int nb, float scale, cudaStream_t stream) {
  if (B == 0 || C * H == 0) return 0;
  const size_t smem = smem_bytes(r, rd);
  cudaError_t e = cudaFuncSetAttribute(paged_mla_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (C * H + kRows - 1) / kRows);
  paged_mla_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(pool_ckv), static_cast<const float*>(pool_krope),
      static_cast<const int*>(tables), static_cast<const int*>(past),
      static_cast<const int*>(lengths), static_cast<float*>(out), C, H, r, rd, bs, nb,
      scale);
  return (int)cudaGetLastError();
}


// ------------------------------------ bf16: wgmma in a cluster of two CTAs
constexpr int kQRows = 64;      // query rows of a cluster: one wgmma M tile
constexpr int kKeys = 64;       // keys per tile
constexpr int kMmaThreads = 128;  // one warpgroup per CTA
constexpr int kQTerms = 3;      // bf16 terms of q
constexpr int kPTerms = 2;      // bf16 terms of P
constexpr int kChunk = 64 * 128;  // 64 rows of 128 bytes: 64 bf16 columns

// HC latent chunks of 64 columns per CTA (r <= 128 * HC: a narrower r is
// zero-padded to it); rank 1 also holds the rope chunk (rd <= 64).
struct MlaCfg {
  static constexpr int HC = 4;
  static constexpr int chunks = HC + 1;                       // the most a CTA holds
  static constexpr int q_term = chunks * kChunk;              // one term of q
  static constexpr int keys = chunks * kChunk;                // one key tile
  // q terms, two key tiles, the peer's partial S, two mbarriers, alignment
  static constexpr int smem = kQTerms * q_term + 2 * keys + kQRows * kKeys * 4 + 16 + 1024;
  static constexpr int NB = 128;                              // PV wgmma N
  static constexpr int NH = HC * 64 / NB;                     // PV wgmmas per k step
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of `p` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(hopper::smem_u32(p)), "r"(rank));
  return out;
}
// 16 bytes into a peer CTA's shared memory, completing 16 bytes of the
// transaction count of the peer's mbarrier `bar`.
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Block until the phase of parity `parity` of this CTA's `bar` completed,
// seeing what the cluster's arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(hopper::smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Two neighbouring values as N bf16x2 words, term i = bf16 of what terms
// 0 .. i-1 left: a = sum of the low halves, b = of the high halves, to the
// terms' precision.
template <int N>
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    w[i] = *reinterpret_cast<const uint32_t*>(&t);
    const float2 f = __bfloat1622float2(t);
    a -= f.x;
    b -= f.y;
  }
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMmaThreads, 1)
    paged_mla_bf16_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                          const __nv_bfloat16* __restrict__ pool_ckv,
                          const __nv_bfloat16* __restrict__ pool_krope,
                          const int* __restrict__ tables, const int* __restrict__ past_len,
                          const int* __restrict__ lengths, float* __restrict__ out,
                          float* __restrict__ part_o, float* __restrict__ part_ml, int C, int H,
                          int r, int rd, int bs, int nb, int n_rt, float scale) {
  using Cfg = MlaCfg;
  constexpr int HC = Cfg::HC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);  // kQTerms x chunks
  uint8_t* k_s = q_s + kQTerms * Cfg::q_term;   // 2 key tiles
  float* peer_s = reinterpret_cast<float*>(k_s + 2 * Cfg::keys);  // the peer's partial S
  // full: the peer's partial landed in peer_s; empty: the peer has read
  // what this CTA wrote into its peer_s
  uint64_t* bar_full = reinterpret_cast<uint64_t*>(peer_s + kQRows * kKeys);
  uint64_t* bar_empty = bar_full + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_chunks = HC + rank;  // rank 1: its latent chunks + the rope chunk
  const int pair = blockIdx.x / 2;
  const int rt = pair % n_rt, split = pair / n_rt, splits = gridDim.x / (2 * n_rt);
  const int b = blockIdx.y, B = gridDim.y;
  const int n_rows = C * H, row0 = rt * kQRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int past = past_len[b];
  const int last = past + lengths[b] - 1;
  const int walk_blocks = min(nb, (last >= 0 ? last / bs : 0) + 1);
  // keys walked for the row, cut at the last position a row of this tile
  // sees (later keys would all be masked: exact to skip)
  const int c_max = min(C - 1, (min(n_rows, row0 + kQRows) - 1) / H);
  const int n_keys = min(walk_blocks * bs, past + c_max + 1);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int2 span = key_splits::tiles(n_tiles, split, splits);
  const int t_begin = span.x, t_end = span.y;
  const int* row_table = tables + (size_t)b * nb;

  // Element offset of 16-byte piece p of local chunk lc in a row: latent
  // chunks first, then (rank 1) the rope chunk; -1 past the row's width.
  auto col_of = [&](int lc, int p) -> int {
    const int col = lc < HC ? (rank * HC + lc) * 64 + 8 * p : 8 * p;
    return col < (lc < HC ? r : rd) ? col : -1;
  };
  // Thread tid copies 16-byte piece p8 = tid % 8 of rows row8 + 16q (row8
  // = tid / 8, q = 0..3) of each chunk: 8 neighbouring threads copy one
  // row's 128 contiguous bytes of a chunk.
  const int p8 = tid % 8, row8 = tid / 8;
  auto load_keys = [&](int t, int s) {
    const uint32_t dst = hopper::smem_u32(k_s + s * Cfg::keys);
    long long slot[4];  // the table entries first: four independent loads
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int key = t * kKeys + row8 + 16 * q;
      slot[q] = key < n_keys ? (long long)row_table[key / bs] * bs + key % bs : -1;
    }
    for (int lc = 0; lc < n_chunks; ++lc) {
      const int col = col_of(lc, p8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = slot[q] >= 0 && col >= 0;
        const __nv_bfloat16* src = pool_ckv;
        if (ok) src = lc < HC ? pool_ckv + slot[q] * r + col : pool_krope + slot[q] * rd + col;
        hopper::cp_async16(dst + hopper::swz<128>(row8 + 16 * q, lc, p8), src, ok);
      }
    }
  };
  // this CTA's columns of the tile's query rows, as kQTerms bf16 terms
  // (rows past C*H and columns past the width are zeros), U pieces a
  // thread in flight
  auto stage_q = [&]() {
    constexpr int U = 10;
    const int items = n_chunks * 4;  // (chunk, row group) pairs of this thread
    for (int i0 = 0; i0 < items; i0 += U) {
      float4 v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int lc = (i0 + u) / 4, row = row0 + row8 + 16 * ((i0 + u) % 4);
        const int col = col_of(lc, p8);
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i0 + u < items && row < n_rows && col >= 0) {
          const size_t qr = (size_t)b * n_rows + row;
          const float4* src = reinterpret_cast<const float4*>(
              lc < HC ? q_lat + qr * r + col : q_rope + qr * rd + col);
          v[u][0] = __ldg(src);
          v[u][1] = __ldg(src + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u >= items) break;
        uint32_t w[4][kQTerms];  // words of columns 2e, 2e + 1
        split_bf16x2(v[u][0].x, v[u][0].y, w[0]);
        split_bf16x2(v[u][0].z, v[u][0].w, w[1]);
        split_bf16x2(v[u][1].x, v[u][1].y, w[2]);
        split_bf16x2(v[u][1].z, v[u][1].w, w[3]);
        const uint32_t off = hopper::swz<128>(row8 + 16 * ((i0 + u) % 4), (i0 + u) / 4, p8);
#pragma unroll
        for (int k = 0; k < kQTerms; ++k)
          *reinterpret_cast<uint4*>(q_s + k * Cfg::q_term + off) =
              make_uint4(w[0][k], w[1][k], w[2][k], w[3][k]);
      }
    }
  };

  const int r_lo = warp * 16 + lane / 4;  // tile rows r_lo and r_lo + 8
  float o[Cfg::NH][Cfg::NB / 2];
#pragma unroll
  for (int nh = 0; nh < Cfg::NH; ++nh)
#pragma unroll
    for (int i = 0; i < Cfg::NB / 2; ++i) o[nh][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = past + (row0 + r_lo + 8 * hh) / H;
  const uint32_t peer_buf = peer_addr(peer_s, rank ^ 1);
  const uint32_t peer_full = peer_addr(bar_full, rank ^ 1);
  const uint32_t peer_empty = peer_addr(bar_empty, rank ^ 1);
  if (tid == 0) {
    hopper::mbar_init(bar_full, 1);
    hopper::mbar_init(bar_empty, 1);
    hopper::mbar_fence_init();
  }

  cluster_arrive();  // this CTA runs and its barriers are set up
  if (t_begin < t_end) {
    load_keys(t_begin, 0);
    hopper::cp_async_commit();
    stage_q();
  }
  cluster_wait();  // so does the peer's: from here on they order the swaps
  for (int t = t_begin; t < t_end; ++t) {
    const int s = (t - t_begin) & 1;
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();  // the landed keys (and q's stores) to wgmma
    __syncthreads();
    const uint8_t* kt = k_s + s * Cfg::keys;

    // partial S over this CTA's columns: 3 q terms x 4 k steps a chunk
    float sc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * HC; ++kk) {
      const int off = (kk / 4) * kChunk + (kk % 4) * 32;
#pragma unroll
      for (int k = 0; k < kQTerms; ++k)
        hopper::Wgmma<64, 0>::ss(sc, hopper::desc_k_major<128>(q_s + k * Cfg::q_term + off),
                                 hopper::desc_k_major<128>(kt + off), (kk | k) ? 1 : 0);
    }
    if (rank == 1) {  // the rope chunk
#pragma unroll
      for (int kk = 4 * HC; kk < 4 * HC + 4; ++kk) {
        const int off = (kk / 4) * kChunk + (kk % 4) * 32;
#pragma unroll
        for (int k = 0; k < kQTerms; ++k)
          hopper::Wgmma<64, 0>::ss(sc, hopper::desc_k_major<128>(q_s + k * Cfg::q_term + off),
                                   hopper::desc_k_major<128>(kt + off), 1);
      }
    }
    hopper::wgmma_commit();
    if (t + 1 < t_end) {  // the next tile's gather overlaps this tile's math
      load_keys(t + 1, s ^ 1);
      hopper::cp_async_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // S = the two partials (a + b == b + a: both CTAs hold the same S)
    const int i_t = t - t_begin;
    if (i_t > 0) mbar_wait_cluster(bar_empty, (i_t - 1) & 1);  // the peer read the last
    if (tid == 0) hopper::mbar_arrive_expect_tx(bar_full, kQRows * kKeys * 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st_async16(peer_buf + (i * kMmaThreads + tid) * 16,
                 make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]), peer_full);
    mbar_wait_cluster(bar_full, i_t & 1);  // the peer's partial is in peer_s
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = reinterpret_cast<const float4*>(peer_s)[i * kMmaThreads + tid];
      sc[4 * i] += v.x;
      sc[4 * i + 1] += v.y;
      sc[4 * i + 2] += v.z;
      sc[4 * i + 3] += v.w;
    }

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
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(sc[4 * i + 2 * hh + j] - m[hh]);
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
    for (int nh = 0; nh < Cfg::NH; ++nh)
#pragma unroll
      for (int i = 0; i < Cfg::NB / 8; ++i) {
        o[nh][4 * i] *= alpha[0];
        o[nh][4 * i + 1] *= alpha[0];
        o[nh][4 * i + 2] *= alpha[1];
        o[nh][4 * i + 3] *= alpha[1];
      }
    // P as kPTerms bf16 terms, the A operand: k step j holds keys 16j ..
    // 16j + 15, the accumulator's chunks 2j and 2j + 1
    uint32_t pa[kPTerms][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t words[kPTerms];  // two neighbouring keys
        split_bf16x2(sc[8 * j + 2 * w], sc[8 * j + 2 * w + 1], words);
#pragma unroll
        for (int k = 0; k < kPTerms; ++k) pa[k][j][w] = words[k];
      }

    // O += P . ckv over this CTA's latent chunks (the key tile, MN-major)
#pragma unroll
    for (int nh = 0; nh < Cfg::NH; ++nh) hopper::fence_regs(o[nh]);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < kPTerms; ++k)
#pragma unroll
        for (int nh = 0; nh < Cfg::NH; ++nh)
          hopper::Wgmma<Cfg::NB, 1>::rs(
              o[nh], pa[k][j],
              hopper::desc_mn_major<128>(kt + nh * (Cfg::NB / 64) * kChunk + j * 16 * 128,
                                         kChunk),
              1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nh = 0; nh < Cfg::NH; ++nh) hopper::fence_regs(o[nh]);
    __syncthreads();  // this key stage and peer_s are read
    if (tid == 0) remote_arrive(peer_empty);  // the peer may write into peer_s again
  }
  cluster_arrive();
  cluster_wait();  // the peer no longer touches this CTA's shared memory

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + r_lo + 8 * hh;
    if (row >= n_rows) continue;
    const size_t idx = part_o == nullptr ? (size_t)b * n_rows + row
                                         : ((size_t)split * B + b) * n_rows + row;
    float* orow = (part_o == nullptr ? out : part_o) + idx * r;
    const float inv = part_o == nullptr ? 1.f / fmaxf(l[hh], 1e-30f) : 1.f;
#pragma unroll
    for (int nh = 0; nh < Cfg::NH; ++nh)
#pragma unroll
      for (int i = 0; i < Cfg::NB / 8; ++i) {
        const int col = rank * HC * 64 + nh * Cfg::NB + 8 * i + 2 * (lane % 4);
        if (col < r)  // r is a multiple of 8: col + 1 < r too
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[nh][4 * i + 2 * hh] * inv, o[nh][4 * i + 2 * hh + 1] * inv);
      }
    if (part_o != nullptr && rank == 0 && lane % 4 == 0) {
      part_ml[2 * idx] = m[hh];
      part_ml[2 * idx + 1] = l[hh];
    }
  }
}

// Where the combine writes query row (b, i): out [B, C*H, r].
struct MlaOutRow {
  float* out;
  int r;
  __device__ float* operator()(size_t row) const { return out + row * r; }
};

int launch_bf16(const void* q_lat, const void* q_rope, const void* pool_ckv,
                const void* pool_krope, const void* tables, const void* past,
                const void* lengths, void* out, void* part_o, void* part_ml, int B, int C,
                int H, int r, int rd, int bs, int nb, int splits, float scale,
                cudaStream_t stream) {
  using Cfg = MlaCfg;
  static cudaError_t attr = cudaFuncSetAttribute(
      paged_mla_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_rt = (C * H + kQRows - 1) / kQRows;
  dim3 grid(2 * n_rt * splits, B);
  float* po = splits > 1 ? static_cast<float*>(part_o) : nullptr;
  paged_mla_bf16_kernel<<<grid, kMmaThreads, Cfg::smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const __nv_bfloat16*>(pool_ckv), static_cast<const __nv_bfloat16*>(pool_krope),
      static_cast<const int*>(tables), static_cast<const int*>(past),
      static_cast<const int*>(lengths), static_cast<float*>(out), po,
      static_cast<float*>(part_ml), C, H, r, rd, bs, nb, n_rt, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  key_splits::combine_kernel<<<B * C * H, 128, 0, stream>>>(
      po, static_cast<const float*>(part_ml), splits, B * C * H, r,
      MlaOutRow{static_cast<float*>(out), r});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the fp32 kernel needs for latent width r and rope width rd.
size_t paged_prefill_mla_smem(int r, int rd) { return smem_bytes(r, rd); }

// Widest latent either kernel takes (the fp32 kernel's per-lane
// accumulator, the bf16 kernel's four chunks a CTA).
int paged_prefill_mla_max_rank() { return 32 * kMaxColsPerLane; }

// Keys per bf16 key tile (the unit the splits are counted in).
int paged_prefill_mla_key_tile() { return kKeys; }

// Pool dtype: 0 = float32, 1 = bfloat16 (q and out are float32). bf16
// takes r <= 512 and rd <= 64, both multiples of 8; with splits > 1 it
// needs part_o (splits * B * C*H * r floats) and part_ml (splits * B *
// C*H * 2 floats) scratch. Returns 0 or a cudaError_t.
int paged_prefill_mla(const void* q_lat, const void* q_rope, const void* pool_ckv,
                      const void* pool_krope, const void* tables, const void* past_len,
                      const void* lengths, void* out, void* part_o, void* part_ml, int B,
                      int C, int H, int r, int rd, int bs, int nb, int splits, float scale,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths, out, B, C,
                  H, r, rd, bs, nb, scale, s);
  if (B == 0 || C * H == 0) return 0;
  if (r % 8 != 0 || rd % 8 != 0 || r > 128 * MlaCfg::HC || rd > 64)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(q_lat, q_rope, pool_ckv, pool_krope, tables, past_len, lengths, out,
                     part_o, part_ml, B, C, H, r, rd, bs, nb, splits, scale, s);
}

}  // extern "C"
