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
// group width, so every weight element is used for a handful of
// products; the least time is 3 * D * F * 2 bytes per expert over 3.35
// TB/s, counting only the experts that have a token. At a decode step
// most tier slots have none: the serving path dispatches into zeroed
// buffers, and a zero token row gives an exactly zero output row (silu(0)
// * 0 = 0 through finite weights), so a slot whose rows are all zero has
// output 0 and its weights need not be read.
//
// bf16 design, three launches in one wrapper call:
//   1. live_rows: one block per slot reads x[e] once and writes the
//      number of its nonzero rows (no host sync: the passes read it).
//   2. gate|up: a CTA owns a 64-wide F panel of one slot; a slot with no
//      live row exits at once. It streams [64 d x 64 f] boxes of W1 and
//      W3 and the matching [T, 64 d] token box by TMA (128-byte swizzle)
//      through a ring of mbarrier stages, and multiplies on the tensor
//      cores with mma.sync m16n8k16: the weights are the M side (read
//      transposed out of shared memory by ldmatrix.trans), the tokens the
//      n = 8 side (up to four n tiles: 32 tokens). It writes
//      h = bf16(silu(g) * u) [E, T, F].
//   3. down: a CTA owns 64 output columns d of one slot and sums h W2
//      over F the same way; a slot with no live row writes zeros and
//      exits. W2 is read in place in either layout: unit stride along F
//      (a tier buffer's [D, F] down matrix, read as stored) or along D (a
//      row-major [F, D] parameter, read transposed as W1 is).
// Both passes may split a panel's reduction axis (D, F) over a
// thread-block cluster of up to 8 CTAs (`mma_plan` in the wrapper: as
// many as leave each CTA 16 stages; deepseek's gate|up pass, D = 5120,
// takes 4, every other pass at the served widths 1); rank 0 adds
// the other ranks' fp32 partials in rank order through distributed
// shared memory, so nothing goes through device memory, no atomics are
// used and the result is the same from run to run. Each pass is a
// programmatic dependent launch of the one before: the down CTAs start
// streaming their weights while the gate|up pass finishes and wait for
// it only before they read h. Tokens are staged a box at a time, so
// shared memory does not bound T; a slot of more than 32 tokens runs the
// three launches once per group of 32 (each group reads the weights
// again, and skips the slots with no live row in it). W1 and W3 need unit
// stride along F, W2 along F or D, and every stride 16-byte alignment;
// ragged panels and reduction edges come from TMA's zero fill.
//
// Measured before this design (PERF.md, PR 14: the CUDA-core kernel's
// phases timed at deepseek-v2's widths): the CUDA-core kernel below moved
// weights at ~0.3 TB/s, its x W1 / x W3 phase bound by the fp32 FMA
// instruction rate (its time grew with the tokens).
//
// fp32 keeps that CUDA-core kernel: on the tensor cores fp32 would run as
// TF32. Grid (expert, F panel of bf <= 64); phase 1: 256 threads = 64
// panel columns x 4 D groups accumulate x W1 and x W3 for up to 8
// tokens at a time (tokens staged as fp32 in shared memory); phase 2:
// each thread owns output columns d and sums h W2 over the panel into
// fp32 partials [splits, E, T, D], which a second kernel adds in split
// order. Weights are addressed through any strides. A slot's tokens are
// staged a group at a time: as many as fit shared memory (the wrapper
// sizes the group: 10 tokens at D = 5120), one launch per group, each
// reading the weights again. A token's arithmetic does not depend on
// its group, so any grouping gives the same bits.
#include <cooperative_groups.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------ fp32: CUDA-core kernel
constexpr int kThreads = 256;
constexpr int kMaxBF = 64;
constexpr int kDGroups = kThreads / kMaxBF;  // 4
constexpr int kTT = 8;                       // tokens per pass

struct WStrides {  // element strides of one weight operand: [e, row, col]
  long long e, r, c;
};

__global__ void __launch_bounds__(kThreads) gemv_panel_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ w3,
    const float* __restrict__ w2, float* __restrict__ part, int E, int T_, int D, int F,
    int bf, int ld, WStrides s1, WStrides s3, WStrides s2) {
  // x and part point at the group's first token; a slot's rows start ld
  // rows apart (ld >= T_: the group of T_ tokens is part of a longer slot)
  extern __shared__ float smem[];
  float* x_s = smem;                              // [T, D]
  float* red_s = x_s + (size_t)T_ * D;            // [2, kDGroups, kTT, kMaxBF]
  float* h_s = red_s + 2 * kDGroups * kTT * kMaxBF;  // [T, kMaxBF]
  const int e = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int f0 = split * bf;
  const float* xe = x + (size_t)e * ld * D;
  for (int i = tid; i < T_ * D; i += kThreads) x_s[i] = xe[i];
  __syncthreads();

  const float* w1e = w1 + e * s1.e;
  const float* w3e = w3 + e * s3.e;
  const int fi = tid % kMaxBF, dg = tid / kMaxBF;
  for (int t0 = 0; t0 < T_; t0 += kTT) {
    const int tn = min(kTT, T_ - t0);
    float g[kTT] = {}, u[kTT] = {};
    if (fi < bf) {
      const long long c1 = (long long)(f0 + fi) * s1.c, c3 = (long long)(f0 + fi) * s3.c;
      for (int d = dg; d < D; d += kDGroups) {
        const float a = w1e[d * s1.r + c1];
        const float b = w3e[d * s3.r + c3];
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
      h_s[(t0 + t) * kMaxBF + f] = gs / (1.f + expf(-gs)) * us;
    }
    __syncthreads();
  }

  // phase 2: partial y[t, d] over this F panel
  const float* w2e = w2 + e * s2.e;
  float* pe = part + ((size_t)split * E + e) * ld * D;
  for (int d = tid; d < D; d += kThreads) {
    float y[kTT];
    for (int t0 = 0; t0 < T_; t0 += kTT) {
      const int tn = min(kTT, T_ - t0);
#pragma unroll
      for (int t = 0; t < kTT; ++t) y[t] = 0.f;
      for (int f = 0; f < bf; ++f) {
        const float wv = w2e[(long long)(f0 + f) * s2.r + (long long)d * s2.c];
#pragma unroll
        for (int t = 0; t < kTT; ++t)
          if (t < tn) y[t] += h_s[(t0 + t) * kMaxBF + f] * wv;
      }
      for (int t = 0; t < tn; ++t) pe[(size_t)(t0 + t) * D + d] = y[t];
    }
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                                     int splits, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];  // split order
    y[i] = s;
  }
}

size_t f32_smem_bytes(int T_, int D) {
  return sizeof(float) * ((size_t)T_ * D + 2 * kDGroups * kTT * kMaxBF + (size_t)T_ * kMaxBF);
}

int launch_f32(const void* x, const void* w1, const void* w3, const void* w2, void* part,
               void* y, int E, int T_, int D, int F, int bf, int group, WStrides s1,
               WStrides s3, WStrides s2, cudaStream_t stream) {
  if (E == 0 || T_ == 0) return 0;
  if (group < 1) return (int)cudaErrorInvalidValue;
  const int g_max = group < T_ ? group : T_;
  cudaError_t err = cudaFuncSetAttribute(gemv_panel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)f32_smem_bytes(g_max, D));
  if (err != cudaSuccess) return (int)err;
  const int splits = F / bf;
  dim3 grid(E, splits);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(part);
  for (int t0 = 0; t0 < T_; t0 += group) {  // groups of tokens that fit shared memory
    const int tg = T_ - t0 < group ? T_ - t0 : group;
    gemv_panel_kernel<<<grid, kThreads, f32_smem_bytes(tg, D), stream>>>(
        xf + (size_t)t0 * D, static_cast<const float*>(w1), static_cast<const float*>(w3),
        static_cast<const float*>(w2), pf + (size_t)t0 * D, E, tg, D, F, bf, T_, s1, s3, s2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t n = (size_t)E * T_ * D;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                   static_cast<float*>(y), splits, n);
  return (int)cudaGetLastError();
}

// ------------------------------------- bf16: live slots + mma.sync passes
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kKC = 64;           // reduction depth (D or F) of a stage: one 128-byte row
constexpr int kPanel = 64;        // output columns of a CTA (F for gate|up, D for down)
constexpr int kStages = 6;        // 6 beat 4 by 0-1% (PERF.md, PR 14)
constexpr int kBox = kKC * kPanel * 2;  // one 64 x 64 weight box: 8 KB
constexpr int kMaxNT = 4;               // n tiles of 8 tokens: a group of 32 tokens
constexpr int kGroup = 8 * kMaxNT;
constexpr int kMaxCluster = 8;          // CTAs sharing one panel's reduction

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows that
// TMA wrote with CU_TENSOR_MAP_SWIZZLE_128B (1024-byte aligned): chunks
// XOR-ed with the row within each group of 8, so ldmatrix's 8 rows of one
// chunk fall in 8 different bank groups.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i. Without .trans a lane gets row lane/4, columns 2*(lane%4) + {0, 1} of
// each; with .trans rows 2*(lane%4) + {0, 1} of column lane/4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, fp32 sums. A: a[0..3] hold
// (row lane/4, cols 2*(lane%4) + {0,1}), rows + 8, cols + 8, both + 8;
// B: b[0] (rows 2*(lane%4) + {0,1}, col lane/4), b[1] rows + 8; D: d[0..1]
// (row lane/4, cols 2*(lane%4) + {0,1}), d[2..3] row + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Programmatic dependent launch: a primary CTA lets the dependent grid be
// scheduled; the dependent waits for the primary grid's completion (and
// its memory) before it reads what the primary wrote. No-ops otherwise.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One block per slot: every thread reads 16-byte pieces of the slot's
// T_ <= 32 rows (all in flight together: a 4-token slot of d_model 5120
// is 2.5 pieces a thread), marks the rows with a nonzero value, and the
// block writes how many rows are live. -0 counts as zero. A slot's rows
// start ld rows apart (ld >= T_: a group of a longer slot).
constexpr int kLiveThreads = 1024;
__global__ void __launch_bounds__(kLiveThreads) live_rows_kernel(const bf16* __restrict__ x,
                                                                 int* __restrict__ nlive,
                                                                 int T_, int D, int ld) {
  pdl_launch_dependents();  // the gate|up CTAs may get ready meanwhile
  __shared__ uint32_t rows;
  const int e = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) rows = 0;
  const uint4* xe = reinterpret_cast<const uint4*>(x + (size_t)e * ld * D);
  const int per_row = D / 8, n = T_ * per_row;
  uint32_t mask = 0;
#pragma unroll 4
  for (int i = tid; i < n; i += kLiveThreads) {
    const uint4 v = xe[i];
    if ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) mask |= 1u << (i / per_row);
  }
  mask = __reduce_or_sync(0xffffffffu, mask);
  __syncthreads();
  if (tid % 32 == 0 && mask) atomicOr(&rows, mask);
  __syncthreads();
  if (tid == 0) nlive[e] = __popc(rows);
}

// The n tiles' B fragments (tokens x 16 of the reduction axis) at k step
// kk from a swizzled [NT*8 tokens, 64] tile.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], uint32_t tile, int kk, int lane) {
  const int l = lane % 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) ldsm_x2(b[nt], tile + swz128(8 * nt + l % 8, 2 * kk + l / 8));
}

// Sum of a panel's partial accumulators over the CTAs of its cluster, in
// rank order: each CTA parks its R floats a thread in its own (drained)
// ring, and rank 0 reads the others' through distributed shared memory.
// Returns false on the CTAs that are done (every rank but 0).
template <int R>
__device__ __forceinline__ bool cluster_sum(float (&acc)[R], uint8_t* ring, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = cluster.num_blocks();
  if (cs == 1) return true;
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < R; ++i) mine[i * kMmaThreads + tid] = acc[i];
  cluster.sync();  // every rank's partials are in place
  const int rank = cluster.block_rank();
  if (rank == 0)
    for (int r = 1; r < cs; ++r) {
      const float* other = cluster.map_shared_rank(mine, r);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += other[i * kMmaThreads + tid];
    }
  cluster.sync();  // rank 0 has read them: the others may exit
  return rank == 0;
}

// The k-chunk range [begin, end) of rank `rank` of `cs` over nk chunks.
__device__ __forceinline__ int2 rank_chunks(int nk, int rank, int cs) {
  return make_int2(nk * rank / cs, nk * (rank + 1) / cs);
}

// gate|up: a CTA owns 64 F columns of one slot and the D range of its
// cluster rank; warp w owns the panel's 16-column tile w. A stage holds
// the [64 d, 64 f] boxes of W1 and W3 and the [NT*8, 64 d] token box. h
// holds the slot's T_ rows ld rows apart.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads) gateup_kernel(
    const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w3_map,
    const __grid_constant__ CUtensorMap x_map, bf16* __restrict__ h,
    const int* __restrict__ nlive, int T_, int D, int F, int ld) {
  constexpr int kStage = 2 * kBox + NT * 8 * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  uint8_t* ring = hopper::align_1024(smem_raw);  // kStages stages of kStage bytes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  pdl_wait();  // nlive is the prepass's
  pdl_launch_dependents();  // the down CTAs may start streaming their weights
  const int e = blockIdx.y;
  if (__ldcg(nlive + e) == 0) return;  // the whole cluster leaves; the down pass zeros y
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int f0 = (blockIdx.x / cs) * kPanel;
  const int2 kr = rank_chunks((D + kKC - 1) / kKC, rank, cs);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto fetch = [&](int kc) {  // thread 0: chunk kc into its stage
    const int s = (kc - kr.x) % kStages;
    uint8_t* st = ring + s * kStage;
    hopper::mbar_arrive_expect_tx(&full[s], kStage);
    hopper::tma_load_3d(st, &w1_map, &full[s], f0, kc * kKC, e);
    hopper::tma_load_3d(st + kBox, &w3_map, &full[s], f0, kc * kKC, e);
    hopper::tma_load_3d(st + 2 * kBox, &x_map, &full[s], kc * kKC, 0, e);
  };
  if (tid == 0)
    for (int kc = kr.x; kc < min(kr.y, kr.x + kStages); ++kc) fetch(kc);

  float g[NT][4], u[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[nt][i] = u[nt][i] = 0.f;
  // A fragments read W [d, f] transposed: matrix mi of the x4 covers f
  // rows 8*(mi%2).. (chunk 2*warp + mi%2) and d columns 8*(mi/2)..
  const int a_row = lane % 8 + 8 * ((lane / 8) / 2), a_chunk = 2 * warp + (lane / 8) % 2;
  for (int kc = kr.x; kc < kr.y; ++kc) {
    const int s = (kc - kr.x) % kStages;
    hopper::mbar_wait(&full[s], ((kc - kr.x) / kStages) & 1);
    const uint32_t st = hopper::smem_u32(ring + s * kStage);
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t a1[4], a3[4], b[NT][2];
      ldsm_x4_trans(a1, st + swz128(16 * kk + a_row, a_chunk));
      ldsm_x4_trans(a3, st + kBox + swz128(16 * kk + a_row, a_chunk));
      load_b<NT>(b, st + 2 * kBox, kk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(g[nt], a1, b[nt]);
        mma_bf16(u[nt], a3, b[nt]);
      }
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && kc + kStages < kr.y) fetch(kc + kStages);
  }
  float acc[NT * 8];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nt * 8 + i] = g[nt][i];
      acc[nt * 8 + 4 + i] = u[nt][i];
    }
  if (!cluster_sum<NT * 8>(acc, ring, tid)) return;
  // accumulator (f = 16*warp + lane/4 + 8*(i/2), t = 8*nt + 2*(lane%4) + i%2)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 8 * nt + 2 * (lane % 4) + i % 2;
      const int f = f0 + 16 * warp + lane / 4 + 8 * (i / 2);
      if (t < T_ && f < F) {
        const float gs = acc[nt * 8 + i], us = acc[nt * 8 + 4 + i];
        h[((size_t)e * ld + t) * F + f] = __float2bfloat16(gs / (1.f + expf(-gs)) * us);
      }
    }
}

// down: a CTA owns 64 output columns d of one slot and the F range of its
// cluster rank. A stage holds the [64 d, 64 f] weight box (kFD: the [64 f,
// 64 d] box of a W2 stored [F, D]) and the [NT*8, 64 f] box of h. y holds
// the slot's T_ rows ld rows apart.
template <int NT, bool kFD>
__global__ void __launch_bounds__(kMmaThreads) down_kernel(
    const __grid_constant__ CUtensorMap w2_map, const __grid_constant__ CUtensorMap h_map,
    bf16* __restrict__ y, const int* __restrict__ nlive, int T_, int D, int F, int ld) {
  constexpr int kStage = kBox + NT * 8 * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  uint8_t* ring = hopper::align_1024(smem_raw);  // kStages stages of kStage bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int e = blockIdx.y, d0 = (blockIdx.x / cs) * kPanel;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ye = y + (size_t)e * ld * D;
  if (__ldcg(nlive + e) == 0) {  // all-zero tokens: output exactly 0
    if (rank == 0)
      for (int i = tid; i < T_ * kPanel; i += kMmaThreads) {
        const int t = i / kPanel, d = d0 + i % kPanel;
        if (d < D) ye[(size_t)t * D + d] = __float2bfloat16(0.f);
      }
    return;
  }
  const int2 kr = rank_chunks((F + kKC - 1) / kKC, rank, cs);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto fetch_w = [&](int kc) {  // thread 0: the weight box of chunk kc
    const int s = (kc - kr.x) % kStages;
    hopper::mbar_arrive_expect_tx(&full[s], kStage);
    if (kFD)
      hopper::tma_load_3d(ring + s * kStage, &w2_map, &full[s], d0, kc * kKC, e);
    else
      hopper::tma_load_3d(ring + s * kStage, &w2_map, &full[s], kc * kKC, d0, e);
  };
  auto fetch_h = [&](int kc) {  // thread 0: the h box of chunk kc
    const int s = (kc - kr.x) % kStages;
    hopper::tma_load_3d(ring + s * kStage + kBox, &h_map, &full[s], kc * kKC, 0, e);
  };
  if (tid == 0) {  // the first stages' weights stream before h exists
    const int pre = min(kr.y, kr.x + kStages);
    for (int kc = kr.x; kc < pre; ++kc) fetch_w(kc);
    pdl_wait();  // the gate|up pass has written h
    for (int kc = kr.x; kc < pre; ++kc) fetch_h(kc);
  }

  float y4[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) y4[nt][i] = 0.f;
  // A fragments of W2ᵀ [d, f]. Stored [D, F]: read as stored, matrix mi
  // covers d rows 8*(mi%2).. and f columns 8*(mi/2)... Stored [F, D] (kFD):
  // read transposed as gate|up reads W1, f rows 8*(mi/2).. of the k step
  // and d columns 8*(mi%2).. (chunk 2*warp + mi%2).
  const int a_row = kFD ? lane % 8 + 8 * ((lane / 8) / 2)
                        : 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
  const int a_chunk = kFD ? 2 * warp + (lane / 8) % 2 : (lane / 8) / 2;
  for (int kc = kr.x; kc < kr.y; ++kc) {
    const int s = (kc - kr.x) % kStages;
    hopper::mbar_wait(&full[s], ((kc - kr.x) / kStages) & 1);
    const uint32_t st = hopper::smem_u32(ring + s * kStage);
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t a[4], b[NT][2];
      if (kFD)
        ldsm_x4_trans(a, st + swz128(16 * kk + a_row, a_chunk));
      else
        ldsm_x4(a, st + swz128(a_row, 2 * kk + a_chunk));
      load_b<NT>(b, st + kBox, kk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(y4[nt], a, b[nt]);
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && kc + kStages < kr.y) {
      fetch_w(kc + kStages);
      fetch_h(kc + kStages);
    }
  }
  float acc[NT * 4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt * 4 + i] = y4[nt][i];
  if (!cluster_sum<NT * 4>(acc, ring, tid)) return;
  // accumulator (d = 16*warp + lane/4 + 8*(i/2), t = 8*nt + 2*(lane%4) + i%2)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 8 * nt + 2 * (lane % 4) + i % 2;
      const int d = d0 + 16 * warp + lane / 4 + 8 * (i / 2);
      if (t < T_ && d < D) ye[(size_t)t * D + d] = __float2bfloat16(acc[nt * 4 + i]);
    }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Launch `kernel` on `grid` in clusters of `cs` CTAs along x (no cluster
// attribute at cs = 1), as a programmatic dependent launch of the kernel
// before it (it saved 1.5% at deepseek's widths and 6-7% at granite's:
// PERF.md, PR 14).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, int cs, size_t smem,
           cudaStream_t stream, Args... args) {
  static_assert(sizeof...(Params) == sizeof...(Args), "one argument per parameter");
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cs > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cs;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// A [dim2, dim1, dim0] bf16 tensor (dim0 contiguous) with byte strides s1,
// s2, read in boxes of (64, rows, 1) with the 128-byte swizzle.
int map3(CUtensorMap* m, const void* base, uint64_t dim0, uint64_t dim1, uint64_t dim2,
         uint64_t s1, uint64_t s2, uint32_t rows) {
  const uint64_t dims[3] = {dim0, dim1, dim2};
  const uint64_t strides[2] = {s1, s2};
  const uint32_t box[3] = {64, rows, 1};
  return hopper::encode_bf16_map(m, base, 3, dims, strides, box, 128);
}

// One group of T_ <= 32 tokens: rows t0 .. t0 + T_ - 1 of slots of ld
// rows, x, h and y already offset to row t0.
template <int NT>
int launch_bf16(const bf16* x, const bf16* w1, const bf16* w3, const bf16* w2, bf16* h,
                int* nlive, bf16* y, int E, int T_, int D, int F, int ld, int cs_gu, int cs_dn,
                long long s1e, long long s1r, long long s3e, long long s3r, long long s2e,
                long long s2r, bool w2_fd, cudaStream_t stream) {
  constexpr size_t gu_smem = kStages * (2 * kBox + NT * 8 * 128) + 1024;
  constexpr size_t dn_smem = kStages * (kBox + NT * 8 * 128) + 1024;
  static const int attr = set_smem(gateup_kernel<NT>, gu_smem) |
                          set_smem(down_kernel<NT, false>, dn_smem) |
                          set_smem(down_kernel<NT, true>, dn_smem);
  if (attr != 0) return attr;
  CUtensorMap w1m, w3m, xm, w2m, hm;
  int err = map3(&w1m, w1, F, D, E, s1r * 2, s1e * 2, kKC);
  if (!err) err = map3(&w3m, w3, F, D, E, s3r * 2, s3e * 2, kKC);
  if (!err) err = map3(&xm, x, D, T_, E, D * 2ull, (uint64_t)ld * D * 2, NT * 8);
  if (!err)
    err = w2_fd ? map3(&w2m, w2, D, F, E, s2r * 2, s2e * 2, kKC)
                : map3(&w2m, w2, F, D, E, s2r * 2, s2e * 2, kPanel);
  if (!err) err = map3(&hm, h, F, T_, E, F * 2ull, (uint64_t)ld * F * 2, NT * 8);
  if (err) return err;
  live_rows_kernel<<<E, kLiveThreads, 0, stream>>>(x, nlive, T_, D, ld);
  err = (int)cudaGetLastError();
  if (!err)
    err = launch(gateup_kernel<NT>, dim3((F + kPanel - 1) / kPanel * cs_gu, E),
                 dim3(kMmaThreads), cs_gu, gu_smem, stream, w1m, w3m, xm, h,
                 (const int*)nlive, T_, D, F, ld);
  auto* down = w2_fd ? &down_kernel<NT, true> : &down_kernel<NT, false>;
  if (!err)
    err = launch(down, dim3((D + kPanel - 1) / kPanel * cs_dn, E), dim3(kMmaThreads), cs_dn,
                 dn_smem, stream, w2m, hm, y, (const int*)nlive, T_, D, F, ld);
  return err;
}

}  // namespace

extern "C" {

size_t expert_ffn_gemv_smem(int tokens, int d_model) { return f32_smem_bytes(tokens, d_model); }

// fp32. x [E, T, D] and y [E, T, D] contiguous; part is fp32 scratch of
// (F / bf) * E * T * D elements. Weight element (e, row, col) of W1/W3
// ([D, F]) and W2 ([F, D]) sits at base + e*s_e + row*s_r + col*s_c.
// bf <= 64 must divide F. A slot's tokens run `group` at a time
// (expert_ffn_gemv_smem(group, D) must fit a block). Returns
// cudaGetLastError().
int expert_ffn_gemv_f32(const void* x, const void* w1, const void* w3, const void* w2,
                        void* part, void* y, int E, int T_, int D, int F, int bf, int group,
                        long long s1e, long long s1r, long long s1c, long long s3e,
                        long long s3r, long long s3c, long long s2e, long long s2r,
                        long long s2c, void* stream) {
  const WStrides a{s1e, s1r, s1c}, b{s3e, s3r, s3c}, c{s2e, s2r, s2c};
  return launch_f32(x, w1, w3, w2, part, y, E, T_, D, F, bf, group, a, b, c,
                    static_cast<cudaStream_t>(stream));
}

// bf16. x, y [E, T, D] contiguous; h [E, T, F] and nlive [ceil(T / 32),
// E] int32 scratch. W1/W3 element (e, d, f) at base + e*s_e + d*s_r + f; W2
// element (e, f, d) at base + e*s2e + f + d*s2r, or with w2_fd at base +
// e*s2e + f*s2r + d. D and F multiples of 8, every base and stride 16-byte
// aligned. cs_gu, cs_dn in {1, 2, 4, 8}: the CTAs a 64-wide panel's
// reduction axis (D for gate|up, F for down) is split over, summed within a
// cluster. `device` is the operands' device. Returns 0, the first failing
// launch's cudaError_t, or hopper::kErrTensorMap + a CUresult.
int expert_ffn_gemv_bf16(const void* x, const void* w1, const void* w3, const void* w2,
                         void* h, void* nlive, void* y, int E, int T_, int D, int F,
                         int cs_gu, int cs_dn, long long s1e, long long s1r, long long s3e,
                         long long s3r, long long s2e, long long s2r, int w2_fd, int device,
                         void* stream) {
  if (E == 0 || T_ == 0) return 0;
  if (cs_gu < 1 || cs_gu > kMaxCluster || cs_dn < 1 || cs_dn > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (const int e = hopper::bind_device(device)) return e;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* a = static_cast<const bf16*>(w1);
  const bf16* b = static_cast<const bf16*>(w3);
  const bf16* c = static_cast<const bf16*>(w2);
  bf16* hb = static_cast<bf16*>(h);
  bf16* yb = static_cast<bf16*>(y);
  int* nl = static_cast<int*>(nlive);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t0 = 0, g = 0; t0 < T_; t0 += kGroup, ++g) {  // groups of 32 tokens
    const int tg = T_ - t0 < kGroup ? T_ - t0 : kGroup, nt = (tg + 7) / 8;
    auto* launch_group = nt == 1 ? launch_bf16<1> : nt == 2 ? launch_bf16<2> : launch_bf16<4>;
    const int err = launch_group(xb + (size_t)t0 * D, a, b, c, hb + (size_t)t0 * F, nl + g * E,
                                 yb + (size_t)t0 * D, E, tg, D, F, T_, cs_gu, cs_dn, s1e, s1r,
                                 s3e, s3r, s2e, s2r, w2_fd != 0, s);
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
