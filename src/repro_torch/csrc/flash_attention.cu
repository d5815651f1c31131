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
// A block walks keys only up to the last one a row of its own can see
// (tiles past the diagonal are skipped, as on the TPU); keys past that
// point, or past sk, take no part in the max or the sum. Non-causal
// attention walks every key. The TPU's tile sizes bq / bk shape VMEM
// blocks; they have no meaning here and the wrapper does not pass them.
//
// What bounds it on the H100: at the shapes it is timed at (S = 512 and
// 8192, dh = 64 and 128) the score and PV products, 4*dh operations per
// visible (query, key) pair, against the bytes of q, k, v and o read or
// written once; on the tensor cores that is compute-bound from a few
// hundred keys on. Beside the products the softmax's exponentials (one
// per pair) run on the SM's special-function units.
//
// bf16 design (tensor cores, hopper_mma.cuh). Grid (bh, tile of 128
// query rows), the tiles with the most keys first. A block is two
// consumer warpgroups of 64 query rows and one producer warp. Tensor
// maps over (dh, S, BH) keep a tile inside its head and zero-fill the
// ragged ends of S; boxes are 64 columns wide (32 at dh = 32, with the
// 64-byte swizzle). The producer loads the [128, dh] query tile once and
// streams [128, dh] K and V tiles through a 2-stage ring (at dh = 128:
// 32 KB + 4 x 32 KB of shared memory). Per key tile a consumer computes
// S = Q K^T with m64n128k16 wgmmas (A = Q and B = K, both K-major in
// shared memory), runs the online softmax in registers on the
// accumulator fragment (two rows per thread, max and sum across the lane
// quad), rounds P to bf16 in registers and uses it as the register A
// operand of O += P V (m64n{dh}k16, B = V MN-major). The max, sum and
// rescale stay fp32; l sums the unrounded P.
//
// fp32 keeps the CUDA-core kernel below: on the tensor cores fp32 would
// run as TF32, and the card tests hold fp32 to 1e-5. The wrapper picks
// the route by dtype. The fp32 kernel's grid is (bh, tile of 64 query
// rows); it stages its query rows in fp32 shared memory and walks key
// tiles of 32, K padded to dh + 1 columns so 32 lanes reading 32 keys hit
// 32 banks. Each warp owns 8 query rows for the whole walk: lane j scores
// key j for its rows, the warp reduces max and sum by shuffles, and for
// the PV product each lane owns dh/32 output columns, the accumulator and
// the softmax state staying in registers.
#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------ bf16: wgmma + TMA ring
constexpr int kBQ = 128;      // query rows per block: two warpgroups of 64
constexpr int kBKey = 128;    // keys per tile
constexpr int kKVStages = 2;  // K/V tiles in flight
constexpr int kFlashThreads = 2 * 128 + 32;

template <int DH>
struct FlashCfg {
  static constexpr int SW = DH * 2 >= 128 ? 128 : DH * 2;  // swizzled row bytes
  static constexpr int chunk = 128 * SW;                    // one box: 128 rows of SW bytes
  static constexpr int tile = 128 * DH * 2;                 // [128, DH]: DH * 2 / SW boxes
  static constexpr int smem = tile * (1 + 2 * kKVStages) + 8 * (1 + 2 * kKVStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kFlashThreads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out, int sq,
    int sk, int causal, float scale) {
  using C = FlashCfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align_1024(smem_raw);
  uint8_t* k_s = q_s + C::tile;              // kKVStages tiles
  uint8_t* v_s = k_s + kKVStages * C::tile;  // kKVStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kKVStages * C::tile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kKVStages;

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int shift = sk - sq;  // query i sits at key position i + shift
  int n_keys = sk;            // keys any row of this block can see
  if (causal) n_keys = max(0, min(sk, min(sq, row0 + kBQ) + shift));
  const int nt = (n_keys + kBKey - 1) / kBKey;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kKVStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warp: one thread issues every load
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(q_full, C::tile);
      for (int c = 0; c < DH * 2 / C::SW; ++c)
        hopper::tma_load_3d(q_s + c * C::chunk, &q_map, q_full, c * C::SW / 2, row0, bh);
      for (int t = 0; t < nt; ++t) {
        const int s = t % kKVStages;
        if (t >= kKVStages) hopper::mbar_wait(&empty[s], ((t / kKVStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * C::tile);
        for (int c = 0; c < DH * 2 / C::SW; ++c) {
          hopper::tma_load_3d(k_s + s * C::tile + c * C::chunk, &k_map, &full[s],
                              c * C::SW / 2, t * kBKey, bh);
          hopper::tma_load_3d(v_s + s * C::tile + c * C::chunk, &v_map, &full[s],
                              c * C::SW / 2, t * kBKey, bh);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r_lo = row0 + wg * 64 + warp * 16 + lane / 4;  // rows r_lo and r_lo + 8
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint8_t* q_wg = q_s + wg * 64 * C::SW;
  hopper::mbar_wait(q_full, 0);

  for (int t = 0; t < nt; ++t) {
    const int s = t % kKVStages;
    hopper::mbar_wait(&full[s], (t / kKVStages) & 1);
    const uint8_t* kt = k_s + s * C::tile;
    const uint8_t* vt = v_s + s * C::tile;

    float sc[64];  // S = Q K^T, m64n128 (the first k step overwrites it)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk * 32 / C::SW) * C::chunk + (kk * 32) % C::SW;
      hopper::Wgmma<128, 0>::ss(sc, hopper::desc_k_major<C::SW>(q_wg + off),
                                hopper::desc_k_major<C::SW>(kt + off), kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // online softmax on the fragment: sc[4i + 2h + j] is row r_lo + 8h,
    // key t * 128 + 8i + 2 * (lane % 4) + j
    const int key0 = t * kBKey + 2 * (lane % 4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + 8 * i + j;
          float v = sc[4 * i + 2 * h + j] * scale;
          if (key >= n_keys) v = -INFINITY;  // not walked: no part in max or sum
          else if (causal && key > r_lo + 8 * h + shift) v = kNegInf;
          sc[4 * i + 2 * h + j] = v;
          mx[h] = fmaxf(mx[h], v);
        }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f((sc[4 * i + 2 * h + j] - m[h]) * kLog2e);
          sc[4 * i + 2 * h + j] = p;
          ps[h] += p;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = l[h] * alpha[h] + ps[h];
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    // P in bf16 as the A operand: k step j holds keys 16j .. 16j + 15,
    // which are the accumulator's chunks 2j and 2j + 1
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        pa[j][w] = hopper::pack_bf16x2(sc[8 * j + 2 * w], sc[8 * j + 2 * w + 1]);

    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hopper::Wgmma<DH, 1>::rs(o, pa[j], hopper::desc_mn_major<C::SW>(vt + j * 16 * C::SW,
                                                                       C::chunk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (tid % 128 == 0) hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)bh * sq + row) * DH;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] / denom, o[4 * i + 2 * h + 1] / denom);
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int sq,
                int sk, int causal, float scale, cudaStream_t stream) {
  using C = FlashCfg<DH>;
  if (sk == 0)  // no key: every output row is 0 / 1e-30 = 0
    return (int)cudaMemsetAsync(out, 0, (size_t)BH * sq * DH * 2, stream);
  CUtensorMap qm, km, vm;
  const uint64_t q_dims[3] = {DH, (uint64_t)sq, (uint64_t)BH};
  const uint64_t k_dims[3] = {DH, (uint64_t)sk, (uint64_t)BH};
  const uint64_t q_strides[2] = {DH * 2, (uint64_t)sq * DH * 2};
  const uint64_t k_strides[2] = {DH * 2, (uint64_t)sk * DH * 2};
  const uint32_t box[3] = {C::SW / 2, 128, 1};
  int r = hopper::encode_bf16_map(&qm, q, 3, q_dims, q_strides, box, C::SW);
  if (r == 0) r = hopper::encode_bf16_map(&km, k, 3, k_dims, k_strides, box, C::SW);
  if (r == 0) r = hopper::encode_bf16_map(&vm, v, 3, k_dims, k_strides, box, C::SW);
  if (r != 0) return r;
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(BH, (sq + kBQ - 1) / kBQ);
  flash_bf16_kernel<DH><<<grid, kFlashThreads, C::smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- fp32: CUDA-core tiles
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr int kMaxColsPerLane = 4;            // dh <= 128

__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int sq, int sk, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  float* q_s = smem;                    // [kRows, dh]
  float* k_s = q_s + kRows * dh;        // [kTile, dh + 1]
  float* v_s = k_s + kTile * (dh + 1);  // [kTile, dh]
  float* p_s = v_s + kTile * dh;        // [kRows, kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = sk - sq;
  const float* qb = q + (size_t)bh * sq * dh;
  const float* kb = k + (size_t)bh * sk * dh;
  const float* vb = v + (size_t)bh * sk * dh;

  for (int i = tid; i < kRows * dh; i += kThreads) {
    const int row = row0 + i / dh;
    q_s[i] = row < sq ? qb[(size_t)row * dh + i % dh] : 0.f;
  }
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
      k_s[j * (dh + 1) + d] = kb[src];
      v_s[i] = vb[src];
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
      p_s[(my_row0 + i) * kTile + lane] = p;
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
    float* o = out + ((size_t)bh * sq + row) * dh;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) {
      const int col = lane + 32 * c;
      if (col < dh) o[col] = acc[i][c] / denom;
    }
  }
}

size_t f32_smem_bytes(int dh) {
  return sizeof(float) *
         ((size_t)kRows * dh + kTile * (dh + 1) + (size_t)kTile * dh + kRows * kTile);
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int sq,
               int sk, int dh, int causal, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(dh);
  cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (sq + kRows - 1) / kRows);
  flash_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, dh, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel of `dtype` (0 = float32, 1 = bfloat16) needs at
// head width dh; 0 for a bf16 width the kernel has no instance of.
size_t flash_attention_smem(int dh, int dtype) {
  if (dtype == 0) return f32_smem_bytes(dh);
  switch (dh) {
    case 32: return FlashCfg<32>::smem;
    case 64: return FlashCfg<64>::smem;
    case 128: return FlashCfg<128>::smem;
    default: return 0;
  }
}

// Widest head the fp32 kernel's per-lane accumulator holds.
int flash_attention_max_head_dim() { return 32 * kMaxColsPerLane; }

// dtype: 0 = float32 (dh <= 128), 1 = bfloat16 (dh in {32, 64, 128}).
// `device` is the operands' device. Returns 0, a cudaError_t, or
// hopper::kErrTensorMap + a CUresult.
int flash_attention(const void* q, const void* k, const void* v, void* out, int BH,
                    int sq, int sk, int dh, int causal, float scale, int dtype, int device,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || sq == 0) return 0;
  if (dtype == 0) return launch_f32(q, k, v, out, BH, sq, sk, dh, causal, scale, s);
  if (const int e = hopper::bind_device(device)) return e;
  switch (dh) {
    case 32: return launch_bf16<32>(q, k, v, out, BH, sq, sk, causal, scale, s);
    case 64: return launch_bf16<64>(q, k, v, out, BH, sq, sk, causal, scale, s);
    case 128: return launch_bf16<128>(q, k, v, out, BH, sq, sk, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
