// Key splits of the bf16 paged attention kernels (flash-decoding), shared
// by paged_attention.cu (GQA) and paged_attention_mla.cu (MLA).
//
// A long key range is split over blocks: split s of a row walks key tiles
// [s*per, (s+1)*per), per = the row's tiles over the splits but at least
// kMinTiles (a split of one tile costs the combine more than it saves),
// so a short row leaves the later splits empty. Each split writes its
// (m, l, o) in fp32, and the combine kernel merges them in split order,
// so a result does not change from run to run. The wrappers size the
// splits (kernels/paged_attention/kernel.py:key_splits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace key_splits {

constexpr int kMinTiles = 2;  // key tiles a split walks at least

// Key tiles [x, y) that split `split` of `splits` walks of a row's n_tiles
// (x >= y: none).
__device__ __forceinline__ int2 tiles(int n_tiles, int split, int splits) {
  const int per = max(kMinTiles, (n_tiles + splits - 1) / splits);
  const int begin = split * per;
  return make_int2(begin, min(n_tiles, begin + per));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Merge the splits of each of n_rows rows in split order: M = max m_s,
// o = sum_s e^(m_s - M) o_s / max(sum_s e^(m_s - M) l_s, 1e-30).
// part_o [splits, n_rows, d] and part_ml [splits, n_rows, 2] are fp32;
// the row's d outputs go to out_row(row), in its element type. One block
// a row.
template <typename OutRow>
__global__ void combine_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_ml, int splits, int n_rows,
                               int d, OutRow out_row) {
  const size_t row = blockIdx.x;
  const size_t stride = n_rows;
  float mmax = -INFINITY;
  for (int s = 0; s < splits; ++s) mmax = fmaxf(mmax, part_ml[2 * (s * stride + row)]);
  float lsum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t i = s * stride + row;
    lsum += expf(part_ml[2 * i] - mmax) * part_ml[2 * i + 1];
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  auto* orow = out_row(row);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = s * stride + row;
      acc += expf(part_ml[2 * i] - mmax) * part_o[i * d + c];
    }
    store(orow + c, acc * inv);
  }
}

}  // namespace key_splits
