// The online softmax shared by the port's attention kernels (flashattn.cu,
// softmax_mm.cu): one key tile of a row folded into the row's running max
// and denominator — by a warp (online_softmax_step, softmax_mm.cu) or by
// the quads of lanes that hold the row in mma accumulators (quad_max and
// quad_sum, flashattn.cu) — and a second kernel that combines key splits
// in a fixed order.  Both take the max, exponentiate and correct in the
// same order, so a routed attention tail and the full attention chain
// round alike.
#pragma once

#include <math.h>

#include "common.cuh"

namespace codo_softmax {

constexpr float NEG_INF = -1e30f;  // a masked score, as on the TPU

// Element strides of a (b, h, s, d) operand.
struct Strides {
  long long b, h, s, d;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One key tile of one row, held by a warp two scores a lane (x): folds
// the tile into the running max m and denominator l, turns x into the
// tile's probabilities exp(x - m_new), and returns exp(m - m_new), the
// correction of the row's accumulator.
__device__ __forceinline__ float online_softmax_step(float (&x)[2], float& m,
                                                     float& l) {
  const float m_new = fmaxf(m, warp_max(fmaxf(x[0], x[1])));
  x[0] = expf(x[0] - m_new);
  x[1] = expf(x[1] - m_new);
  const float corr = expf(m - m_new);
  l = l * corr + warp_sum(x[0] + x[1]);
  m = m_new;
  return corr;
}

// Max and sum over the quad of lanes (4·g .. 4·g + 3) that holds one row
// of an mma.sync m16n8 accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// o[row] = Σ_s acc_s·e^(m_s−m) / max(Σ_s l_s·e^(m_s−m), 1e-30), m = max_s m_s,
// splits summed in order.  One block per (b·h, q) row.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_ml,
                               T* __restrict__ o, int splits, int BH, int Hq,
                               int Sq, int hd, Strides os) {
  const int row = blockIdx.x;
  const int bh = row / Sq, qr = row % Sq;
  const int b = bh / Hq, h = bh % Hq;
  float m = -INFINITY;
  for (int z = 0; z < splits; ++z)
    m = fmaxf(m, part_ml[(((size_t)z * BH + bh) * Sq + qr) * 2]);
  float l = 0.f;
  for (int z = 0; z < splits; ++z) {
    const size_t at = (((size_t)z * BH + bh) * Sq + qr) * 2;
    l += part_ml[at + 1] * expf(part_ml[at] - m);
  }
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + b * os.b + h * os.h + qr * os.s;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) {
      const size_t at = ((size_t)z * BH + bh) * Sq + qr;
      a += part_o[at * hd + d] * expf(part_ml[at * 2] - m);
    }
    orow[d * os.d] = codo::from_f32<T>(a * inv_l);
  }
}

}  // namespace codo_softmax
