// The online softmax shared by the port's attention kernels (flashattn.cu,
// softmax_mm.cu): a key tile of a row folded into the row's running max
// and denominator by the quad of lanes that holds the row in mma.sync
// fragments (quad_max, quad_sum), and a second kernel that combines key
// splits in a fixed order.  Both kernels take the max, exponentiate and
// correct in the same order.
#pragma once

#include <math.h>

#include "common.cuh"

namespace codo_softmax {

constexpr float NEG_INF = -1e30f;  // a masked score, as on the TPU

// Element strides of a (b, h, s, d) operand.
struct Strides {
  long long b, h, s, d;
};

// Max and sum over the quad of lanes (4·g .. 4·g + 3) that holds one row
// of an mma.sync m16n8 accumulator or m16k8 A fragment.
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
