// Blocked matmul for Hopper (sm_90a), float32 accumulation written once.
//
// Replaces: repro/kernels/matmul/matmul.py: matmul (the pl.pallas_call
// kernel _mm_kernel), reached through kernels/matmul/ops.py: mm (no
// routing pattern).  Same contract: a (M, K), b (K, N) of one element type
// (float32 or bfloat16), products summed in float32, the output in a's type.
// As in the paper's reduction rewriting (Fig. 5), each output tile's
// float32 accumulator stays on chip for the whole contraction and is
// written once, after the last k step.  Unlike the TPU kernel no dimension
// must divide a block: ragged edges are masked.
//
// What bounds it on this card: 2·M·N·K flops on float32 CUDA cores (no
// TF32: 67 TFLOP/s; bfloat16 operands are widened and summed the same
// way) against one read of each operand: at the GPT-2-medium FFN's fc
// shape, (1024, 1024) @ (1024, 4096), 128 µs of flops against 7.5 µs of
// bytes — compute-bound.  The TPU kernel's accumulator lives in VMEM
// across its sequential k grid axis; here the k loop runs inside the
// block.
//
// What the design does about it: the grid tiles the output into 64 × 128
// tiles, one block of 128 threads each, and runs the register-tiled tile
// product the chain_grad kernel uses (gemm_tile.cuh): a thread keeps an
// 8 × 8 slice of the tile's accumulator in registers, so every
// shared-memory float4 it reads feeds eight FMAs, and the contraction
// runs in 8-deep stages through two padded shared-memory buffers, the
// next stage fetched into registers while the current one computes.
// Simple CUDA-core FMAs; wgmma and TMA (with bf16 operands on the tensor
// cores) are later work.

#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace codo_gemm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int M, int N, int K) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[8][8] = {};
  tile_product<T, true, true>(acc, a, K, 1, b, N, 1, M, N, 0, K, m0, n0);

  // The accumulator, written once after the last k stage.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_index(tr, i, BM / 2);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_index(tc, j, BN / 2);
      if (gn < N) out[(size_t)gm * N + gn] = codo::from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

// Launch matmul_kernel over (ceil(N/128), ceil(M/64)) blocks: a (M, K), b
// (K, N) and out (M, N) row-major, all of element type dtype.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty or oversized
// shape.
extern "C" int codo_matmul(int dtype, const void* a, const void* b, void* out,
                           int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == codo::kBF16)
    matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}
