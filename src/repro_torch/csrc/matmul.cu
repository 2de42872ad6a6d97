// Blocked matmul for Hopper (sm_90a) on the tensor cores, float32
// accumulation written once.
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
// What bounds it on this card: 2·M·N·K flops against one read of each
// operand and one write of the output.  At the GPT-2-medium FFN's fc
// shape, (1024, 1024) @ (1024, 4096), that is 52 µs of flops at 165
// TFLOP/s of float32-accurate work on the TF32 tensor cores (three TF32
// products a float32 one), 128 µs on the float32 CUDA cores, against
// 7.5 µs of bytes: compute-bound.  The TPU kernel's accumulator lives in
// VMEM across its sequential k grid axis; here the k loop runs inside the
// block.
//
// What the design does about it: the grid tiles the output into 128 × 128
// tiles, and each block runs the tensor-core tile of mma_gemm.cuh that
// fused_matmul_grad runs: 8 warps of 64 × 32 on mma.sync m16n8k8 TF32 with
// the 3×TF32 split (bfloat16 operands, exact in TF32, take one pass), a
// three-stage cp.async ring of 32-deep stages, 16-byte copies where rows
// are 16-byte aligned.  b is N-contiguous, so its tile is kept row by row
// (k, then n) and its fragments are read without ldmatrix.  The tensor
// cores accumulate, as in fused_matmul_grad.  The accumulator then goes
// through shared memory and the block stores its tile row by row,
// consecutive threads on consecutive columns.  At the route shape the 256
// tiles are one wave of two blocks a SM (≈ 107 KB of shared memory each).

#include <stdint.h>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace codo_gemm_mma;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  tile_product<T, false>(acc, a, K, 1, b, N, 1, M, N, 0, K, m0, n0,
                         reinterpret_cast<T*>(smem4));
  float* c_s = reinterpret_cast<float*>(smem4);
  stash_tile(acc, c_s);

  // The accumulator, written once after the last k stage.
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (r < rows && c < cols)
      out[(size_t)(m0 + r) * N + n0 + c] =
          codo::from_f32<T>(c_s[r * C_LD + c]);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, false>();
  cudaError_t err = codo::set_smem<matmul_kernel<T>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch matmul_kernel over (ceil(N/128), ceil(M/128)) blocks: a (M, K), b
// (K, N) and out (M, N) row-major, all of element type dtype.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty or oversized
// shape.
extern "C" int codo_matmul(int dtype, const void* a, const void* b, void* out,
                           int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch<__nv_bfloat16>(a, b, out, M, N, K, s);
  return launch<float>(a, b, out, M, N, K, s);
}
