// Fused matmul chain ew(a @ w1) @ w2 for Hopper (sm_90a), float32
// accumulation.
//
// Replaces: repro/kernels/streamfuse/chain.py: fused_matmul_chain (the
// pl.pallas_call kernel _chain_kernel), routed as streamfuse.mmchain.
// Same contract: a (M, K), w1 (K, N1), w2 (N1, N2), one element type for
// all three (float32 or bfloat16), products accumulated in float32, the
// elementwise tail applied to the f32 intermediate, output in a's type.
// The intermediate h = ew(a @ w1) never goes to device memory.
//
// What bounds it on this card: on gpt2_block's FFN (K = 1024, N1 = 4096,
// N2 = 1024, float32) the work is 4·M·K·N1 flops on float32 CUDA cores
// (no TF32: 67 TFLOP/s peak) against 34–42 MB of operands, so it is
// compute-bound (32 µs of flops at M = 128, 256 µs at M = 1024).  The TPU
// kernel holds both weights whole (32 MiB) and walks M in row blocks — at
// M = 128 that is one block, and 32 MiB is far beyond a block's 227 KB.
//
// What the design does about it: the grid tiles M by BM = 64 and N1 into
// chunks of bn1 columns (chosen by the wrapper so the grid fills the 132
// SMs).  A block computes its (BM × bn1) slice of h with a register-tiled
// SIMT GEMM (8 × 8 outputs a thread, float4 shared-memory reads), applies
// the elementwise tail in registers, keeps the slice in dynamic shared
// memory (k-major, so phase 2 reads it as float4 too), and multiplies it
// by the matching bn1 rows of w2 into a float32 partial (BM × N2) product
// in a scratch buffer, fetching each stage's tiles while the previous
// one computes.  A second kernel sums the partials over the chunks in a
// fixed order, so results repeat bit for bit (no atomics).  Simple
// CUDA-core FMAs; wgmma and TMA are later work.
//
// The tail arrives as op codes plus two float attributes per op (the
// EW_KINDS of repro/kernels/streamfuse/ops.py), never as a closure.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;       // rows of a per block
constexpr int BN = 128;      // output columns per register tile
constexpr int BKK = 8;       // contraction depth per shared-memory stage
constexpr int THREADS = 128; // 8 × 16 threads, 8 × 8 outputs each
constexpr int MAX_EW = 8;

enum EwOp {
  kIdentity = 0,
  kRelu = 1,
  kGelu = 2,     // tanh approximation (jax.nn.gelu's default)
  kScale = 3,    // x * a
  kAffine = 4,   // a * x + b, with a = ±1 exact
  kDivc = 5,     // x / a
  kRdivc = 6,    // a / x
};

struct EwChain {
  int n;
  int op[MAX_EW];
  float a[MAX_EW];
  float b[MAX_EW];
};

__device__ __forceinline__ float apply_ew(float x, const EwChain& ew) {
  for (int i = 0; i < ew.n; ++i) {
    const float a = ew.a[i];
    switch (ew.op[i]) {
      case kRelu:
        x = x < 0.f ? 0.f : x;
        break;
      case kGelu: {
        const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
        x = 0.5f * x * (1.f + tanhf(inner));
        break;
      }
      case kScale:
        x = __fmul_rn(x, a);
        break;
      case kAffine: {
        const float y = a == 1.f ? x : (a == -1.f ? -x : __fmul_rn(a, x));
        x = __fadd_rn(y, ew.b[i]);
        break;
      }
      case kDivc:
        x = __fdiv_rn(x, a);
        break;
      case kRdivc:
        x = __fdiv_rn(a, x);
        break;
      default:
        break;
    }
  }
  return x;
}

// One stage of the register-tiled product: acc[8][8] += As · Bs over BKK.
// As is k-major [BKK][lda], Bs [BKK][BN].  A thread owns rows tr·4+i and
// BM/2+tr·4+i and columns tc·4+j and BN/2+tc·4+j (i, j < 4), so each
// operand is two float4 reads a step: broadcast for As, conflict-free for
// Bs.
__device__ __forceinline__ void mma_stage(float (&acc)[8][8], const float* As,
                                          int lda, const float* Bs, int tr,
                                          int tc) {
#pragma unroll
  for (int kk = 0; kk < BKK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * lda + tr * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * lda + BM / 2 + tr * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN + tc * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * BN + BN / 2 + tc * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// Row (half = BM/2) or column (half = BN/2) of the tile that register
// index i (< 8) of thread coordinate t stands for.
__device__ __forceinline__ int tile_index(int t, int i, int half) {
  return (i < 4 ? 0 : half) + t * 4 + (i & 3);
}

constexpr int A_TILE = BKK * BM;            // floats of one a tile
constexpr int B_TILE = BKK * BN;            // floats of one weight tile
constexpr int A_PER = A_TILE / THREADS;     // a elements a thread moves
constexpr int B_PER = B_TILE / THREADS;     // weight elements a thread moves

// Global -> registers: the a tile at (m0, k0), element i of it at row
// i / BKK, column i % BKK (eight threads read a row's 32 bytes).
template <typename T>
__device__ __forceinline__ void fetch_a(float (&r)[A_PER], const T* a, int M,
                                        int K, int m0, int k0, int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    const int i = tid + u * THREADS, gm = m0 + i / BKK, gk = k0 + i % BKK;
    r[u] = (gm < M && gk < K) ? codo::to_f32(a[(size_t)gm * K + gk]) : 0.f;
  }
}

__device__ __forceinline__ void stash_a(float* a_s, const float (&r)[A_PER],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    const int i = tid + u * THREADS;
    a_s[(i % BKK) * BM + i / BKK] = r[u];     // k-major
  }
}

// Global -> registers: the (BKK × BN) tile at (k0, n0) of a row-major
// (rows × cols) weight with leading dimension ld.
template <typename T>
__device__ __forceinline__ void fetch_w(float (&r)[B_PER], const T* w,
                                        int rows, int cols, int ld, int k0,
                                        int n0, int tid) {
#pragma unroll
  for (int u = 0; u < B_PER; ++u) {
    const int i = tid + u * THREADS, gk = k0 + i / BN, gn = n0 + i % BN;
    r[u] = (gk < rows && gn < cols) ? codo::to_f32(w[(size_t)gk * ld + gn])
                                    : 0.f;
  }
}

__device__ __forceinline__ void stash_w(float* b_s, const float (&r)[B_PER],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < B_PER; ++u) b_s[tid + u * THREADS] = r[u];
}

// Both phases run the same pipeline: the next stage's tiles are fetched
// into registers while the current stage computes from one of two
// shared-memory buffers, so global latency hides behind the FMAs and one
// barrier a stage suffices.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    chain_kernel(const T* __restrict__ a, const T* __restrict__ w1,
                 const T* __restrict__ w2, float* __restrict__ partial, int M,
                 int K, int N1, int N2, int bn1, EwChain ew) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [bn1][BM] h slice, k-major
  float* a_s = h_s + BM * bn1;     // 2 × [BKK][BM]  a tiles, k-major
  float* b_s = a_s + 2 * A_TILE;   // 2 × [BKK][BN]  w1 or w2 tiles

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int m0 = blockIdx.x * BM;
  const int chunk = blockIdx.y, n10 = chunk * bn1;
  float ra[A_PER], rb[B_PER];

  // ---- phase 1: h_s = ew(a[m0:m0+BM, :] @ w1[:, n10:n10+bn1]) ----
  for (int nb = 0; nb < bn1; nb += BN) {
    float acc[8][8] = {};
    fetch_a(ra, a, M, K, m0, 0, tid);
    fetch_w(rb, w1, K, N1, N1, 0, n10 + nb, tid);
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BKK) {
      stash_a(a_s + buf * A_TILE, ra, tid);
      stash_w(b_s + buf * B_TILE, rb, tid);
      __syncthreads();
      if (k0 + BKK < K) {
        fetch_a(ra, a, M, K, m0, k0 + BKK, tid);
        fetch_w(rb, w1, K, N1, N1, k0 + BKK, n10 + nb, tid);
      }
      mma_stage(acc, a_s + buf * A_TILE, BM, b_s + buf * B_TILE, tr, tc);
      buf ^= 1;
    }
    __syncthreads();
    // The tail runs on real elements only: padded entries stay 0 so that
    // they add nothing in phase 2 (an affine or rdivc tail would not).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb + tile_index(tc, j, BN / 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float h4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = tile_index(tr, 4 * half + i, BM / 2);
          h4[i] = (m0 + m < M && n10 + n < N1)
                      ? apply_ew(acc[4 * half + i][j], ew)
                      : 0.f;
        }
        float* dst = h_s + n * BM + tile_index(tr, 4 * half, BM / 2);
        *reinterpret_cast<float4*>(dst) = make_float4(h4[0], h4[1], h4[2], h4[3]);
      }
    }
  }
  __syncthreads();

  // ---- phase 2: partial[chunk] rows m0.. = h_s @ w2[n10:n10+bn1, :] ----
  float* out = partial + (size_t)chunk * M * N2;
  for (int nb = 0; nb < N2; nb += BN) {
    float acc[8][8] = {};
    fetch_w(rb, w2, N1, N2, N2, n10, nb, tid);
    int buf = 0;
    for (int k0 = 0; k0 < bn1; k0 += BKK) {
      stash_w(b_s + buf * B_TILE, rb, tid);
      __syncthreads();
      if (k0 + BKK < bn1) fetch_w(rb, w2, N1, N2, N2, n10 + k0 + BKK, nb, tid);
      mma_stage(acc, h_s + k0 * BM, BM, b_s + buf * B_TILE, tr, tc);
      buf ^= 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gm = m0 + tile_index(tr, i, BM / 2);
        const int gn = nb + tile_index(tc, j, BN / 2);
        if (gm < M && gn < N2) out[(size_t)gm * N2 + gn] = acc[i][j];
      }
  }
}

// out = sum over chunks of partial, in chunk order: deterministic.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial,
                              T* __restrict__ out, int chunks, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[c * mn + i];
    out[i] = codo::from_f32<T>(s);
  }
}

template <typename T>
int launch_main(const void* a, const void* w1, const void* w2, void* partial,
                int M, int K, int N1, int N2, int bn1, const EwChain& ew,
                cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BM * bn1 + 2 * A_TILE + 2 * B_TILE);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N1 + bn1 - 1) / bn1);
  chain_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<float*>(partial), M, K, N1, N2,
      bn1, ew);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* partial, void* out, int chunks, long long mn,
                  cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (mn + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  reduce_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), chunks, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch chain_kernel: partial (chunks, M, N2) float32 scratch, chunks =
// ceil(N1 / bn1), bn1 a multiple of 128.  ew: n_ew op codes with attributes
// ew_a / ew_b.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// bn1 or tail the kernel does not take.
extern "C" int codo_matmul_chain(int dtype, const void* a, const void* w1,
                                 const void* w2, void* partial, int M, int K,
                                 int N1, int N2, int bn1, int n_ew,
                                 const int* ew_ops, const float* ew_a,
                                 const float* ew_b, void* stream) {
  if (n_ew < 0 || n_ew > MAX_EW || bn1 <= 0 || bn1 % BN != 0)
    return (int)cudaErrorInvalidValue;
  EwChain ew{};
  ew.n = n_ew;
  for (int i = 0; i < n_ew; ++i) {
    ew.op[i] = ew_ops[i];
    ew.a[i] = ew_a[i];
    ew.b[i] = ew_b[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_main<__nv_bfloat16>(a, w1, w2, partial, M, K, N1, N2, bn1,
                                      ew, s);
  return launch_main<float>(a, w1, w2, partial, M, K, N1, N2, bn1, ew, s);
}

// Launch reduce_kernel: out (M, N2) in the chain's element type.
extern "C" int codo_matmul_chain_reduce(int dtype, const void* partial,
                                        void* out, int chunks, long long mn,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_reduce<__nv_bfloat16>(partial, out, chunks, mn, s);
  return launch_reduce<float>(partial, out, chunks, mn, s);
}
