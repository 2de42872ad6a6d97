// Fused backward matmul with its gradient epilogue, ew(a @ w, *extras), for
// Hopper (sm_90a), float32 accumulation.
//
// Replaces: repro/kernels/streamfuse/chain.py: fused_matmul_grad (the
// pl.pallas_call kernel _grad_chain_kernel), routed as streamfuse.mmgrad.
// Same contract: a (M, K), w (K, N), each extra (M, N), one element type for
// all (float32 or bfloat16), products accumulated in float32, the tail
// (the EW_KINDS plus relu_grad, gelu_grad and softmax_grad, each gradient
// kind reading one residual operand) applied to the float32 product, output
// in a's type.  Every operand is read through the strides it is given: on
// the train step's backward w is a transposed view (W_fc2ᵀ, vᵀ) and an
// extra may be an expand view, and nothing is copied to make them dense.
//
// What bounds it on this card: on gpt2_block's backward the FFN chain is
// (S, 1024) @ (1024, 4096) + gelu_grad and the attention chain (S, 1024) @
// (1024, S) + softmax_grad + scale.  2·M·N·K flops on float32 CUDA cores
// (no TF32: 67 TFLOP/s) against one read of w (16 MiB for the FFN): the
// FFN chain is compute-bound (16 µs of flops at S = 128, 128 µs at
// S = 1024), the attention chain too at S = 1024.  The TPU kernel holds w
// whole and walks M in row blocks: 1–8 blocks at the route's M, and 16 MiB
// is far beyond a block's 227 KB.
//
// What the design does about it: the grid tiles the output into 64 × 128
// tiles and, where that gives fewer than two blocks per SM (few rows),
// splits K as well.  A block runs a register-tiled SIMT GEMM (8 × 8
// outputs a thread, float4 shared-memory reads from padded, conflict-free
// tiles), fetching the next stage's tiles into registers while the current
// one computes; which threads fetch which elements follows each operand's
// unit-stride dimension, so a transposed w is read coalesced.  With one
// split and no softmax_grad, the whole tail runs in registers on the output
// tile, reading the matching elements of each extra, and the output is
// written once (one launch).  softmax_grad needs the dot of its whole row
// (N up to S), and a split K needs its partial sums: then the first launch
// writes float32 values (the tail applied up to the first softmax_grad),
// and a second, one block a row, sums the splits in a fixed order, takes
// each softmax_grad's row dot as a fixed-order block reduction and applies
// the rest of the tail.  Results repeat bit for bit (no atomics).  Simple
// CUDA-core FMAs; wgmma and TMA are later work.
//
// The tail arrives as op codes, two float attributes and an extra index per
// stage (kernels/streamfuse/chain.py GRAD_CODES), never as a closure.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace codo_gemm;

constexpr int MAX_EW = 8;
constexpr int ROW_THREADS = 256;

enum EwOp {
  kIdentity = 0,
  kRelu = 1,
  kGelu = 2,         // tanh approximation (jax.nn.gelu's default)
  kScale = 3,        // x * a
  kAffine = 4,       // a * x + b, with a = ±1 exact
  kDivc = 5,         // x / a
  kRdivc = 6,        // a / x
  kReluGrad = 7,     // x * (e > 0)
  kGeluGrad = 8,     // x * gelu'(e)
  kSoftmaxGrad = 9,  // e * (x - Σ_row x·e)
};

// The tail: per stage an op code, two attributes and the index of the
// extra it reads (-1 for none); per extra a pointer and its two strides.
struct Tail {
  int n;
  int op[MAX_EW];
  float a[MAX_EW];
  float b[MAX_EW];
  int ex[MAX_EW];
  const void* ptr[MAX_EW];
  long long sm[MAX_EW];
  long long sn[MAX_EW];
};

template <typename T>
__device__ __forceinline__ float extra_at(const Tail& t, int stage, int m,
                                          int n) {
  const int e = t.ex[stage];
  if (e < 0) return 0.f;
  const T* p = static_cast<const T*>(t.ptr[e]);
  return codo::to_f32(p[(long long)m * t.sm[e] + (long long)n * t.sn[e]]);
}

// d/dx of the tanh gelu, in the order of the op registry's gelu_grad body:
// 0.5(1+t) + 0.5·x·(1−t²)·√(2/π)·(1+3·0.044715·x²).
__device__ __forceinline__ float gelu_deriv(float x) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * (x * x * x)));
  return 0.5f * (1.f + t) +
         0.5f * x * (1.f - t * t) * c *
             (1.f + static_cast<float>(3.0 * 0.044715) * (x * x));
}

// One stage other than softmax_grad (which needs its row's dot); e is the
// stage's extra at this element.
__device__ __forceinline__ float apply_stage(float x, int op, float a, float b,
                                             float e) {
  switch (op) {
    case kRelu:
      return x < 0.f ? 0.f : x;
    case kGelu: {
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case kScale:
      return __fmul_rn(x, a);
    case kAffine: {
      const float y = a == 1.f ? x : (a == -1.f ? -x : __fmul_rn(a, x));
      return __fadd_rn(y, b);
    }
    case kDivc:
      return __fdiv_rn(x, a);
    case kRdivc:
      return __fdiv_rn(a, x);
    case kReluGrad:
      return __fmul_rn(x, e > 0.f ? 1.f : 0.f);
    case kGeluGrad:
      return __fmul_rn(x, gelu_deriv(e));
    default:
      return x;
  }
}


// The tiled product of split blockIdx.z (contraction k in [z·per,
// (z+1)·per)), then the first n_apply stages of the tail in registers.
// write_out: write the output in T to dst (M, N); else write float32 values to
// dst[z] of a (splits, M, N) buffer.
template <typename T, bool A_K_FAST, bool W_N_FAST>
__global__ void __launch_bounds__(THREADS)
    grad_gemm_kernel(const T* __restrict__ a, long long sam, long long sak,
                     const T* __restrict__ w, long long swk, long long swn,
                     void* __restrict__ dst, int write_out, int M, int N, int K,
                     int per, int n_apply, Tail tail) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * per;
  float acc[8][8] = {};
  tile_product<T, A_K_FAST, W_N_FAST>(acc, a, sam, sak, w, swk, swn, M, N,
                                      kb, min(K, kb + per), m0, n0);

  float* part = static_cast<float*>(dst) + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_index(tr, i, BM / 2);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_index(tc, j, BN / 2);
      if (gn >= N) continue;
      float v = acc[i][j];
      for (int s = 0; s < n_apply; ++s)
        v = apply_stage(v, tail.op[s], tail.a[s], tail.b[s],
                        extra_at<T>(tail, s, gm, gn));
      const size_t at = (size_t)gm * N + gn;
      if (write_out)
        static_cast<T*>(dst)[at] = codo::from_f32<T>(v);
      else
        part[at] = v;
    }
  }
}

// Sum over the block's threads, the same value on every thread, in a fixed
// order: a shuffle tree in each warp, then the warps' sums in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < ROW_THREADS / 32; ++i) s += red[i];
  return s;
}

// One block a row: the split sums in order (stored back into split 0's
// row), then from stage `start` on, segment by segment, each softmax_grad's
// row dot and the elementwise stages up to the next one.  A thread always
// owns the same columns, so rewriting the row in place is race-free.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    grad_rows_kernel(float* __restrict__ part, int splits, T* __restrict__ out,
                     int M, int N, int start, Tail tail) {
  __shared__ float red[ROW_THREADS / 32];
  const int m = blockIdx.x;
  const size_t mn = (size_t)M * N;
  float* row = part + (size_t)m * N;
  bool summed = false;  // row already holds the split sum
  int s = start;
  for (;;) {
    const bool sg = s < tail.n && tail.op[s] == kSoftmaxGrad;
    float dot = 0.f;
    if (sg) {
      float acc = 0.f;
      for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
        float v = row[n];
        if (!summed) {
          for (int z = 1; z < splits; ++z) v += row[z * mn + n];
          row[n] = v;
        }
        acc += v * extra_at<T>(tail, s, m, n);
      }
      summed = true;
      dot = block_sum(acc, red);
    }
    int e = s + (sg ? 1 : 0);
    while (e < tail.n && tail.op[e] != kSoftmaxGrad) ++e;
    const bool last = e == tail.n;
    for (int n = threadIdx.x; n < N; n += ROW_THREADS) {
      float v = row[n];
      if (!summed)
        for (int z = 1; z < splits; ++z) v += row[z * mn + n];
      int i = s;
      if (sg) {
        const float y = extra_at<T>(tail, i, m, n);
        v = __fmul_rn(y, __fsub_rn(v, dot));
        ++i;
      }
      for (; i < e; ++i)
        v = apply_stage(v, tail.op[i], tail.a[i], tail.b[i],
                        extra_at<T>(tail, i, m, n));
      if (last)
        out[(size_t)m * N + n] = codo::from_f32<T>(v);
      else
        row[n] = v;
    }
    if (last) break;
    summed = true;
    s = e;
  }
}

template <typename T, bool A_K_FAST, bool W_N_FAST>
int launch_gemm(const void* a, long long sam, long long sak, const void* w,
                long long swk, long long swn, void* dst, int write_out, int M,
                int N, int K, int per, int splits, int n_apply,
                const Tail& tail, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  grad_gemm_kernel<T, A_K_FAST, W_N_FAST><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), sam, sak, static_cast<const T*>(w), swk, swn,
      dst, write_out, M, N, K, per, n_apply, tail);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemm_any(const void* a, long long sam, long long sak,
                    const void* w, long long swk, long long swn, void* dst,
                    int write_out, int M, int N, int K, int per, int splits,
                    int n_apply, const Tail& tail, cudaStream_t stream) {
  auto* fn = &launch_gemm<T, false, false>;
  if (sak == 1 && swn == 1)
    fn = &launch_gemm<T, true, true>;
  else if (sak == 1)
    fn = &launch_gemm<T, true, false>;
  else if (swn == 1)
    fn = &launch_gemm<T, false, true>;
  return fn(a, sam, sak, w, swk, swn, dst, write_out, M, N, K, per, splits,
            n_apply, tail, stream);
}

// The tail from the wrapper's arrays; false if it is not one the kernels
// take.
bool make_tail(Tail& t, int n_ew, const int* ops, const float* ea,
               const float* eb, const int* ex, int n_extras,
               const void* const* ptrs, const long long* sm,
               const long long* sn) {
  if (n_ew < 0 || n_ew > MAX_EW || n_extras < 0 || n_extras > MAX_EW)
    return false;
  t = Tail{};
  t.n = n_ew;
  for (int i = 0; i < n_ew; ++i) {
    if (ops[i] < kIdentity || ops[i] > kSoftmaxGrad || ex[i] >= n_extras)
      return false;
    t.op[i] = ops[i];
    t.a[i] = ea[i];
    t.b[i] = eb[i];
    t.ex[i] = ex[i];
  }
  for (int e = 0; e < n_extras; ++e) {
    t.ptr[e] = ptrs[e];
    t.sm[e] = sm[e];
    t.sn[e] = sn[e];
  }
  return true;
}

}  // namespace

// Launch grad_gemm_kernel over an (N/128, M/64, splits) grid; each split
// covers `per` (a multiple of 8) of K.  write_out != 0: dst is the (M, N)
// output in the operands' type (then splits must be 1); else a float32
// (splits, M, N) buffer for codo_matmul_grad_rows.  The first n_apply tail
// stages run in registers (never a softmax_grad).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int codo_matmul_grad(int dtype, const void* a, long long sam,
                                long long sak, const void* w, long long swk,
                                long long swn, void* dst, int write_out, int M,
                                int N, int K, int per, int splits, int n_apply,
                                int n_ew, const int* ew_ops, const float* ew_a,
                                const float* ew_b, const int* ew_extra,
                                int n_extras, const void* const* extras,
                                const long long* extra_sm,
                                const long long* extra_sn, void* stream) {
  Tail tail;
  if (!make_tail(tail, n_ew, ew_ops, ew_a, ew_b, ew_extra, n_extras, extras,
                 extra_sm, extra_sn) ||
      per <= 0 || per % BKK != 0 || splits <= 0 || (write_out && splits != 1) ||
      n_apply < 0 || n_apply > n_ew)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_apply; ++i)
    if (tail.op[i] == kSoftmaxGrad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = dtype == codo::kBF16 ? &launch_gemm_any<__nv_bfloat16>
                                  : &launch_gemm_any<float>;
  return fn(a, sam, sak, w, swk, swn, dst, write_out, M, N, K, per, splits,
            n_apply, tail, s);
}

// Launch grad_rows_kernel, one block a row: part is the float32 (splits, M,
// N) buffer codo_matmul_grad wrote (its split 0 is rewritten), out the (M,
// N) output; tail stages from `start` on are applied.
extern "C" int codo_matmul_grad_rows(int dtype, void* part, int splits,
                                     void* out, int M, int N, int start,
                                     int n_ew, const int* ew_ops,
                                     const float* ew_a, const float* ew_b,
                                     const int* ew_extra, int n_extras,
                                     const void* const* extras,
                                     const long long* extra_sm,
                                     const long long* extra_sn, void* stream) {
  Tail tail;
  if (!make_tail(tail, n_ew, ew_ops, ew_a, ew_b, ew_extra, n_extras, extras,
                 extra_sm, extra_sn) ||
      splits <= 0 || start < 0 || start > n_ew)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == codo::kBF16)
    grad_rows_kernel<__nv_bfloat16><<<M, ROW_THREADS, 0, s>>>(
        p, splits, static_cast<__nv_bfloat16*>(out), M, N, start, tail);
  else
    grad_rows_kernel<float><<<M, ROW_THREADS, 0, s>>>(
        p, splits, static_cast<float*>(out), M, N, start, tail);
  return (int)cudaGetLastError();
}
