// Fused backward matmul with its gradient epilogue, ew(a @ w, *extras), for
// Hopper (sm_90a), float32 accumulation on the tensor cores.
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
// (1024, S) + softmax_grad + scale.  2·M·N·K flops against one read of w
// (16 MiB for the FFN): at 165 TFLOP/s of float32-accurate work on the
// TF32 tensor cores (three products a multiply) the FFN chain is
// compute-bound (6.5 µs of flops at S = 128 against 6.4 µs of bytes, 52 µs
// at S = 1024), the attention chain too at S = 1024.  The TPU kernel holds
// w whole and walks M in row blocks: 1–8 blocks at the route's M, and
// 16 MiB is far beyond a block's 227 KB.
//
// What the design does about it: the grid tiles the output into 128 × 128
// tiles and, where that leaves the card short of a wave (few rows), splits
// K as well.  A block runs the tensor-core tile of mma_gemm.cuh — 8 warps
// of 64 × 32 on mma.sync m16n8k8 TF32 with the 3×TF32 split, a
// three-stage cp.async ring of 32-deep stages, w's tile kept by n when w
// is a transposed view (every routed call) so that it is copied in
// 16-byte vectors along k.  The accumulator then goes through shared
// memory, and the epilogue walks the tile row by row, consecutive threads
// on consecutive columns: with one split and no softmax_grad the whole
// tail runs there, reading each extra through its strides, and the output
// is written once (one launch).  softmax_grad needs the dot of its whole
// row (N up to S), and a split K needs its partial sums: then the first
// launch writes float32 values (the tail applied up to the first
// softmax_grad), and a second, one block a row (or a row's 1024 columns
// where no softmax_grad follows), sums the splits in a fixed order, takes
// each softmax_grad's row dot as a fixed-order block reduction and
// applies the rest of the tail.  Results repeat bit for bit (no
// atomics).
//
// The tail arrives as op codes, two float attributes and an extra index per
// stage (kernels/streamfuse/chain.py GRAD_CODES), never as a closure; each
// stage carries its extra's pointer and strides, and the kernels index the
// stages by compile-time numbers only (a run-time index would put the
// struct on the stack).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace codo_gemm_mma;

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

// The tail: per stage an op code, two attributes, and the extra it reads
// (pointer and element strides; nullptr for none).
struct Tail {
  int n;
  int op[MAX_EW];
  float a[MAX_EW];
  float b[MAX_EW];
  const void* ptr[MAX_EW];
  long long sm[MAX_EW];
  long long sn[MAX_EW];
};

// Stage s's extra at (m, n); s a compile-time number where it is called
// in an unrolled loop.
template <typename T>
__device__ __forceinline__ float extra_at(const Tail& t, int s, int m, int n) {
  const T* p = static_cast<const T*>(t.ptr[s]);
  if (p == nullptr) return 0.f;
  return codo::to_f32(p[(long long)m * t.sm[s] + (long long)n * t.sn[s]]);
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

// Stages [first, last) at element (m, n), each indexed by a compile-time
// number.
template <typename T>
__device__ __forceinline__ float apply_stages(float v, const Tail& tail,
                                              int first, int last, int m,
                                              int n) {
#pragma unroll
  for (int s = 0; s < MAX_EW; ++s)
    if (s >= first && s < last)
      v = apply_stage(v, tail.op[s], tail.a[s], tail.b[s],
                      extra_at<T>(tail, s, m, n));
  return v;
}

// The tile product of split blockIdx.z (contraction k in [z·per,
// (z+1)·per)), then the first n_apply stages of the tail on the staged
// tile.  write_out: write the output in T to dst (M, N); else write
// float32 values to dst[z] of a (splits, M, N) buffer.
template <typename T, bool W_BY_N>
__global__ void __launch_bounds__(THREADS, 2)
    grad_mma_kernel(const T* __restrict__ a, long long sam, long long sak,
                    const T* __restrict__ w, long long swk, long long swn,
                    void* __restrict__ dst, int write_out, int M, int N,
                    int K, int per, int n_apply, Tail tail) {
  extern __shared__ float4 smem4[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * per;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  tile_product<T, W_BY_N>(acc, a, sam, sak, w, swk, swn, M, N, kb,
                          min(K, kb + per), m0, n0,
                          reinterpret_cast<T*>(smem4));
  float* c_s = reinterpret_cast<float*>(smem4);
  stash_tile(acc, c_s);

  float* part = static_cast<float*>(dst) + (size_t)blockIdx.z * M * N;
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (r >= rows || c >= cols) continue;
    const int gm = m0 + r, gn = n0 + c;
    const float v = apply_stages<T>(c_s[r * C_LD + c], tail, 0, n_apply, gm,
                                    gn);
    const size_t at = (size_t)gm * N + gn;
    if (write_out)
      static_cast<T*>(dst)[at] = codo::from_f32<T>(v);
    else
      part[at] = v;
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

// Whether stage s (a run-time number) is a softmax_grad, by compile-time
// indices.
__device__ __forceinline__ bool is_softmax_grad(const Tail& tail, int s) {
  bool r = false;
#pragma unroll
  for (int i = 0; i < MAX_EW; ++i)
    if (i == s) r = tail.op[i] == kSoftmaxGrad;
  return r;
}

template <typename T>
__device__ __forceinline__ float extra_of(const Tail& tail, int s, int m,
                                          int n) {
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_EW; ++i)
    if (i == s) r = extra_at<T>(tail, i, m, n);
  return r;
}

// Block (m, y) takes columns [y·cols, (y + 1)·cols) of row m (the whole
// row, cols = N, when a softmax_grad follows): the split sums in order
// (stored back into split 0's row), then from stage `start` on, segment by
// segment, each softmax_grad's row dot and the elementwise stages up to
// the next one.  A thread always owns the same columns, so rewriting the
// row in place is race-free.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    grad_rows_kernel(float* __restrict__ part, int splits, T* __restrict__ out,
                     int M, int N, int cols, int start, Tail tail) {
  __shared__ float red[ROW_THREADS / 32];
  const int m = blockIdx.x;
  const int n0 = blockIdx.y * cols, n1 = min(N, n0 + cols);
  const size_t mn = (size_t)M * N;
  float* row = part + (size_t)m * N;
  bool summed = false;  // row already holds the split sum
  int s = start;
  for (;;) {
    const bool sg = s < tail.n && is_softmax_grad(tail, s);
    float dot = 0.f;
    if (sg) {
      float acc = 0.f;
      for (int n = n0 + threadIdx.x; n < n1; n += ROW_THREADS) {
        float v = row[n];
        if (!summed) {
          for (int z = 1; z < splits; ++z) v += row[z * mn + n];
          row[n] = v;
        }
        acc += v * extra_of<T>(tail, s, m, n);
      }
      summed = true;
      dot = block_sum(acc, red);
    }
    int e = s + (sg ? 1 : 0);
    while (e < tail.n && !is_softmax_grad(tail, e)) ++e;
    const bool last = e == tail.n;
    for (int n = n0 + threadIdx.x; n < n1; n += ROW_THREADS) {
      float v = row[n];
      if (!summed)
        for (int z = 1; z < splits; ++z) v += row[z * mn + n];
      if (sg) v = __fmul_rn(extra_of<T>(tail, s, m, n), __fsub_rn(v, dot));
      v = apply_stages<T>(v, tail, s + (sg ? 1 : 0), e, m, n);
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

template <typename T, bool W_BY_N>
int launch_gemm(const void* a, long long sam, long long sak, const void* w,
                long long swk, long long swn, void* dst, int write_out, int M,
                int N, int K, int per, int splits, int n_apply,
                const Tail& tail, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, W_BY_N>();
  cudaError_t err =
      codo::set_smem<grad_mma_kernel<T, W_BY_N>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  grad_mma_kernel<T, W_BY_N><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a), sam, sak, static_cast<const T*>(w), swk, swn,
      dst, write_out, M, N, K, per, n_apply, tail);
  return (int)cudaGetLastError();
}

// w's tile by n unless w is N-contiguous (then by k, copied in vectors
// along n).
template <typename T>
int launch_gemm_any(const void* a, long long sam, long long sak,
                    const void* w, long long swk, long long swn, void* dst,
                    int write_out, int M, int N, int K, int per, int splits,
                    int n_apply, const Tail& tail, cudaStream_t stream) {
  auto* fn = swn == 1 ? &launch_gemm<T, false> : &launch_gemm<T, true>;
  return fn(a, sam, sak, w, swk, swn, dst, write_out, M, N, K, per, splits,
            n_apply, tail, stream);
}

// The tail from the wrapper's arrays (each stage's extra index resolved to
// the extra's pointer and strides); false if it is not one the kernels
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
    if (ex[i] >= 0) {
      t.ptr[i] = ptrs[ex[i]];
      t.sm[i] = sm[ex[i]];
      t.sn[i] = sn[ex[i]];
    }
  }
  return true;
}

}  // namespace

// Launch grad_mma_kernel over an (N/128, M/128, splits) grid; each split
// covers `per` (a multiple of 32) of K.  write_out != 0: dst is the (M, N)
// output in the operands' type (then splits must be 1); else a float32
// (splits, M, N) buffer for codo_matmul_grad_rows.  The first n_apply tail
// stages run in the epilogue (never a softmax_grad).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int codo_matmul_grad(int dtype, const void* a, long long sam,
                                long long sak, const void* w, long long swk,
                                long long swn, void* dst, int write_out, int M,
                                int N, int K, int per, int splits, int n_apply,
                                int n_ew, const int* ew_ops,
                                const float* ew_a, const float* ew_b,
                                const int* ew_extra, int n_extras,
                                const void* const* extras,
                                const long long* extra_sm,
                                const long long* extra_sn, void* stream) {
  Tail tail;
  if (!make_tail(tail, n_ew, ew_ops, ew_a, ew_b, ew_extra, n_extras, extras,
                 extra_sm, extra_sn) ||
      M <= 0 || N <= 0 || K <= 0 || per <= 0 || per % BK != 0 ||
      splits <= 0 || splits > 65535 || (M + BM - 1) / BM > 65535 ||
      (write_out && splits != 1) || n_apply < 0 || n_apply > n_ew)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_apply; ++i)
    if (tail.op[i] == kSoftmaxGrad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* fn = dtype == codo::kBF16 ? &launch_gemm_any<__nv_bfloat16>
                                  : &launch_gemm_any<float>;
  return fn(a, sam, sak, w, swk, swn, dst, write_out, M, N, K, per, splits,
            n_apply, tail, s);
}

// Launch grad_rows_kernel, one block a row, or a row's 1024-column chunk
// where no softmax_grad follows `start`: part is the float32 (splits, M, N)
// buffer codo_matmul_grad wrote (its split 0 is rewritten), out the (M, N)
// output; tail stages from `start` on are applied.
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
  bool whole = false;
  for (int i = start; i < n_ew; ++i) whole |= tail.op[i] == kSoftmaxGrad;
  const int cols = whole ? N : 4 * ROW_THREADS;
  const dim3 grid(M, (N + cols - 1) / cols);
  if (dtype == codo::kBF16)
    grad_rows_kernel<__nv_bfloat16><<<grid, ROW_THREADS, 0, s>>>(
        p, splits, static_cast<__nv_bfloat16*>(out), M, N, cols, start, tail);
  else
    grad_rows_kernel<float><<<grid, ROW_THREADS, 0, s>>>(
        p, splits, static_cast<float*>(out), M, N, cols, start, tail);
  return (int)cudaGetLastError();
}
