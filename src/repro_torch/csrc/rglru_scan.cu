// RG-LRU linear recurrence for Hopper (sm_90a), float32 state.
//
// Replaces: repro/kernels/rglru/rglru.py: rglru_scan (the pl.pallas_call
// kernel _rglru_kernel), routed as rglru.scan.  Same contract: a, b (B, S,
// D) of one element type (float32 or bfloat16), h_t = a_t·h_{t-1} + b_t
// over axis 1 with h_{-1} = 0, the state carried in float32, h written in
// a's type.  Unlike the TPU kernel S need not be a multiple of the chunk:
// the last chunk is short.
//
// What bounds it on this card: a and b are read once and h written once,
// two flops an element, so it is bound by bytes: at the RecurrentGemma-9B
// route (2, 2048, 4096) that is 3 × 64 MiB, about 0.060 ms at 3.35 TB/s.
// The TPU kernel walks time as its sequential grid with the (B, D) state
// in VMEM.  A thread per (b, d) channel with a loop over S is the direct
// translation, but B·D = 8192 channels fill only a few percent of the
// card's 270,336 resident threads, and each thread's steps wait on memory.
//
// What the design does about it: time is split into chunks of L steps and
// scanned in two passes, so the grid is (D / 256, S / L, B) — at the route
// with L = 64, 262,144 threads.  The summary pass runs each chunk from a
// zero state and writes its product of a's and its local end state
// (float32, B·(S/L)·D each).  The apply pass gives each (channel, chunk)
// thread its carried-in state by folding the earlier chunks' summaries in
// order, then runs its chunk again from that state and writes h.  No
// product is divided out (a cumulative product that underflows over 2048
// steps costs nothing) and the fold is the recurrence itself, so the chunk
// length moves only where rounding falls.  a_t and b_t do not depend on h:
// each thread loads U steps ahead of the arithmetic.  The price is a
// second read of a and b (5 × 64 MiB moved instead of 3); the one-pass
// form with a decoupled look-back is later work.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // time steps loaded ahead

// Channel d of batch b, chunk c = blockIdx.y: steps [c·L, min(S, c·L + L)).
struct Chunk {
  int d, b, c, t0, t1;
  size_t at;  // element offset of (b, t0, d)
};

__device__ __forceinline__ bool chunk_of(Chunk& k, int S, int D, int L) {
  k.d = blockIdx.x * THREADS + threadIdx.x;
  k.c = blockIdx.y;
  k.b = blockIdx.z;
  k.t0 = k.c * L;
  k.t1 = min(S, k.t0 + L);
  k.at = ((size_t)k.b * S + k.t0) * D + k.d;
  return k.d < D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_summary_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         float* __restrict__ prod, float* __restrict__ local,
                         int S, int D, int L) {
  Chunk k;
  if (!chunk_of(k, S, D, L)) return;
  float p = 1.f, h = 0.f;
  for (int t = k.t0; t < k.t1; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t + u < k.t1;
      const size_t at = k.at + (size_t)(t + u - k.t0) * D;
      av[u] = in ? codo::to_f32(a[at]) : 1.f;
      bv[u] = in ? codo::to_f32(b[at]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p *= av[u];
      h = av[u] * h + bv[u];
    }
  }
  const size_t s = ((size_t)k.b * gridDim.y + k.c) * D + k.d;
  prod[s] = p;
  local[s] = h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_apply_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const float* __restrict__ prod,
                       const float* __restrict__ local, T* __restrict__ out,
                       int S, int D, int L) {
  Chunk k;
  if (!chunk_of(k, S, D, L)) return;
  // The carried-in state: the earlier chunks' summaries folded in order.
  float h = 0.f;
  const size_t s0 = (size_t)k.b * gridDim.y * D + k.d;
  for (int c = 0; c < k.c; ++c)
    h = prod[s0 + (size_t)c * D] * h + local[s0 + (size_t)c * D];
  for (int t = k.t0; t < k.t1; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t + u < k.t1;
      const size_t at = k.at + (size_t)(t + u - k.t0) * D;
      av[u] = in ? codo::to_f32(a[at]) : 1.f;
      bv[u] = in ? codo::to_f32(b[at]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = av[u] * h + bv[u];
      if (t + u < k.t1)
        out[k.at + (size_t)(t + u - k.t0) * D] = codo::from_f32<T>(h);
    }
  }
}

bool bad_shape(int B, int S, int D, int L) {
  return B <= 0 || S <= 0 || D <= 0 || L <= 0 || B > 65535 ||
         (S + L - 1) / L > 65535;
}

dim3 grid_of(int B, int S, int D, int L) {
  return dim3((D + THREADS - 1) / THREADS, (S + L - 1) / L, B);
}

}  // namespace

// Launch rglru_summary_kernel over (ceil(D/256), ceil(S/L), B) blocks: a
// and b contiguous (B, S, D) of element type dtype; prod and local float32
// (B, ceil(S/L), D).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the grid does not take.
extern "C" int codo_rglru_chunk_summary(int dtype, const void* a,
                                        const void* b, void* prod,
                                        void* local, int B, int S, int D,
                                        int L, void* stream) {
  if (bad_shape(B, S, D, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(prod);
  float* l = static_cast<float*>(local);
  if (dtype == codo::kBF16)
    rglru_summary_kernel<__nv_bfloat16><<<grid_of(B, S, D, L), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), p, l, S, D, L);
  else
    rglru_summary_kernel<float><<<grid_of(B, S, D, L), THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), p, l, S,
        D, L);
  return (int)cudaGetLastError();
}

// Launch rglru_apply_kernel over the same grid: out (B, S, D) in dtype,
// from the summaries codo_rglru_chunk_summary wrote (not read when S <= L).
extern "C" int codo_rglru_chunk_apply(int dtype, const void* a, const void* b,
                                      const void* prod, const void* local,
                                      void* out, int B, int S, int D, int L,
                                      void* stream) {
  if (bad_shape(B, S, D, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(prod);
  const float* l = static_cast<const float*>(local);
  if (dtype == codo::kBF16)
    rglru_apply_kernel<__nv_bfloat16><<<grid_of(B, S, D, L), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), p, l,
        static_cast<__nv_bfloat16*>(out), S, D, L);
  else
    rglru_apply_kernel<float><<<grid_of(B, S, D, L), THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), p, l,
        static_cast<float*>(out), S, D, L);
  return (int)cudaGetLastError();
}
