// Mamba-2 SSD inter-chunk state scan for Hopper (sm_90a), float32 state.
//
// Replaces: repro/kernels/ssd/ssd.py: ssd_chunk_scan (the pl.pallas_call
// kernel _ssd_kernel), routed as ssd.scan.  Same contract: states (nc, BH,
// P, N) and decay (nc, BH, 1, 1) of one element type (float32 or
// bfloat16); out[c] is the state carried into chunk c, h_0 = 0 and
// h_{c+1} = h_c·decay_c + state_c, carried in float32 and written in the
// states' type before chunk c folds in.
//
// What bounds it on this card: every element of states is read once and
// every element of out written once, with two flops between them, so it
// is bound by bytes: at the Mamba-2 780M route (16, 96, 64, 128) that is
// 2 × 48 MiB, about 0.030 ms at 3.35 TB/s.  The TPU kernel walks the
// chunks as its sequential grid with the whole (BH, P, N) state in VMEM;
// here nothing carries from one block to the next.
//
// What the design does about it: the chunk loop moves inside the thread.
// One thread owns one (bh, p, n) element and walks the nc chunks in order,
// so the grid is (P·N / 256, BH) — 786,432 threads at the route, enough to
// fill the card — and consecutive threads read consecutive elements of
// each chunk (coalesced).  A block belongs to one bh: its nc decays are
// read once into shared memory.  The next U chunks' states do not depend
// on h, so each thread loads them ahead of the arithmetic, U loads in
// flight.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // chunks loaded ahead

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ states, const T* __restrict__ decay,
                    T* __restrict__ out, int nc, int BH, int PN) {
  extern __shared__ float dec_s[];  // [nc]: this bh's decays
  const int bh = blockIdx.y;
  for (int c = threadIdx.x; c < nc; c += THREADS)
    dec_s[c] = codo::to_f32(decay[(size_t)c * BH + bh]);
  __syncthreads();
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= PN) return;
  const size_t stride = (size_t)BH * PN;  // one chunk
  const size_t base = (size_t)bh * PN + e;
  float h = 0.f;
  for (int c0 = 0; c0 < nc; c0 += U) {
    float st[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      st[u] = c0 + u < nc ? codo::to_f32(states[base + (c0 + u) * stride])
                          : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        out[base + c * stride] = codo::from_f32<T>(h);
        h = h * dec_s[c] + st[u];
      }
    }
  }
}

template <typename T>
int launch(const void* states, const void* decay, void* out, int nc, int BH,
           int PN, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)nc;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((PN + THREADS - 1) / THREADS, BH);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(states), static_cast<const T*>(decay),
      static_cast<T*>(out), nc, BH, PN);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch ssd_scan_kernel over (ceil(P·N / 256), BH) blocks.  states and out
// are contiguous (nc, BH, P·N), decay contiguous (nc, BH); dtype is the
// element type of all three.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty or oversized shape.
extern "C" int codo_ssd_chunk_scan(int dtype, const void* states,
                                   const void* decay, void* out, int nc,
                                   int BH, int PN, void* stream) {
  if (nc <= 0 || BH <= 0 || PN <= 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch<__nv_bfloat16>(states, decay, out, nc, BH, PN, s);
  return launch<float>(states, decay, out, nc, BH, PN, s);
}
