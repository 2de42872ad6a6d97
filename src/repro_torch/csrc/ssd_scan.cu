// Mamba-2 SSD inter-chunk state scan and its backward for Hopper
// (sm_90a), float32 state.
//
// Replaces: repro/kernels/ssd/ssd.py: ssd_chunk_scan (the pl.pallas_call
// kernel _ssd_kernel), routed as ssd.scan.  Same contract: states (nc, BH,
// P, N) and decay (nc, BH, 1, 1) of one element type (float32 or
// bfloat16); out[c] is the state carried into chunk c, h_0 = 0 and
// h_{c+1} = h_c·decay_c + state_c, carried in float32 and written in the
// states' type before chunk c folds in.  The TPU function has no backward
// kernel (JAX differentiates its reference); the backward here is the one
// autograd runs for it: for the cotangent g of the emitted h, μ_nc = 0,
// dstates_c = μ_{c+1}, μ_c = g_c + dec_c·μ_{c+1}, and ddecay_c =
// Σ_{P,N} μ_{c+1}·h_c with μ rounded to the states' type before the
// product.
//
// What bounds it on this card: each operand element is read once and
// each result element written once, with two flops an element forward
// and four backward, so both are bound by bytes: at the Mamba-2 780M
// trainer's (8, 96, 64, 128) the forward moves 2 × 25 MB, about 0.015 ms
// at 3.35 TB/s, the backward 3 × 25 MB, 0.0225 ms.  The TPU kernel walks
// the chunks as its sequential grid with the whole (BH, P, N) state in
// VMEM; here nothing carries from one block to the next, so the chunk loop
// moves inside the thread, and the backward's sum over (P, N) spans
// blocks.
//
// What the design does about it:
//  * A thread owns VEC = 4 consecutive (p, n) elements of one bh and walks
//    the chunks with their four float32 states in registers: one 16-byte
//    load and store a chunk (8 bytes in bfloat16), consecutive threads on
//    consecutive addresses.  A shape whose P·N or pointers do not allow the
//    vector form takes four element loads, masked at the ragged edge.
//  * The forward's grid is (ceil(P·N / 1024), BH) blocks of 256 threads:
//    at BH = 96 that is 768 blocks, one wave at six blocks an SM (the
//    launch bounds hold a thread to 40 registers).  U_FWD chunks' loads
//    stay in flight ahead of the arithmetic: each chunk's slot is refilled
//    with the chunk U_FWD further on as soon as it is folded in, so a
//    thread never waits with its loads drained.  ~100 KB in flight an SM,
//    where ~25 KB cover the memory's latency at its full rate.
//  * A block's nc decays (strided by BH in memory) are staged in shared
//    memory by one load instruction per thread, issued after the first
//    chunks' loads, so the barrier that follows waits for nothing those
//    loads do not wait for anyway.
//  * The backward walks the chunks from nc − 1 down to 0 by index, so
//    nothing is flipped or copied: g and h are read once, dstates written
//    once, and μ never leaves registers.  Its per-chunk sum Σ μ·h is
//    reduced without float atomics, in a fixed order, so two runs are bit
//    for bit the same: a thread's four products in order, a warp by
//    shuffles, the block's eight warps in order in shared memory, then the
//    bh's blocks — one thread-block cluster of K = 1, 2, 4 or 8 blocks,
//    K·1024 ≥ P·N where it fits, 8 otherwise, each block then walking
//    every K-th group of 1024 elements — summed by the cluster's first
//    block over distributed shared memory in rank order.  One launch a
//    call at any P·N; at the LM's P·N = 8192 K = 8 blocks take a group
//    each.
// The look-ahead and the launch bounds were chosen on the card, at the LM
// shapes, among (U_FWD, BLOCKS_FWD, U_BWD, BLOCKS_BWD) = (4, 6, 4, 4),
// (2, 8, 2, 6), (8, 4, 8, 2) and (4, 6, 2, 6): the first was fastest or
// tied in every case (the backward at two chunks ahead spills 16-40 bytes,
// at eight holds 96 registers and two blocks an SM).  TMA bulk copies were
// not taken: the loads are 16 bytes a thread with ample bytes in flight,
// so it is the bytes, not the instructions that issue them, that bound the
// scan.

#include <cooperative_groups.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                   // consecutive elements a thread
constexpr int GROUP = THREADS * VEC;     // elements a block walks at once
constexpr int U_FWD = 4;                 // chunks in flight ahead
constexpr int U_BWD = 4;
constexpr int BLOCKS_FWD = 6;            // resident blocks an SM
constexpr int BLOCKS_BWD = 4;
constexpr int MAX_CLUSTER = 8;           // blocks summing one bh's ddecay

// Elements [0, VEC) of p into x as float32: one vector load (V), or one
// load an element, those at or past `valid` read as 0.
template <bool V>
__device__ __forceinline__ void load4(const float* p, int valid,
                                      float (&x)[VEC]) {
  if constexpr (V) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = k < valid ? __ldg(p + k) : 0.f;
  }
}

template <bool V>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int valid,
                                      float (&x)[VEC]) {
  if constexpr (V) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      x[k] = k < valid ? __bfloat162float(p[k]) : 0.f;
  }
}

// x rounded to T into elements [0, VEC) of p (those below `valid` alone
// when not V).
template <bool V>
__device__ __forceinline__ void store4(float* p, int valid,
                                       const float (&x)[VEC]) {
  if constexpr (V) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < valid) p[k] = x[k];
  }
}

template <bool V>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int valid,
                                       const float (&x)[VEC]) {
  if constexpr (V) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 v;
    v.x = *reinterpret_cast<const unsigned*>(&lo);
    v.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < valid) p[k] = __float2bfloat16(x[k]);
  }
}

// Grid (ceil(PN / GROUP), BH): thread t of block (x, bh) owns elements
// [(x·THREADS + t)·VEC, +VEC) of row bh in every chunk.
template <typename T, bool V>
__global__ void __launch_bounds__(THREADS, BLOCKS_FWD)
    ssd_scan_kernel(const T* __restrict__ states, const T* __restrict__ decay,
                    T* __restrict__ out, int nc, int BH, int PN) {
  extern __shared__ float dec_s[];  // [nc]: this bh's decays
  const int bh = blockIdx.y;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  const int valid = min(VEC, PN - e);
  const size_t stride = (size_t)BH * PN;  // one chunk
  const T* src = states + (size_t)bh * PN + e;
  T* dst = out + (size_t)bh * PN + e;
  float st[U_FWD][VEC];
  if (valid > 0) {
#pragma unroll
    for (int u = 0; u < U_FWD; ++u)
      if (u < nc) load4<V>(src + u * stride, valid, st[u]);
  }
  for (int c = threadIdx.x; c < nc; c += THREADS)
    dec_s[c] = codo::to_f32(decay[(size_t)c * BH + bh]);
  __syncthreads();
  if (valid <= 0) return;
  float h[VEC] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += U_FWD) {
#pragma unroll
    for (int u = 0; u < U_FWD; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        store4<V>(dst + c * stride, valid, h);
        const float d = dec_s[c];
#pragma unroll
        for (int k = 0; k < VEC; ++k) h[k] = h[k] * d + st[u][k];
        if (c + U_FWD < nc)
          load4<V>(src + (c + U_FWD) * stride, valid, st[u]);
      }
    }
  }
}

// Grid (K, BH) in clusters of K along x: block `rank` of bh's cluster walks
// the element groups rank, rank + K, ... of row bh, the chunks in reverse.
// Dynamic shared memory: the decays [nc], each warp's part of Σ μ·h
// [nc][WARPS] and the block's [nc].
template <typename T, bool V>
__global__ void __launch_bounds__(THREADS, BLOCKS_BWD)
    ssd_scan_backward_kernel(const T* __restrict__ g,
                             const T* __restrict__ decay,
                             const T* __restrict__ h, T* __restrict__ dstates,
                             T* __restrict__ ddecay, int nc, int BH, int PN) {
  extern __shared__ float smem[];
  float* dec_s = smem;
  float* red_s = smem + nc;
  float* sum_s = red_s + (size_t)nc * WARPS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int K = (int)cluster.num_blocks();
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = (size_t)BH * PN;  // one chunk
  for (int c = threadIdx.x; c < nc; c += THREADS)
    dec_s[c] = codo::to_f32(decay[(size_t)c * BH + bh]);
  for (int i = threadIdx.x; i < nc * WARPS; i += THREADS) red_s[i] = 0.f;
  __syncthreads();
  for (int e0 = rank * GROUP; e0 < PN; e0 += K * GROUP) {
    const int e = e0 + threadIdx.x * VEC;
    const int valid = min(VEC, PN - e);  // <= 0: zeros, in the sums only
    const size_t row = (size_t)bh * PN + e;
    float gr[U_BWD][VEC], hr[U_BWD][VEC];
#pragma unroll
    for (int u = 0; u < U_BWD; ++u) {
      const int c = nc - 1 - u;
      if (c >= 0) {
        if (valid > 0) {
          load4<V>(g + row + c * stride, valid, gr[u]);
          load4<V>(h + row + c * stride, valid, hr[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) gr[u][k] = hr[u][k] = 0.f;
        }
      }
    }
    float mu[VEC] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = nc - 1; c0 >= 0; c0 -= U_BWD) {
#pragma unroll
      for (int u = 0; u < U_BWD; ++u) {
        const int c = c0 - u;
        if (c >= 0) {
          float m[VEC];
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            m[k] = codo::to_f32(codo::from_f32<T>(mu[k]));
            part += m[k] * hr[u][k];
          }
          if (valid > 0) store4<V>(dstates + row + c * stride, valid, m);
          const float d = dec_s[c];
#pragma unroll
          for (int k = 0; k < VEC; ++k) mu[k] = mu[k] * d + gr[u][k];
          if (c - U_BWD >= 0 && valid > 0) {
            load4<V>(g + row + (c - U_BWD) * stride, valid, gr[u]);
            load4<V>(h + row + (c - U_BWD) * stride, valid, hr[u]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part += __shfl_down_sync(0xffffffffu, part, o);
          if (lane == 0) red_s[c * WARPS + warp] += part;
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red_s[c * WARPS + w];
    sum_s[c] = s;
  }
  cluster.sync();  // every block's sums are in place
  if (rank == 0) {
    for (int c = threadIdx.x; c < nc; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < K; ++r) s += cluster.map_shared_rank(sum_s, r)[c];
      ddecay[(size_t)c * BH + bh] = codo::from_f32<T>(s);
    }
  }
  cluster.sync();  // no block leaves while the first still reads its sums
}

// The vector form takes P·N a multiple of VEC and every pointer on a
// VEC-element boundary.
template <typename T>
bool vector_form(int PN, std::initializer_list<const void*> ptrs) {
  if (PN % VEC) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % (VEC * sizeof(T))) return false;
  return true;
}

template <typename T, bool V>
int launch(const void* states, const void* decay, void* out, int nc, int BH,
           int PN, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)nc;
  if (smem > 48 * 1024) {
    const cudaError_t err = codo::set_smem<ssd_scan_kernel<T, V>>(smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((PN + GROUP - 1) / GROUP, BH);
  ssd_scan_kernel<T, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(states), static_cast<const T*>(decay),
      static_cast<T*>(out), nc, BH, PN);
  return (int)cudaGetLastError();
}

template <typename T, bool V>
int launch_backward(const void* g, const void* decay, const void* h,
                    void* dstates, void* ddecay, int nc, int BH, int PN,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)nc * (WARPS + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        codo::set_smem<ssd_scan_backward_kernel<T, V>>(smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (PN + GROUP - 1) / GROUP;
  int K = 1;
  while (K < groups && K < MAX_CLUSTER) K *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, BH, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ssd_scan_backward_kernel<T, V>, static_cast<const T*>(g),
      static_cast<const T*>(decay), static_cast<const T*>(h),
      static_cast<T*>(dstates), static_cast<T*>(ddecay), nc, BH, PN);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int nc, int BH, int PN) {
  return nc <= 0 || BH <= 0 || PN <= 0 || BH > 65535;
}

}  // namespace

// Launch ssd_scan_kernel over (ceil(P·N / 1024), BH) blocks.  states and
// out are contiguous (nc, BH, P·N), decay contiguous (nc, BH); dtype is the
// element type of all three.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty or oversized shape.
extern "C" int codo_ssd_chunk_scan(int dtype, const void* states,
                                   const void* decay, void* out, int nc,
                                   int BH, int PN, void* stream) {
  if (bad_shape(nc, BH, PN)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16) {
    using T = __nv_bfloat16;
    return vector_form<T>(PN, {states, out})
               ? launch<T, true>(states, decay, out, nc, BH, PN, s)
               : launch<T, false>(states, decay, out, nc, BH, PN, s);
  }
  return vector_form<float>(PN, {states, out})
             ? launch<float, true>(states, decay, out, nc, BH, PN, s)
             : launch<float, false>(states, decay, out, nc, BH, PN, s);
}

// Launch ssd_scan_backward_kernel: one launch, clusters of K blocks a bh.
// g, h and dstates are contiguous (nc, BH, P·N), decay and ddecay
// contiguous (nc, BH), all of element type dtype.  Returns as
// codo_ssd_chunk_scan.
extern "C" int codo_ssd_chunk_scan_backward(int dtype, const void* g,
                                            const void* decay, const void* h,
                                            void* dstates, void* ddecay,
                                            int nc, int BH, int PN,
                                            void* stream) {
  if (bad_shape(nc, BH, PN)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16) {
    using T = __nv_bfloat16;
    return vector_form<T>(PN, {g, h, dstates})
               ? launch_backward<T, true>(g, decay, h, dstates, ddecay, nc,
                                          BH, PN, s)
               : launch_backward<T, false>(g, decay, h, dstates, ddecay, nc,
                                           BH, PN, s);
  }
  return vector_form<float>(PN, {g, h, dstates})
             ? launch_backward<float, true>(g, decay, h, dstates, ddecay, nc,
                                            BH, PN, s)
             : launch_backward<float, false>(g, decay, h, dstates, ddecay,
                                             nc, BH, PN, s);
}
