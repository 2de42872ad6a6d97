// RG-LRU linear recurrence for Hopper (sm_90a), float32 state, one pass.
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
// card's resident threads, and each thread's steps wait on memory.
//
// What the design does about it: time is split into chunks of L steps,
// and one block takes a strip of 128 channels of one chunk; each thread
// holds its channel's L steps of a and b in registers (up to HELD = 64
// steps: 128 values, three blocks an SM, ~190 KB of loads in flight an
// SM where ~25 KB cover the memory's latency).  It runs the chunk from a
// zero state, publishes its summary — the product of its a's and its
// local end state, float32 — and a flag; waits until chunks 0 … c-1 of
// its strip have published; folds their summaries in order from zero
// (the recurrence itself: no product is divided out, so a cumulative
// product that underflows over 2048 steps costs nothing); and applies its
// chunk from that carried-in state out of the registers.  So a and b are
// read once and h written once, in one launch.  The arithmetic is that
// of rglru_scan_plain, which runs it pass by pass (every summary, the
// in-order fold from zero, every apply), so results do not depend on
// timing, and L moves only where rounding falls.
//
// Three things make the one pass work:
//  * Forward progress.  Blocks are not scheduled in blockIdx order, so a
//    block takes its (chunk, strip, batch) from an atomic ticket, chunk
//    by chunk.  It waits only on earlier chunks, whose blocks hold
//    earlier tickets and so are running or done: no deadlock, whatever
//    the grid's size against the resident blocks.
//  * No reset between calls.  The flags hold the call's generation, one
//    past the epoch in the state; the last block to finish advances the
//    epoch and zeroes the ticket and its own counter.  Nothing comes from
//    the host a call and nothing syncs with it.
//  * Ordering, at the least cost on a block's critical path: the block's
//    summaries, a barrier, then one release store of its flag; a waiter
//    polls flags with acquire loads, meets its block at a barrier and
//    copies the summaries past L1 (cp.async) into shared memory, FOLD at
//    a time.  No other fence: a fence stalls the block on its critical
//    path with none of its loads in flight, and one before the finish
//    counter would hold the block until its stores of h drained.
// A chunk longer than HELD steps (the route never takes one) is read a
// second time for its apply; the last chunk computes no summary, so S <=
// L reads once at any length.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // channels a block
constexpr int HELD = 64;      // steps a thread holds in registers
constexpr int FOLD = 32;      // earlier summaries staged at once
// The state's words: the epoch, the ticket and the finished-block count,
// each on a 128-byte line of its own, then one flag a block (by ticket).
constexpr int EPOCH = 0, TICKET = 32, DONE = 64, FLAGS = 96;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One float from global to shared memory, asynchronously.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// Every copy_async of this thread landed.
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
                   "memory");
}

// Steps [off, off + HELD) of a thread's chunk (length n, element offset
// at of its first step, row stride D) into av, bv; the identity step
// (a = 1, b = 0) past the end, which leaves a product and a state exact.
template <typename T>
__device__ __forceinline__ void load_steps(float (&av)[HELD],
                                           float (&bv)[HELD], const T* a,
                                           const T* b, size_t at, int off,
                                           int n, int D) {
#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const bool in = off + u < n;
    const size_t i = at + (size_t)(off + u) * D;
    av[u] = in ? codo::to_f32(a[i]) : 1.f;
    bv[u] = in ? codo::to_f32(b[i]) : 0.f;
  }
}

// Grid: one block a (chunk, strip of THREADS channels, batch), in any
// order; summary (2, B, chunks, D) float32; state the epoch, ticket and
// counter words and a flag for each block, zeroed before the first call.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, float* summary,
                      unsigned* state, int B, int S, int D, int L) {
  __shared__ unsigned ticket_s;
  __shared__ float fold_s[2][FOLD][THREADS];   // staged prod, local
  const int tid = threadIdx.x;
  const unsigned gen = *(volatile unsigned*)(state + EPOCH) + 1u;
  if (tid == 0) ticket_s = atomicAdd(state + TICKET, 1u);
  __syncthreads();
  const unsigned ticket = ticket_s;
  const int strips = (D + THREADS - 1) / THREADS;
  const int chunks = (S + L - 1) / L;
  const unsigned per_chunk = (unsigned)strips * B;   // tickets a chunk
  const int c = (int)(ticket / per_chunk);
  const int r = (int)(ticket % per_chunk);
  const int bi = r / strips;
  const int d = (r % strips) * THREADS + tid;
  const bool live = d < D;
  const int t0 = c * L;
  const int n = min(L, S - t0);
  const bool held = n <= HELD;
  const bool last = c + 1 == chunks;
  const size_t at = ((size_t)bi * S + t0) * D + d;
  // Chunk j's flag, and its summary slots prod[bi][j][d], local[bi][j][d].
  const unsigned* flag = state + FLAGS + r;
  const size_t plane = (size_t)B * chunks * D;
  float* const prod = summary + (size_t)bi * chunks * D + d;
  float* const local = prod + plane;

  float av[HELD], bv[HELD];
  if (live && held) load_steps(av, bv, a, b, at, 0, n, D);

  // ---- the chunk from a zero state: its summary, for later chunks ----
  if (!last) {
    if (live) {
      float p = 1.f, h = 0.f;
      for (int off = 0; off < n; off += HELD) {
        if (!held) load_steps(av, bv, a, b, at, off, n, D);
#pragma unroll
        for (int u = 0; u < HELD; ++u) {
          p = __fmul_rn(p, av[u]);
          h = __fmaf_rn(av[u], h, bv[u]);
        }
      }
      prod[(size_t)c * D] = p;
      local[(size_t)c * D] = h;
    }
    __syncthreads();   // the block's summaries are written
    if (tid == 0) st_release(state + FLAGS + ticket, gen);
  }

  // ---- wait until chunks 0 … c-1 of this strip have published ----
  for (int j = tid; j < c; j += THREADS)
    while (ld_acquire(flag + (size_t)j * per_chunk) != gen) __nanosleep(32);
  __syncthreads();

  // ---- the carried-in state: their summaries folded in order from zero,
  // FOLD at a time through shared memory (each thread its own column) ----
  float h = 0.f;
  for (int j0 = 0; j0 < c; j0 += FOLD) {
    const int m = min(FOLD, c - j0);
    if (live)
      for (int j = 0; j < m; ++j) {
        copy_async(&fold_s[0][j][tid], prod + (size_t)(j0 + j) * D);
        copy_async(&fold_s[1][j][tid], local + (size_t)(j0 + j) * D);
      }
    copies_wait();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < m; ++j)
        h = __fmaf_rn(fold_s[0][j][tid], h, fold_s[1][j][tid]);
    }
  }

  // ---- the chunk from its carried-in state ----
  if (live)
    for (int off = 0; off < n; off += HELD) {
      if (!held) load_steps(av, bv, a, b, at, off, n, D);
#pragma unroll
      for (int u = 0; u < HELD; ++u) {
        h = __fmaf_rn(av[u], h, bv[u]);
        if (off + u < n)
          out[at + (size_t)(off + u) * D] = codo::from_f32<T>(h);
      }
    }

  // ---- the last block to finish readies the state for the next call.
  // Every block has taken its ticket, read the epoch and passed its wait
  // by then, and the next call starts after this one ends. ----
  if (tid == 0 && atomicAdd(state + DONE, 1u) == gridDim.x - 1) {
    state[DONE] = 0;
    state[TICKET] = 0;
    state[EPOCH] = gen;
  }
}

// Blocks of a call on (B, S, D) with chunk L, or -1 for a shape the grid
// does not take.
long long blocks_of(int B, int S, int D, int L) {
  if (B <= 0 || S <= 0 || D <= 0 || L <= 0) return -1;
  const long long blocks = (long long)B * ((D + THREADS - 1) / THREADS) *
                           ((S + L - 1) / L);
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace

// Launch rglru_scan_kernel, one block a (chunk, strip, batch): a and b
// contiguous (B, S, D) of element type dtype, out the same; summary
// float32 (2, B, ceil(S/L), D) scratch; state 96 + (number of blocks)
// unsigned words, zeroed before its first call and left to the kernel
// after it (one state a stream: two calls must not overlap on it).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// grid does not take.
extern "C" int codo_rglru_scan(int dtype, const void* a, const void* b,
                               void* out, void* summary, void* state, int B,
                               int S, int D, int L, void* stream) {
  const long long blocks = blocks_of(B, S, D, L);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sum = static_cast<float*>(summary);
  unsigned* st = static_cast<unsigned*>(state);
  if (dtype == codo::kBF16)
    rglru_scan_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), sum, st, B, S, D, L);
  else
    rglru_scan_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), sum, st, B, S, D, L);
  return (int)cudaGetLastError();
}
