// The register-tiled SIMT GEMM tile shared by the port's matmul kernels
// (chain_grad.cu, matmul.cu): a 64 × 128 output tile a block of 128
// threads, each thread keeping an 8 × 8 slice of the float32 accumulator
// in registers, the contraction in 8-deep stages through two padded
// k-major shared-memory buffers.  Each operand is read through its
// strides; which threads fetch which elements follows its unit-stride
// dimension (K_FAST, N_FAST), so a transposed operand is read coalesced.
#pragma once

#include "common.cuh"

namespace codo_gemm {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BKK = 8;        // contraction depth per shared-memory stage
constexpr int THREADS = 128;  // 8 × 16 threads, 8 × 8 outputs each
constexpr int LDA = BM + 4;   // padded rows of the k-major tiles: the
constexpr int LDB = BN + 4;   // column-wise stores hit distinct banks
constexpr int A_PER = BKK * BM / THREADS;  // a elements a thread moves
constexpr int B_PER = BKK * BN / THREADS;  // w elements a thread moves

// Element i of the (BM × BKK) a tile: eight threads along k when k is a's
// unit-stride dimension, else consecutive threads along m.
template <bool K_FAST>
__device__ __forceinline__ void a_coords(int i, int& m, int& k) {
  if (K_FAST) {
    m = i / BKK;
    k = i % BKK;
  } else {
    m = i % BM;
    k = i / BM;
  }
}

// Element i of the (BKK × BN) w tile: consecutive threads along n when n is
// w's unit-stride dimension, else eight threads along k (a transposed w).
template <bool N_FAST>
__device__ __forceinline__ void w_coords(int i, int& k, int& n) {
  if (N_FAST) {
    k = i / BN;
    n = i % BN;
  } else {
    k = i % BKK;
    n = i / BKK;
  }
}

template <typename T, bool K_FAST>
__device__ __forceinline__ void fetch_a(float (&r)[A_PER], const T* a,
                                        long long sm, long long sk, int M,
                                        int kend, int m0, int k0, int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    int m, k;
    a_coords<K_FAST>(tid + u * THREADS, m, k);
    const int gm = m0 + m, gk = k0 + k;
    r[u] = (gm < M && gk < kend) ? codo::to_f32(a[gm * sm + gk * sk]) : 0.f;
  }
}

template <bool K_FAST>
__device__ __forceinline__ void stash_a(float* a_s, const float (&r)[A_PER],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    int m, k;
    a_coords<K_FAST>(tid + u * THREADS, m, k);
    a_s[k * LDA + m] = r[u];  // k-major
  }
}

template <typename T, bool N_FAST>
__device__ __forceinline__ void fetch_w(float (&r)[B_PER], const T* w,
                                        long long sk, long long sn, int kend,
                                        int N, int k0, int n0, int tid) {
#pragma unroll
  for (int u = 0; u < B_PER; ++u) {
    int k, n;
    w_coords<N_FAST>(tid + u * THREADS, k, n);
    const int gk = k0 + k, gn = n0 + n;
    r[u] = (gk < kend && gn < N) ? codo::to_f32(w[gk * sk + gn * sn]) : 0.f;
  }
}

template <bool N_FAST>
__device__ __forceinline__ void stash_w(float* b_s, const float (&r)[B_PER],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < B_PER; ++u) {
    int k, n;
    w_coords<N_FAST>(tid + u * THREADS, k, n);
    b_s[k * LDB + n] = r[u];
  }
}

// One stage of the register-tiled product: acc[8][8] += As · Bs over BKK.
// A thread owns rows tr·4+i and BM/2+tr·4+i and columns tc·4+j and
// BN/2+tc·4+j (i, j < 4): two float4 reads of each operand a step,
// broadcast for As, conflict-free for Bs.
__device__ __forceinline__ void mma_stage(float (&acc)[8][8], const float* As,
                                          const float* Bs, int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < BKK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDA + tr * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * LDA + BM / 2 + tr * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDB + tc * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * LDB + BN / 2 + tc * 4);
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


// acc[8][8] += a[m0.., kb:ke] · w[kb:ke, n0..] for the block's 64 × 128
// tile (rows tile_index(tr, i, BM/2), columns tile_index(tc, j, BN/2) of
// thread (tr, tc) = (threadIdx.x / 16, threadIdx.x % 16)): the next stage's
// elements are fetched into registers while the current one computes.
// Every thread of the block calls it (it synchronises the block).
template <typename T, bool K_FAST, bool N_FAST>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const T* a,
                                             long long sam, long long sak,
                                             const T* w, long long swk,
                                             long long swn, int M, int N,
                                             int kb, int ke, int m0, int n0) {
  __shared__ __align__(16) float a_s[2][BKK * LDA];
  __shared__ __align__(16) float b_s[2][BKK * LDB];
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  float ra[A_PER], rb[B_PER];
  fetch_a<T, K_FAST>(ra, a, sam, sak, M, ke, m0, kb, tid);
  fetch_w<T, N_FAST>(rb, w, swk, swn, ke, N, kb, n0, tid);
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += BKK) {
    stash_a<K_FAST>(a_s[buf], ra, tid);
    stash_w<N_FAST>(b_s[buf], rb, tid);
    __syncthreads();
    if (k0 + BKK < ke) {
      fetch_a<T, K_FAST>(ra, a, sam, sak, M, ke, m0, k0 + BKK, tid);
      fetch_w<T, N_FAST>(rb, w, swk, swn, ke, N, k0 + BKK, n0, tid);
    }
    mma_stage(acc, a_s[buf], b_s[buf], tr, tc);
    buf ^= 1;
  }
}

}  // namespace codo_gemm
