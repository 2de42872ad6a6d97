// The tensor-core GEMM tile shared by the port's float32-accurate matrix
// products (chain_grad.cu; matmul.cu can take it with this one include):
// a 128 × 128 output tile a block of 8 warps, each warp a 64 × 32 slice on
// mma.sync m16n8k8 TF32 with the 3×TF32 split (mma_tf32.cuh; bfloat16
// operands, exact in TF32, take one pass), the contraction in 32-deep
// stages through a three-stage cp.async ring.
//
// Operands are read through their strides.  a's tile is kept row by row
// (m, then k).  w's tile is kept column by column (n, then k) when w is
// not N-contiguous — the routed backward chains hand w over as a
// transposed view, K-contiguous, so its tile is copied in 16-byte vectors
// along k, as flash copies a kᵀ tile — and row by row (k, then n) when it
// is.  Every row of a tile is padded so that rows start 16-byte aligned
// for cp.async and fragment reads hit 32 distinct banks.  A view that
// keeps neither row 16-byte aligned (an aT view, odd strides) takes
// load_tile's element path.
//
// The tensor cores add each product into the float32 accumulator with
// their own rounding, which is not round-to-nearest: over K = 1024 that
// is most of the 3×TF32 error (chip_smoke.py's precision phase; PERF.md
// §6).  Promoting each 8-deep step into the accumulator by
// round-to-nearest adds took it under cuBLAS float32's error but cost
// 9–12 % of the device time at gpt2_block's backward chains (PERF.md §6,
// NVIDIA H100 80GB HBM3 at 700 W), so the tile lets the tensor cores
// accumulate.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace codo_gemm_mma {

using namespace codo_mma;

constexpr int BM = 128;       // output rows a block
constexpr int BN = 128;       // output columns a block
constexpr int BK = 32;        // contraction depth a stage
constexpr int STAGES = 3;     // cp.async ring
constexpr int THREADS = 256;  // 8 warps: 2 (m) × 4 (n)
constexpr int WM = 64, WN = 32;        // a warp's slice
constexpr int WARPS_N = BN / WN;
constexpr int MT = WM / 16;   // m16 fragments a warp
constexpr int NT = WN / 8;    // n8 fragments a warp
constexpr int C_LD = BN + 8;  // floats a row of the staged output tile

// Row strides (elements) of the three tile layouts: a by m and w by n
// (BK + 16 bytes), w by k (BN + 32 bytes).
template <typename T>
__host__ __device__ constexpr int k_ld() {
  return BK + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int n_ld() {
  return BN + 32 / (int)sizeof(T);
}

template <typename T, bool W_BY_N>
__host__ __device__ constexpr int stage_elems() {
  return BM * k_ld<T>() + (W_BY_N ? BN * k_ld<T>() : BK * n_ld<T>());
}

// Dynamic shared memory of a block: the ring, reused after the product
// for the float32 output tile (stash_tile).
template <typename T, bool W_BY_N>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * STAGES * stage_elems<T, W_BY_N>() >
                 sizeof(float) * BM * C_LD
             ? sizeof(T) * STAGES * stage_elems<T, W_BY_N>()
             : sizeof(float) * BM * C_LD;
}

// Four 8 × 8 matrices of 16-bit elements from shared memory, lane L
// giving the address of row L % 8 of matrix L / 8: on float32 data, lane
// 4g + t receives element (g, t) of each 8 × 4-float matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc += the block's 128 × 128 tile of a[m0.., kb..ke) @ w[kb..ke), n0..],
// a (M, ·) with element strides (sam, sak), w (·, N) with (swk, swn).
// Warp w holds rows (w / 4)·64 + 16i + {g, g + 8}, columns (w % 4)·32 +
// 8j + {2t, 2t + 1} in acc[i][j] (lane = 4g + t).  Ends with every copy
// landed and a barrier: smem may be reused at once.
template <typename T, bool W_BY_N>
__device__ __forceinline__ void tile_product(
    float (&acc)[MT][NT][4], const T* __restrict__ a, long long sam,
    long long sak, const T* __restrict__ w, long long swk, long long swn,
    int M, int N, int kb, int ke, int m0, int n0, T* smem) {
  constexpr int P = Passes<T>::value;
  constexpr int ALD = k_ld<T>();
  constexpr int WLD = W_BY_N ? k_ld<T>() : n_ld<T>();
  constexpr int SE = stage_elems<T, W_BY_N>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const T* a0 = a + (long long)m0 * sam + (long long)kb * sak;
  const T* w0 = w + (long long)kb * swk + (long long)n0 * swn;
  const bool a_vec = vec_ok(a0, sam, sak, ke - kb);
  const bool w_vec = W_BY_N ? vec_ok(w0, swn, swk, ke - kb)
                            : vec_ok(w0, swk, swn, N - n0);
  const int stages = (ke - kb + BK - 1) / BK;
  // ldmatrix (float32 tiles): lane L addresses row L % 8 of 8 × 4-float
  // matrix L / 8, which for a is rows +8 (matrix 1, 3) and k + 4 (2, 3) of
  // an m16 × k8 fragment, for w by n k + 4 (1, 3) and the next n8 (2, 3).
  constexpr bool LDSM = sizeof(T) == 4;
  const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * ALD +
                     (lane >> 4) * 4;
  const int b_lane = ((lane & 7) + (lane >> 4) * 8) * WLD +
                     ((lane >> 3) & 1) * 4;

  auto load = [&](int s) {
    const int k = s * BK;
    T* as = smem + (s % STAGES) * SE;
    T* ws = as + BM * ALD;
    load_tile<T, THREADS>(as, ALD, a0 + (long long)k * sak, sam, sak, BM, BK,
                          M - m0, ke - kb - k, a_vec, tid);
    if constexpr (W_BY_N)
      load_tile<T, THREADS>(ws, WLD, w0 + (long long)k * swk, swn, swk, BN,
                            BK, N - n0, ke - kb - k, w_vec, tid);
    else
      load_tile<T, THREADS>(ws, WLD, w0 + (long long)k * swk, swk, swn, BK,
                            BN, ke - kb - k, N - n0, w_vec, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s landed; stage s - 1's buffer is free
    if (s + STAGES - 1 < stages) load(s + STAGES - 1);
    cp_async_commit();
    const T* as = smem + (s % STAGES) * SE;
    const T* ws = as + BM * ALD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragB<P> fb[NT];
      if constexpr (LDSM && W_BY_N) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, ws + (wn * WN + j * 8) * WLD + kk + b_lane);
          fb[j].set(__uint_as_float(r[0]), __uint_as_float(r[1]));
          fb[j + 1].set(__uint_as_float(r[2]), __uint_as_float(r[3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (W_BY_N) {
            const T* p = ws + (wn * WN + j * 8 + g) * WLD + kk + t;
            fb[j].set(codo::to_f32(p[0]), codo::to_f32(p[4]));
          } else {
            const T* p = ws + (kk + t) * WLD + wn * WN + j * 8 + g;
            fb[j].set(codo::to_f32(p[0]), codo::to_f32(p[4 * WLD]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        FragA<P> fa;
        if constexpr (LDSM) {
          uint32_t r[4];
          ldsm_x4(r, as + (wm * WM + i * 16) * ALD + kk + a_lane);
          fa.set(__uint_as_float(r[0]), __uint_as_float(r[1]),
                 __uint_as_float(r[2]), __uint_as_float(r[3]));
        } else {
          const T* r = as + (wm * WM + i * 16 + g) * ALD + kk + t;
          fa.set(codo::to_f32(r[0]), codo::to_f32(r[8 * ALD]),
                 codo::to_f32(r[4]), codo::to_f32(r[8 * ALD + 4]));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_f32<P>(acc[i][j], fa, fb[j]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The accumulator into a float32 (BM × C_LD) tile in shared memory, so
// that an epilogue walks the output row by row with consecutive threads
// on consecutive columns (coalesced stores, coalesced reads of an
// operand of the output's shape).  Ends with a barrier.
__device__ __forceinline__ void stash_tile(const float (&acc)[MT][NT][4],
                                           float* c_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * WM + i * 16 + g + 8 * h;
        const int c = wn * WN + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(c_s + r * C_LD + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
}

}  // namespace codo_gemm_mma
