// The tensor-core GEMM tile shared by the port's float32-accurate matrix
// products: chain_grad.cu and matmul.cu run its 128 × 128 tile
// (tile_product), pad_conv_relu.cu runs the same ring and product step on
// that tile and on a 64 × 128 one, gathering its second operand itself
// (ring_product with its own loader).  Warps run mma.sync m16n8k8 TF32 with the 3×TF32
// split (mma_tf32.cuh; bfloat16 operands, exact in TF32, take one pass),
// the contraction in 32-deep stages through a cp.async ring.
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
// NVIDIA H100 80GB HBM3 at 700 W), so tile_product lets the tensor cores
// accumulate.  ring_product can promote once a 32-deep stage instead (a
// fresh accumulator a stage, added into the kept one by round-to-nearest
// adds): the conv's 64 × 128 tile, whose warps of 32 × 32 hold both
// accumulators, takes that form.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace codo_gemm_mma {

using namespace codo_mma;

constexpr int BK = 32;        // contraction depth a stage

// A block's tile: BM_ × BN_ outputs, warps of WM_ × WN_ (m16 × n8
// fragments), a STAGES_-deep cp.async ring.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct TileShape {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16;   // m16 fragments a warp
  static constexpr int NT = WN / 8;    // n8 fragments a warp
  static constexpr int C_LD = BN + 8;  // floats a row of the staged output
};

// The GEMM tile: 128 × 128 outputs a block of 8 warps, 2 (m) × 4 (n) of
// 64 × 32, three stages.
using Gemm = TileShape<128, 128, 64, 32, 3>;
constexpr int BM = Gemm::BM, BN = Gemm::BN, STAGES = Gemm::STAGES;
constexpr int THREADS = Gemm::THREADS, MT = Gemm::MT, NT = Gemm::NT;
constexpr int C_LD = Gemm::C_LD;

// Row strides (elements) of the three tile layouts: a by m and w by n
// (BK + 16 bytes), w by k (BN + 32 bytes).
template <typename T>
__host__ __device__ constexpr int k_ld() {
  return BK + 16 / (int)sizeof(T);
}
template <typename T, int N_COLS = BN>
__host__ __device__ constexpr int n_ld() {
  return N_COLS + 32 / (int)sizeof(T);
}

template <typename T, bool W_BY_N, typename S = Gemm>
__host__ __device__ constexpr int stage_elems() {
  return S::BM * k_ld<T>() +
         (W_BY_N ? S::BN * k_ld<T>() : BK * n_ld<T, S::BN>());
}

// Dynamic shared memory of a block: the ring, reused after the product
// for the float32 output tile (stash_tile).
template <typename T, bool W_BY_N, typename S = Gemm>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * S::STAGES * stage_elems<T, W_BY_N, S>() >
                 sizeof(float) * S::BM * S::C_LD
             ? sizeof(T) * S::STAGES * stage_elems<T, W_BY_N, S>()
             : sizeof(float) * S::BM * S::C_LD;
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

// acc += the product of `stages` BK-deep stages of the block's tile:
// load(s, as, ws) issues the cp.async copies (or plain stores) of stage s
// into its a tile `as` (BM × BK, kept by m) and w tile `ws` (kept by n
// when W_BY_N, else by k), zero past the operands' ends; it is called for
// s = 0, 1, 2, ... in order.  Warp w holds rows (w / WARPS_N)·WM + 16i +
// {g, g + 8}, columns (w % WARPS_N)·WN + 8j + {2t, 2t + 1} in acc[i][j]
// (lane = 4g + t).  PROMOTE: each stage's products go into a fresh
// accumulator, added into acc by round-to-nearest adds.  Ends with every
// copy landed and a barrier: smem may be reused at once.
template <typename T, bool W_BY_N, typename S, bool PROMOTE, typename Load>
__device__ __forceinline__ void ring_product(float (&acc)[S::MT][S::NT][4],
                                             int stages, T* smem,
                                             Load&& load) {
  constexpr int P = Passes<T>::value;
  constexpr int MT_ = S::MT, NT_ = S::NT, WM_ = S::WM, WN_ = S::WN;
  constexpr int ALD = k_ld<T>();
  constexpr int WLD = W_BY_N ? k_ld<T>() : n_ld<T, S::BN>();
  constexpr int SE = stage_elems<T, W_BY_N, S>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  // ldmatrix (float32 tiles): lane L addresses row L % 8 of 8 × 4-float
  // matrix L / 8, which for a is rows +8 (matrix 1, 3) and k + 4 (2, 3) of
  // an m16 × k8 fragment, for w by n k + 4 (1, 3) and the next n8 (2, 3).
  constexpr bool LDSM = sizeof(T) == 4;
  const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * ALD +
                     (lane >> 4) * 4;
  const int b_lane = ((lane & 7) + (lane >> 4) * 8) * WLD +
                     ((lane >> 3) & 1) * 4;
  auto issue = [&](int s) {
    T* as = smem + (s % S::STAGES) * SE;
    load(s, as, as + S::BM * ALD);
  };

#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < stages) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();   // stage s landed; stage s - 1's buffer is free
    if (s + S::STAGES - 1 < stages) issue(s + S::STAGES - 1);
    cp_async_commit();
    const T* as = smem + (s % S::STAGES) * SE;
    const T* ws = as + S::BM * ALD;
    float fresh[MT_][NT_][4];
    if constexpr (PROMOTE) {
#pragma unroll
      for (int i = 0; i < MT_; ++i)
#pragma unroll
        for (int j = 0; j < NT_; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fresh[i][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragB<P> fb[NT_];
      if constexpr (LDSM && W_BY_N) {
#pragma unroll
        for (int j = 0; j < NT_; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, ws + (wn * WN_ + j * 8) * WLD + kk + b_lane);
          fb[j].set(__uint_as_float(r[0]), __uint_as_float(r[1]));
          fb[j + 1].set(__uint_as_float(r[2]), __uint_as_float(r[3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT_; ++j) {
          if constexpr (W_BY_N) {
            const T* p = ws + (wn * WN_ + j * 8 + g) * WLD + kk + t;
            fb[j].set(codo::to_f32(p[0]), codo::to_f32(p[4]));
          } else {
            const T* p = ws + (kk + t) * WLD + wn * WN_ + j * 8 + g;
            fb[j].set(codo::to_f32(p[0]), codo::to_f32(p[4 * WLD]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT_; ++i) {
        FragA<P> fa;
        if constexpr (LDSM) {
          uint32_t r[4];
          ldsm_x4(r, as + (wm * WM_ + i * 16) * ALD + kk + a_lane);
          fa.set(__uint_as_float(r[0]), __uint_as_float(r[1]),
                 __uint_as_float(r[2]), __uint_as_float(r[3]));
        } else {
          const T* r = as + (wm * WM_ + i * 16 + g) * ALD + kk + t;
          fa.set(codo::to_f32(r[0]), codo::to_f32(r[8 * ALD]),
                 codo::to_f32(r[4]), codo::to_f32(r[8 * ALD + 4]));
        }
#pragma unroll
        for (int j = 0; j < NT_; ++j) {
          if constexpr (PROMOTE)
            mma_f32<P>(fresh[i][j], fa, fb[j]);
          else
            mma_f32<P>(acc[i][j], fa, fb[j]);
        }
      }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int i = 0; i < MT_; ++i)
#pragma unroll
        for (int j = 0; j < NT_; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = __fadd_rn(acc[i][j][e], fresh[i][j][e]);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// acc += the block's 128 × 128 tile of a[m0.., kb..ke) @ w[kb..ke), n0..],
// a (M, ·) with element strides (sam, sak), w (·, N) with (swk, swn), the
// tensor cores accumulating (ring_product without promotion).
template <typename T, bool W_BY_N>
__device__ __forceinline__ void tile_product(
    float (&acc)[MT][NT][4], const T* __restrict__ a, long long sam,
    long long sak, const T* __restrict__ w, long long swk, long long swn,
    int M, int N, int kb, int ke, int m0, int n0, T* smem) {
  constexpr int ALD = k_ld<T>();
  constexpr int WLD = W_BY_N ? k_ld<T>() : n_ld<T>();
  const int tid = threadIdx.x;
  const T* a0 = a + (long long)m0 * sam + (long long)kb * sak;
  const T* w0 = w + (long long)kb * swk + (long long)n0 * swn;
  const bool a_vec = vec_ok(a0, sam, sak, ke - kb);
  const bool w_vec = W_BY_N ? vec_ok(w0, swn, swk, ke - kb)
                            : vec_ok(w0, swk, swn, N - n0);
  auto load = [&](int s, T* as, T* ws) {
    const int k = s * BK;
    load_tile<T, THREADS>(as, ALD, a0 + (long long)k * sak, sam, sak, BM, BK,
                          M - m0, ke - kb - k, a_vec, tid);
    if constexpr (W_BY_N)
      load_tile<T, THREADS>(ws, WLD, w0 + (long long)k * swk, swn, swk, BN,
                            BK, N - n0, ke - kb - k, w_vec, tid);
    else
      load_tile<T, THREADS>(ws, WLD, w0 + (long long)k * swk, swk, swn, BK,
                            BN, ke - kb - k, N - n0, w_vec, tid);
  };
  ring_product<T, W_BY_N, Gemm, false>(acc, (ke - kb + BK - 1) / BK, smem,
                                       load);
}

// The accumulator into a float32 (BM × C_LD) tile in shared memory, so
// that an epilogue walks the output row by row with consecutive threads
// on consecutive columns (coalesced stores, coalesced reads of an
// operand of the output's shape).  Ends with a barrier.
template <typename S = Gemm>
__device__ __forceinline__ void stash_tile(const float (&acc)[S::MT][S::NT][4],
                                           float* c_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * S::WM + i * 16 + g + 8 * h;
        const int c = wn * S::WN + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(c_s + r * S::C_LD + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
}

}  // namespace codo_gemm_mma
