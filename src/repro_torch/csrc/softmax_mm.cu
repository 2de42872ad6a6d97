// Streaming attention tail softmax(s, -1) @ v for Hopper (sm_90a), float32
// accumulation on the tensor cores.
//
// Replaces: repro/kernels/streamfuse/chain.py: fused_softmax_matmul (the
// pl.pallas_call kernel _softmax_mm_kernel), routed as
// streamfuse.softmaxmm.  Same contract: s (M, K), v (K, N) of one element
// type (float32 or bfloat16), the online softmax over key tiles with a
// running max m starting at -1e30, a running denominator l and a float32
// accumulator, the output acc / max(l, 1e-30) in s's type written once.
// Unlike the TPU kernel no dimension must divide a block (ragged edges are
// masked: keys past K take exactly zero weight, rows past M are never
// written), the output columns are tiled (the pattern guard does not bound
// N), and each operand is read through its strides.
//
// What bounds it on this card: 2·M·K·N flops against one read of s.  At
// one RecurrentGemma-9B head, (2048, 2048) @ (2048, 256), 13 µs at 165
// TFLOP/s of float32-accurate work on the TF32 tensor cores (three
// products a multiply) against 6.3 µs of bytes — compute-bound; at one
// GPT-2-medium head, (1024, 1024) @ (1024, 64), 0.8 µs of flops against
// 1.4 µs of bytes — bound by reading s.  The TPU kernel walks the keys as
// its sequential grid axis with an (rows, N) accumulator in VMEM, and its
// only parallelism is M / rows: 8 to 16 blocks at these shapes.
//
// What the design does about it: flashattn.cu's P·V step with no q·kᵀ
// product.  A block of 4 warps owns 64 rows (16 a warp), 64 or 128 output
// columns and one contiguous split of the key tiles (flash-decoding
// style: the wrapper splits keys so that the grid fills one wave).  Each
// 64-key tile of s and of V streams through two cp.async buffers, one
// barrier a tile; a transposed s takes load_tile's element path.  A warp
// reads its rows' scores straight into A-fragment order (rows g and g + 8,
// keys t and t + 4 of each 8-key step), so a row lives on the four lanes
// of a quad and the online softmax runs on registers (quad_max, quad_sum
// in online_softmax.cuh); the probabilities stay there as the A operand of
// P·V on mma.sync m16n8k8 TF32 with the 3×TF32 split (mma_tf32.cuh;
// bfloat16 operands, exact in TF32, take one pass).  Where a block walks
// more than one key tile (PROMOTE), a tile's P·V is taken in a fresh
// fragment and folded into the accumulator as acc·corr + fresh by the
// CUDA cores (round-to-nearest), so the tensor cores' own accumulation
// rounds a tile's partial only: at (2048, 2048) @ (2048, 256) eight times
// less error against float64 and no more device time (PERF.md §6, NVIDIA
// H100 80GB HBM3 at 700 W).  With one key tile both forms compute the
// same, and the plain one runs.  Wider N is tiled
// over the grid, each column tile recomputing the same row statistics.
// With one split the block writes the normalized output; otherwise each
// split writes its unnormalized accumulator with its m and l, and the
// shared combine_kernel sums the splits in a fixed order, so results
// repeat bit for bit (no atomics).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"
#include "online_softmax.cuh"

namespace {

using namespace codo_softmax;

constexpr int BQ = 64;        // rows a block, 16 a warp
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // 4 warps

// Row strides in shared memory (elements): s tiles row by row (BK + 16
// bytes), V tiles key by key (BN + 32 bytes), so that every row starts
// 16-byte aligned for cp.async and fragment reads hit distinct banks.
template <typename T>
__host__ __device__ constexpr int s_ld() {
  return BK + 16 / (int)sizeof(T);
}
template <typename T, int BN>
__host__ __device__ constexpr int v_ld() {
  return BN + 32 / (int)sizeof(T);
}
template <typename T, int BN>
__host__ __device__ constexpr int buf_elems() {
  return BQ * s_ld<T>() + BK * v_ld<T, BN>();
}
template <typename T, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * sizeof(T) * (size_t)buf_elems<T, BN>();
}

// NT: n8 fragments a warp (BN = 8·NT output columns a block).  part_o ==
// nullptr: one split, write out (M, N) normalized; else write part_o
// (splits, M, N) unnormalized and part_ml (splits, M, 2).
template <typename T, int NT, bool PROMOTE>
__global__ void __launch_bounds__(THREADS, NT == 16 ? 2 : 3)
    softmax_mm_kernel(const T* __restrict__ s, const T* __restrict__ v,
                      long long ss0, long long ss1, long long sv0,
                      long long sv1, T* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int M, int K, int N, int tiles_per_split) {
  using namespace codo_mma;
  constexpr int P = Passes<T>::value;
  constexpr int BN = 8 * NT;
  constexpr int SLD = s_ld<T>();
  constexpr int VLD = v_ld<T, BN>();
  constexpr int BUF = buf_elems<T, BN>();
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);   // 2 × ([BQ][SLD] s, [BK][VLD] V)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, n0 = blockIdx.y * BN;
  const int kt_begin = blockIdx.z * tiles_per_split;
  const int tiles =
      min((K + BK - 1) / BK, kt_begin + tiles_per_split) - kt_begin;
  const T* sb = s + (long long)q0 * ss0;
  const T* vb = v + (long long)n0 * sv1;
  const bool s_vec = vec_ok(sb, ss0, ss1, K);
  const bool v_vec = vec_ok(vb, sv0, sv1, N - n0);

  auto load = [&](int i) {
    const int k0 = (kt_begin + i) * BK;
    T* st = smem + (i & 1) * BUF;
    load_tile<T, THREADS>(st, SLD, sb + (long long)k0 * ss1, ss0, ss1, BQ, BK,
                          M - q0, K - k0, s_vec, tid);
    load_tile<T, THREADS>(st + BQ * SLD, VLD, vb + (long long)k0 * sv0, sv0,
                          sv1, BK, BN, K - k0, N - n0, v_vec, tid);
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g+8
  const int row0 = warp * 16 + g;   // the warp's rows row0 and row0 + 8

  load(0);
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();   // tile i landed; tile i - 1's buffer is free
    if (i + 1 < tiles) load(i + 1);
    const T* st = smem + (i & 1) * BUF;
    const T* vt = st + BQ * SLD;
    const int k0 = (kt_begin + i) * BK;

    // ---- the tile's scores in A-fragment order: x[j] = (row0, k), (row0
    // + 8, k), (row0, k + 4), (row0 + 8, k + 4), k = 8j + t; keys past K
    // take exactly zero weight ----
    float x[BK / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const T* sr = st + row0 * SLD + j * 8 + t;
      const bool in0 = k0 + j * 8 + t < K, in1 = k0 + j * 8 + t + 4 < K;
      x[j][0] = in0 ? codo::to_f32(sr[0]) : -INFINITY;
      x[j][1] = in0 ? codo::to_f32(sr[8 * SLD]) : -INFINITY;
      x[j][2] = in1 ? codo::to_f32(sr[4]) : -INFINITY;
      x[j][3] = in1 ? codo::to_f32(sr[8 * SLD + 4]) : -INFINITY;
      mx[0] = fmaxf(mx[0], fmaxf(x[j][0], x[j][2]));
      mx[1] = fmaxf(mx[1], fmaxf(x[j][1], x[j][3]));
    }
    // ---- the online softmax of rows row0 (h = 0) and row0 + 8 (h = 1):
    // a quad of lanes holds a row ----
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        x[j][h] = expf(x[j][h] - m_new);
        x[j][h + 2] = expf(x[j][h + 2] - m_new);
        sum += x[j][h] + x[j][h + 2];
      }
      corr[h] = expf(m_run[h] - m_new);
      l_run[h] = l_run[h] * corr[h] + quad_sum(sum);
      m_run[h] = m_new;
    }

    // ---- acc = acc·corr + p (16 × 64) · V (64 × BN), p from registers:
    // the A fragment's k = t, t + 4 are V's rows 8j + t, 8j + t + 4 ----
    float fresh[PROMOTE ? NT : 1][4];
    if constexpr (PROMOTE) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[n][e] = 0.f;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      FragA<P> fa;
      fa.set(x[j][0], x[j][1], x[j][2], x[j][3]);
      const T* vr = vt + (j * 8 + t) * VLD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB<P> fb;
        fb.set(codo::to_f32(vr[n * 8]), codo::to_f32(vr[4 * VLD + n * 8]));
        if constexpr (PROMOTE)
          mma_f32<P>(fresh[n], fa, fb);
        else
          mma_f32<P>(acc[n], fa, fb);
      }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = __fmaf_rn(acc[n][e], corr[e >> 1], fresh[n][e]);
    }
  }
  cp_async_wait_all();   // nothing in flight when the block ends

  // ---- the output rows row0, row0 + 8 of this block's columns ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + row0 + 8 * h;
    if (qr >= M) continue;
    if (part_o == nullptr) {
      const float inv_l = 1.f / fmaxf(l_run[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + n * 8 + 2 * t + e;
          if (col < N)
            out[(size_t)qr * N + col] =
                codo::from_f32<T>(acc[n][2 * h + e] * inv_l);
        }
    } else {
      const size_t at = (size_t)blockIdx.z * M + qr;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + n * 8 + 2 * t + e;
          if (col < N) part_o[at * N + col] = acc[n][2 * h + e];
        }
      if (blockIdx.y == 0 && t == 0) {  // every column tile has the same m, l
        part_ml[at * 2] = m_run[h];
        part_ml[at * 2 + 1] = l_run[h];
      }
    }
  }
}

template <typename T, int NT, bool PROMOTE>
int launch_nt(const void* s, const void* v, const long long* st, void* dst,
              void* part_ml, int M, int K, int N, int splits, int per,
              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, 8 * NT>();
  cudaError_t err =
      codo::set_smem<softmax_mm_kernel<T, NT, PROMOTE>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BQ - 1) / BQ, (N + 8 * NT - 1) / (8 * NT), splits);
  T* out = splits == 1 ? static_cast<T*>(dst) : nullptr;
  float* po = splits == 1 ? nullptr : static_cast<float*>(dst);
  softmax_mm_kernel<T, NT, PROMOTE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(v), st[0], st[1], st[2],
      st[3], out, po, static_cast<float*>(part_ml), M, K, N, per);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* s, const void* v, const long long* st, void* dst,
           void* part_ml, int M, int K, int N, int bn, int splits, int per,
           cudaStream_t stream) {
  const bool promote = per > 1;
  auto* fn = promote ? &launch_nt<T, 16, true> : &launch_nt<T, 16, false>;
  if (bn == 64)
    fn = promote ? &launch_nt<T, 8, true> : &launch_nt<T, 8, false>;
  return fn(s, v, st, dst, part_ml, M, K, N, splits, per, stream);
}

}  // namespace

// Launch softmax_mm_kernel over (ceil(M/64), ceil(N/bn), splits) blocks,
// each walking tiles_per_split 64-key tiles; bn (64 or 128) output columns
// a block.  strides: (row, key) element strides of s, then (key, column)
// of v.  splits == 1: dst is the contiguous (M, N) output in the operands'
// type and part_ml is not read; else dst is float32 (splits, M, N) scratch
// and part_ml float32 (splits, M, 2).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int codo_softmax_matmul(int dtype, const void* s, const void* v,
                                   const long long* strides, void* dst,
                                   void* part_ml, int M, int K, int N, int bn,
                                   int splits, int tiles_per_split,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || tiles_per_split <= 0 ||
      (bn != 64 && bn != 128) ||
      (N + bn - 1) / bn > 65535 || splits > 65535 ||
      (long long)(splits - 1) * tiles_per_split * BK >= K ||
      (splits > 1 && part_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch<__nv_bfloat16>(s, v, strides, dst, part_ml, M, K, N, bn,
                                 splits, tiles_per_split, st);
  return launch<float>(s, v, strides, dst, part_ml, M, K, N, bn, splits,
                       tiles_per_split, st);
}

// Launch the shared combine_kernel (online_softmax.cuh), one block per
// row: out the contiguous (M, N) output in the operands' type.
extern "C" int codo_softmax_matmul_combine(int dtype, const void* part_o,
                                           const void* part_ml, void* out,
                                           int splits, int M, int N,
                                           void* stream) {
  if (M <= 0 || N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = N >= 256 ? 256 : 64;
  const float* po = static_cast<const float*>(part_o);
  const float* pml = static_cast<const float*>(part_ml);
  const Strides os{0, 0, N, 1};  // one (b, h): rows of N
  if (dtype == codo::kBF16)
    combine_kernel<__nv_bfloat16><<<M, threads, 0, s>>>(
        po, pml, static_cast<__nv_bfloat16*>(out), splits, 1, 1, M, N, os);
  else
    combine_kernel<float><<<M, threads, 0, s>>>(
        po, pml, static_cast<float*>(out), splits, 1, 1, M, N, os);
  return (int)cudaGetLastError();
}
