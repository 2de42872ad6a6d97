// Streaming attention tail softmax(s, -1) @ v for Hopper (sm_90a), float32
// accumulation.
//
// Replaces: repro/kernels/streamfuse/chain.py: fused_softmax_matmul (the
// pl.pallas_call kernel _softmax_mm_kernel), routed as
// streamfuse.softmaxmm.  Same contract: s (M, K), v (K, N) of one element
// type (float32 or bfloat16), the online softmax over key tiles with a
// running max m starting at -1e30, a running denominator l and a float32
// accumulator, the output acc / max(l, 1e-30) in s's type written once.
// Unlike the TPU kernel no dimension must divide a block (ragged edges are
// masked), the output columns are tiled (the pattern guard does not bound
// N), and each operand is read through its strides.
//
// What bounds it on this card: 2·M·K·N flops on float32 CUDA cores (no
// TF32: 67 TFLOP/s) against one read of s: at one RecurrentGemma-9B head,
// (2048, 2048) @ (2048, 256), 32 µs of flops against 6 µs of bytes —
// compute-bound; at one GPT-2-medium head, (1024, 1024) @ (1024, 64),
// 2.0 µs of flops against 1.4 µs of bytes.  The TPU kernel walks the keys
// as its sequential grid axis with an (rows, N) accumulator in VMEM, and
// its only parallelism is M / rows: 8 to 16 blocks at these shapes.
//
// What the design does about it: flashattn.cu's online-softmax step with
// the q·kᵀ step left out.  A block owns 16 rows, up to 256 output columns
// and one contiguous split of the key tiles (flash-decoding style), so the
// grid is (M/16, N/256, splits) and the wrapper picks splits to reach two
// blocks per SM.  Each warp reads its two rows' 64 scores of a tile
// straight from memory (lanes on consecutive keys), updates m and l in
// registers with warp shuffles and leaves the tile's probabilities and
// corrections in shared memory; each of the 256 threads keeps a 4-row ×
// (N/64)-column slice of the accumulator in registers and streams V
// through shared memory 8 keys at a time.  With one split the block
// writes the normalized output; otherwise each split writes its
// unnormalized accumulator with its m and l, and a second kernel combines
// the splits in a fixed order, so results repeat bit for bit.  Simple
// CUDA-core FMAs; wgmma and TMA are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "online_softmax.cuh"

namespace {

using namespace codo_softmax;

constexpr int BQ = 16;        // rows per block
constexpr int BK = 64;        // keys per tile
constexpr int BKV = 8;        // keys per V chunk
constexpr int THREADS = 256;  // 8 warps: warp w owns rows 2w, 2w+1

// NC: accumulator columns a thread (a block owns BN = 64·NC columns).
// part_o == nullptr: one split, write out (M, N) normalized; else write
// part_o (splits, M, N) unnormalized and part_ml (splits, M, 2).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 2)
    softmax_mm_kernel(const T* __restrict__ s, const T* __restrict__ v,
                      long long ss0, long long ss1, long long sv0,
                      long long sv1, T* __restrict__ out,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int M, int K, int N, int tiles_per_split) {
  constexpr int BN = 64 * NC;
  __shared__ float p_s[BQ * BK];   // the tile's probabilities
  __shared__ float c_s[BQ];        // the tile's row corrections
  __shared__ float l_s[BQ];        // final denominators
  __shared__ float v_s[BKV * BN];  // one V chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 6, cg = tid & 63;  // accumulator rows 4rg.., cols cg+64c
  const int q0 = blockIdx.x * BQ, n0 = blockIdx.y * BN;
  const int kt_begin = blockIdx.z * tiles_per_split;
  const int kt_end = min((K + BK - 1) / BK, kt_begin + tiles_per_split);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows 2w+i

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;

    // ---- the online softmax of the warp's two rows, in registers; keys
    // past K take no weight, rows past M read zeros and are never written.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * warp + i, qr = q0 + row;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        x[c] = kpos >= K ? -INFINITY
               : qr < M  ? codo::to_f32(s[qr * ss0 + kpos * ss1])
                         : 0.f;
      }
      const float corr = online_softmax_step(x, m_run[i], l_run[i]);
      p_s[row * BK + lane] = x[0];
      p_s[row * BK + lane + 32] = x[1];
      if (lane == 0) c_s[row] = corr;
    }
    __syncthreads();

    // ---- acc = acc·corr + p·V, V streamed in BKV-key chunks ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[4 * rg + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    for (int j0 = 0; j0 < BK; j0 += BKV) {
      for (int e = tid; e < BKV * BN; e += THREADS) {
        const int j = e / BN, d = e - j * BN;
        const int kr = k0 + j0 + j, col = n0 + d;
        v_s[e] = (kr < K && col < N) ? codo::to_f32(v[kr * sv0 + col * sv1])
                                     : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BKV; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = p_s[(4 * rg + i) * BK + j0 + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = v_s[j * BN + cg + 64 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
      __syncthreads();
    }
  }

  if (part_o == nullptr) {
    // ---- one split: acc / max(l, 1e-30), written once in T ----
    if (lane == 0) {
      l_s[2 * warp] = l_run[0];
      l_s[2 * warp + 1] = l_run[1];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + 4 * rg + i;
      if (qr >= M) continue;
      const float inv_l = 1.f / fmaxf(l_s[4 * rg + i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = n0 + cg + 64 * c;
        if (col < N)
          out[(size_t)qr * N + col] = codo::from_f32<T>(acc[i][c] * inv_l);
      }
    }
    return;
  }

  // ---- this split's unnormalized accumulator, running max and sum ----
  const size_t base = (size_t)blockIdx.z * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * rg + i;
    if (qr >= M) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = n0 + cg + 64 * c;
      if (col < N) part_o[(base + qr) * N + col] = acc[i][c];
    }
  }
  if (lane == 0 && blockIdx.y == 0) {  // every column tile has the same m, l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = q0 + 2 * warp + i;
      if (qr < M) {
        part_ml[(base + qr) * 2] = m_run[i];
        part_ml[(base + qr) * 2 + 1] = l_run[i];
      }
    }
  }
}

template <typename T>
int launch(const void* s, const void* v, const long long* st, void* dst,
           void* part_ml, int M, int K, int N, int bn, int splits, int per,
           cudaStream_t stream) {
  const dim3 grid((M + BQ - 1) / BQ, (N + bn - 1) / bn, splits);
  const T* sp = static_cast<const T*>(s);
  const T* vp = static_cast<const T*>(v);
  T* out = splits == 1 ? static_cast<T*>(dst) : nullptr;
  float* po = splits == 1 ? nullptr : static_cast<float*>(dst);
  float* pml = static_cast<float*>(part_ml);
#define CODO_SMM(NC)                                                        \
  softmax_mm_kernel<T, NC><<<grid, THREADS, 0, stream>>>(                   \
      sp, vp, st[0], st[1], st[2], st[3], out, po, pml, M, K, N, per)
  if (bn == 64)
    CODO_SMM(1);
  else if (bn == 128)
    CODO_SMM(2);
  else
    CODO_SMM(4);
#undef CODO_SMM
  return (int)cudaGetLastError();
}

}  // namespace

// Launch softmax_mm_kernel over (ceil(M/16), ceil(N/bn), splits) blocks,
// each walking tiles_per_split 64-key tiles; bn (64, 128 or 256) output
// columns a block.  strides: (row, key) element strides of s, then (key,
// column) of v.  splits == 1: dst is the contiguous (M, N) output in the
// operands' type and part_ml is not read; else dst is float32 (splits, M,
// N) scratch and part_ml float32 (splits, M, 2).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int codo_softmax_matmul(int dtype, const void* s, const void* v,
                                   const long long* strides, void* dst,
                                   void* part_ml, int M, int K, int N, int bn,
                                   int splits, int tiles_per_split,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || tiles_per_split <= 0 ||
      (bn != 64 && bn != 128 && bn != 256) || (N + bn - 1) / bn > 65535 ||
      splits > 65535 || (splits > 1 && part_ml == nullptr))
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
