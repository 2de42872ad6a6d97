// Fused pad -> conv2d -> relu for Hopper (sm_90a), float32 accumulation.
//
// Replaces: repro/kernels/streamfuse/streamfuse.py: fused_pad_conv_relu (the
// pl.pallas_call kernel _fused_kernel), routed as streamfuse.conv.  Same
// contract: x (N, C, H, W) and w (CO, C, K, K) of one element type (float32
// or bfloat16), stride 1, SAME padding, K odd; out = relu(conv2d(pad(x), w)),
// (N, CO, H, W) in x's type, products summed in float32.  The padded input
// is never written: out-of-image taps are masked loads that read as zero.
//
// What bounds it on this card: ResNet-18's routed chains at 224x224 are
// 2*N*H*W*CO*C*K*K flops (0.231 GFLOP each at N = 1) on float32 CUDA cores
// (no TF32: 67 TFLOP/s peak), against x, w and the output once (at N = 1
// the 512-channel stage's weights alone are 9.4 MB, 2.8 us at 3.35 TB/s),
// so they sit near the ridge at N = 1 and are operations-bound at N = 8.
// The TPU kernel steps an (N, H) grid, one output row a step, with the whole
// weight resident in VMEM; one row is far too little work for an SM, and
// at N = 1 the deep stages have 49 to 196 pixels for 132 SMs.
//
// What the design does about it: an implicit GEMM, out[co][p] = sum over
// k of w[co][k] * window[k][p], with p the N*H*W output pixels and k the
// C*K*K window in w's (c, kh, kw) order.  A block owns a 64-channel x
// 128-pixel tile and walks its share of k in 8-deep stages: the weight
// tile is read row-major and kept k-major (padded rows, no bank
// conflicts), the window tile is gathered with one pixel a thread (so
// neighbouring threads read neighbouring x values) and a running (c, kh,
// kw) counter instead of divisions; the next stage is fetched into
// registers while the current one computes (the register-tiled 8 x 8 FMA
// step of chain.cu).  When the tiles are too few to fill the card the
// window is split over blockIdx.z (the wrapper's k_splits rule) and each
// split writes float32 partial sums; a second kernel adds them in split
// order and applies the ReLU, so results repeat bit for bit (no atomics).
// Otherwise the ReLU is applied in the epilogue.  Simple CUDA-core FMAs;
// wgmma offers float32 only as TF32.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // output channels per block
constexpr int BN = 128;       // output pixels per block
constexpr int BKK = 8;        // window depth per shared-memory stage
constexpr int THREADS = 128;  // 8 x 16 threads, 8 x 8 outputs each
constexpr int LDA = BM + 4;   // padded row of the k-major weight tile
constexpr int A_PER = BKK * BM / THREADS;  // weight elements a thread moves

static_assert(BN == THREADS, "one window column (pixel) per thread");

struct Shape {
  int N, C, H, W, CO, K, pad;
  int HW;  // pixels of one image
  int P;   // output pixels, N * H * W
  int KK;  // K * K
  int Kd;  // window depth, C * K * K
};

// One stage of the register-tiled product: acc[8][8] += As · Bs over BKK.
// As is k-major [BKK][lda] (channels), Bs [BKK][BN] (pixels).  A thread
// owns channels tr·4+i and BM/2+tr·4+i and pixels tc·4+j and BN/2+tc·4+j
// (i, j < 4): two float4 reads of each operand a step.
__device__ __forceinline__ void mma_stage(float (&acc)[8][8], const float* As,
                                          int lda, const float* Bs, int tr,
                                          int tc) {
#pragma unroll
  for (int kk = 0; kk < BKK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * lda + tr * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * lda + BM / 2 + tr * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN + tc * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * BN + BN / 2 + tc * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// Channel (half = BM/2) or pixel (half = BN/2) of the tile that register
// index i (< 8) of thread coordinate t stands for.
__device__ __forceinline__ int tile_index(int t, int i, int half) {
  return (i < 4 ? 0 : half) + t * 4 + (i & 3);
}

// Global -> registers: the weight tile at (co0, k0), element i of it at
// channel i / BKK, depth i % BKK (eight threads read a row's 32 bytes).
template <typename T>
__device__ __forceinline__ void fetch_w(float (&r)[A_PER], const T* w,
                                        const Shape& s, int co0, int k0,
                                        int kend, int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    const int i = tid + u * THREADS, co = co0 + i / BKK, k = k0 + i % BKK;
    r[u] = (co < s.CO && k < kend) ? codo::to_f32(w[(size_t)co * s.Kd + k])
                                   : 0.f;
  }
}

__device__ __forceinline__ void stash_w(float* a_s, const float (&r)[A_PER],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < A_PER; ++u) {
    const int i = tid + u * THREADS;
    a_s[(i % BKK) * LDA + i / BKK] = r[u];  // k-major
  }
}

// Where a thread's window column reads: its pixel (n, h, w) and a running
// (c, kh, kw) decomposition of the next depth k it fetches.
struct Cursor {
  const void* xn;  // image n of x
  bool live;       // the pixel exists (p < P)
  int h, w;
  int c, kh, kw;
};

// Global -> registers: the thread's column of the window tile for the
// BKK depths from k0, zero where the tap falls in the padding, past the
// split's end, or past the last pixel.  Advances the cursor by BKK.
template <typename T>
__device__ __forceinline__ void fetch_x(float (&r)[BKK], Cursor& q,
                                        const Shape& s, int k0, int kend) {
  const T* xn = static_cast<const T*>(q.xn);
#pragma unroll
  for (int kk = 0; kk < BKK; ++kk) {
    const int ih = q.h + q.kh - s.pad, iw = q.w + q.kw - s.pad;
    const bool ok = q.live && k0 + kk < kend && (unsigned)ih < (unsigned)s.H &&
                    (unsigned)iw < (unsigned)s.W;
    r[kk] = ok ? codo::to_f32(xn[(size_t)q.c * s.HW + ih * s.W + iw]) : 0.f;
    if (++q.kw == s.K) {
      q.kw = 0;
      if (++q.kh == s.K) {
        q.kh = 0;
        ++q.c;
      }
    }
  }
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// One (BM channels x BN pixels) output tile over the depths [kbeg, kend)
// of split blockIdx.z.  final_out: write relu(acc) into out (N, CO, H, W)
// in T; otherwise write acc into the float32 partial (splits, CO, P).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                void* __restrict__ dst, Shape s, int per, int final_out) {
  __shared__ __align__(16) float a_s[2][BKK * LDA];
  __shared__ __align__(16) float b_s[2][BKK * BN];

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int p0 = blockIdx.x * BN, co0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * per;
  const int kend = min(kbeg + per, s.Kd);

  Cursor q;
  const int p = p0 + tid;
  q.live = p < s.P;
  const int n = q.live ? p / s.HW : 0;
  const int hw = q.live ? p - n * s.HW : 0;
  q.h = hw / s.W;
  q.w = hw - q.h * s.W;
  q.xn = x + (size_t)n * s.C * s.HW;
  q.c = kbeg / s.KK;
  const int r0 = kbeg - q.c * s.KK;
  q.kh = r0 / s.K;
  q.kw = r0 - q.kh * s.K;

  float acc[8][8] = {};
  float ra[A_PER], rb[BKK];
  fetch_w(ra, w, s, co0, kbeg, kend, tid);
  fetch_x<T>(rb, q, s, kbeg, kend);
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += BKK) {
    stash_w(a_s[buf], ra, tid);
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) b_s[buf][kk * BN + tid] = rb[kk];
    __syncthreads();
    if (k0 + BKK < kend) {
      fetch_w(ra, w, s, co0, k0 + BKK, kend, tid);
      fetch_x<T>(rb, q, s, k0 + BKK, kend);
    }
    mma_stage(acc, a_s[buf], LDA, b_s[buf], tr, tc);
    buf ^= 1;
  }

  if (final_out) {
    T* out = static_cast<T*>(dst);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pp = p0 + tile_index(tc, j, BN / 2);
      if (pp >= s.P) continue;
      const int nj = pp / s.HW, hwj = pp - nj * s.HW;
      T* col = out + (size_t)nj * s.CO * s.HW + hwj;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int co = co0 + tile_index(tr, i, BM / 2);
        if (co < s.CO) col[(size_t)co * s.HW] = codo::from_f32<T>(relu(acc[i][j]));
      }
    }
  } else {
    float* part = static_cast<float*>(dst) + (size_t)blockIdx.z * s.CO * s.P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int co = co0 + tile_index(tr, i, BM / 2);
      if (co >= s.CO) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pp = p0 + tile_index(tc, j, BN / 2);
        if (pp < s.P) part[(size_t)co * s.P + pp] = acc[i][j];
      }
    }
  }
}

// out (N, CO, HW) = relu(sum over splits of partial (splits, CO, N*HW)),
// in split order: deterministic.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial,
                              T* __restrict__ out, int splits, int CO, int N,
                              int HW) {
  const long long P = (long long)N * HW, total = (long long)CO * P;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * total + i];
    const long long co = i / P, pp = i - co * P;
    const long long n = pp / HW, hw = pp - n * HW;
    out[(n * CO + co) * HW + hw] = codo::from_f32<T>(relu(v));
  }
}

template <typename T>
int launch_conv(const void* x, const void* w, void* dst, const Shape& s,
                int per, int splits, int final_out, cudaStream_t stream) {
  dim3 grid((s.P + BN - 1) / BN, (s.CO + BM - 1) / BM, splits);
  conv_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(w), dst,
                                               s, per, final_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* partial, void* out, int splits, int CO, int N,
                  int HW, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = ((long long)CO * N * HW + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  reduce_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), splits, CO, N,
      HW);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch conv_kernel over a (P/128, CO/64, splits) grid, each split `per`
// deep (a multiple of 8) except the last.  final_out = 1 (only with one
// split): dst is out (N, CO, H, W) in the element type; otherwise dst is
// the float32 partial (splits, CO, N*H*W) for codo_pad_conv_relu_reduce.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or
// split the kernel does not take.
extern "C" int codo_pad_conv_relu(int dtype, const void* x, const void* w,
                                  void* dst, int N, int C, int H, int W,
                                  int CO, int K, int per, int splits,
                                  int final_out, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || CO <= 0 || K <= 0 ||
      K % 2 != 1 || per <= 0 || per % BKK != 0 || splits <= 0 ||
      (long long)per * (splits - 1) >= (long long)C * K * K ||
      (final_out != 0) != (splits == 1))
    return (int)cudaErrorInvalidValue;
  Shape s{N, C, H, W, CO, K, K / 2, H * W, N * H * W, K * K, C * K * K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_conv<__nv_bfloat16>(x, w, dst, s, per, splits, final_out,
                                      st);
  return launch_conv<float>(x, w, dst, s, per, splits, final_out, st);
}

// Launch reduce_kernel: out (N, CO, H, W) in the element type.
extern "C" int codo_pad_conv_relu_reduce(int dtype, const void* partial,
                                         void* out, int splits, int CO, int N,
                                         int HW, void* stream) {
  if (splits <= 0 || CO <= 0 || N <= 0 || HW <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_reduce<__nv_bfloat16>(partial, out, splits, CO, N, HW, st);
  return launch_reduce<float>(partial, out, splits, CO, N, HW, st);
}
