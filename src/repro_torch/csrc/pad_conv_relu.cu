// Fused pad -> conv2d -> relu for Hopper (sm_90a) as an implicit GEMM on
// the tensor cores, float32 accumulation.
//
// Replaces: repro/kernels/streamfuse/streamfuse.py: fused_pad_conv_relu (the
// pl.pallas_call kernel _fused_kernel), routed as streamfuse.conv.  Same
// contract: x (N, C, H, W) and w (CO, C, K, K) of one element type (float32
// or bfloat16), stride 1, SAME padding, K odd; out = relu(conv2d(pad(x), w)),
// (N, CO, H, W) in x's type, products summed in float32.  The padded input
// is never written: out-of-image taps are copies of zero.
//
// What bounds it on this card: 2·N·H·W·CO·C·K·K flops against x, w and the
// output once.  ResNet-18's routed chains at 224 × 224 are 0.231 GFLOP
// each at N = 1 and VGG-16's thirteen 30.7 GFLOP a request: at 165
// TFLOP/s of float32-accurate work on the TF32 tensor cores (three TF32
// products a float32 one) 1.4 µs and 0.186 ms, on the float32 CUDA cores
// (67 TFLOP/s) 3.5 µs and 0.458 ms, against bytes of 2.8 µs for the
// 512-channel stage's weights alone (9.4 MB at 3.35 TB/s): operations
// bound but at the ridge for the deep stages at N = 1.  The TPU kernel
// steps an (N, H) grid, one output row a step, with the whole weight
// resident in VMEM; one row is far too little work for an SM, and at N = 1
// the deep stages have 49 to 196 pixels for 132 SMs.
//
// What the design does about it: out[co][p] = Σ_k w[co][k]·win[k][p], p the
// N·H·W output pixels and k the C·K·K window in w's (c, kh, kw) order, on
// the ring and the mma.sync product step of mma_gemm.cuh (ring_product):
// 3×TF32 (bfloat16 operands, exact in TF32, take one pass), the window
// walked in 32-deep stages through a three-stage cp.async ring, blocks of
// 8 warps over 128 pixels, two blocks a SM.  The wrapper picks one of two
// tiles by the output channels (conv_tile_rows): a layer of up to 64
// channels takes 64 channels a block, warps of 32 × 32, and each 32-deep
// stage goes into a fresh accumulator, added into the kept one by
// round-to-nearest adds (both fit 128 registers); a wider layer takes 128
// channels a block, warps of 64 × 32 (mma_gemm.cuh's GEMM tile), which
// halves the window gathered per output but leaves no registers for a
// second accumulator, so the tensor cores accumulate, and the wrapper
// keeps each split of the window at most 512 deep: their truncating
// accumulation grows with the depth of a split (chip_smoke.py's precision
// phase reads it at one split and at the route's; PERF.md §6), and the
// splits are summed in float32 with round-to-nearest.  w is (CO, C·K·K)
// row-major, the ring's a operand, copied 16 bytes at a time where rows
// are 16-byte aligned (element copies for C·K·K = 27 and the ragged K = 5,
// 7 shapes).  The window tile is gathered by this kernel's own loader and
// kept pixel by pixel, 32 depths a row, so its fragments are read with
// ldmatrix as the a tile's are: a quad of lanes loads four depths of one
// pixel and a warp eight pixels (32 distinct banks; neighbouring taps of
// neighbouring pixels, so a warp's 32 reads fall in a few 32-byte runs of
// x), each thread stepping its (c, kh, kw) tap with a running counter, no
// divisions.  A thread issues all 16 of its loads of a stage (zero for
// taps in the padding) before its first store to shared memory.
// The epilogue stages the tile through shared memory and writes NCHW
// rows, pixels contiguous.  When the tiles are too few to fill the card
// the window is split over blockIdx.z (the wrapper's conv_splits rule)
// and each split writes float32 partial sums; a second kernel adds them
// in split order and applies the ReLU, so results repeat bit for bit (no
// atomics).  Otherwise the ReLU is applied in the epilogue.

#include <stdint.h>

#include "common.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace codo_gemm_mma;

// The two tiles, 8 warps over 128 pixels and three stages each: 64
// channels in warps of 32 × 32 (each stage promoted), 128 channels in
// warps of 64 × 32 (the tensor cores accumulating).
using NarrowTile = TileShape<64, 128, 32, 32, 3>;
using WideTile = TileShape<128, 128, 64, 32, 3>;

// Two blocks of either tile, each with the 1 KB the runtime reserves, fit
// a SM's 228 KB of shared memory, and every tile row is whole 16-byte
// vectors (cp.async copies, ldmatrix reads), in both element types.
template <typename T, typename S>
constexpr bool two_blocks_fit() {
  return 2 * (smem_bytes<T, true, S>() + 1024) <= 233472 &&
         k_ld<T>() * sizeof(T) % 16 == 0;
}
static_assert(two_blocks_fit<float, NarrowTile>() &&
                  two_blocks_fit<__nv_bfloat16, NarrowTile>() &&
                  two_blocks_fit<float, WideTile>() &&
                  two_blocks_fit<__nv_bfloat16, WideTile>(),
              "a conv tile does not fit two blocks a SM");

struct Shape {
  int N, C, H, W, CO, K, pad;
  int HW;  // pixels of one image
  int P;   // output pixels, N * H * W
  int KK;  // K * K
  int Kd;  // window depth, C * K * K
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// One (S::BM channels × S::BN pixels) output tile over the depths [kb, ke)
// of split blockIdx.z.  final_out: write relu(acc) into out (N, CO, H, W)
// in T; otherwise write acc into the float32 partial (splits, CO, P).
template <typename T, typename S, bool PROMOTE>
__global__ void __launch_bounds__(S::THREADS, 512 / S::THREADS)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                void* __restrict__ dst, Shape s, int per, int final_out) {
  extern __shared__ float4 smem4[];
  constexpr int LD = k_ld<T>();          // both tiles are kept k-minor
  constexpr int PIX = S::THREADS / 4;    // pixels a gather round
  constexpr int ROUNDS = S::BN / PIX;
  static_assert(S::BN % PIX == 0, "whole gather rounds");
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * S::BN, co0 = blockIdx.y * S::BM;
  const int kb = blockIdx.z * per, ke = min(s.Kd, kb + per);

  const T* w0 = w + (size_t)co0 * s.Kd + kb;
  const bool w_vec = vec_ok(w0, s.Kd, 1, ke - kb);

  // The thread's share of the window tile: depths kb + ksub + 4i of the
  // pixels p0 + col[r], a quad of lanes on four depths of one pixel, so a
  // warp loads 8 pixels × 4 depths (32 distinct banks; 32-byte runs of x).
  // The tap of the thread's depth k is (c, dh = kh - pad, dw = kw - pad),
  // at offset c·HW + dh·W + dw from a pixel.
  const int ksub = lane & 3;
  int col[ROUNDS], hh[ROUNDS], ww[ROUNDS];
  const T* px[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    col[r] = r * PIX + (tid >> 5) * 8 + (lane >> 2);
    const int p = p0 + col[r];
    const bool live = p < s.P;
    const int n = live ? p / s.HW : 0;
    const int hw = live ? p - n * s.HW : 0;
    hh[r] = live ? hw / s.W : -(1 << 20);   // a dead pixel fails every tap
    ww[r] = hw - (hw / s.W) * s.W;
    px[r] = x + (size_t)n * s.C * s.HW + hw;
  }
  int k = kb + ksub;
  int dh, dw, off;
  {
    const int c = k / s.KK, r = k - c * s.KK;
    dh = r / s.K - s.pad;
    dw = r - (r / s.K) * s.K - s.pad;
    off = c * s.HW + dh * s.W + dw;
  }

  // The weight tile by cp.async; the window tile by plain loads, every
  // one of the stage in flight before the first store.
  auto load = [&](int st, T* as, T* ws) {
    load_tile<T, S::THREADS>(as, LD, w0 + st * BK, s.Kd, 1, S::BM, BK,
                             s.CO - co0, ke - kb - st * BK, w_vec, tid);
    T v[BK / 4][ROUNDS];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const bool ok = k < ke && (unsigned)(hh[r] + dh) < (unsigned)s.H &&
                        (unsigned)(ww[r] + dw) < (unsigned)s.W;
        v[i][r] = ok ? px[r][off] : codo::from_f32<T>(0.f);
      }
      k += 4;
      dw += 4;
      off += 4;
      while (dw > s.pad) {
        dw -= s.K;
        off += s.W - s.K;
        if (++dh > s.pad) {
          dh = -s.pad;
          off += s.HW - s.K * s.W;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i)
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) ws[col[r] * LD + ksub + 4 * i] = v[i][r];
  };

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  ring_product<T, true, S, PROMOTE>(acc, (ke - kb + BK - 1) / BK,
                                    reinterpret_cast<T*>(smem4), load);
  float* c_s = reinterpret_cast<float*>(smem4);
  stash_tile<S>(acc, c_s);

  // Pixel p0 + oc of the tile, channels orow + GROUPS·i: consecutive
  // threads write consecutive pixels.
  constexpr int GROUPS = S::THREADS / S::BN;
  const int oc = tid % S::BN, orow = tid / S::BN;
  const int p = p0 + oc;
  if (p >= s.P) return;
  if (final_out) {
    const int n = p / s.HW, hw = p - n * s.HW;
    T* o = static_cast<T*>(dst) + (size_t)n * s.CO * s.HW + hw;
    for (int r = orow; r < S::BM && co0 + r < s.CO; r += GROUPS)
      o[(size_t)(co0 + r) * s.HW] =
          codo::from_f32<T>(relu(c_s[r * S::C_LD + oc]));
  } else {
    float* part = static_cast<float*>(dst) + (size_t)blockIdx.z * s.CO * s.P;
    for (int r = orow; r < S::BM && co0 + r < s.CO; r += GROUPS)
      part[(size_t)(co0 + r) * s.P + p] = c_s[r * S::C_LD + oc];
  }
}

// out (N, CO, HW) = relu(sum over splits of partial (splits, CO, N*HW)),
// in split order: deterministic.  Four outputs a thread, read as float4
// (HW a multiple of 4, so the four share an image and a channel); 32-bit
// indices (codo_pad_conv_relu_reduce refuses CO·N·HW of 2³¹ or more).
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial,
                              T* __restrict__ out, int splits, int CO, int N,
                              int HW) {
  const int P = N * HW, total = CO * P;
  for (int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x); i < total;
       i += 4 * gridDim.x * blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 u = *reinterpret_cast<const float4*>(
          partial + (size_t)sp * total + i);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    int o = i;                            // N = 1: out is partial's layout
    if (N > 1) {
      const int co = i / P, pp = i - co * P, n = pp / HW;
      o = (n * CO + co) * HW + (pp - n * HW);
    }
    out[o] = codo::from_f32<T>(relu(v.x));
    out[o + 1] = codo::from_f32<T>(relu(v.y));
    out[o + 2] = codo::from_f32<T>(relu(v.z));
    out[o + 3] = codo::from_f32<T>(relu(v.w));
  }
}

// The same one output a thread, for HW not a multiple of 4.
template <typename T>
__global__ void reduce1_kernel(const float* __restrict__ partial,
                               T* __restrict__ out, int splits, int CO, int N,
                               int HW) {
  const int P = N * HW, total = CO * P;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[(size_t)sp * total + i];
    const int co = i / P, pp = i - co * P, n = pp / HW;
    out[(n * CO + co) * HW + (pp - n * HW)] = codo::from_f32<T>(relu(v));
  }
}

template <typename T, typename S, bool PROMOTE>
int launch_conv(const void* x, const void* w, void* dst, const Shape& s,
                int per, int splits, int final_out, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, true, S>();
  cudaError_t err = codo::set_smem<conv_kernel<T, S, PROMOTE>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s.P + S::BN - 1) / S::BN, (s.CO + S::BM - 1) / S::BM, splits);
  conv_kernel<T, S, PROMOTE><<<grid, S::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), dst, s, per,
      final_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* partial, void* out, int splits, int CO, int N,
                  int HW, cudaStream_t stream) {
  const int threads = 256;
  const bool by4 = HW % 4 == 0;
  long long blocks = ((long long)CO * N * HW / (by4 ? 4 : 1) + threads - 1) /
                     threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  auto* kernel = by4 ? &reduce_kernel<T> : &reduce1_kernel<T>;
  kernel<<<(int)blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), splits, CO, N,
      HW);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch conv_kernel over a (P/128, CO/rows, splits) grid, rows = 64
// (the narrow tile, each stage promoted) or 128 (the wide tile), each
// split `per` deep (a multiple of 32) except the last.  final_out = 1
// (only with one split): dst is out (N, CO, H, W) in the element type;
// otherwise dst is the float32 partial (splits, CO, N*H*W) for
// codo_pad_conv_relu_reduce.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, tile or split the kernel does not
// take.
extern "C" int codo_pad_conv_relu(int dtype, const void* x, const void* w,
                                  void* dst, int N, int C, int H, int W,
                                  int CO, int K, int rows, int per,
                                  int splits, int final_out, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || CO <= 0 || K <= 0 ||
      K % 2 != 1 || (rows != NarrowTile::BM && rows != WideTile::BM) ||
      per <= 0 || per % BK != 0 || splits <= 0 || splits > 65535 ||
      (CO + rows - 1) / rows > 65535 ||
      (long long)per * (splits - 1) >= (long long)C * K * K ||
      (long long)N * C * H * W >= (1ll << 31) ||
      (long long)N * CO * H * W >= (1ll << 31) ||
      (final_out != 0) != (splits == 1))
    return (int)cudaErrorInvalidValue;
  Shape s{N, C, H, W, CO, K, K / 2, H * W, N * H * W, K * K, C * K * K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = rows == WideTile::BM;
  auto* fn = dtype == codo::kBF16
                 ? (wide ? &launch_conv<__nv_bfloat16, WideTile, false>
                         : &launch_conv<__nv_bfloat16, NarrowTile, true>)
                 : (wide ? &launch_conv<float, WideTile, false>
                         : &launch_conv<float, NarrowTile, true>);
  return fn(x, w, dst, s, per, splits, final_out, st);
}

// Launch reduce_kernel: out (N, CO, H, W) in the element type.
extern "C" int codo_pad_conv_relu_reduce(int dtype, const void* partial,
                                         void* out, int splits, int CO, int N,
                                         int HW, void* stream) {
  if (splits <= 0 || CO <= 0 || N <= 0 || HW <= 0 ||
      (long long)CO * N * HW >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_reduce<__nv_bfloat16>(partial, out, splits, CO, N, HW, st);
  return launch_reduce<float>(partial, out, splits, CO, N, HW, st);
}
