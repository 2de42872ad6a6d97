// Fused matmul chain ew(a @ w1) @ w2 for Hopper (sm_90a), float32
// accumulation.
//
// Replaces: repro/kernels/streamfuse/chain.py: fused_matmul_chain (the
// pl.pallas_call kernel _chain_kernel), routed as streamfuse.mmchain.
// Same contract: a (M, K), w1 (K, N1), w2 (N1, N2), one element type for
// all three (float32 or bfloat16), products accumulated in float32, the
// elementwise tail applied to the f32 intermediate, output in a's type.
// The intermediate h = ew(a @ w1) goes to device memory only as the
// small-M form's split partials of a @ w1 (splits × M × N1 floats, under
// 1 MB at VGG-16's head, L2-resident); the large-M form keeps it in
// shared memory.
//
// What bounds it on this card: at one row (VGG-16's head, 1 × 25088 × 512
// × 512) the work is a matrix-vector product bound by bytes: w1 is 51.4
// MB, 0.0157 ms at 3.35 TB/s.  On gpt2_block's FFN (K = 1024, N1 = 4096,
// N2 = 1024, float32) it is 4·M·K·N1 flops, bound by operations: 67
// TFLOP/s on the float32 CUDA cores, ~165 TFLOP/s of float32-accurate work
// on the TF32 tensor cores at three products a multiply.  The TPU kernel
// holds both weights whole (32 MiB) and walks M in row blocks; a Hopper
// block has 227 KB.
//
// What the design does about it: two forms, picked by shape in the
// wrapper (kernels/streamfuse/chain.py).
//  * Small M (up to 16 rows): a K-split GEMV over at least 264 blocks;
//    each block streams its slab of w1 once in 16-byte coalesced loads
//    (eight lanes on each 128-byte row segment, 32 rows in flight) and
//    writes a float32 partial of a @ w1.  A second kernel sums the splits
//    in a fixed order, applies the tail to real elements only and
//    multiplies by w2 the same way.  Plain FMAs: the bytes bound it.
//  * Large M: 64-row tiles on mma.sync m16n8k8 TF32 with the 3×TF32 split
//    (mma_tf32.cuh; bfloat16 operands exact in one pass), a and weight
//    tiles double-buffered through cp.async, one barrier a stage.  Each
//    32-deep stage goes into a fresh accumulator that is added into the
//    running one with round-to-nearest adds: the tensor cores' float32
//    accumulation truncates, and over gpt2_block's K = 1024 whole it
//    erred 5.6 times as much as cuBLAS float32.  A
//    thread-block cluster of c blocks shares one chunk of bn1 = 64·c
//    columns of h: each block computes 64 of them into its own shared
//    memory, then, after cluster.sync(), computes its share of the output
//    columns over the whole chunk, reading the other blocks' slices
//    through distributed shared memory.  So the grid has c blocks a chunk
//    without c times the float32 partials that a second kernel sums over
//    the chunks in a fixed order.
// No atomics anywhere: results repeat bit for bit.
//
// The tail arrives as op codes plus two float attributes per op (the
// EW_KINDS of repro/kernels/streamfuse/ops.py), never as a closure.

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace codo_mma;

constexpr int MAX_EW = 8;

enum EwOp {
  kIdentity = 0,
  kRelu = 1,
  kGelu = 2,     // tanh approximation (jax.nn.gelu's default)
  kScale = 3,    // x * a
  kAffine = 4,   // a * x + b, with a = ±1 exact
  kDivc = 5,     // x / a
  kRdivc = 6,    // a / x
};

struct EwChain {
  int n;
  int op[MAX_EW];
  float a[MAX_EW];
  float b[MAX_EW];
};

__device__ __forceinline__ float apply_ew(float x, const EwChain& ew) {
  for (int i = 0; i < ew.n; ++i) {
    const float a = ew.a[i];
    switch (ew.op[i]) {
      case kRelu:
        x = x < 0.f ? 0.f : x;
        break;
      case kGelu: {
        const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
        x = 0.5f * x * (1.f + tanhf(inner));
        break;
      }
      case kScale:
        x = __fmul_rn(x, a);
        break;
      case kAffine: {
        const float y = a == 1.f ? x : (a == -1.f ? -x : __fmul_rn(a, x));
        x = __fadd_rn(y, ew.b[i]);
        break;
      }
      case kDivc:
        x = __fdiv_rn(x, a);
        break;
      case kRdivc:
        x = __fdiv_rn(a, x);
        break;
      default:
        break;
    }
  }
  return x;
}

// ======================= large-M form: cluster + mma =======================

constexpr int BM = 64;         // rows of a a block
constexpr int BN = 64;         // h columns a block owns; output columns a pass
constexpr int BK = 32;         // contraction depth a stage
constexpr int THREADS = 128;   // 4 warps, 2 × 2, each a 32 × 32 tile
constexpr int H_LD = BN + 4;   // h slice row stride (floats)
constexpr int F_LD = BK + 4;   // float a-tile row stride (36: no conflicts)
constexpr int W_LD = BN + 8;   // weight tile row stride (elements)
constexpr int A_BUF = BM * F_LD;   // floats of one a-tile buffer
constexpr int W_BUF = BK * W_LD;   // elements of one weight-tile buffer

// a-tile row stride in elements: 16-byte rows for cp.async.
template <typename T>
__host__ __device__ constexpr int a_ld() {
  return BK + 16 / (int)sizeof(T);
}

// acc[i][j] += the warp's 32 × 32 tile of As (BM × BK) · Bs (BK × BN):
// rows wm·32 + 16i.., columns wn·32 + 8j...  The stage's products go into
// a fresh accumulator, which is then added into acc with round-to-nearest
// adds: the tensor cores' own float32 accumulation truncates, so it never
// carries more than one BK-deep stage (the promotion of mma_gemm.cuh's
// ring_product).
template <int PASSES, typename TA, typename TB>
__device__ __forceinline__ void tile_mma(float (&acc)[2][4][4], const TA* As,
                                         int lda, const TB* Bs, int wm,
                                         int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float fresh[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    FragA<PASSES> fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const TA* r = As + (wm * 32 + i * 16 + g) * lda + kk + t;
      fa[i].set(codo::to_f32(r[0]), codo::to_f32(r[8 * lda]),
                codo::to_f32(r[4]), codo::to_f32(r[8 * lda + 4]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const TB* c = Bs + (kk + t) * W_LD + wn * 32 + j * 8 + g;
      FragB<PASSES> fb;
      fb.set(codo::to_f32(c[0]), codo::to_f32(c[4 * W_LD]));
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_f32<PASSES>(fresh[i][j], fa[i], fb);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e], fresh[i][j][e]);
}

// Row and column (in the block's 64 × 64 tile) of accumulator element e
// of fragment (i, j).
__device__ __forceinline__ int acc_row(int wm, int i, int e, int lane) {
  return wm * 32 + i * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int wn, int j, int e, int lane) {
  return wn * 32 + j * 8 + 2 * (lane & 3) + (e & 1);
}

// An h tile (BM × BK floats, columns kk.. of a slice at src, row stride
// H_LD) into registers, PRE float4 a thread; then into an a-tile buffer.
template <int PRE>
__device__ __forceinline__ void fetch_h(float4 (&pre)[PRE], const float* src,
                                        int kk, int tid) {
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int i = tid + u * THREADS, r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
    pre[u] = *reinterpret_cast<const float4*>(src + r * H_LD + kk + c4);
  }
}

template <int PRE>
__device__ __forceinline__ void stash_h(float* dst, const float4 (&pre)[PRE],
                                        int tid) {
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int i = tid + u * THREADS, r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * F_LD + c4) = pre[u];
  }
}

// Grid (chunks · c, ceil(M / 64)), clusters of c blocks along x.  Block
// rank r of chunk ch computes h columns ch·64c + 64r.. into h_s, then
// output columns [r·ncr, (r + 1)·ncr) of partial[ch] over the chunk's
// 64c columns of h, rank by rank.  Three blocks an SM: left to itself
// ptxas gives the promoted tile 234 registers, which holds two blocks an
// SM and runs a fifth slower.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    chain_kernel(const T* __restrict__ a, const T* __restrict__ w1,
                 const T* __restrict__ w2, float* __restrict__ partial, int M,
                 int K, int N1, int N2, int c, int ncr, EwChain ew) {
  constexpr int P = Passes<T>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / c;
  const int m0 = blockIdx.y * BM;
  const int bn1 = BN * c;
  const int h0 = chunk * bn1 + rank * BN;

  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // [BM][H_LD]
  float* a_f = h_s + BM * H_LD;                     // 2 × [BM][F_LD]
  T* w_s = reinterpret_cast<T*>(a_f + 2 * A_BUF);   // 2 × [BK][W_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  // ---- phase 1: h_s = ew(a[m0.., :] @ w1[:, h0..h0+64]) ----
  {
    const bool a_vec = vec_ok(a, K, 1, K), w_vec = vec_ok(w1, N1, 1, N1);
    const int stages = (K + BK - 1) / BK;
    auto load = [=](int s, int buf) {
      const int k0 = s * BK;
      load_tile<T, THREADS>(reinterpret_cast<T*>(a_f + buf * A_BUF), a_ld<T>(),
                            a + (size_t)m0 * K + k0, K, 1, BM, BK, M - m0,
                            K - k0, a_vec, tid);
      load_tile<T, THREADS>(w_s + buf * W_BUF, W_LD, w1 + (size_t)k0 * N1 + h0,
                            N1, 1, BK, BN, K - k0, N1 - h0, w_vec, tid);
      cp_async_commit();
    };
    float acc[2][4][4] = {};
    load(0, 0);
    for (int s = 0; s < stages; ++s) {
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < stages) load(s + 1, (s + 1) & 1);  // stage s - 1's buffer
      tile_mma<P>(acc, reinterpret_cast<const T*>(a_f + (s & 1) * A_BUF),
                  a_ld<T>(), w_s + (s & 1) * W_BUF, wm, wn, lane);
    }
    // The tail runs on real elements only: padded entries stay 0 so that
    // they add nothing in phase 2 (an affine or rdivc tail would not).
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(wm, i, e, lane);
          const int col = acc_col(wn, j, e, lane);
          h_s[r * H_LD + col] = (m0 + r < M && h0 + col < N1)
                                    ? apply_ew(acc[i][j][e], ew)
                                    : 0.f;
        }
  }
  cluster.sync();   // every slice of the chunk's h is in place

  // ---- phase 2: partial[chunk] = h(chunk) @ w2[chunk rows, r·ncr..] ----
  const bool w_vec = vec_ok(w2, N2, 1, N2);
  const int dstages = c * (BN / BK);
  float* out = partial + (size_t)chunk * M * N2;
  const int n_end = min(N2, (rank + 1) * ncr);
  constexpr int PRE = BM * BK / 4 / THREADS;   // float4 of h a thread moves
  for (int n0 = rank * ncr; n0 < n_end; n0 += BN) {
    float4 pre[PRE];
    auto load_w2 = [=](int s, int buf) {
      const int j0 = chunk * bn1 + s * BK;   // global row of w2 (h column)
      load_tile<T, THREADS>(w_s + buf * W_BUF, W_LD, w2 + (size_t)j0 * N2 + n0,
                            N2, 1, BK, BN, N1 - j0, N2 - n0, w_vec, tid);
      cp_async_commit();
    };
    float acc[2][4][4] = {};
    load_w2(0, 0);
    fetch_h(pre, cluster.map_shared_rank(h_s, 0), 0, tid);
    stash_h(a_f, pre, tid);
    for (int s = 0; s < dstages; ++s) {
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < dstages) load_w2(s + 1, (s + 1) & 1);
      // Stage s reads rank s / 2's slice, columns (s % 2)·32.., through
      // distributed shared memory; the next one is fetched ahead.
      if (s + 1 < dstages)
        fetch_h(pre, cluster.map_shared_rank(h_s, (s + 1) / (BN / BK)),
                ((s + 1) % (BN / BK)) * BK, tid);
      tile_mma<P>(acc, a_f + (s & 1) * A_BUF, F_LD, w_s + (s & 1) * W_BUF,
                  wm, wn, lane);
      if (s + 1 < dstages) stash_h(a_f + ((s + 1) & 1) * A_BUF, pre, tid);
    }
    __syncthreads();   // before the next pass writes buffer 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gm = m0 + acc_row(wm, i, e, lane);
          const int gn = n0 + acc_col(wn, j, e, lane);
          if (gm < M && gn < n_end) out[(size_t)gm * N2 + gn] = acc[i][j][e];
        }
  }
  cluster.sync();   // no block leaves while another still reads its h_s
}

// out = sum over chunks of partial, in chunk order: deterministic.
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ partial,
                              T* __restrict__ out, int chunks, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += partial[ch * mn + i];
    out[i] = codo::from_f32<T>(s);
  }
}

constexpr size_t main_smem() {
  return sizeof(float) * ((size_t)BM * H_LD + 2 * A_BUF + 2 * W_BUF);
}

template <typename T>
int launch_main(const void* a, const void* w1, const void* w2, void* partial,
                int M, int K, int N1, int N2, int c, int ncr,
                const EwChain& ew, cudaStream_t stream) {
  const size_t smem = main_smem();
  cudaError_t err = codo::set_smem<chain_kernel<T>>(smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (N1 + BN * c - 1) / (BN * c);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks * c, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chain_kernel<T>, static_cast<const T*>(a),
                           static_cast<const T*>(w1), static_cast<const T*>(w2),
                           static_cast<float*>(partial), M, K, N1, N2, c, ncr,
                           ew);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* partial, void* out, int chunks, long long mn,
                  cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (mn + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  reduce_kernel<T><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), chunks, mn);
  return (int)cudaGetLastError();
}

// ======================= small-M form: split GEMV ==========================

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_LPR = 8;                        // lanes a row: 128 bytes
constexpr int GV_RG = GV_THREADS / GV_LPR;       // row groups: 32

template <typename T>
__host__ __device__ constexpr int gv_vec() {
  return 16 / (int)sizeof(T);     // elements of one 16-byte load
}
template <typename T>
__host__ __device__ constexpr int gv_cols() {
  return GV_LPR * gv_vec<T>();    // columns of one block
}
// Rows a thread has in flight: more where the accumulator is small.
template <typename T, int MR>
__host__ __device__ constexpr int gv_unroll() {
  return MR * gv_vec<T>() <= 8    ? 8
         : MR * gv_vec<T>() <= 32 ? 4
         : MR * gv_vec<T>() <= 64 ? 2
                                  : 1;
}

// VEC elements of row r of w from column c (zero past n), as float.
template <typename T>
__device__ __forceinline__ void load_vec(float (&v)[gv_vec<T>()], const T* w,
                                         long long ld, int r, int c, int n,
                                         bool vec) {
  constexpr int VEC = gv_vec<T>();
  const T* p = w + (size_t)r * ld + c;
  if (vec && c + VEC <= n) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = codo::to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = c + i < n ? codo::to_f32(p[i]) : 0.f;
  }
}

// red[m·BC + col] = Σ_r x_s[m·ldx + r − r0] · w[r][c0 + col] over rows
// r0 ≤ r < r1.  A thread owns VEC columns (lane % 8) of row group
// warp·4 + lane / 8, which walks every 32nd row; the four row groups of a
// warp are summed by shuffles and the warps' sums in warp order, so the
// result is the same on every call.  red holds GV_WARPS × MR × BC floats.
template <typename T, int MR>
__device__ __forceinline__ void gemv_block(const float* x_s, int ldx,
                                           const T* w, long long ldw, int r0,
                                           int r1, int c0, int n, float* red,
                                           int tid) {
  constexpr int VEC = gv_vec<T>(), BC = gv_cols<T>(), U = gv_unroll<T, MR>();
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp * (32 / GV_LPR) + lane / GV_LPR;
  const int c = c0 + (lane % GV_LPR) * VEC;
  const bool vec = (ldw % VEC) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  float acc[MR][VEC];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[m][i] = 0.f;
  for (int r = r0 + rg; r < r1; r += GV_RG * U) {
    float wv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * GV_RG;
      if (rr < r1 && c < n) {
        load_vec<T>(wv[u], w, ldw, rr, c, n, vec);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) wv[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * GV_RG;
      if (rr >= r1) break;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xm = x_s[m * ldx + rr - r0];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[m][i] = fmaf(xm, wv[u][i], acc[m][i]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = acc[m][i];
      v += __shfl_xor_sync(0xffffffffu, v, GV_LPR);
      v += __shfl_xor_sync(0xffffffffu, v, 2 * GV_LPR);
      if (lane < GV_LPR) red[(warp * MR + m) * BC + lane * VEC + i] = v;
    }
  __syncthreads();
  for (int idx = tid; idx < MR * BC; idx += GV_THREADS) {
    float s = 0.f;
    for (int wp = 0; wp < GV_WARPS; ++wp) s += red[wp * MR * BC + idx];
    red[idx] = s;   // slot idx of warp 0, read only by this thread above
  }
  __syncthreads();
}

// Phase 1, grid (ceil(N1 / BC), splits): part[split] (M × N1, float32) =
// a[:, split's K rows] @ w1[those rows, block's columns].
template <typename T, int MR>
__global__ void __launch_bounds__(GV_THREADS)
    rows_kernel(const T* __restrict__ a, const T* __restrict__ w1,
                float* __restrict__ part, int M, int K, int N1, int kper) {
  constexpr int BC = gv_cols<T>();
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);   // [MR][kper]
  float* red = x_s + MR * kper;                     // [GV_WARPS][MR][BC]
  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * kper, k1 = min(K, k0 + kper);
  const int c0 = blockIdx.x * BC;
  for (int i = tid; i < MR * kper; i += GV_THREADS) {
    const int m = i / kper, kk = i - m * kper;
    x_s[i] = (m < M && k0 + kk < K) ? codo::to_f32(a[(size_t)m * K + k0 + kk])
                                    : 0.f;
  }
  __syncthreads();
  gemv_block<T, MR>(x_s, kper, w1, N1, k0, k1, c0, N1, red, tid);
  float* dst = part + (size_t)blockIdx.y * M * N1;
  for (int idx = tid; idx < MR * BC; idx += GV_THREADS) {
    const int m = idx / BC, n = c0 + idx % BC;
    if (m < M && n < N1) dst[(size_t)m * N1 + n] = red[idx];
  }
}

// Phase 2, grid ceil(N2 / BC): h = ew(Σ_split part) in split order (the
// tail on real elements only), out = h @ w2 over the block's columns.
template <typename T, int MR>
__global__ void __launch_bounds__(GV_THREADS)
    rows_out_kernel(const float* __restrict__ part, const T* __restrict__ w2,
                    T* __restrict__ out, int M, int N1, int N2, int splits,
                    EwChain ew) {
  constexpr int BC = gv_cols<T>();
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // [MR][N1]
  float* red = h_s + MR * N1;                       // [GV_WARPS][MR][BC]
  const int tid = threadIdx.x;
  for (int i = tid; i < MR * N1; i += GV_THREADS) {
    const int m = i / N1;
    float h = 0.f;
    if (m < M) {
      const size_t at = (size_t)m * N1 + (i - m * N1);
      float s = 0.f;
#pragma unroll 8
      for (int z = 0; z < splits; ++z) s += part[(size_t)z * M * N1 + at];
      h = apply_ew(s, ew);
    }
    h_s[i] = h;
  }
  __syncthreads();
  const int c0 = blockIdx.x * BC;
  gemv_block<T, MR>(h_s, N1, w2, N2, 0, N1, c0, N2, red, tid);
  for (int idx = tid; idx < MR * BC; idx += GV_THREADS) {
    const int m = idx / BC, n = c0 + idx % BC;
    if (m < M && n < N2) out[(size_t)m * N2 + n] = codo::from_f32<T>(red[idx]);
  }
}

template <typename T, int MR>
int launch_rows_mr(const void* a, const void* w1, void* part, int M, int K,
                   int N1, int kper, int splits, cudaStream_t stream) {
  constexpr int BC = gv_cols<T>();
  const size_t smem = sizeof(float) * ((size_t)MR * kper + GV_WARPS * MR * BC);
  cudaError_t err = codo::set_smem<rows_kernel<T, MR>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N1 + BC - 1) / BC, splits);
  rows_kernel<T, MR><<<grid, GV_THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w1),
      static_cast<float*>(part), M, K, N1, kper);
  return (int)cudaGetLastError();
}

template <typename T, int MR>
int launch_rows_out_mr(const void* part, const void* w2, void* out, int M,
                       int N1, int N2, int splits, const EwChain& ew,
                       cudaStream_t stream) {
  constexpr int BC = gv_cols<T>();
  const size_t smem = sizeof(float) * ((size_t)MR * N1 + GV_WARPS * MR * BC);
  cudaError_t err = codo::set_smem<rows_out_kernel<T, MR>>(smem);
  if (err != cudaSuccess) return (int)err;
  rows_out_kernel<T, MR><<<(N2 + BC - 1) / BC, GV_THREADS, smem, stream>>>(
      static_cast<const float*>(part), static_cast<const T*>(w2),
      static_cast<T*>(out), M, N1, N2, splits, ew);
  return (int)cudaGetLastError();
}

// MR: the rows the kernel is compiled for, the least power of 2 >= M.
#define CODO_BY_MR(CALL)                                   \
  if (M <= 1) return CALL(1);                              \
  if (M <= 2) return CALL(2);                              \
  if (M <= 4) return CALL(4);                              \
  if (M <= 8) return CALL(8);                              \
  if (M <= 16) return CALL(16);                            \
  return (int)cudaErrorInvalidValue;

template <typename T>
int launch_rows(const void* a, const void* w1, void* part, int M, int K,
                int N1, int kper, int splits, cudaStream_t stream) {
#define CODO_CALL(R) \
  launch_rows_mr<T, R>(a, w1, part, M, K, N1, kper, splits, stream)
  CODO_BY_MR(CODO_CALL)
#undef CODO_CALL
}

template <typename T>
int launch_rows_out(const void* part, const void* w2, void* out, int M,
                    int N1, int N2, int splits, const EwChain& ew,
                    cudaStream_t stream) {
#define CODO_CALL(R) \
  launch_rows_out_mr<T, R>(part, w2, out, M, N1, N2, splits, ew, stream)
  CODO_BY_MR(CODO_CALL)
#undef CODO_CALL
}
#undef CODO_BY_MR

bool ew_ok(const EwChain* ew) { return ew->n >= 0 && ew->n <= MAX_EW; }

}  // namespace

// The entry points take their shape as an int array (the wrapper builds
// one a shape) and the tail as an EwChain (n op codes with attributes a,
// b; built once a route): a launch's host time grows with its argument
// count.
//
// Large-M form: launch chain_kernel over clusters of c (1..8) blocks;
// shape {M, K, N1, N2, c, ncr}; partial (chunks, M, N2) float32 scratch,
// chunks = ceil(N1 / (64·c)); a block writes output columns [r·ncr, (r +
// 1)·ncr), ncr a multiple of 64.  Returns the launch's CUDA error, or
// cudaErrorInvalidValue for a c, ncr or tail the kernel does not take.
extern "C" int codo_matmul_chain(int dtype, const void* a, const void* w1,
                                 const void* w2, void* partial,
                                 const int* shape, const void* tail,
                                 void* stream) {
  const EwChain* ew = static_cast<const EwChain*>(tail);
  const int M = shape[0], K = shape[1], N1 = shape[2], N2 = shape[3],
            c = shape[4], ncr = shape[5];
  if (c < 1 || c > 8 || ncr <= 0 || ncr % BN != 0 || !ew_ok(ew))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_main<__nv_bfloat16>(a, w1, w2, partial, M, K, N1, N2, c,
                                      ncr, *ew, s);
  return launch_main<float>(a, w1, w2, partial, M, K, N1, N2, c, ncr, *ew,
                            s);
}

// Large-M form, second launch: out (M, N2) in the chain's element type.
extern "C" int codo_matmul_chain_reduce(int dtype, const void* partial,
                                        void* out, int chunks, long long mn,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_reduce<__nv_bfloat16>(partial, out, chunks, mn, s);
  return launch_reduce<float>(partial, out, chunks, mn, s);
}

// Small-M form (M <= 16), first launch: shape {M, K, N1, kper, splits};
// part (splits, M, N1) float32, split s covering K rows [s·kper, (s +
// 1)·kper).
extern "C" int codo_matmul_chain_rows(int dtype, const void* a,
                                      const void* w1, void* part,
                                      const int* shape, void* stream) {
  const int M = shape[0], K = shape[1], N1 = shape[2], kper = shape[3],
            splits = shape[4];
  if (kper <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_rows<__nv_bfloat16>(a, w1, part, M, K, N1, kper, splits, s);
  return launch_rows<float>(a, w1, part, M, K, N1, kper, splits, s);
}

// Small-M form, second launch: shape {M, K, N1, kper, splits} (its own),
// N2; out (M, N2) = ew(Σ part) @ w2.
extern "C" int codo_matmul_chain_rows_out(int dtype, const void* part,
                                          const void* w2, void* out,
                                          const int* shape, int N2,
                                          const void* tail, void* stream) {
  const EwChain* ew = static_cast<const EwChain*>(tail);
  if (!ew_ok(ew)) return (int)cudaErrorInvalidValue;
  const int M = shape[0], N1 = shape[2], splits = shape[4];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == codo::kBF16)
    return launch_rows_out<__nv_bfloat16>(part, w2, out, M, N1, N2, splits,
                                          *ew, s);
  return launch_rows_out<float>(part, w2, out, M, N1, N2, splits, *ew, s);
}
