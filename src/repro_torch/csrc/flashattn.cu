// Streaming flash attention for Hopper (sm_90a), float32 accumulation.
//
// Replaces: repro/kernels/flashattn/flashattn.py: flash_attention (the
// pl.pallas_call kernel _flash_kernel).  Same contract: q (B, Hq, Sq, hd),
// k/v (B, Hkv, Sk, hd), GQA maps q head h to kv head h / (Hq / Hkv),
// causal and sliding-window masks set scores to -1e30, online softmax over
// key tiles, output acc / max(l, 1e-30) in q's type.  Unlike the TPU kernel
// the ragged edge is masked (keys past Sk take no weight, rows past Sq are
// not written) instead of asserting divisibility, every operand is read
// through its own strides (the routed chain hands k over as a transposed
// view of kᵀ, never copied), and the scale is a parameter (the chain's own
// constant instead of 1/sqrt(hd) with a pre-scaled q).
//
// What bounds it on this card: 4·Sq·Sk·hd flops against 4·(3+1)·S·hd
// bytes, so operations: at mha_batched (16 heads, S = 2048, hd = 256)
// 68.7 GFLOP, 1.03 ms on the float32 CUDA cores (67 TFLOP/s) and ~0.42 ms
// at ~165 TFLOP/s of float32-accurate work on the TF32 tensor cores (three
// products a multiply).  The routed gpt2_block chain is single-head with hd
// = 1024: a 64-row float32 accumulator of 1024 columns does not fit a
// block's registers, and with B·H = 1 the only parallelism is Sq / rows.
//
// What the design does about it: a block of 4 warps owns 64 query rows,
// one warp on each 16, and one contiguous split of the key tiles
// (flash-decoding style; the wrapper splits keys only where the grid falls
// short of the card).  QKᵀ and PV run on mma.sync m16n8k8 TF32 with the
// 3×TF32 split (mma_tf32.cuh; bfloat16 operands, exact in TF32, take one
// pass); each 32-deep stage of QKᵀ goes into a fresh accumulator added
// into the scores with round-to-nearest adds, since the tensor cores'
// float32 accumulation truncates (at gpt2_block's hd = 1024 the scores
// reach ~100 before the scale).  A warp scores all 64 keys of a tile for
// its 16 rows and accumulates every output column, so the online softmax
// runs on the mma accumulator's layout with no exchange between warps: a
// row lives on the four lanes of a quad (quad_max, quad_sum in
// online_softmax.cuh), and the probabilities stay in registers as the A
// operand of PV.  K and V tiles of 64 keys stream through two cp.async
// buffers, one barrier a stage; a kᵀ view (the routed chains hand k over
// so) is copied in 16-byte vectors
// along the keys and kept transposed, d by d.  Above hd = 256 a cluster
// of ceil(hd / 256) blocks shares each q tile: each computes the partial
// scores over its 256 head-dim columns, the partials are summed in rank
// order through distributed shared memory, and each block runs the same
// softmax and PV for its 256 output columns.  With one split the block
// writes the output; otherwise each split writes its unnormalized
// accumulator with its max and denominator and a second kernel combines
// the splits in a fixed order.  No atomics: results repeat bit for bit.

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"
#include "online_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace codo_softmax;

constexpr int MQ = 64;          // query rows a block, 16 a warp
constexpr int MK = 64;          // keys a tile
constexpr int FTHREADS = 128;   // 4 warps
constexpr int XCH = 4 * 8 * 32 * 4;   // floats of a block's score tile

// Row strides in shared memory (elements), each row 16 bytes longer than
// its data so that every row starts 16-byte aligned for cp.async and
// fragment reads are conflict-free: the q, K and V tiles row by row, and a
// K tile stored transposed, d by d, when k arrives as a kᵀ view (keys
// contiguous in memory).
template <typename T, int HDP>
__host__ __device__ constexpr int tile_ld() {
  return HDP + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int kt_ld() {
  return MK + 16 / (int)sizeof(T);
}

template <typename T, int HDP>
__host__ __device__ constexpr int kv_buf() {
  return MQ * tile_ld<T, HDP>() > HDP * kt_ld<T>() ? MQ * tile_ld<T, HDP>()
                                                   : HDP * kt_ld<T>();
}

template <typename T, int HDP>
__host__ __device__ constexpr size_t mma_smem() {
  return sizeof(T) * ((size_t)MQ * tile_ld<T, HDP>() + 2 * kv_buf<T, HDP>()) +
         (HDP == 256 ? sizeof(float) * XCH : 0);
}

// The cluster barrier in its two halves: arrive (release: this block's
// shared-memory writes are visible) and wait (acquire: every block has
// arrived).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (q tiles · c, B·Hq, splits); with c > 1 (hd > 256, HDP = 256) the c
// blocks of a cluster share one q tile, block rank r holding head-dim
// columns 256r...  KT: k is a kᵀ view, its tiles kept d by d.  A block
// walks its split's key tiles in stages — K tile j, then V tile j —
// through two cp.async buffers with one barrier a stage.  final: write
// acc / max(l, 1e-30) to o; else the split's unnormalized accumulator,
// max and denominator to part_o / part_ml.
template <typename T, int HDP, bool KT>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ part_o,
                     float* __restrict__ part_ml, T* __restrict__ o,
                     Strides os, int Hq, int Hkv, int Sq, int Sk, int hd,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal, int window, int tiles_per_split, int c,
                     int final_out) {
  using namespace codo_mma;
  constexpr int P = Passes<T>::value;
  constexpr int LD = tile_ld<T, HDP>();
  constexpr int KT_LD = kt_ld<T>();
  constexpr int BUF = kv_buf<T, HDP>();
  constexpr int NTO = HDP / 8;   // output n-tiles a warp
  constexpr int NTS = MK / 8;    // score n-tiles a warp
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);           // [MQ][LD]
  T* kv_s = q_s + MQ * LD;                         // 2 × BUF
  float* x_s = reinterpret_cast<float*>(kv_s + 2 * BUF);  // [XCH], HDP 256

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int rank = 0;
  if constexpr (HDP == 256) rank = (int)cg::this_cluster().block_rank();
  const int q0 = (blockIdx.x / c) * MQ;
  const int d0 = rank * HDP;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * qs.b + h * qs.h + q0 * qs.s + d0 * qs.d;
  const T* kb = k + b * ks.b + hk * ks.h + d0 * ks.d;
  const T* vb = v + b * vs.b + hk * vs.h + d0 * vs.d;
  const bool k_vec = KT ? vec_ok(kb, ks.d, ks.s, Sk)
                        : vec_ok(kb, ks.s, ks.d, hd - d0);
  const bool v_vec = vec_ok(vb, vs.s, vs.d, hd - d0);

  // Key tiles this block walks: its split, minus tiles that every row of
  // the q tile masks.  Those add exactly nothing once a row has a visible
  // key (exp(-1e30 - m) is 0 in float32, and a leading all-masked stretch
  // is wiped by the first correction factor), and with Sq <= Sk row q
  // always sees key q; otherwise every tile is walked, as on the TPU.
  int kt_begin = blockIdx.z * tiles_per_split;
  int kt_end = min((Sk + MK - 1) / MK, kt_begin + tiles_per_split);
  if (Sq <= Sk) {
    if (causal) kt_end = min(kt_end, (min(q0 + MQ, Sq) - 1) / MK + 1);
    if (window) kt_begin = max(kt_begin, max(0, q0 - window + 1) / MK);
  }
  const int stages = 2 * max(0, kt_end - kt_begin);

  auto load_kv = [=](int st, int buf) {
    const int k0 = (kt_begin + st / 2) * MK;
    T* dst = kv_s + buf * BUF;
    if (st & 1)
      load_tile<T, FTHREADS>(dst, LD, vb + k0 * vs.s, vs.s, vs.d, MK, HDP,
                             Sk - k0, hd - d0, v_vec, tid);
    else if (KT)
      load_tile<T, FTHREADS>(dst, KT_LD, kb + k0, ks.d, 1, HDP, MK, hd - d0,
                             Sk - k0, k_vec, tid);
    else
      load_tile<T, FTHREADS>(dst, LD, kb + k0 * ks.s, ks.s, ks.d, MK, HDP,
                             Sk - k0, hd - d0, k_vec, tid);
    cp_async_commit();
  };

  load_tile<T, FTHREADS>(q_s, LD, qb, qs.s, qs.d, MQ, HDP, Sq - q0, hd - d0,
                         vec_ok(qb, qs.s, qs.d, hd - d0), tid);
  if (stages > 0) load_kv(0, 0);
  else cp_async_commit();

  float acc[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float p[NTS][4];                  // scores, then probabilities, of a tile
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g+8
  const int row0 = warp * 16 + g;   // the warp's rows row0 and row0 + 8
  bool reading = false;   // a cluster barrier arrival awaits its wait

  for (int st = 0; st < stages; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < stages) load_kv(st + 1, (st + 1) & 1);
    const T* tile = kv_s + (st & 1) * BUF;
    const int k0 = (kt_begin + st / 2) * MK;
    if ((st & 1) == 0) {
      // ---- scores: p = q (16 × HDP) · Kᵀ (HDP × 64), each 32-deep stage
      // into a fresh accumulator added into p with round-to-nearest adds
      // (the tensor cores' own float32 accumulation truncates) ----
#pragma unroll
      for (int j = 0; j < NTS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll 1
      for (int ks0 = 0; ks0 < HDP; ks0 += 32) {
        float fresh[NTS][4] = {};
#pragma unroll
        for (int kk = ks0; kk < ks0 + 32; kk += 8) {
          const T* qr = q_s + row0 * LD + kk + t;
          FragA<P> fa;
          fa.set(codo::to_f32(qr[0]), codo::to_f32(qr[8 * LD]),
                 codo::to_f32(qr[4]), codo::to_f32(qr[8 * LD + 4]));
#pragma unroll
          for (int j = 0; j < NTS; ++j) {
            FragB<P> fb;
            if constexpr (KT) {
              const T* kr = tile + (kk + t) * KT_LD + j * 8 + g;
              fb.set(codo::to_f32(kr[0]), codo::to_f32(kr[4 * KT_LD]));
            } else {
              const T* kr = tile + (j * 8 + g) * LD + kk + t;
              fb.set(codo::to_f32(kr[0]), codo::to_f32(kr[4]));
            }
            mma_f32<P>(fresh[j], fa, fb);
          }
        }
#pragma unroll
        for (int j = 0; j < NTS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[j][e] = __fadd_rn(p[j][e], fresh[j][e]);
      }
      if constexpr (HDP == 256) {
        if (c > 1) {
          // The partial scores of the c head-dim slices, summed in rank
          // order through distributed shared memory: every block of the
          // cluster gets the same sum, so the same softmax.  The barrier
          // after the reads is waited for only before the next tile's
          // writes, so it overlaps this tile's softmax and PV.
          cg::cluster_group cluster = cg::this_cluster();
          float4* x4 = reinterpret_cast<float4*>(x_s);
          if (reading) cluster_wait();
#pragma unroll
          for (int j = 0; j < NTS; ++j)
            x4[(warp * NTS + j) * 32 + lane] =
                make_float4(p[j][0], p[j][1], p[j][2], p[j][3]);
          cluster_arrive();
          cluster_wait();
          for (int r = 0; r < c; ++r) {
            const float4* src = reinterpret_cast<const float4*>(
                cluster.map_shared_rank(x_s, r));
#pragma unroll
            for (int j = 0; j < NTS; ++j) {
              const float4 s4 = src[(warp * NTS + j) * 32 + lane];
              const float part[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p[j][e] = r == 0 ? part[e] : p[j][e] + part[e];
            }
          }
          cluster_arrive();
          reading = true;
        }
      }
      // ---- scale, mask (-1e30 as on the TPU; keys past Sk take no
      // weight) and the online softmax of rows row0, row0 + 8: a quad of
      // lanes holds a row ----
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NTS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + row0 + (e >= 2 ? 8 : 0);
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          float x;
          if (kpos >= Sk) {
            x = -INFINITY;
          } else {
            bool keep = true;
            if (causal) keep = keep && qpos >= kpos;
            if (window) keep = keep && (qpos - kpos) < window;
            x = keep ? p[j][e] * scale : NEG_INF;
          }
          p[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NTS; ++j) {
          p[j][2 * i] = expf(p[j][2 * i] - m_new);
          p[j][2 * i + 1] = expf(p[j][2 * i + 1] - m_new);
          sum += p[j][2 * i] + p[j][2 * i + 1];
        }
        const float corr = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * corr + quad_sum(sum);
        m_run[i] = m_new;
#pragma unroll
        for (int n = 0; n < NTO; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }
    } else {
      // ---- acc += p (16 × 64) · V (64 × HDP), p from registers: the
      // accumulator's columns 2t, 2t+1 of key tile j are the A fragment's
      // k = t, t+4, so V's rows are read in that order ----
#pragma unroll
      for (int j = 0; j < NTS; ++j) {
        FragA<P> fa;
        fa.set(p[j][0], p[j][2], p[j][1], p[j][3]);
        const T* vr = tile + (j * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NTO; ++n) {
          FragB<P> fb;
          fb.set(codo::to_f32(vr[n * 8]), codo::to_f32(vr[LD + n * 8]));
          mma_f32<P>(acc[n], fa, fb);
        }
      }
    }
  }
  cp_async_wait_all();   // nothing in flight when the block ends
  if (reading) cluster_wait();   // no block leaves while another reads it

  // ---- the output rows row0, row0 + 8 of this block's columns ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qr = q0 + row0 + 8 * half;
    if (qr >= Sq) continue;
    if (final_out) {
      const float inv_l = 1.f / fmaxf(l_run[half], 1e-30f);
      T* orow = o + b * os.b + h * os.h + qr * os.s;
#pragma unroll
      for (int n = 0; n < NTO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = d0 + n * 8 + 2 * t + e;
          if (col < hd)
            orow[col * os.d] = codo::from_f32<T>(acc[n][2 * half + e] * inv_l);
        }
    } else {
      const size_t at = ((size_t)blockIdx.z * BH + bh) * Sq + qr;
#pragma unroll
      for (int n = 0; n < NTO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = d0 + n * 8 + 2 * t + e;
          if (col < hd) part_o[at * hd + col] = acc[n][2 * half + e];
        }
      if (rank == 0 && t == 0) {
        part_ml[at * 2] = m_run[half];
        part_ml[at * 2 + 1] = l_run[half];
      }
    }
  }
}

template <typename T, int HDP, bool KT>
int launch_mma_hdp(const void* q, const void* k, const void* v, float* part_o,
                   float* part_ml, void* o, const Strides& os, int B, int Hq,
                   int Hkv, int Sq, int Sk, int hd, const Strides& qs,
                   const Strides& ks, const Strides& vs, float scale,
                   int causal, int window, int splits, int tiles_per_split,
                   int c, cudaStream_t stream) {
  const size_t smem = mma_smem<T, HDP>();
  cudaError_t err = codo::set_smem<flash_mma_kernel<T, HDP, KT>>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((Sq + MQ - 1) / MQ) * c, B * Hq, splits);
  cfg.blockDim = dim3(FTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, flash_mma_kernel<T, HDP, KT>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), part_o, part_ml,
      static_cast<T*>(o), os, Hq, Hkv, Sq, Sk, hd, qs, ks, vs, scale, causal,
      window, tiles_per_split, c, splits == 1 ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// HDP: the head-dim columns a block holds, the least of 32, 64, 128, 256
// that covers hd; above 256, clusters of c = ceil(hd / 256) blocks.
template <typename T>
int launch_mma(const void* q, const void* k, const void* v, float* part_o,
               float* part_ml, void* o, const Strides& os, int B, int Hq,
               int Hkv, int Sq, int Sk, int hd, const Strides& qs,
               const Strides& ks, const Strides& vs, float scale, int causal,
               int window, int splits, int tiles_per_split,
               cudaStream_t stream) {
  const bool kt = ks.s == 1 && ks.d != 1;   // kᵀ view: K tiles stored by d
#define CODO_FLASH_HDP(N, C)                                                 \
  return kt ? launch_mma_hdp<T, N, true>(q, k, v, part_o, part_ml, o, os, B, \
                                         Hq, Hkv, Sq, Sk, hd, qs, ks, vs,    \
                                         scale, causal, window, splits,      \
                                         tiles_per_split, C, stream)         \
            : launch_mma_hdp<T, N, false>(q, k, v, part_o, part_ml, o, os,   \
                                          B, Hq, Hkv, Sq, Sk, hd, qs, ks, vs, \
                                          scale, causal, window, splits,     \
                                          tiles_per_split, C, stream);
  if (hd <= 32) CODO_FLASH_HDP(32, 1)
  if (hd <= 64) CODO_FLASH_HDP(64, 1)
  if (hd <= 128) CODO_FLASH_HDP(128, 1)
  if (hd <= 1024) CODO_FLASH_HDP(256, (hd + 255) / 256)
#undef CODO_FLASH_HDP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch the attention kernel over (ceil(Sq/64)·c, B·Hq, splits) blocks,
// clusters of c = ceil(hd / 256) above hd = 256; each block walks
// tiles_per_split 64-key tiles.  strides: 12 element strides, (b, h, s, d)
// of q, k and v.  With one split the kernel writes o (strided by
// o_strides); otherwise part_o (splits, B·Hq, Sq, hd) and part_ml (splits,
// B·Hq, Sq, 2) are float32 scratch for codo_flash_combine.  Returns the
// launch's CUDA error, or cudaErrorInvalidValue for hd > 1024.
extern "C" int codo_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* part_o,
                                    void* part_ml, void* o,
                                    const long long* o_strides, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int hd,
                                    const long long* strides, float scale,
                                    int causal, int window, int splits,
                                    int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  const Strides qs{strides[0], strides[1], strides[2], strides[3]},
      ks{strides[4], strides[5], strides[6], strides[7]},
      vs{strides[8], strides[9], strides[10], strides[11]},
      os{o_strides[0], o_strides[1], o_strides[2], o_strides[3]};
  if (dtype == codo::kBF16)
    return launch_mma<__nv_bfloat16>(q, k, v, po, pml, o, os, B, Hq, Hkv, Sq,
                                     Sk, hd, qs, ks, vs, scale, causal, window,
                                     splits, tiles_per_split, s);
  return launch_mma<float>(q, k, v, po, pml, o, os, B, Hq, Hkv, Sq, Sk, hd, qs,
                           ks, vs, scale, causal, window, splits,
                           tiles_per_split, s);
}

// Launch combine_kernel: one block per (b·h, q) row, o strided (b, h, s, d)
// in the operands' type.
extern "C" int codo_flash_combine(int dtype, const void* part_o,
                                  const void* part_ml, void* o, int splits,
                                  int BH, int Hq, int Sq, int hd,
                                  const long long* o_strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides os{o_strides[0], o_strides[1], o_strides[2], o_strides[3]};
  const int threads = hd >= 256 ? 256 : 64;
  const float* po = static_cast<const float*>(part_o);
  const float* pml = static_cast<const float*>(part_ml);
  if (dtype == codo::kBF16)
    combine_kernel<__nv_bfloat16><<<BH * Sq, threads, 0, s>>>(
        po, pml, static_cast<__nv_bfloat16*>(o), splits, BH, Hq, Sq, hd, os);
  else
    combine_kernel<float><<<BH * Sq, threads, 0, s>>>(
        po, pml, static_cast<float*>(o), splits, BH, Hq, Sq, hd, os);
  return (int)cudaGetLastError();
}
