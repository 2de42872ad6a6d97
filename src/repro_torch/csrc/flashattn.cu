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
// What bounds it on this card: the routed gpt2_block chain is single-head
// with hd = 1024, so the work is 4·Sq·Sk·hd flops on float32 CUDA cores
// (no TF32: 67 TFLOP/s peak) against 4·(3+1)·S·hd bytes; at S = 1024 it
// is compute-bound (64 µs of flops vs 5 µs of bytes), at S = 128 launch-
// bound.  Two things make hd = 1024 awkward: a (rows, hd) float32
// accumulator is 4 KB a row, and with B·H = 1 the only parallelism the
// TPU grid has is Sq / rows.
//
// What the design does about it: a block owns BQ = 16 query rows and one
// contiguous split of the key tiles (flash-decoding style), so the grid is
// (Sq/16, B·Hq, splits) and the wrapper picks splits to fill the SMs.  The
// q tile sits in dynamic shared memory; each of the 256 threads keeps a
// 4-row × (hd/64)-column slice of the accumulator in registers (64 floats
// at hd = 1024).  Scores are computed 2 rows × 2 keys a thread from float4
// shared-memory reads, and the online softmax runs in registers with warp
// shuffles (a warp owns two rows).  Each block writes its unnormalized
// accumulator with its running max and denominator; a second kernel
// combines the splits in a fixed order, so results repeat bit for bit.
// Simple CUDA-core FMAs; wgmma and TMA are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "online_softmax.cuh"

namespace {

using namespace codo_softmax;

constexpr int BQ = 16;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int DK = 64;          // hd columns per K chunk
constexpr int KPAD = DK + 4;    // K chunk row stride: float4-aligned, no conflicts
constexpr int BKV = 8;          // keys per V chunk
constexpr int THREADS = 256;    // 8 warps: warp w owns rows 2w, 2w+1

// NC: accumulator columns per thread (hd <= 64·NC).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ part_o,
                 float* __restrict__ part_ml, int Hq, int Hkv, int Sq, int Sk,
                 int hd, int hdp, Strides qs, Strides ks, Strides vs,
                 float scale, int causal, int window, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);          // [BQ][hdp]
  float* kv_s = q_s + BQ * hdp;  // K chunk [BK][KPAD] or V chunk [BKV][hdp]
  const int kv_floats = max(BK * KPAD, BKV * hdp);
  float* p_s = kv_s + kv_floats;                         // [BQ][BK]
  float* c_s = p_s + BQ * BK;                            // [BQ] corrections

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * hdp; i += THREADS) {
    const int r = i / hdp, d = i - r * hdp, qr = q0 + r;
    q_s[i] = (qr < Sq && d < hd) ? codo::to_f32(qb[qr * qs.s + d * qs.d])
                                 : 0.f;
  }

  // Key tiles this block walks: its split, minus tiles that every row of
  // the q tile masks.  Those add exactly nothing once a row has a visible
  // key (exp(-1e30 - m) is 0 in float32, and a leading all-masked stretch
  // is wiped by the first correction factor), and with Sq <= Sk row q
  // always sees key q; otherwise every tile is walked, as on the TPU.
  int kt_begin = blockIdx.z * tiles_per_split;
  int kt_end = min((Sk + BK - 1) / BK, kt_begin + tiles_per_split);
  if (Sq <= Sk) {
    if (causal) kt_end = min(kt_end, (min(q0 + BQ, Sq) - 1) / BK + 1);
    if (window) kt_begin = max(kt_begin, max(0, q0 - window + 1) / BK);
  }

  const bool k_by_key = ks.s == 1 && ks.d != 1;   // kᵀ view: keys contiguous
  const bool v_by_key = vs.s == 1 && vs.d != 1;
  const int rg = tid >> 6, cg = tid & 63;   // accumulator: rows 4rg.., cols cg+64c
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows 2w+i
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;

    // ---- scores: rows 2w, 2w+1 × keys lane, lane+32, K in DK chunks ----
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int d0 = 0; d0 < hdp; d0 += DK) {
      for (int i = tid; i < BK * DK; i += THREADS) {
        int j, d;
        if (k_by_key) {
          j = i % BK;
          d = i / BK;
        } else {
          d = i % DK;
          j = i / DK;
        }
        const int kr = k0 + j, dc = d0 + d;
        kv_s[j * KPAD + d] = (kr < Sk && dc < hd)
                                 ? codo::to_f32(kb[kr * ks.s + dc * ks.d])
                                 : 0.f;
      }
      __syncthreads();
      const float* q0p = q_s + (2 * warp) * hdp + d0;
#pragma unroll 4
      for (int d = 0; d < DK; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q0p + d);
        const float4 qb4 = *reinterpret_cast<const float4*>(q0p + hdp + d);
        const float4 ka =
            *reinterpret_cast<const float4*>(kv_s + lane * KPAD + d);
        const float4 kb4 =
            *reinterpret_cast<const float4*>(kv_s + (lane + 32) * KPAD + d);
        s[0][0] += qa.x * ka.x + qa.y * ka.y + qa.z * ka.z + qa.w * ka.w;
        s[0][1] += qa.x * kb4.x + qa.y * kb4.y + qa.z * kb4.z + qa.w * kb4.w;
        s[1][0] += qb4.x * ka.x + qb4.y * ka.y + qb4.z * ka.z + qb4.w * ka.w;
        s[1][1] += qb4.x * kb4.x + qb4.y * kb4.y + qb4.z * kb4.z + qb4.w * kb4.w;
      }
      __syncthreads();
    }

    // ---- scale, mask (-1e30 as on the TPU; keys past Sk take no weight)
    // and the online softmax of the warp's two rows, in registers ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * warp + i, qpos = q0 + row;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        if (kpos >= Sk) {
          x[c] = -INFINITY;
        } else {
          x[c] = s[i][c] * scale;
          bool keep = true;
          if (causal) keep = keep && qpos >= kpos;
          if (window) keep = keep && (qpos - kpos) < window;
          if (!keep) x[c] = NEG_INF;
        }
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
      for (int i = tid; i < BKV * hdp; i += THREADS) {
        int j, d;
        if (v_by_key) {
          j = i % BKV;
          d = i / BKV;
        } else {
          d = i % hdp;
          j = i / hdp;
        }
        const int kr = k0 + j0 + j;
        kv_s[j * hdp + d] = (kr < Sk && d < hd)
                                ? codo::to_f32(vb[kr * vs.s + d * vs.d])
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
          const int col = cg + 64 * c;
          const float vv = col < hd ? kv_s[j * hdp + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
      __syncthreads();
    }
  }

  // ---- this split's unnormalized accumulator, running max and sum ----
  const size_t base = ((size_t)blockIdx.z * BH + bh) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * rg + i;
    if (qr >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cg + 64 * c;
      if (col < hd) part_o[(base + qr) * hd + col] = acc[i][c];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = q0 + 2 * warp + i;
      if (qr < Sq) {
        part_ml[(base + qr) * 2] = m_run[i];
        part_ml[(base + qr) * 2 + 1] = l_run[i];
      }
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, float* part_o,
              float* part_ml, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
              const long long* st, float scale, int causal, int window,
              int splits, int tiles_per_split, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2], st[3]}, ks{st[4], st[5], st[6], st[7]},
      vs{st[8], st[9], st[10], st[11]};
  const int hdp = (hd + DK - 1) / DK * DK;
  const size_t kv_floats = (size_t)max(BK * KPAD, BKV * hdp);
  const size_t smem =
      sizeof(float) * ((size_t)BQ * hdp + kv_floats + BQ * BK + BQ);
  cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq, splits);
  flash_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_o, part_ml, Hq, Hkv, Sq, Sk, hd, hdp, qs,
      ks, vs, scale, causal, window, tiles_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, float* part_o,
           float* part_ml, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
           const long long* st, float scale, int causal, int window,
           int splits, int tiles_per_split, cudaStream_t stream) {
  const int nc = (hd + 63) / 64;
#define CODO_FLASH_NC(N)                                                      \
  if (nc <= N)                                                                \
    return launch_nc<T, N>(q, k, v, part_o, part_ml, B, Hq, Hkv, Sq, Sk, hd, \
                           st, scale, causal, window, splits,                 \
                           tiles_per_split, stream);
  CODO_FLASH_NC(1)
  CODO_FLASH_NC(2)
  CODO_FLASH_NC(4)
  CODO_FLASH_NC(8)
  CODO_FLASH_NC(16)
#undef CODO_FLASH_NC
  return (int)cudaErrorInvalidValue;  // hd > 1024: no tiling
}

}  // namespace

// Launch flash_kernel over (ceil(Sq/16), B·Hq, splits) blocks, each walking
// tiles_per_split 64-key tiles.  strides: 12 element strides, (b, h, s, d)
// of q, k and v.  part_o (splits, B·Hq, Sq, hd) and part_ml (splits,
// B·Hq, Sq, 2) are float32 scratch.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for hd > 1024.
extern "C" int codo_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* part_o,
                                    void* part_ml, int B, int Hq, int Hkv,
                                    int Sq, int Sk, int hd,
                                    const long long* strides, float scale,
                                    int causal, int window, int splits,
                                    int tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == codo::kBF16)
    return launch<__nv_bfloat16>(q, k, v, po, pml, B, Hq, Hkv, Sq, Sk, hd,
                                 strides, scale, causal, window, splits,
                                 tiles_per_split, s);
  return launch<float>(q, k, v, po, pml, B, Hq, Hkv, Sq, Sk, hd, strides,
                       scale, causal, window, splits, tiles_per_split, s);
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
