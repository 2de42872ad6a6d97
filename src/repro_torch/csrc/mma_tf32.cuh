// Tensor-core pieces shared by the port's redesigned kernels (chain.cu,
// flashattn.cu, softmax_mm.cu, and chain_grad.cu, matmul.cu and
// pad_conv_relu.cu through mma_gemm.cuh):
// the m16n8k8 TF32 mma.sync, the 3×TF32 split that keeps a float32 product
// float32-accurate on it, and cp.async copies.
//
// 3×TF32: x = hi + lo with hi = tf32(x) and lo = x − hi, which the tensor
// cores read truncated to TF32; a·b is taken as lo_a·hi_b + hi_a·lo_b +
// hi_a·hi_b (the lo·lo term is below float32's last bit), accumulated in
// float32 by the tensor cores — the idea of CUTLASS's OpMultiplyAddFastF32.
// A single TF32 pass keeps ~11 bits and misses the float32 bands;
// bfloat16 operands are exact in TF32 (8 mantissa bits of TF32's 10), so
// they take one pass.
//
// m16n8k8 fragment layouts (lane = 4·g + t, g < 8, t < 4):
//   A (16 × 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 × 8, k × n):      b0 (t, g), b1 (t + 4, g)
//   C (16 × 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace codo_mma {

// x rounded to TF32 (nearest, ties away — what cvt.rna.tf32.f32 gives),
// by integer add and mask: the conversion unit's cvt would be the busiest
// pipe of the inner loops, and the mask leaves x − hi exact in float32.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// PASSES 3: hi and lo of x, lo = x − hi passed whole (the tensor cores
// read a TF32 operand's top 19 bits and drop the rest).  Rounding lo as
// well, as CUTLASS does, measured slower on flash and the chain and
// hardly more accurate at the paths' shapes (PERF.md).  PASSES 1: hi only (lo
// unused).
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  if (PASSES == 3) lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (both halves) of four float32 values.
template <int PASSES>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split<PASSES>(a0, hi[0], lo[0]);
    split<PASSES>(a1, hi[1], lo[1]);
    split<PASSES>(a2, hi[2], lo[2]);
    split<PASSES>(a3, hi[3], lo[3]);
  }
};

template <int PASSES>
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split<PASSES>(b0, hi[0], lo[0]);
    split<PASSES>(b1, hi[1], lo[1]);
  }
};

// d += a·b in PASSES TF32 products, the small terms first.
template <int PASSES>
__device__ __forceinline__ void mma_f32(float (&d)[4], const FragA<PASSES>& a,
                                        const FragB<PASSES>& b) {
  if (PASSES == 3) {
    mma(d, a.lo, b.hi);
    mma(d, a.hi, b.lo);
  }
  mma(d, a.hi, b.hi);
}

// Passes an element type takes: float32 splits, bfloat16 is exact.
template <typename T>
struct Passes {
  static constexpr int value = 3;
};
template <>
struct Passes<__nv_bfloat16> {
  static constexpr int value = 1;
};

// ---- cp.async: global -> shared without staging in registers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Wait until at most N committed groups are still in flight (a ring of
// N + 2 stages waits for the oldest).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}


// Copy a (rows × cols) tile of a 2-D operand (element strides rs, cs) into
// shared memory, row-major with leading dimension ld (elements, a multiple
// of 16 bytes); entries past (valid_rows, valid_cols) become 0.  With
// cs == 1, 16-byte aligned rows and valid_cols a whole number of 16-byte
// vectors, every vector is one cp.async; otherwise each element is copied
// alone (cp.async of 4 bytes for float32, a plain load and store for
// bfloat16), threads walking whichever axis is contiguous in memory.
// Completion: cp_async_commit, then cp_async_wait_all and a barrier.
template <typename T, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long rs, long long cs,
                                          int rows, int cols, int valid_rows,
                                          int valid_cols, bool vec_ok,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec_ok) {
    const int vpr = cols / VEC;  // vectors a row
    for (int i = tid; i < rows * vpr; i += THREADS) {
      const int r = i / vpr, c = (i - r * vpr) * VEC;
      const bool ok = r < valid_rows && c < valid_cols;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
    return;
  }
  const bool by_row = rs == 1 && cs != 1;  // rows contiguous: walk rows
  for (int i = tid; i < rows * cols; i += THREADS) {
    int r, c;
    if (by_row) {
      r = i % rows;
      c = i / rows;
    } else {
      c = i % cols;
      r = i / cols;
    }
    const bool ok = r < valid_rows && c < valid_cols;
    const T* s = ok ? src + r * rs + c * cs : src;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst + r * ld + c, s, ok);
    } else {
      dst[r * ld + c] = ok ? *s : codo::from_f32<T>(0.f);
    }
  }
}

// Whether load_tile may copy 16-byte vectors: unit column stride, a row
// stride and base address that keep every row 16-byte aligned, and a
// valid width of whole vectors.
template <typename T>
__device__ __host__ __forceinline__ bool vec_ok(const T* base, long long rs,
                                                long long cs,
                                                int valid_cols) {
  constexpr int VEC = 16 / sizeof(T);
  return cs == 1 && rs % VEC == 0 && valid_cols % VEC == 0 &&
         (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

}  // namespace codo_mma
