// Tensor-core tile helpers shared by the attention forward
// (prefix_attention.cu) and backward (prefix_attention_bwd.cu) on Hopper
// (sm_90a): the block shape, 16-byte cp.async staging of row-major tiles,
// ldmatrix, mma.sync in bf16 (m16n8k16) and as 3xTF32 for f32 (m16n8k8 three
// times), and the two tile products of a warp: X Y^T over Dh (mma_xyt) and a
// product whose A operand is an accumulator fragment (mma_fz).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

// A block is 4 warps; a warp owns 16 rows of the block's 64 (q rows, or key
// columns in the backward's dK/dV pass).
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int BM = 16 * kMmaWarps;

// Row stride of a staged tile in elements: Dh plus 16 bytes.
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() {
  return DH + 16 / (int)sizeof(T);
}

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// The value a product operand takes in type T (the TPU kernels' casts).
template <typename T>
__device__ __forceinline__ float round_like(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ bool visible(int r, int c, int Tq, int Tk, int prefix_s) {
  return r < Tq && c < Tk && (prefix_s < 0 || c < prefix_s || (r >= prefix_s && c <= r));
}

// Kernel 4's bias of one element for a row < Tq and a column < Tk, -inf
// otherwise (so P is 0 there); S = (q.k + bias) * scale.  The offsets within
// one (b, h) slice are 32-bit.
__device__ __forceinline__ float bias_at(const float* bb, const Bias& bias, int r, int c, int Tq,
                                         int Tk) {
  if (r >= Tq || c >= Tk) return -INFINITY;
  return bb[r * (int)bias.sq + c * (int)bias.sk];  // fits: the launch entries check
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared, or 4 zero bytes when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 bf16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// what cvt.rna.tf32.f32 gives, in two integer operations instead of one
// conversion.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 values.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// A fragment of 3xTF32: the big and small parts of a0..a3.
struct SplitA {
  unsigned big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  split_tf32(a0, s.big[0], s.small[0]);
  split_tf32(a1, s.big[1], s.small[1]);
  split_tf32(a2, s.big[2], s.small[2]);
  split_tf32(a3, s.big[3], s.small[3]);
  return s;
}

// c += a b to f32 accuracy: a_s b_b + a_b b_s + a_b b_b, in that order.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a, float b0, float b1) {
  unsigned bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, a.small, bb0, bb1);
  mma_tf32(c, a.big, bs0, bs1);
  mma_tf32(c, a.big, bb0, bb1);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ------------------------------------------------------------ tile products

// acc[n] += X Y^T over DH columns for a warp: X the 16 rows at x
// (row-major, stride LDT), Y the NT * 8 rows at y.  acc[n] is the m16n8 C
// fragment of columns 8n .. 8n + 7: lane (g = lane / 4, t = lane % 4) holds
// rows g, g + 8 and columns 2t, 2t + 1.  kF32Sum (f32): each k step of 8
// sums into a zeroed fragment that is added to acc in f32, as in mma_fz; the
// split tiles sum S over Dh chunk by chunk, and at Dh 256 the tensor cores'
// truncated sums over 96 products per score held the TTS's gradients 1.1x
// over their bar.  LDT defaults to a DH-wide tile's; a wider tile passes its
// own to sum over DH of its columns.
template <typename T, int DH, int NT, bool kF32Sum = false, int LDT = row_stride<T, DH>()>
__device__ __forceinline__ void mma_xyt(float (&acc)[NT][4], const T* x, const T* y, int lane) {
  if constexpr (kF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k0 = 0; k0 < DH; k0 += 8) {
      const float* xa = x + g * LDT + k0 + t;
      const SplitA a = split_a(xa[0], xa[8 * LDT], xa[4], xa[8 * LDT + 4]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* yb = y + (8 * n + g) * LDT + k0 + t;
        if constexpr (kF32Sum) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(part, a, yb[0], yb[4]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
        } else {
          mma_3xtf32(acc[n], a, yb[0], yb[4]);
        }
      }
    }
  } else {
    static_assert(NT % 2 == 0, "bf16 tiles pair their n8 tiles");
    const int lr = lane & 7, m = lane >> 3;
#pragma unroll
    for (int k0 = 0; k0 < DH; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, x + (lr + (m & 1) * 8) * LDT + k0 + (m >> 1) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldsm_x4(b, y + (8 * n + (m >> 1) * 8 + lr) * LDT + k0 + (m & 1) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[n] += F Z for a warp: F the 16 x (KT * 8) operand held as KT C
// fragments (already rounded like T), Z the KT * 8 rows at z (row-major,
// stride LDT) of which the Dh columns are the output's.  In f32 each k step
// of 8 sums into a zeroed fragment that is then added to acc in f32: the
// tensor cores round their own sums toward zero, and over the hundreds of
// steps of a long row that bias reached 1e-5 of the result.
template <typename T, int DH, int KT>
__device__ __forceinline__ void mma_fz(float (&acc)[DH / 8][4], const float (&f)[KT][4],
                                       const T* z, int lane) {
  constexpr int LDT = row_stride<T, DH>();
  if constexpr (kF32<T>) {
    // k = t is column 2t of the fragment and k = t + 4 column 2t + 1, on both
    // operands.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const SplitA a = split_a(f[j][0], f[j][2], f[j][1], f[j][3]);
      const float* zb = z + (8 * j + 2 * t) * LDT + g;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(part, a, zb[8 * n], zb[LDT + 8 * n]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
    }
  } else {
    static_assert(KT % 2 == 0, "bf16 tiles pair their n8 tiles");
    const int lr = lane & 7, m = lane >> 3;
#pragma unroll
    for (int j = 0; j < KT; j += 2) {
      const unsigned a[4] = {pack_bf16(f[j][0], f[j][1]), pack_bf16(f[j][2], f[j][3]),
                             pack_bf16(f[j + 1][0], f[j + 1][1]),
                             pack_bf16(f[j + 1][2], f[j + 1][3])};
#pragma unroll
      for (int n = 0; n < DH / 8; n += 2) {
        unsigned b[4];
        ldsm_x4_t(b, z + (8 * j + (m & 1) * 8 + lr) * LDT + 8 * n + (m >> 1) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[m][n] += X Z for a warp, both operands in shared memory: X the MT * 16
// rows at x (row-major, stride LDX, K columns, already rounded like T), Z
// the K rows at z (row-major, stride LDZ) of which the NT * 8 columns from z
// are the output's.  f32 pairs k = t with column 2t of X (row 2t of Z) and
// k = t + 4 with 2t + 1, so that X's fragment comes in two 8-byte loads
// (conflict-free at LDX = 8 mod 32 words), and each k step of 8 sums into a
// zeroed fragment that is added to acc in f32, as in mma_fz.  bf16: ldmatrix
// for both (Z transposed), conflict-free where a row is an odd number of 16
// bytes.
template <typename T, int MT, int NT, int K, int LDX, int LDZ>
__device__ __forceinline__ void mma_xz(float (&acc)[MT][NT][4], const T* x, const T* z,
                                       int lane) {
  if constexpr (kF32<T>) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2  // wholly unrolled at K = 32, the dK/dV pass spilled at 255 registers
    for (int k0 = 0; k0 < K; k0 += 8) {
      SplitA a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* xa = x + (16 * m + g) * LDX + k0 + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(xa);
        const float2 hi = *reinterpret_cast<const float2*>(xa + 8 * LDX);
        a[m] = split_a(lo.x, hi.x, lo.y, hi.y);
      }
      const float* zb = z + (k0 + 2 * t) * LDZ + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float b0 = zb[8 * n], b1 = zb[LDZ + 8 * n];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(part, a[m], b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[e];
        }
      }
    }
  } else {
    static_assert(NT % 2 == 0, "bf16 tiles pair their n8 tiles");
    const int lr = lane & 7, mm = lane >> 3;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4(a[m], x + (16 * m + lr + (mm & 1) * 8) * LDX + k0 + (mm >> 1) * 8);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldsm_x4_t(b, z + (k0 + (mm & 1) * 8 + lr) * LDZ + 8 * n + (mm >> 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][n], a[m], b[0], b[1]);
          mma_bf16(acc[m][n + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

// Two adjacent elements of a C fragment (columns 2t, 2t + 1 of a row) into
// shared memory as T, at p (8-byte aligned in f32, 4-byte in bf16).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float lo, float hi) {
  if constexpr (kF32<T>)
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  else
    *reinterpret_cast<unsigned*>(p) = pack_bf16(lo, hi);
}

// Copy rows [r0, r0 + ROWS) of x (row stride x_st elements, Dh contiguous) into
// s (row stride LDT); rows >= lim are zero.  vec: every row is 16-byte
// aligned, so the copy is asynchronous (cp.async, completed by the caller's
// wait); otherwise it is a plain copy.  NTHR: the block's threads.
template <typename T, int DH, int ROWS, int NTHR = kMmaThreads>
__device__ __forceinline__ void stage_rows(T* s, const T* x, long long x_st, int r0, int lim,
                                           bool vec) {
  constexpr int LDT = row_stride<T, DH>(), kVec = 16 / (int)sizeof(T), kChunks = DH / kVec;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHR) {
      const int r = i / kChunks, ch = i % kChunks;
      const bool ok = r0 + r < lim;
      cp_async16(s + r * LDT + ch * kVec, ok ? x + (long long)(r0 + r) * x_st + ch * kVec : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DH; i += NTHR) {
      const int r = i / DH, d = i % DH;
      from_float(r0 + r < lim ? to_float(x[(long long)(r0 + r) * x_st + d]) : 0.f,
                 &s[r * LDT + d]);
    }
  }
}

// Launch a pass with kMmaThreads threads and `smem` bytes of dynamic shared
// memory, raising the kernel's limit first.
template <typename... P, typename... A>
cudaError_t launch_pass(void (*kern)(P...), dim3 grid, size_t smem, cudaStream_t stream,
                        A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kMmaThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Whether every row of a (.., T, H, Dh) view starts on 16 bytes.
inline bool rows_aligned(const void* p, long long sb, long long st, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb * (long long)elem) % 16 == 0 &&
         (st * (long long)elem) % 16 == 0;
}

}  // namespace
