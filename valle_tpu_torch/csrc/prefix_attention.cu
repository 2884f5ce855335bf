// Attention forward for Hopper (sm_90a): kernel 2 (prefix-LM / dense, with
// dropout) and kernel 4 (dense bias) of the port, one tile body for both.
//
// Kernel 2 replaces: valle_tpu/ops/fused_attention.py::_fwd_kernel (driven
// by _pallas_fwd, pallas_call at fused_attention.py:233, wrapper
// fused_prefix_attention) and, on the port's attn_impl="flash" route, the
// library flash kernel behind valle_tpu/ops/flash_attention.py for
// key-padding and prefix-LM masks.
//
// Kernel 2 computes out = softmax(q k^T / sqrt(Dh) + kv_bias[col], structural
// mask) v for q (B, Tq, H, Dh), k/v (B, Tk, H, Dh), f32 or bf16, exact f32
// softmax.  The structural mask is built from row/column indices, never
// stored:
//   prefix_s = s > 0: a row < s sees columns < s; a row >= s sees columns < s
//                     plus columns <= row (text prefix, causal audio);
//   prefix_s = 0:     causal;
//   prefix_s < 0:     dense, key padding only (Tq may differ from Tk).
// A structurally masked column is excluded; the key bias (-1e9 at padding)
// is added.  Every row sees at least one column structurally, so no row is
// empty.
//
// Dropout (training): as in the TPU kernel, the row sum l accumulates the
// probabilities before dropout, and the dropped probabilities, scaled by
// 1 / (1 - rate), go into the P.V accumulator; out = acc / l.  The keep bits
// are Philox4x32-10 per element (philox.cuh), so the backward kernel and the
// plain PyTorch version draw the same mask for any tiling.  When a gradient is
// needed the kernel also writes the row log-sum-exp m + log l, (B, H, Tq) f32,
// from which the backward recomputes P.  At rate 0 with no LSE requested the
// launch runs the dropout-free instantiation, the same code as inference.
//
// Kernel 4 replaces: the dense `ab` branch of
// valle_tpu/ops/flash_attention.py::flash_attention_biased (:142-162), which
// calls JAX's library Pallas flash kernel (installed
// jax/experimental/pallas/ops/tpu/flash_attention.py, pallas_call at :758).
// It computes, in the library's order (bias before scale),
//   out = softmax((q k^T + bias) / sqrt(Dh)) v
// with an f32 bias read through four strides (b, h, row, col), 0 on a
// broadcast dimension, so the (B, 1, Tq, Tk) masks of the model are never
// copied per head.  It has no structural mask and no dropout: every column's
// bias is added and every key tile is walked.  A row whose every column holds
// -1e9 gets S ~ -1.25e8 everywhere: finite, so it averages v over the Tk
// columns (the TPU wrapper also averages the zero columns it pads to 128).
// It is the kBias instantiation of the tile body; kBias = false compiles to
// kernel 2's code alone.
//
// What bounds both on the H100: operations.  The work is ~4 B H Tq Tk_eff Dh
// flops against 67 TFLOP/s of f32 CUDA-core FMA (989 bf16 / 495 TF32 on the
// tensor cores); the bytes are a few MB, plus 4 B Tq Tk of kernel 4's bias
// (14 MB at B=4, T=938).
//
// What the design does about it: one block of 256 threads per (64-row q
// tile, head, batch).  The block walks 64-column K/V tiles staged in shared
// memory (K transposed so the score micro-kernel reads conflict-free) with
// an online softmax; kernel 2 stops at the tile's structural frontier
// max(prefix_s, tile_end), which skips the masked upper triangle as the TPU
// kernel's _windows clip did.  Each thread owns a 4x4 block of scores and a
// 4 x Dh/16 block of the output, so every shared-memory load feeds 4 FMAs.
// Kernel 4 reads its bias once per score from global memory (16 consecutive
// columns per row of a half-warp; the heads of one batch row meet in L2).
// The ragged edges of Tq and Tk are masked in the kernel (no padding to 128
// as the TPU wrapper does).  Later work: tensor cores (wgmma), TMA, and
// skipping kernel 4's key tiles that are wholly masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)DH * LD * 2 + (size_t)BK * DH + (size_t)BK * LD + BK + BQ * 2;
}

// One (64-row q tile, head, batch) of the forward.  kBias: kernel 4 (dense
// bias, bias before scale, no structural mask, no dropout); otherwise kernel
// 2 (q pre-scaled, key bias, structural mask from prefix_s).
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attention_fwd_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, T* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int prefix_s, float scale,
    unsigned drop_threshold, float inv_keep, uint2 seed) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DJ = DH / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;            // [DH][LD]  q^T (pre-scaled unless kBias)
  float* sKt = sQt + DH * LD;     // [DH][LD]  k^T
  float* sV = sKt + DH * LD;      // [BK][DH]
  float* sP = sV + BK * DH;       // [BK][LD]  scores / probs, column-major
  float* sBias = sP + BK * LD;    // [BK]      key bias (kernel 2 only)
  float* sAlpha = sBias + (kBias ? 0 : BK);  // [BQ]
  float* sL = sAlpha + BQ;        // [BQ]

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rb = tid >> 2, pb = tid & 3;  // softmax phase: row, quarter

  int kend = Tk;  // structural frontier of this q tile
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BQ));

  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float x = 0.f;
    if (r0 + r < Tq) {
      x = to_float(qb[(long long)(r0 + r) * q_st + d]);
      if constexpr (!kBias) x *= scale;
    }
    sQt[d * LD + r] = x;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row rb's stats (same in its 4 lanes)

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's sP / sV readers are done
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < kend) {
        kx = to_float(kb[(long long)(k0 + c) * k_st + d]);
        vx = to_float(vb[(long long)(k0 + c) * v_st + d]);
      }
      sKt[d * LD + c] = kx;
      sV[c * DH + d] = vx;
    }
    if constexpr (!kBias) {
      if (tid < BK)
        sBias[tid] = (kv_bias != nullptr && k0 + tid < kend) ? kv_bias[(long long)b * Tk + k0 + tid] : 0.f;
    }
    __syncthreads();

    // Scores: rows ty*4 + i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQt[d * LD + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKt[d * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j, c = k0 + cl;
      float4 w;
      float* wp = reinterpret_cast<float*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        if constexpr (kBias) {
          float x = -INFINITY;
          if (c < Tk) {
            const float bv = (r < Tq) ? bb[(long long)r * bias.sq + (long long)c * bias.sk] : 0.f;
            x = (s[i][j] + bv) * scale;
          }
          wp[i] = x;
        } else {
          const bool ok = c < kend && (prefix_s < 0 || c < prefix_s || (r >= prefix_s && c <= r));
          wp[i] = ok ? s[i][j] + sBias[cl] : -INFINITY;
        }
      }
      *reinterpret_cast<float4*>(&sP[cl * LD + ty * 4]) = w;
    }
    __syncthreads();

    // Online softmax: 4 lanes per row, each over 16 columns.
    float tmax = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) tmax = fmaxf(tmax, sP[(pb + 4 * kk) * LD + rb]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) {
      float* sp = &sP[(pb + 4 * kk) * LD + rb];
      const float x = *sp;
      const float p = (x == -INFINITY) ? 0.f : expf(x - m_new);
      *sp = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (pb == 0) sAlpha[rb] = alpha;
    __syncthreads();

    if constexpr (kDrop) {
      // Dropout on the unnormalised probabilities: thread (row, 4-column
      // group); a warp covers 32 consecutive rows of one group.
      const int r = tid & (BQ - 1);
      const unsigned bh = (unsigned)(b * H + h);
#pragma unroll
      for (int m = 0; m < BK / 16; ++m) {
        const int g = (tid >> 6) + 4 * m;
        const unsigned keep =
            philox_keep4((unsigned)(k0 >> 2) + g, (unsigned)(r0 + r), bh, seed, drop_threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* sp = &sP[(4 * g + e) * LD + r];
          *sp = ((keep >> e) & 1u) ? *sp * inv_keep : 0.f;
        }
      }
      __syncthreads();
    }

    // Output: rows ty*4 + i, dims tx + 16 j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&sP[c * LD + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vv[j], acc[i][j]);
    }
  }

  if (pb == 0) {
    sL[rb] = l_run;
    if (lse != nullptr && r0 + rb < Tq)
      lse[((long long)b * H + h) * Tq + r0 + rb] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float inv = 1.f / sL[ty * 4 + i];
    T* o = out + (((long long)b * Tq + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) from_float(acc[i][j] * inv, &o[tx + 16 * j]);
  }
}

// Kernel 2.
template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) prefix_attention_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,
    int Tq, int Tk, int H, int prefix_s, float scale, unsigned drop_threshold,
    float inv_keep, uint2 seed) {
  attention_fwd_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                          Bias{}, out, lse, Tq, Tk, H, prefix_s, scale,
                                          drop_threshold, inv_keep, seed);
}

// Kernel 4.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bias_fwd_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H,
    float scale) {
  attention_fwd_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,
                                         bias, out, lse, Tq, Tk, H, -1, scale, 0u, 1.f,
                                         make_uint2(0u, 0u));
}

template <typename T>
cudaError_t launch_prefix(int Dh, const void* q, long long q_sb, long long q_st, const void* k,
                          long long k_sb, long long k_st, const void* v, long long v_sb,
                          long long v_st, const float* kv_bias, void* out, float* lse, int B,
                          int Tq, int Tk, int H, int prefix_s, Dropout drop,
                          cudaStream_t stream) {
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    auto kern = prefix_attention_kernel<T, DH, true>;
    if (drop.threshold == 0) kern = prefix_attention_kernel<T, DH, false>;
    return launch(kern, dim3((Tq + BQ - 1) / BQ, H, B), sizeof(float) * smem_floats<DH>(),
                  stream, static_cast<const T*>(q), q_sb, q_st, static_cast<const T*>(k), k_sb,
                  k_st, static_cast<const T*>(v), v_sb, v_st, kv_bias, static_cast<T*>(out), lse,
                  Tq, Tk, H, prefix_s, 1.f / sqrtf((float)DH), drop.threshold, drop.inv_keep,
                  drop.seed);
  });
}

template <typename T>
cudaError_t launch_bias(int Dh, const void* q, long long q_sb, long long q_st, const void* k,
                        long long k_sb, long long k_st, const void* v, long long v_sb,
                        long long v_st, Bias bias, void* out, float* lse, int B, int Tq, int Tk,
                        int H, cudaStream_t stream) {
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    auto kern = flash_bias_fwd_kernel<T, DH>;
    return launch(kern, dim3((Tq + BQ - 1) / BQ, H, B),
                  sizeof(float) * smem_floats<DH>(), stream, static_cast<const T*>(q), q_sb,
                  q_st, static_cast<const T*>(k), k_sb, k_st, static_cast<const T*>(v), v_sb,
                  v_st, bias, static_cast<T*>(out), lse, Tq, Tk, H, 1.f / sqrtf((float)DH));
  });
}

}  // namespace

// Kernel 2.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q: (B, Tq, H, Dh) with batch / row strides q_sb / q_st in elements and
// (H, Dh) contiguous; k, v likewise over Tk; kv_bias: (B, Tk) f32 or null;
// out: (B, Tq, H, Dh) contiguous; lse: (B, H, Tq) f32 or null (not written);
// prefix_s < 0 selects dense mode.  drop_threshold: keep a probability when
// its Philox bits are >= it (0 = no dropout); inv_keep = 1 / (1 - rate);
// seed: the 64-bit Philox key.  Returns the cudaError_t of the launch.
extern "C" int prefix_attention_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* kv_bias,
    void* out, float* lse, int dtype, int B, int Tq, int Tk, int H, int Dh, int prefix_s,
    unsigned drop_threshold, float inv_keep, unsigned long long seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_threshold, inv_keep,
                     make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32))};
  if (dtype == 0)
    return (int)launch_prefix<float>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                     out, lse, B, Tq, Tk, H, prefix_s, drop, s);
  if (dtype == 1)
    return (int)launch_prefix<__nv_bfloat16>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                                             kv_bias, out, lse, B, Tq, Tk, H, prefix_s, drop, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4.  dtype, q, k, v, out and lse as in prefix_attention_launch;
// bias: f32, element (b, h, r, c) at bias[b * b_sb + h * b_sh + r * b_sq +
// c * b_sk].  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* bias,
    long long b_sb, long long b_sh, long long b_sq, long long b_sk, void* out, float* lse,
    int dtype, int B, int Tq, int Tk, int H, int Dh, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias bs{bias, b_sb, b_sh, b_sq, b_sk};
  if (dtype == 0)
    return (int)launch_bias<float>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bs, out, lse,
                                   B, Tq, Tk, H, s);
  if (dtype == 1)
    return (int)launch_bias<__nv_bfloat16>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bs,
                                           out, lse, B, Tq, Tk, H, s);
  return (int)cudaErrorInvalidValue;
}
