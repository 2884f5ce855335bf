// Attention forward for Hopper (sm_90a): kernel 2 (prefix-LM / dense, with
// dropout) and kernel 4 (dense bias) of the port, one tile body for both, on
// the tensor cores.
//
// Kernel 2 replaces: valle_tpu/ops/fused_attention.py::_fwd_kernel (driven
// by _pallas_fwd, pallas_call at fused_attention.py:233, wrapper
// fused_prefix_attention) and, on the port's attn_impl="flash" route, the
// library flash kernel behind valle_tpu/ops/flash_attention.py for
// key-padding and prefix-LM masks.  In _fwd_kernel's order it computes, for
// q (B, Tq, H, Dh), k / v (B, Tk, H, Dh), f32 or bf16:
//   S = (q k^T) / sqrt(Dh) + kv_bias[col]     (structurally masked: -inf)
//   p = exp(S - row max),  l = sum of p,  pd = keep * p / (1 - rate)
//   out = (round(pd) v) / l,  lse = row max + log l
// where round() is the input dtype (the TPU kernel's p.astype(q.dtype)).  The
// structural mask is built from row/column indices, never stored:
//   prefix_s = s > 0: a row < s sees columns < s; a row >= s sees columns < s
//                     plus columns <= row (text prefix, causal audio);
//   prefix_s = 0:     causal;
//   prefix_s < 0:     dense, key padding only (Tq may differ from Tk).
// Every row sees column 0, so no row is empty.  The keep bits are
// Philox4x32-10 per element (philox.cuh), counter (col / 4, row, b H + h), so
// the backward kernel and the plain PyTorch version draw the same mask for
// any tiling.  The row log-sum-exp (B, H, Tq) f32 is written when a gradient
// is needed; at rate 0 the launch runs the dropout-free instantiation.
//
// Kernel 4 replaces: the dense `ab` branch of
// valle_tpu/ops/flash_attention.py::flash_attention_biased (:142-162), which
// calls JAX's library Pallas flash kernel (installed
// jax/experimental/pallas/ops/tpu/flash_attention.py, pallas_call at :758).
// In the library's order (bias before scale):
//   out = softmax((q k^T + bias) / sqrt(Dh)) v
// with an f32 bias read through four strides (b, h, row, col), 0 on a
// broadcast dimension, so the (B, 1, Tq, Tk) masks of the model are never
// copied per head.  No structural mask, no dropout; every key tile is
// walked.  A row whose every column holds -1e9 gets S ~ -1.25e8 everywhere:
// finite, so it averages v over the Tk columns (the TPU wrapper also
// averages the zero columns it pads to 128).  The library rounds the
// normalised P to the input dtype when the keys fit one block; this kernel
// rounds p relative to its running max, before normalising, which agrees
// within bf16 rounding.  It is the kBias instantiation of the tile body.
//
// What bounds both on the H100: operations.  Two products per visible (row,
// column) pair, 4 B H Dh flops per pair, on a few MB of inputs (plus 4 B Tq
// Tk bytes of kernel 4's bias when it is per batch row).  bf16 runs on the
// tensor cores at 989 TFLOP/s dense; f32 runs as 3xTF32, 165 TFLOP/s of
// f32-accurate products (three TF32 products at 495 TFLOP/s).
//
// What the design does about it (the forward sibling of the backward's dQ
// pass, prefix_attention_bwd.cu, with the helpers of mma_tile.cuh):
//   1. Both products on the tensor cores with mma.sync: S = q k^T through
//      mma_xyt and O += P V through mma_fz, bf16 as m16n8k16 and f32 as
//      3xTF32.  TF32 stays off globally; 3xTF32 is the kernel's own
//      arithmetic.  P V takes each k step into a zeroed fragment added in f32
//      (the tensor cores truncate their sums; a row at T = 880 sums 110
//      steps).
//   2. One block of 4 warps x 16 q rows per (64-row q tile, head, batch).  q
//      is staged once; K and V stream through a two-stage ring of
//      KN-column tiles with 16-byte cp.async, untransposed and row-padded by
//      16 bytes (conflict-free ldmatrix and 32-bit fragment loads), so the
//      next tile's loads overlap this tile's products; kernel 2's key bias
//      travels with each tile (4-byte cp.async).  bf16 stays bf16 in shared
//      memory.  A plain copy replaces cp.async where a row is not 16-byte
//      aligned.
//   3. The online softmax runs in registers on the S accumulator fragments:
//      a lane holds rows g and g + 8 of its warp, the row max is taken over
//      the four lanes of a quad by shuffles, the accumulator is rescaled by
//      exp(m_old - m_new) once per key tile, and the fragments, rounded like
//      T, are the A operand of P V with no trip through shared memory.  Each
//      lane keeps its part of the row sum and the quad adds them at the end.
//      One lane draws the Philox bits of each (row, 4-column group) and the
//      others take them by shuffles, as in the dQ pass.  Each row's visible
//      columns are [0, lim): one compare per score covers kernel 2's
//      structural mask and the ragged edges.  Kernel 4's bias is read before
//      the products, so its latency hides behind them.
//   4. q is not pre-scaled: the scale multiplies the f32 product, in JAX's
//      order, so no bf16 operand carries a rounded q / sqrt(Dh).
//   5. Kernel 2 stops at the q tile's structural frontier max(prefix_s, tile
//      end), which skips the masked upper triangle as the TPU kernel's
//      _windows clip did.  No atomics: reruns are bit-equal.
//   6. Registers decide the occupancy: fwd_bounds_class() gives each
//      instantiation the launch bounds under which ptxas spills nothing.
// Later work: wgmma / TMA, and skipping kernel 4's wholly masked key tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include "attention_common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace {

// Key columns of a streamed K / V tile: kFwdKN, or 16 in f32 at Dh = 128,
// where 32 spills.  A wider tile spreads the per-tile rescale of the
// accumulator over more columns but holds more scores in registers.
constexpr int kFwdKN = 32;
template <typename T, int DH>
__host__ __device__ constexpr int fwd_kn() {
  return (kF32<T> && DH == 128) ? 16 : kFwdKN;
}

// The launch bounds of an instantiation, chosen so that ptxas spills
// nothing: 4 asks it to fit four blocks per SM (at most 128 registers), 2 two
// (at most 255), 0 leaves the count to it.  Held to 128 registers, the f32
// instantiations at Dh <= 64 spill; left alone, ptxas gives them 116-141.
template <typename T, int DH>
constexpr int fwd_bounds_class() {
  if (DH == 128) return 2;
  return kF32<T> ? 0 : 4;
}

template <typename T, int DH>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(BM + 4 * fwd_kn<T, DH>()) * row_stride<T, DH>() * sizeof(T) +
         2 * fwd_kn<T, DH>() * sizeof(float);
}

// Two adjacent outputs, rounded like T.
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// One (64-row q tile, head, batch) of the forward.  kBias: kernel 4 (dense
// bias, bias before scale, no structural mask, no dropout); otherwise kernel
// 2 (key bias, structural mask from prefix_s, dropout when kDrop).
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attention_fwd_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, T* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int KN = fwd_kn<T, DH>();
  constexpr int LDT = row_stride<T, DH>(), TILE = KN * LDT;
  constexpr int NT = KN / 8, DT = DH / 8;  // n8 tiles of a key tile, of Dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BM][LDT]
  T* sK = sQ + BM * LDT;                   // [2][KN][LDT]
  T* sV = sK + 2 * TILE;                   // [2][KN][LDT]
  float* sB = reinterpret_cast<float*>(sV + 2 * TILE);  // [2][KN] kernel 2's key bias

  const int r0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  int kend = Tk;  // structural frontier of this q tile
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BM));
  const int n_tiles = (kend + KN - 1) / KN;

  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  const float* kvb = (!kBias && kv_bias != nullptr) ? kv_bias + (long long)b * Tk : nullptr;
  // kernel 2's key bias of columns [c0, c0 + KN) into stage st (0 past kend;
  // both stages stay 0 without a bias)
  auto stage_bias = [&](int st, int c0) {
    if constexpr (!kBias) {
      if (kvb != nullptr && threadIdx.x < KN) {
        const int c = c0 + threadIdx.x;
        cp_async4(sB + st * KN + threadIdx.x, c < kend ? kvb + c : kvb, c < kend);
      }
    }
  };
  if (!kBias && kvb == nullptr && threadIdx.x < 2 * KN) sB[threadIdx.x] = 0.f;
  stage_rows<T, DH, BM>(sQ, q + (long long)b * q_sb + (long long)h * DH, q_st, r0, Tq, vec);
  stage_rows<T, DH, KN>(sK, kb, k_st, 0, kend, vec);
  stage_rows<T, DH, KN>(sV, vb, v_st, 0, kend, vec);
  stage_bias(0, 0);
  cp_async_commit();

  const int wr = 16 * warp;  // the warp's first row in the tile
  const int ra = r0 + wr + g, rb = ra + 8;
  // the columns each of the two rows sees are [0, lim): kernel 2's structural
  // mask and the ragged edges, kernel 4's ragged edges
  auto col_limit = [&](int r) {
    if (r >= Tq) return 0;
    if (kBias || prefix_s < 0) return Tk;
    return min(kend, r < prefix_s ? prefix_s : max(prefix_s, r + 1));
  };
  const int lim_a = col_limit(ra), lim_b = col_limit(rb);
  float m_a = -INFINITY, m_b = -INFINITY;  // running row maxima of rows ra, rb
  float l_a = 0.f, l_b = 0.f;              // this lane's part of their row sums
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KN;
    if (it + 1 < n_tiles) {  // the next K / V tile loads while this one computes
      stage_rows<T, DH, KN>(sK + ((it + 1) & 1) * TILE, kb, k_st, k0 + KN, kend, vec);
      stage_rows<T, DH, KN>(sV + ((it + 1) & 1) * TILE, vb, v_st, k0 + KN, kend, vec);
      stage_bias((it + 1) & 1, k0 + KN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + (it & 1) * TILE;
    const T* cV = sV + (it & 1) * TILE;
    const float* cB = sB + (it & 1) * KN;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // kernel 4's biases (-inf outside Tq x Tk), read before the product so
    // that their latency hides behind it
    float add[NT][4];
    if constexpr (kBias) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb, c = k0 + 8 * n + 2 * t + (e & 1);
          add[n][e] = c < (e < 2 ? lim_a : lim_b) ? bb[r * (int)bias.sq + c * (int)bias.sk]
                                                  : -INFINITY;
        }
    }
    mma_xyt<T, DH, NT>(s, sQ + wr * LDT, cK, lane);  // S = q k^T

    // scaled scores (-inf where masked) and this tile's row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * n + 2 * t + (e & 1);
        float x;
        if constexpr (kBias)
          x = (s[n][e] + add[n][e]) * scale;
        else
          x = k0 + cl < (e < 2 ? lim_a : lim_b) ? s[n][e] * scale + cB[cl] : -INFINITY;
        s[n][e] = x;
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with nothing visible yet keeps m = -inf and alpha = 1
    const float al_a = (mn_a == -INFINITY) ? 1.f : __expf(m_a - mn_a);
    const float al_b = (mn_b == -INFINITY) ? 1.f : __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // s becomes P after dropout, rounded like T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned keep_a = 0xFu, keep_b = 0xFu;
      if constexpr (kDrop) {
        // lane L draws (row wr + L % 16, group L / 16) of this 16 x 8 tile
        const unsigned w = philox_keep4((unsigned)((k0 + 8 * n) >> 2) + (lane >> 4),
                                        (unsigned)(r0 + wr + (lane & 15)), bh, drop.seed,
                                        drop.threshold);
        keep_a = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g) >> (2 * (t & 1));
        keep_b = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g + 8) >> (2 * (t & 1));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = (x == -INFINITY) ? 0.f : __expf(x - (e < 2 ? m_a : m_b));
        if (e < 2)
          l_a += p;
        else
          l_b += p;
        float pd = p;
        if constexpr (kDrop) {
          const bool kept = (((e < 2 ? keep_a : keep_b) >> (e & 1)) & 1u) != 0;
          pd = kept ? p * drop.inv_keep : 0.f;
        }
        s[n][e] = round_like<T>(pd);
      }
    }
    mma_fz<T, DH, NT>(acc, s, cV, lane);  // O += P v
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= Tq) continue;
      const float l = half ? l_b : l_a;
      store2(out + (((long long)b * Tq + r) * H + h) * DH + 8 * n + 2 * t,
             acc[n][2 * half] / l, acc[n][2 * half + 1] / l);
    }
  }
  if (lse != nullptr && t == 0) {
    const long long base = ((long long)b * H + h) * Tq;
    if (ra < Tq) lse[base + ra] = m_a + logf(l_a);
    if (rb < Tq) lse[base + rb] = m_b + logf(l_b);
  }
}

// The kernels (kernel 2's prefix_attention_kernel, kernel 4's
// flash_bias_fwd_kernel), defined once per launch bounds of
// fwd_bounds_class(); each instantiation is taken from one of them.
#define FWD_KERNELS(BOUNDS)                                                                      \
template <typename T, int DH, bool kDrop>                                                         \
__global__ void BOUNDS prefix_attention_kernel(                                                   \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,              \
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec) {                   \
  attention_fwd_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,   \
                                          Bias{}, out, lse, Tq, Tk, H, prefix_s, scale, drop,     \
                                          vec);                                                   \
}                                                                                                 \
                                                                                                  \
template <typename T, int DH>                                                                     \
__global__ void BOUNDS flash_bias_fwd_kernel(                                                     \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H,               \
    float scale, bool vec) {                                                                      \
  attention_fwd_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,    \
                                         bias, out, lse, Tq, Tk, H, -1, scale, Dropout{}, vec);   \
}

namespace fit4 {
FWD_KERNELS(__launch_bounds__(kMmaThreads, 4))
}  // namespace fit4
namespace fit2 {
FWD_KERNELS(__launch_bounds__(kMmaThreads, 2))
}  // namespace fit2
namespace any_regs {
FWD_KERNELS(__launch_bounds__(kMmaThreads))
}  // namespace any_regs
#undef FWD_KERNELS

// Kernel 2.
template <typename T, int DH, bool kDrop>
auto prefix_kernel() {
  constexpr int c = fwd_bounds_class<T, DH>();
  if constexpr (c == 4) return fit4::prefix_attention_kernel<T, DH, kDrop>;
  else if constexpr (c == 2) return fit2::prefix_attention_kernel<T, DH, kDrop>;
  else return any_regs::prefix_attention_kernel<T, DH, kDrop>;
}

// Kernel 4.
template <typename T, int DH>
auto bias_kernel() {
  constexpr int c = fwd_bounds_class<T, DH>();
  if constexpr (c == 4) return fit4::flash_bias_fwd_kernel<T, DH>;
  else if constexpr (c == 2) return fit2::flash_bias_fwd_kernel<T, DH>;
  else return any_regs::flash_bias_fwd_kernel<T, DH>;
}

// Whether q, k and v can be staged with 16-byte cp.async.
template <typename T>
bool qkv_aligned(const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
                 long long k_st, const void* v, long long v_sb, long long v_st) {
  return rows_aligned(q, q_sb, q_st, sizeof(T)) && rows_aligned(k, k_sb, k_st, sizeof(T)) &&
         rows_aligned(v, v_sb, v_st, sizeof(T));
}

template <typename T>
cudaError_t launch_prefix(int Dh, const void* q, long long q_sb, long long q_st, const void* k,
                          long long k_sb, long long k_st, const void* v, long long v_sb,
                          long long v_st, const float* kv_bias, void* out, float* lse, int B,
                          int Tq, int Tk, int H, int prefix_s, Dropout drop, float scale,
                          cudaStream_t stream) {
  const bool vec = qkv_aligned<T>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st);
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    auto kern = prefix_kernel<T, DH, true>();
    if (drop.threshold == 0) kern = prefix_kernel<T, DH, false>();
    return launch_pass(kern, dim3((Tq + BM - 1) / BM, H, B), fwd_smem_bytes<T, DH>(), stream,
                       static_cast<const T*>(q), q_sb, q_st, static_cast<const T*>(k), k_sb,
                       k_st, static_cast<const T*>(v), v_sb, v_st, kv_bias,
                       static_cast<T*>(out), lse, Tq, Tk, H, prefix_s, scale, drop, vec);
  });
}

template <typename T>
cudaError_t launch_bias(int Dh, const void* q, long long q_sb, long long q_st, const void* k,
                        long long k_sb, long long k_st, const void* v, long long v_sb,
                        long long v_st, Bias bias, void* out, float* lse, int B, int Tq, int Tk,
                        int H, float scale, cudaStream_t stream) {
  const bool vec = qkv_aligned<T>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st);
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    auto kern = bias_kernel<T, DH>();
    return launch_pass(kern, dim3((Tq + BM - 1) / BM, H, B), fwd_smem_bytes<T, DH>(), stream,
                       static_cast<const T*>(q), q_sb, q_st, static_cast<const T*>(k), k_sb,
                       k_st, static_cast<const T*>(v), v_sb, v_st, bias, static_cast<T*>(out),
                       lse, Tq, Tk, H, scale, vec);
  });
}

}  // namespace

// Kernel 2.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q: (B, Tq, H, Dh) with batch / row strides q_sb / q_st in elements and
// (H, Dh) contiguous; k, v likewise over Tk; kv_bias: (B, Tk) f32 or null;
// out: (B, Tq, H, Dh) contiguous; lse: (B, H, Tq) f32 or null (not written);
// prefix_s < 0 selects dense mode.  drop_threshold: keep a probability when
// its Philox bits are >= it (0 = no dropout); inv_keep = 1 / (1 - rate);
// seed: the 64-bit Philox key; scale: the logits' scale, 1 / sqrt(Dh) of the
// caller's head dim (the wrapper zero-pads other head dims up to an
// instantiated one).  Returns the cudaError_t of the launch.
extern "C" int prefix_attention_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* kv_bias,
    void* out, float* lse, int dtype, int B, int Tq, int Tk, int H, int Dh, int prefix_s,
    unsigned drop_threshold, float inv_keep, unsigned long long seed, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_threshold, inv_keep,
                     make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32))};
  if (dtype == 0)
    return (int)launch_prefix<float>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                     out, lse, B, Tq, Tk, H, prefix_s, drop, scale, s);
  if (dtype == 1)
    return (int)launch_prefix<__nv_bfloat16>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,
                                             kv_bias, out, lse, B, Tq, Tk, H, prefix_s, drop,
                                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4.  dtype, q, k, v, out, lse and scale as in prefix_attention_launch;
// bias: f32, element (b, h, r, c) at bias[b * b_sb + h * b_sh + r * b_sq +
// c * b_sk].  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// where an offset within one (b, h) slice of the bias needs 32 bits or
// more).
extern "C" int flash_attention_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* bias,
    long long b_sb, long long b_sh, long long b_sq, long long b_sk, void* out, float* lse,
    int dtype, int B, int Tq, int Tk, int H, int Dh, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias bs{bias, b_sb, b_sh, b_sq, b_sk};
  // the kernel indexes within one (b, h) slice of the bias in 32 bits
  if ((long long)Tq * llabs(b_sq) + (long long)Tk * llabs(b_sk) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_bias<float>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bs, out, lse,
                                   B, Tq, Tk, H, scale, s);
  if (dtype == 1)
    return (int)launch_bias<__nv_bfloat16>(Dh, q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, bs,
                                           out, lse, B, Tq, Tk, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
