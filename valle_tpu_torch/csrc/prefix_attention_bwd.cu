// Attention backward for Hopper (sm_90a): kernel 3 (prefix-LM / dense, with
// dropout) and kernel 4's backward (dense bias), one set of tile bodies for
// both, on the tensor cores.
//
// Kernel 3 replaces: valle_tpu/ops/fused_attention.py::_bwd_kernel (driven by
// _pallas_bwd, pallas_call at fused_attention.py:268, and the custom_vjp at
// :400-430).  Given q, k, v, the key bias, the forward's output `out`, its row
// log-sum-exp `lse` (prefix_attention.cu) and the output gradient dO:
//   P    = exp(q k^T / sqrt(Dh) + bias - lse)      (recomputed, never stored)
//   Pd   = keep * P / (1 - rate)                    (Philox bits, philox.cuh)
//   dV   = Pd^T dO
//   dP   = keep * (dO V^T) / (1 - rate)
//   delta = rowsum(dO * out)   (the dropout mask cancels in this row term)
//   dS   = P * (dP - delta)
//   dQ   = dS K / sqrt(Dh),  dK = dS^T Q / sqrt(Dh)
// with the forward's structural mask (prefix_s > 0 prefix-LM, 0 causal, < 0
// dense with Tq != Tk allowed).
//
// Kernel 4's backward replaces: JAX's library Pallas flash backward on the
// dense `ab` branch of valle_tpu/ops/flash_attention.py::flash_attention_biased
// (installed jax/experimental/pallas/ops/tpu/flash_attention.py, pallas_call
// at :1121 for dK/dV and :1456 for dQ and d(ab)).  In the library's order:
//   S     = (q k^T + bias) * scale,  P = exp(S - lse)
//   dV    = P^T dO,  dP = dO V^T,  delta = rowsum(dO * out)
//   dS    = (dP - delta) * P * scale
//   dQ    = dS K,  dK = dS^T q,  d(bias) = dS
// with no structural mask.  d(bias) is written in f32 as the full (B, H, Tq,
// Tk) tensor, only when the caller asks for it (the wrapper sums it over the
// broadcast dimensions).  It is the kBias instantiation of the tile bodies;
// kBias = false compiles to kernel 3's code alone.
//
// In bf16, P (Pd) and dS are rounded to bf16 before their products, as the
// TPU kernels cast them to the input dtype (they are the MMA operands); every
// sum is kept in f32 (the TPU kernel 3 sums its dK/dV window partials in the
// model dtype).  dq, dk, dv are written in the input dtype.
//
// What bounds it on the H100: operations.  Five products per visible (row,
// column) pair (S, dP, dV, dQ, dK): 10 B H Dh flops per visible pair, with a
// few MB of inputs (plus kernel 4's bias and, when written, 4 B H Tq Tk bytes
// of d(bias)).  bf16 runs on the tensor cores at 989 TFLOP/s dense.  f32
// runs as 3xTF32: three TF32 products per f32 product at 495 TFLOP/s, i.e.
// 165 TFLOP/s of f32-accurate products, against 67 TFLOP/s of f32 FMA on the
// CUDA cores.
//
// What the design does about it:
//   1. Tensor cores for all five products, with mma.sync: bf16 m16n8k16, and
//      for f32 m16n8k8 TF32 three times, each operand x split into big =
//      tf32_rna(x) and small = tf32_rna(x - big), summing small*big,
//      big*small, big*big in f32, in that order.  TF32 stays off globally;
//      3xTF32 is this kernel's own arithmetic.  The tensor cores round their
//      sums toward zero, so the long sums (dQ over keys, dK / dV over rows)
//      take each k step's three products into a zeroed fragment and add it in
//      f32: without that the bias reached 1e-5 of the result at T = 880.
//   2. Tiles are copied row-major, untransposed, with 16-byte cp.async into a
//      ring of two stages, so the next tile's loads overlap the current
//      tile's MMAs (zero-filled past the ragged edge; a plain copy where a
//      row is not 16-byte aligned).  The dQ pass streams K and V; the dK/dV
//      pass streams Q, dO, LSE and delta.  Rows are padded by 16 bytes: bf16
//      fragments come from ldmatrix (8 rows of 16 bytes at a row stride of 16
//      mod 128 bytes), f32 fragments from 32-bit loads whose row stride is 4
//      mod 32 words; neither has bank conflicts.  bf16 is staged as bf16.
//   3. The element pass runs in registers on the MMA's S and dP accumulator
//      fragments, which then serve as the A operand of the next product with
//      no trip through shared memory: in the dQ pass, dS (rows x keys) is the
//      A of dQ = dS K; the dK/dV pass computes S^T = K q^T and dP^T = V dO^T
//      directly, so Pd^T and dS^T are the A of dV = Pd^T dO and dK = dS^T q.
//      For TF32 the k index of the second product is permuted (k = t -> col
//      2t, k = t + 4 -> col 2t + 1) on both operands, which leaves the sum
//      unchanged.  One lane computes the Philox call of each (row, 4-column
//      group), counter (col / 4, row, b H + h) as before, and the others take
//      its bits with shuffles.  Kernel 4's bias is read before the products,
//      so that its latency hides behind them.
//   4. The kernel is latency-bound, so occupancy decides: 4 warps of 16 rows
//      (dQ pass) or 16 key columns (dK/dV pass) per block, 16-row streamed
//      tiles (52 KB of shared memory in f32 at Dh = 64), and launch bounds per
//      instantiation (bounds_class) that fit four blocks per SM in at most
//      128 registers where ptxas manages that without spills.  No
//      instantiation spills.
//   5. Three launches, no atomics, so two runs give bit-equal gradients:
//      delta (one warp per (b, row, head)); dQ (and kernel 4's d(bias)) per
//      (64-row q tile, head, batch), walking key tiles up to the tile's
//      frontier max(prefix_s, tile end) (kernel 4: every key tile); dK/dV per
//      (64-column key tile, head, batch), walking only the q tiles that can
//      see it (prefix mode: rows >= c0 for a key tile at c0 >= prefix_s).
//      P is recomputed in both passes.  S no longer follows the forward's
//      FMA order, so P agrees with the forward's to f32 rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <type_traits>

#include "attention_common.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"

namespace {

// The streamed tile of either pass (the block's 64 rows are BM of
// mma_tile.cuh): 16 rows of keys (dQ pass) or of q (dK/dV pass).
constexpr int BN = 16;

// The launch bounds of a pass instantiation, chosen so that ptxas reports no
// spills: 4 asks it to fit four blocks of kMmaThreads per SM (at most 128
// registers), 1 lets it take up to 255, 0 leaves the choice to it (at Dh =
// 64 that gave fewer registers than 1).  In f32 at Dh = 64 the dQ passes
// take 100-114 registers unbounded, and kernel 4's dK/dV pass spills when
// held to 128.
template <typename T, int DH, bool kDrop, bool kBias, bool kDq>
constexpr int bounds_class() {
  if (DH != 64) return 1;
  if (!kF32<T>) return 4;
  return (!kDq && !kBias) ? 4 : 0;
}

// ------------------------------------------------------------ passes

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ delta, int n_rows,
    int Tq, int H, int DH) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // (b, r, h)
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc += to_float(dout[(long long)row * DH + d]) * to_float(out[(long long)row * DH + d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int h = row % H, r = (row / H) % Tq, b = row / (H * Tq);
    delta[((long long)b * H + h) * Tq + r] = acc;
  }
}

// Shared memory of either pass: four tiles (two stages of the streamed pair)
// plus the two that stay, and the dK/dV pass's two stages of LSE and delta.
template <typename T, int DH>
constexpr size_t bwd_smem_bytes() {
  return (2 * BM + 4 * BN) * (size_t)row_stride<T, DH>() * sizeof(T) + 4 * BN * sizeof(float);
}

// The dQ pass of one (64-row q tile, head, batch).  kBias: kernel 4 (dense
// bias, no structural mask, writes d(bias) when dbias is not null);
// otherwise kernel 3.
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dq_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ dbias, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int LDT = row_stride<T, DH>(), TILE = BN * LDT;
  constexpr int NT = BN / 8, DT = DH / 8;  // n8 tiles of a key tile, of Dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BM][LDT]
  T* sDO = sQ + BM * LDT;                  // [BM][LDT]
  T* sK = sDO + BM * LDT;                  // [2][BN][LDT]
  T* sV = sK + 2 * TILE;                   // [2][BN][LDT]

  const int r0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  int kend = Tk;
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BM));
  const int n_tiles = (kend + BN - 1) / BN;

  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  stage_rows<T, DH, BM>(sQ, q + (long long)b * q_sb + (long long)h * DH, q_st, r0, Tq, vec);
  stage_rows<T, DH, BM>(sDO, dout + (long long)b * Tq * H * DH + (long long)h * DH,
                        (long long)H * DH, r0, Tq, vec);
  stage_rows<T, DH, BN>(sK, kb, k_st, 0, kend, vec);
  stage_rows<T, DH, BN>(sV, vb, v_st, 0, kend, vec);
  cp_async_commit();

  const int wr = 16 * warp;  // the warp's first row in the tile
  const int ra = r0 + wr + g, rb = ra + 8;
  const float lse_a = ra < Tq ? lse[bh4 * Tq + ra] : 0.f;
  const float lse_b = rb < Tq ? lse[bh4 * Tq + rb] : 0.f;
  const float dl_a = ra < Tq ? delta[bh4 * Tq + ra] : 0.f;
  const float dl_b = rb < Tq ? delta[bh4 * Tq + rb] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < n_tiles) {  // the next K / V tile loads while this one computes
      stage_rows<T, DH, BN>(sK + ((it + 1) & 1) * TILE, kb, k_st, k0 + BN, kend, vec);
      stage_rows<T, DH, BN>(sV + ((it + 1) & 1) * TILE, vb, v_st, k0 + BN, kend, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + (it & 1) * TILE;
    const T* cV = sV + (it & 1) * TILE;

    {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // kernel 4's biases (-inf outside Tq x Tk), read before the products so
      // that their latency hides behind them
      float add[NT][4];
      if constexpr (kBias) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            add[n][e] = bias_at(bb, bias, e < 2 ? ra : rb, k0 + 8 * n + 2 * t + (e & 1), Tq, Tk);
      }
      mma_xyt<T, DH, NT>(s, sQ + wr * LDT, cK, lane);   // S = q k^T
      mma_xyt<T, DH, NT>(dp, sDO + wr * LDT, cV, lane); // dPd = dO v^T

      // element pass: s becomes dS, rounded like T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int cn = k0 + 8 * n;  // the n8 tile's first column
        unsigned keep_a = 0xFu, keep_b = 0xFu;
        if constexpr (kDrop) {
          // lane L draws (row wr + L % 16, group L / 16) of this 16 x 8 tile
          const unsigned w = philox_keep4((unsigned)(cn >> 2) + (lane >> 4),
                                          (unsigned)(r0 + wr + (lane & 15)), bh, drop.seed,
                                          drop.threshold);
          keep_a = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g) >> (2 * (t & 1));
          keep_b = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g + 8) >> (2 * (t & 1));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb, c = cn + 2 * t + (e & 1);
          const float lr = e < 2 ? lse_a : lse_b, dl = e < 2 ? dl_a : dl_b;
          float ds;
          if constexpr (kBias) {
            const float x = (s[n][e] + add[n][e]) * scale;
            const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
            ds = (dp[n][e] - dl) * p * scale;
            if (dbias != nullptr && r < Tq && c < Tk) dbias[(bh4 * Tq + r) * Tk + c] = ds;
          } else {
            const float kvb = (kv_bias != nullptr && c < Tk) ? kv_bias[(long long)b * Tk + c] : 0.f;
            const float x =
                (c < kend && visible(r, c, Tq, Tk, prefix_s)) ? s[n][e] * scale + kvb : -INFINITY;
            const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
            float dpd = dp[n][e];
            if constexpr (kDrop) {
              const bool keep = (((e < 2 ? keep_a : keep_b) >> (e & 1)) & 1u) != 0;
              dpd = keep ? dpd * drop.inv_keep : 0.f;
            }
            ds = p * (dpd - dl);
          }
          s[n][e] = round_like<T>(ds);
        }
      }
      mma_fz<T, DH, NT>(acc, s, cK, lane);  // dQ += dS k
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= Tq) continue;
      T* o = dq + (((long long)b * Tq + r) * H + h) * DH + 8 * n + 2 * t;
      from_float(acc[n][2 * half] * post, &o[0]);
      from_float(acc[n][2 * half + 1] * post, &o[1]);
    }
  }
}

// The dK/dV pass of one (64-column key tile, head, batch); kBias as in
// attn_bwd_dq_tile.  A warp owns 16 key columns and computes S^T and dP^T
// for them against NR q rows at a time.
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dkv_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int LDT = row_stride<T, DH>(), TILE = BN * LDT;
  // q rows whose S^T / dP^T a warp holds at once (f32 at Dh = 128: 8, or it spills)
  constexpr int NR = DH <= 64 ? BN : (kF32<T> ? 8 : 16);
  constexpr int RT = NR / 8, DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BM][LDT]
  T* sV = sK + BM * LDT;                   // [BM][LDT]
  T* sQ = sV + BM * LDT;                   // [2][BN][LDT]
  T* sDO = sQ + 2 * TILE;                  // [2][BN][LDT]
  float* sL = reinterpret_cast<float*>(sDO + 2 * TILE);  // [2][BN] lse
  float* sDl = sL + 2 * BN;                               // [2][BN] delta

  const int c0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* dob = dout + (long long)b * Tq * H * DH + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;

  // In prefix mode rows < c0 see no column of this tile unless c0 < prefix_s.
  const int rstart = (!kBias && prefix_s >= 0 && c0 >= prefix_s) ? c0 : 0;
  const int n_tiles = (Tq - rstart + BN - 1) / BN;

  // LSE and delta of rows [r0, r0 + BN) into stage `st` (zero past Tq).
  auto stage_rowstats = [&](int st, int r0) {
    if (threadIdx.x >= 2 * BN) return;
    const int i = threadIdx.x % BN, r = r0 + i;
    const bool ok = r < Tq;
    const float* src = threadIdx.x < BN ? lse : delta;
    float* dst = (threadIdx.x < BN ? sL : sDl) + st * BN + i;
    if (vec)
      cp_async4(dst, ok ? src + bh4 * Tq + r : src, ok);
    else
      *dst = ok ? src[bh4 * Tq + r] : 0.f;
  };

  stage_rows<T, DH, BM>(sK, k + (long long)b * k_sb + (long long)h * DH, k_st, c0, Tk, vec);
  stage_rows<T, DH, BM>(sV, v + (long long)b * v_sb + (long long)h * DH, v_st, c0, Tk, vec);
  stage_rows<T, DH, BN>(sQ, qb, q_st, rstart, Tq, vec);
  stage_rows<T, DH, BN>(sDO, dob, (long long)H * DH, rstart, Tq, vec);
  stage_rowstats(0, rstart);
  cp_async_commit();

  const int wc = 16 * warp;  // the warp's first column in the tile
  const int ca = c0 + wc + g, cb = ca + 8;
  float kvb_a = 0.f, kvb_b = 0.f;
  if constexpr (!kBias) {
    if (kv_bias != nullptr) {
      if (ca < Tk) kvb_a = kv_bias[(long long)b * Tk + ca];
      if (cb < Tk) kvb_b = kv_bias[(long long)b * Tk + cb];
    }
  }

  float acc_k[DT][4], acc_v[DT][4];  // rows: the warp's columns; columns: Dh
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = rstart + it * BN, st = it & 1;
    if (it + 1 < n_tiles) {  // the next q tile loads while this one computes
      stage_rows<T, DH, BN>(sQ + (st ^ 1) * TILE, qb, q_st, r0 + BN, Tq, vec);
      stage_rows<T, DH, BN>(sDO + (st ^ 1) * TILE, dob, (long long)H * DH, r0 + BN, Tq, vec);
      stage_rowstats(st ^ 1, r0 + BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cQ = sQ + st * TILE;
    const T* cDO = sDO + st * TILE;
    const float* cL = sL + st * BN;
    const float* cDl = sDl + st * BN;

#pragma unroll 1
    for (int rc = 0; rc < BN && r0 + rc < Tq; rc += NR) {
      float s[RT][4], dp[RT][4];
#pragma unroll
      for (int n = 0; n < RT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // each score's additive term (bias; -inf where masked), read before the
      // products as in the dQ pass
      // the keep bits of the fragment's elements in n8 tile n of this chunk
      auto keep_bits = [&](int n) -> unsigned {
        // lane L draws (row L % 8, group L / 8) of this 8 x 16 tile
        const unsigned w = philox_keep4((unsigned)((c0 + wc) >> 2) + (lane >> 3),
                                        (unsigned)(r0 + rc + 8 * n + (lane & 7)), bh, drop.seed,
                                        drop.threshold);
        const int src = (g >> 2) * 8 + 2 * t, bit = g & 3;
        return ((__shfl_sync(0xffffffffu, w, src) >> bit) & 1u) |
               (((__shfl_sync(0xffffffffu, w, src + 1) >> bit) & 1u) << 1) |
               (((__shfl_sync(0xffffffffu, w, src + 16) >> bit) & 1u) << 2) |
               (((__shfl_sync(0xffffffffu, w, src + 17) >> bit) & 1u) << 3);
      };
      // drawn before the products (fewer registers live across them)
      unsigned keeps = 0;
      if constexpr (kDrop) {
#pragma unroll
        for (int n = 0; n < RT; ++n) keeps |= keep_bits(n) << (4 * n);
      }
      float add[RT][4];
#pragma unroll
      for (int n = 0; n < RT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + rc + 8 * n + 2 * t + (e & 1), c = e < 2 ? ca : cb;
          if constexpr (kBias)
            add[n][e] = bias_at(bb, bias, r, c, Tq, Tk);
          else
            add[n][e] = visible(r, c, Tq, Tk, prefix_s) ? (e < 2 ? kvb_a : kvb_b) : -INFINITY;
        }
      mma_xyt<T, DH, RT>(s, sK + wc * LDT, cQ + rc * LDT, lane);   // S^T = k q^T
      mma_xyt<T, DH, RT>(dp, sV + wc * LDT, cDO + rc * LDT, lane); // dPd^T = v dO^T

      // element pass: s becomes Pd^T and dp becomes dS^T, rounded like T
#pragma unroll
      for (int n = 0; n < RT; ++n) {
        const int rl = rc + 8 * n;  // the n8 tile's first row in the q tile
        unsigned keep = 0xFu;  // bits: (ca, 2t), (ca, 2t + 1), (cb, 2t), (cb, 2t + 1)
        if constexpr (kDrop) keep = keeps >> (4 * n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rl + 2 * t + (e & 1);
          const float lr = cL[i], dl = cDl[i];
          if constexpr (kBias) {
            const float x = (s[n][e] + add[n][e]) * scale;
            const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
            dp[n][e] = round_like<T>((dp[n][e] - dl) * p * scale);
            s[n][e] = round_like<T>(p);
          } else {
            const float x = s[n][e] * scale + add[n][e];
            const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
            float pd = p, dpd = dp[n][e];
            if constexpr (kDrop) {
              const bool kept = ((keep >> e) & 1u) != 0;
              pd = kept ? p * drop.inv_keep : 0.f;
              dpd = kept ? dpd * drop.inv_keep : 0.f;
            }
            dp[n][e] = round_like<T>(p * (dpd - dl));
            s[n][e] = round_like<T>(pd);
          }
        }
      }
      mma_fz<T, DH, RT>(acc_v, s, cDO + rc * LDT, lane);  // dV += Pd^T dO
      mma_fz<T, DH, RT>(acc_k, dp, cQ + rc * LDT, lane);  // dK += dS^T q
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half ? cb : ca;
      if (c >= Tk) continue;
      const long long off = (((long long)b * Tk + c) * H + h) * DH + 8 * n + 2 * t;
      from_float(acc_k[n][2 * half] * post, &dk[off]);
      from_float(acc_k[n][2 * half + 1] * post, &dk[off + 1]);
      from_float(acc_v[n][2 * half], &dv[off]);
      from_float(acc_v[n][2 * half + 1], &dv[off + 1]);
    }
  }
}

// The pass kernels (kernel 3's attn_bwd_*, kernel 4's flash_bias_bwd_*),
// defined three times, once per launch bounds of bounds_class() (fit4, fit1,
// any_regs); each instantiation is taken from one of them.
#define BWD_PASS_KERNELS(BOUNDS)                                                                     \
template <typename T, int DH, bool kDrop>                                                         \
__global__ void BOUNDS attn_bwd_dq_kernel(                                                        \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, const T* __restrict__ dout,                                \
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,           \
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec) {                   \
  attn_bwd_dq_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,     \
                                        Bias{}, dout, lse, delta, dq, nullptr, Tq, Tk, H,         \
                                        prefix_s, scale, drop, vec);                              \
}                                                                                                 \
                                                                                                  \
template <typename T, int DH, bool kDrop>                                                         \
__global__ void BOUNDS attn_bwd_dkv_kernel(                                                       \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, const T* __restrict__ dout,                                \
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,           \
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,           \
    bool vec) {                                                                                   \
  attn_bwd_dkv_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,    \
                                         Bias{}, dout, lse, delta, dk, dv, Tq, Tk, H, prefix_s,   \
                                         scale, drop, vec);                                       \
}                                                                                                 \
                                                                                                  \
template <typename T, int DH>                                                                     \
__global__ void BOUNDS flash_bias_bwd_dq_kernel(                                                  \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,                         \
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias,               \
    int Tq, int Tk, int H, float scale, bool vec) {                                               \
  attn_bwd_dq_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,      \
                                       bias, dout, lse, delta, dq, dbias, Tq, Tk, H, -1, scale,   \
                                       Dropout{}, vec);                                           \
}                                                                                                 \
                                                                                                  \
template <typename T, int DH>                                                                     \
__global__ void BOUNDS flash_bias_bwd_dkv_kernel(                                                 \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,                         \
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,      \
    int H, float scale, bool vec) {                                                               \
  attn_bwd_dkv_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,     \
                                        bias, dout, lse, delta, dk, dv, Tq, Tk, H, -1, scale,     \
                                        Dropout{}, vec);                                          \
}                                                                                                 \
                                                                                                  
namespace fit4 {
BWD_PASS_KERNELS(__launch_bounds__(kMmaThreads, 4))
}  // namespace fit4
namespace fit1 {
BWD_PASS_KERNELS(__launch_bounds__(kMmaThreads, 1))
}  // namespace fit1
namespace any_regs {
BWD_PASS_KERNELS(__launch_bounds__(kMmaThreads))
}  // namespace any_regs
#undef BWD_PASS_KERNELS

template <typename T, int DH, bool kDrop>
auto dq_kernel() {
  constexpr int c = bounds_class<T, DH, kDrop, false, true>();
  if constexpr (c == 4) return fit4::attn_bwd_dq_kernel<T, DH, kDrop>;
  else if constexpr (c == 1) return fit1::attn_bwd_dq_kernel<T, DH, kDrop>;
  else return any_regs::attn_bwd_dq_kernel<T, DH, kDrop>;
}

template <typename T, int DH, bool kDrop>
auto dkv_kernel() {
  constexpr int c = bounds_class<T, DH, kDrop, false, false>();
  if constexpr (c == 4) return fit4::attn_bwd_dkv_kernel<T, DH, kDrop>;
  else if constexpr (c == 1) return fit1::attn_bwd_dkv_kernel<T, DH, kDrop>;
  else return any_regs::attn_bwd_dkv_kernel<T, DH, kDrop>;
}

template <typename T, int DH>
auto bias_dq_kernel() {
  constexpr int c = bounds_class<T, DH, false, true, true>();
  if constexpr (c == 4) return fit4::flash_bias_bwd_dq_kernel<T, DH>;
  else if constexpr (c == 1) return fit1::flash_bias_bwd_dq_kernel<T, DH>;
  else return any_regs::flash_bias_bwd_dq_kernel<T, DH>;
}

template <typename T, int DH>
auto bias_dkv_kernel() {
  constexpr int c = bounds_class<T, DH, false, true, false>();
  if constexpr (c == 4) return fit4::flash_bias_bwd_dkv_kernel<T, DH>;
  else if constexpr (c == 1) return fit1::flash_bias_bwd_dkv_kernel<T, DH>;
  else return any_regs::flash_bias_bwd_dkv_kernel<T, DH>;
}

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
  const float* kv_bias;  // kernel 3
  Bias bias;             // kernel 4
  const void *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* dbias;  // kernel 4, or null
  int B, Tq, Tk, H, prefix_s;
};

// The three passes of kernel 4 (kBias) or kernel 3.
template <typename T, bool kBias>
cudaError_t launch_bwd(int Dh, const Args& a, Dropout drop, float scale, cudaStream_t stream) {
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    const size_t smem = bwd_smem_bytes<T, DH>();
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    T* dq = static_cast<T*>(a.dq);
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    const dim3 gq((a.Tq + BM - 1) / BM, a.H, a.B), gk((a.Tk + BM - 1) / BM, a.H, a.B);
    const size_t es = sizeof(T);
    const bool vec = rows_aligned(q, a.q_sb, a.q_st, es) && rows_aligned(k, a.k_sb, a.k_st, es) &&
                     rows_aligned(v, a.v_sb, a.v_st, es) &&
                     rows_aligned(dout, (long long)a.Tq * a.H * DH, (long long)a.H * DH, es);

    const int n_rows = a.B * a.Tq * a.H;
    auto kdelta = attn_bwd_delta_kernel<T>;
    cudaError_t err = launch(kdelta, dim3((n_rows + kThreads / 32 - 1) / (kThreads / 32)), 0,
                             stream, dout, static_cast<const T*>(a.out), a.delta, n_rows, a.Tq,
                             a.H, DH);
    if (err != cudaSuccess) return err;
    if constexpr (kBias) {
      auto kdq = bias_dq_kernel<T, DH>();
      auto kdkv = bias_dkv_kernel<T, DH>();
      err = launch_pass(kdq, gq, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                        a.v_st, a.bias, dout, a.lse, a.delta, dq, a.dbias, a.Tq, a.Tk, a.H,
                        scale, vec);
      if (err != cudaSuccess) return err;
      return launch_pass(kdkv, gk, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                         a.v_st, a.bias, dout, a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H, scale,
                         vec);
    } else {
      auto kdq = dq_kernel<T, DH, true>();
      auto kdkv = dkv_kernel<T, DH, true>();
      if (drop.threshold == 0) {
        kdq = dq_kernel<T, DH, false>();
        kdkv = dkv_kernel<T, DH, false>();
      }
      err = launch_pass(kdq, gq, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                        a.v_st, a.kv_bias, dout, a.lse, a.delta, dq, a.Tq, a.Tk, a.H,
                        a.prefix_s, scale, drop, vec);
      if (err != cudaSuccess) return err;
      return launch_pass(kdkv, gk, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                         a.v_st, a.kv_bias, dout, a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H,
                         a.prefix_s, scale, drop, vec);
    }
  });
}

}  // namespace

// Kernel 3.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv
// share it).  q: (B, Tq, H, Dh) with batch / row strides in elements and
// (H, Dh) contiguous; k, v likewise over Tk; kv_bias: (B, Tk) f32 or null;
// out, dout, dq: (B, Tq, H, Dh) contiguous; dk, dv: (B, Tk, H, Dh)
// contiguous; lse and delta (scratch, written here): (B, H, Tq) f32.
// prefix_s < 0 selects dense mode.  drop_threshold / inv_keep / seed as in
// prefix_attention_launch; scale: the logits' scale, 1 / sqrt(Dh) of the
// caller's head dim (the wrapper zero-pads other head dims up to an
// instantiated one).  Returns the first cudaError_t of the three launches.
extern "C" int prefix_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* kv_bias,
    const void* out, const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Tq, int Tk, int H, int Dh, int prefix_s,
    unsigned drop_threshold, float inv_keep, unsigned long long seed, float scale,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, kv_bias, Bias{}, out, dout, lse,
               delta, dq, dk, dv, nullptr, B, Tq, Tk, H, prefix_s};
  const Dropout drop{drop_threshold, inv_keep,
                     make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32))};
  if (dtype == 0) return (int)launch_bwd<float, false>(Dh, a, drop, scale, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16, false>(Dh, a, drop, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4's backward.  dtype, q, k, v, out, dout, dq, dk, dv, lse, delta and scale
// as in prefix_attention_bwd_launch; bias: f32 read through (b_sb, b_sh,
// b_sq, b_sk) as in flash_attention_launch; dbias: (B, H, Tq, Tk) f32
// contiguous, or null to skip it.  Returns the first cudaError_t of the
// three launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* bias,
    long long b_sb, long long b_sh, long long b_sq, long long b_sk, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    float* dbias, int dtype, int B, int Tq, int Tk, int H, int Dh, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, nullptr,
               Bias{bias, b_sb, b_sh, b_sq, b_sk}, out, dout, lse, delta, dq, dk, dv, dbias,
               B, Tq, Tk, H, -1};
  // the kernels index within one (b, h) slice of the bias in 32 bits
  if ((long long)Tq * llabs(b_sq) + (long long)Tk * llabs(b_sk) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_bwd<float, true>(Dh, a, Dropout{}, scale, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16, true>(Dh, a, Dropout{}, scale, s);
  return (int)cudaErrorInvalidValue;
}
