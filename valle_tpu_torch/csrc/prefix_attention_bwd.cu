// Attention backward for Hopper (sm_90a): kernel 3 (prefix-LM / dense, with
// dropout) and kernel 4's backward (dense bias), one set of tile bodies for
// both.
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
// TPU kernels cast them to the input dtype; every sum is kept in f32 (the TPU
// kernel 3 sums its dK/dV window partials in the model dtype).  dq, dk, dv
// are written in the input dtype.
//
// What bounds it on the H100: operations.  Five products per visible (row,
// column) pair (S, dP, dV, dQ, dK): 10 B H Dh visible flops against 67
// TFLOP/s of f32 CUDA-core FMA, with a few MB of inputs (plus kernel 4's bias
// and, when written, 4 B H Tq Tk bytes of d(bias)).
//
// What the design does about it: three launches, no atomics, so two runs give
// bit-equal gradients.
//   1. delta: one warp per (b, row, head).
//   2. dQ (and kernel 4's d(bias), since this pass holds dS per tile): one
//      block of 256 threads per (64-row q tile, head, batch), walking 64-column
//      key tiles up to the tile's frontier max(prefix_s, tile end), as the
//      forward does (kernel 4: every key tile).
//   3. dK/dV: one block per (64-column key tile, head, batch), walking only
//      the q tiles that can see it: in prefix mode a key tile at c0 >= prefix_s
//      is seen by rows >= c0 only, one at c0 < prefix_s by every row (kernel 4:
//      every q tile).
// Each block recomputes its S tile with the forward's exact loop (the same
// staging of q, FMAs in the same order), so P is the forward's to rounding.
// Dropout bits and dS are formed in an element pass over shared memory where
// one thread owns 4 adjacent columns (one Philox call).  Each thread holds a
// 4 x 4 block of scores and a 4 x Dh/16 block of its outputs.  Later work:
// tensor cores (wgmma) and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "philox.cuh"

namespace {

// The value a product operand takes in type T (the TPU kernels' casts).
template <typename T>
__device__ __forceinline__ float round_like(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ bool visible(int r, int c, int Tq, int Tk, int prefix_s) {
  return r < Tq && c < Tk && (prefix_s < 0 || c < prefix_s || (r >= prefix_s && c <= r));
}

// Kernel 4's S of one element: (q.k + bias) * scale for a row < Tq and a
// column < Tk, -inf otherwise (so P is 0 there).
__device__ __forceinline__ float logit(float qk, const float* bb, const Bias& bias, int r, int c,
                                       int Tq, int Tk, float scale) {
  if (r >= Tq || c >= Tk) return -INFINITY;
  return (qk + bb[(long long)r * bias.sq + (long long)c * bias.sk]) * scale;
}

// Stage a 64-row tile of x (rows [r0, r0 + 64) of a (.., T, H, DH) view with
// row stride x_st) transposed into s[d * LD + r], times mul; rows >= lim are 0.
template <typename T, int DH>
__device__ __forceinline__ void stage_t(float* s, const T* x, long long x_st, int r0, int lim,
                                        float mul) {
  for (int i = threadIdx.x; i < 64 * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float val = 0.f;
    if (r0 + r < lim) val = to_float(x[(long long)(r0 + r) * x_st + d]) * mul;
    s[d * LD + r] = val;
  }
}

// S = q k^T and dPd = dO v^T for rows ty*4+i, columns tx+16j of the staged
// tiles, in the forward kernel's FMA order.
template <int DH>
__device__ __forceinline__ void scores(const float* sQt, const float* sKt, const float* sDOt,
                                       const float* sVt, int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float4 ov = *reinterpret_cast<const float4*>(&sDOt[d * LD + ty * 4]);
    const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
    float vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = sVt[d * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(oa[i], vv[j], dp[i][j]);
  }
}

// One element of kernel 3's softmax backward: x = score + bias (-inf if
// masked), dpd = (dO V^T) of the element; returns dS and sets pd = dropped P.
template <bool kDrop>
__device__ __forceinline__ float grad_elem(float x, float dpd, float lse, float delta, bool keep,
                                           float inv_keep, float* pd) {
  const float p = (x == -INFINITY) ? 0.f : expf(x - lse);
  float dp = dpd;
  *pd = p;
  if constexpr (kDrop) {
    *pd = keep ? p * inv_keep : 0.f;
    dp = keep ? dpd * inv_keep : 0.f;
  }
  return p * (dp - delta);
}

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

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)DH * LD * 4 + (size_t)BK * LD * 2 + BK + BQ * 2;
}

// The dQ pass of one (64-row q tile, head, batch).  kBias: kernel 4 (q
// staged unscaled, dense bias, no structural mask, writes d(bias) when
// dbias is not null); otherwise kernel 3.
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dq_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ dbias, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DJ = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;             // [DH][LD]  q^T (pre-scaled unless kBias)
  float* sDOt = sQt + DH * LD;   // [DH][LD]  dO^T
  float* sKt = sDOt + DH * LD;   // [DH][LD]  k^T
  float* sVt = sKt + DH * LD;    // [DH][LD]  v^T
  float* sS = sVt + DH * LD;     // [BK][LD]  scores, column-major (c * LD + r)
  float* sD = sS + BK * LD;      // [BK][LD]  dPd, then dS, column-major
  float* sBias = sD + BK * LD;   // [BK]      key bias (kernel 3 only)
  float* sLse = sBias + (kBias ? 0 : BK);  // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;  // kernel 4 indexes (b, h) rows in 64 bits
  int kend = Tk;
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BQ));

  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  stage_t<T, DH>(sQt, q + (long long)b * q_sb + (long long)h * DH, q_st, r0, Tq,
                 kBias ? 1.f : scale);
  stage_t<T, DH>(sDOt, dout + (long long)b * Tq * H * DH + (long long)h * DH, (long long)H * DH,
                 r0, Tq, 1.f);
  if (tid < BQ) {
    const bool ok = r0 + tid < Tq;
    sLse[tid] = ok ? lse[(kBias ? bh4 : (long long)bh) * Tq + r0 + tid] : 0.f;
    sDelta[tid] = ok ? delta[(kBias ? bh4 : (long long)bh) * Tq + r0 + tid] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<T, DH>(sKt, kb, k_st, k0, kend, 1.f);
    stage_t<T, DH>(sVt, vb, v_st, k0, kend, 1.f);
    if constexpr (!kBias) {
      if (tid < BK)
        sBias[tid] = (kv_bias != nullptr && k0 + tid < kend) ? kv_bias[(long long)b * Tk + k0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DH>(sQt, sKt, sDOt, sVt, tx, ty, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j, c = k0 + cl;
      float4 w, w2;
      float* wp = reinterpret_cast<float*>(&w);
      float* wp2 = reinterpret_cast<float*>(&w2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        if constexpr (kBias)
          wp[i] = logit(s[i][j], bb, bias, r, c, Tq, Tk, scale);
        else
          wp[i] = (c < kend && visible(r, c, Tq, Tk, prefix_s)) ? s[i][j] + sBias[cl] : -INFINITY;
        wp2[i] = dp[i][j];
      }
      *reinterpret_cast<float4*>(&sS[cl * LD + ty * 4]) = w;
      *reinterpret_cast<float4*>(&sD[cl * LD + ty * 4]) = w2;
    }
    __syncthreads();

    {  // element pass: thread (row, 4-column group); a warp spans 32 rows
      const int r = tid & (BQ - 1);
#pragma unroll
      for (int m = 0; m < BK / 16; ++m) {
        const int g = (tid >> 6) + 4 * m;
        unsigned keep = 0xFu;
        if constexpr (kDrop)
          keep = philox_keep4((unsigned)(k0 >> 2) + g, (unsigned)(r0 + r), bh, drop.seed,
                              drop.threshold);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = (4 * g + e) * LD + r;
          float ds;
          if constexpr (kBias) {
            const float x = sS[idx];
            const float p = (x == -INFINITY) ? 0.f : expf(x - sLse[r]);
            ds = (sD[idx] - sDelta[r]) * p * scale;
            const int c = k0 + 4 * g + e;
            if (dbias != nullptr && r0 + r < Tq && c < Tk)
              dbias[(((kBias ? bh4 : (long long)bh) * Tq + r0 + r) * Tk) + c] = ds;
          } else {
            float pd;
            ds = grad_elem<kDrop>(sS[idx], sD[idx], sLse[r], sDelta[r], (keep >> e) & 1u,
                                  drop.inv_keep, &pd);
          }
          sD[idx] = round_like<T>(ds);
        }
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty*4 + i, dims tx + 16 j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 dv4 = *reinterpret_cast<const float4*>(&sD[c * LD + ty * 4]);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sKt[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(da[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= Tq) continue;
    T* o = dq + (((long long)b * Tq + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if constexpr (kBias)  // dS already carries the scale
        from_float(acc[i][j], &o[tx + 16 * j]);
      else
        from_float(acc[i][j] * scale, &o[tx + 16 * j]);
    }
  }
}

// The dK/dV pass of one (64-column key tile, head, batch); kBias as in
// attn_bwd_dq_tile.
template <typename T, int DH, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dkv_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DJ = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;             // [DH][LD]  k^T of this block's key tile
  float* sVt = sKt + DH * LD;    // [DH][LD]  v^T
  float* sQt = sVt + DH * LD;    // [DH][LD]  q^T of the current q tile (pre-scaled unless kBias)
  float* sDOt = sQt + DH * LD;   // [DH][LD]  dO^T
  float* sS = sDOt + DH * LD;    // [BQ][LD]  scores, then Pd, row-major (r * LD + c)
  float* sD = sS + BQ * LD;      // [BQ][LD]  dPd, then dS, row-major
  float* sBias = sD + BQ * LD;   // [BK]      key bias (kernel 3 only)
  float* sLse = sBias + (kBias ? 0 : BK);  // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int c0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;  // kernel 4 indexes (b, h) rows in 64 bits
  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* dob = dout + (long long)b * Tq * H * DH + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;

  stage_t<T, DH>(sKt, k + (long long)b * k_sb + (long long)h * DH, k_st, c0, Tk, 1.f);
  stage_t<T, DH>(sVt, v + (long long)b * v_sb + (long long)h * DH, v_st, c0, Tk, 1.f);
  if constexpr (!kBias) {
    if (tid < BK)
      sBias[tid] = (kv_bias != nullptr && c0 + tid < Tk) ? kv_bias[(long long)b * Tk + c0 + tid] : 0.f;
  }

  float acc_k[4][DJ], acc_v[4][DJ];  // columns ty*4 + i, dims tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // In prefix mode rows < c0 see no column of this tile unless c0 < prefix_s.
  const int rstart = (!kBias && prefix_s >= 0 && c0 >= prefix_s) ? c0 : 0;
  for (int r0 = rstart; r0 < Tq; r0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<T, DH>(sQt, qb, q_st, r0, Tq, kBias ? 1.f : scale);
    stage_t<T, DH>(sDOt, dob, (long long)H * DH, r0, Tq, 1.f);
    if (tid < BQ) {
      const bool ok = r0 + tid < Tq;
      sLse[tid] = ok ? lse[(kBias ? bh4 : (long long)bh) * Tq + r0 + tid] : 0.f;
      sDelta[tid] = ok ? delta[(kBias ? bh4 : (long long)bh) * Tq + r0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DH>(sQt, sKt, sDOt, sVt, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = r0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        if constexpr (kBias)
          sS[rl * LD + cl] = logit(s[i][j], bb, bias, r, c0 + cl, Tq, Tk, scale);
        else
          sS[rl * LD + cl] = visible(r, c0 + cl, Tq, Tk, prefix_s) ? s[i][j] + sBias[cl] : -INFINITY;
        sD[rl * LD + cl] = dp[i][j];
      }
    }
    __syncthreads();

    {  // element pass: thread (4-column group, row); 16 threads cover one row
      const int g = tid & 15;
#pragma unroll
      for (int m = 0; m < BQ / 16; ++m) {
        const int rl = (tid >> 4) + 16 * m;
        unsigned keep = 0xFu;
        if constexpr (kDrop)
          keep = philox_keep4((unsigned)(c0 >> 2) + g, (unsigned)(r0 + rl), bh, drop.seed,
                              drop.threshold);
        float4* ps = reinterpret_cast<float4*>(&sS[rl * LD + 4 * g]);
        float4* pdd = reinterpret_cast<float4*>(&sD[rl * LD + 4 * g]);
        float4 xs = *ps, xd = *pdd;
        float* xsp = reinterpret_cast<float*>(&xs);
        float* xdp = reinterpret_cast<float*>(&xd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kBias) {
            const float p = (xsp[e] == -INFINITY) ? 0.f : expf(xsp[e] - sLse[rl]);
            xdp[e] = round_like<T>((xdp[e] - sDelta[rl]) * p * scale);
            xsp[e] = round_like<T>(p);
          } else {
            float pd;
            const float ds = grad_elem<kDrop>(xsp[e], xdp[e], sLse[rl], sDelta[rl],
                                              (keep >> e) & 1u, drop.inv_keep, &pd);
            xsp[e] = round_like<T>(pd);
            xdp[e] = round_like<T>(ds);
          }
        }
        *ps = xs;
        *pdd = xd;
      }
    }
    __syncthreads();

    // dV += Pd^T dO, dK += dS^T q (q pre-scaled unless kBias, where dS
    // carries the scale): columns ty*4 + i, dims tx + 16 j.
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sS[r * LD + ty * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&sD[r * LD + ty * 4]);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
      float ov[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sDOt[(tx + 16 * j) * LD + r];
        qv[j] = sQt[(tx + 16 * j) * LD + r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[i][j] = fmaf(pa[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(da[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= Tk) continue;
    const long long off = (((long long)b * Tk + c) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      from_float(acc_k[i][j], &dk[off + tx + 16 * j]);
      from_float(acc_v[i][j], &dv[off + tx + 16 * j]);
    }
  }
}

// Kernel 3's passes.
template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  attn_bwd_dq_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                        Bias{}, dout, lse, delta, dq, nullptr, Tq, Tk, H,
                                        prefix_s, scale, drop);
}

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  attn_bwd_dkv_tile<T, DH, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                         Bias{}, dout, lse, delta, dk, dv, Tq, Tk, H, prefix_s,
                                         scale, drop);
}

// Kernel 4's passes.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bias_bwd_dq_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias,
    int Tq, int Tk, int H, float scale) {
  attn_bwd_dq_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,
                                       bias, dout, lse, delta, dq, dbias, Tq, Tk, H, -1, scale,
                                       Dropout{});
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bias_bwd_dkv_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
    int H, float scale) {
  attn_bwd_dkv_tile<T, DH, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr,
                                        bias, dout, lse, delta, dk, dv, Tq, Tk, H, -1, scale,
                                        Dropout{});
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
cudaError_t launch_bwd(int Dh, const Args& a, Dropout drop, cudaStream_t stream) {
  return dispatch_dh(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    const size_t smem = sizeof(float) * smem_floats<DH>();
    const float scale = 1.f / sqrtf((float)DH);
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    T* dq = static_cast<T*>(a.dq);
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    const dim3 gq((a.Tq + BQ - 1) / BQ, a.H, a.B), gk((a.Tk + BK - 1) / BK, a.H, a.B);

    const int n_rows = a.B * a.Tq * a.H;
    auto kdelta = attn_bwd_delta_kernel<T>;
    cudaError_t err = launch(kdelta, dim3((n_rows + kThreads / 32 - 1) / (kThreads / 32)), 0,
                             stream, dout, static_cast<const T*>(a.out), a.delta, n_rows, a.Tq,
                             a.H, DH);
    if (err != cudaSuccess) return err;
    if constexpr (kBias) {
      auto kdq = flash_bias_bwd_dq_kernel<T, DH>;
      auto kdkv = flash_bias_bwd_dkv_kernel<T, DH>;
      err = launch(kdq, gq, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                   a.v_st, a.bias, dout, a.lse, a.delta, dq, a.dbias, a.Tq, a.Tk, a.H, scale);
      if (err != cudaSuccess) return err;
      return launch(kdkv, gk, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                    a.v_st, a.bias, dout, a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H, scale);
    } else {
      auto kdq = attn_bwd_dq_kernel<T, DH, true>;
      auto kdkv = attn_bwd_dkv_kernel<T, DH, true>;
      if (drop.threshold == 0) {
        kdq = attn_bwd_dq_kernel<T, DH, false>;
        kdkv = attn_bwd_dkv_kernel<T, DH, false>;
      }
      err = launch(kdq, gq, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                   a.v_st, a.kv_bias, dout, a.lse, a.delta, dq, a.Tq, a.Tk, a.H, a.prefix_s,
                   scale, drop);
      if (err != cudaSuccess) return err;
      return launch(kdkv, gk, smem, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                    a.v_st, a.kv_bias, dout, a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H, a.prefix_s,
                    scale, drop);
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
// prefix_attention_launch.  Returns the first cudaError_t of the three
// launches.
extern "C" int prefix_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* kv_bias,
    const void* out, const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Tq, int Tk, int H, int Dh, int prefix_s,
    unsigned drop_threshold, float inv_keep, unsigned long long seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, kv_bias, Bias{}, out, dout, lse,
               delta, dq, dk, dv, nullptr, B, Tq, Tk, H, prefix_s};
  const Dropout drop{drop_threshold, inv_keep,
                     make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32))};
  if (dtype == 0) return (int)launch_bwd<float, false>(Dh, a, drop, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16, false>(Dh, a, drop, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4's backward.  dtype, q, k, v, out, dout, dq, dk, dv, lse and delta
// as in prefix_attention_bwd_launch; bias: f32 read through (b_sb, b_sh,
// b_sq, b_sk) as in flash_attention_launch; dbias: (B, H, Tq, Tk) f32
// contiguous, or null to skip it.  Returns the first cudaError_t of the
// three launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* bias,
    long long b_sb, long long b_sh, long long b_sq, long long b_sk, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    float* dbias, int dtype, int B, int Tq, int Tk, int H, int Dh, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, nullptr,
               Bias{bias, b_sb, b_sh, b_sq, b_sk}, out, dout, lse, delta, dq, dk, dv, dbias,
               B, Tq, Tk, H, -1};
  if (dtype == 0) return (int)launch_bwd<float, true>(Dh, a, Dropout{}, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16, true>(Dh, a, Dropout{}, s);
  return (int)cudaErrorInvalidValue;
}
