// Prefix-LM / dense attention backward for Hopper (sm_90a), with dropout.
//
// Replaces: valle_tpu/ops/fused_attention.py::_bwd_kernel (driven by
// _pallas_bwd, pallas_call at fused_attention.py:268, and the custom_vjp at
// :400-430).
//
// Given q, k, v, the key bias, the forward's output `out`, its row
// log-sum-exp `lse` (prefix_attention.cu) and the output gradient dO:
//   P    = exp(q k^T / sqrt(Dh) + bias - lse)      (recomputed, never stored)
//   Pd   = keep * P / (1 - rate)                    (Philox bits, philox.cuh)
//   dV   = Pd^T dO
//   dP   = keep * (dO V^T) / (1 - rate)
//   delta = rowsum(dO * out)   (the dropout mask cancels in this row term)
//   dS   = P * (dP - delta)
//   dQ   = dS K / sqrt(Dh),  dK = dS^T Q / sqrt(Dh)
// with the forward's structural mask (prefix_s > 0 prefix-LM, 0 causal, < 0
// dense with Tq != Tk allowed).  In bf16, Pd and dS are rounded to bf16
// before their products, as the TPU kernel casts them to the input dtype;
// every sum is kept in f32 (the TPU kernel sums its dK/dV window partials in
// the model dtype).  dq, dk, dv are written in the input dtype.
//
// What bounds it on the H100: operations.  Five products per visible (row,
// column) pair (S, dPd, dV, dQ, dK): 10 B H Dh visible flops against 67
// TFLOP/s of f32 CUDA-core FMA, with a few MB of inputs.
//
// What the design does about it: three launches, no atomics, so two runs give
// bit-equal gradients.
//   1. delta: one warp per (b, row, head).
//   2. dQ: one block of 256 threads per (64-row q tile, head, batch), walking
//      64-column key tiles up to the tile's frontier max(prefix_s, tile end),
//      as the forward does.
//   3. dK/dV: one block per (64-column key tile, head, batch), walking only
//      the q tiles that can see it: in prefix mode a key tile at c0 >= prefix_s
//      is seen by rows >= c0 only, one at c0 < prefix_s by every row.
// Each block recomputes its S tile with the forward's exact loop (q staged
// pre-scaled, FMAs in the same order), so P is the forward's to rounding.
// Dropout bits and dS are formed in an element pass over shared memory where
// one thread owns 4 adjacent columns (one Philox call).  Each thread holds a
// 4 x 4 block of scores and a 4 x Dh/16 block of its outputs.  Later work:
// tensor cores (wgmma) and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // key columns per tile
constexpr int LD = 68;  // padded leading dimension (keeps float4 rows aligned)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// The value a product operand takes in type T (the TPU kernel's casts).
template <typename T>
__device__ __forceinline__ float round_like(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

struct Dropout {
  unsigned threshold;  // keep when bits >= threshold; 0 = no dropout
  float inv_keep;      // 1 / (1 - rate)
  uint2 seed;
};

__device__ __forceinline__ bool visible(int r, int c, int Tq, int Tk, int prefix_s) {
  return r < Tq && c < Tk && (prefix_s < 0 || c < prefix_s || (r >= prefix_s && c <= r));
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

// S = (q scale) k^T and dPd = dO v^T for rows ty*4+i, columns tx+16j of the
// staged tiles, in the forward kernel's FMA order.
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

// One element of the softmax backward: x = score + bias (-inf if masked),
// dpd = (dO V^T) of the element; returns dS and sets pd = dropped P.
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

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  constexpr int DJ = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;             // [DH][LD]  q^T, pre-scaled
  float* sDOt = sQt + DH * LD;   // [DH][LD]  dO^T
  float* sKt = sDOt + DH * LD;   // [DH][LD]  k^T
  float* sVt = sKt + DH * LD;    // [DH][LD]  v^T
  float* sS = sVt + DH * LD;     // [BK][LD]  scores, column-major (c * LD + r)
  float* sD = sS + BK * LD;      // [BK][LD]  dPd, then dS, column-major
  float* sBias = sD + BK * LD;   // [BK]
  float* sLse = sBias + BK;      // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const unsigned bh = (unsigned)(b * H + h);
  int kend = Tk;
  if (prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BQ));

  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  stage_t<T, DH>(sQt, q + (long long)b * q_sb + (long long)h * DH, q_st, r0, Tq, scale);
  stage_t<T, DH>(sDOt, dout + (long long)b * Tq * H * DH + (long long)h * DH, (long long)H * DH,
                 r0, Tq, 1.f);
  if (tid < BQ) {
    const bool ok = r0 + tid < Tq;
    sLse[tid] = ok ? lse[(long long)bh * Tq + r0 + tid] : 0.f;
    sDelta[tid] = ok ? delta[(long long)bh * Tq + r0 + tid] : 0.f;
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
    if (tid < BK)
      sBias[tid] = (kv_bias != nullptr && k0 + tid < kend) ? kv_bias[(long long)b * Tk + k0 + tid] : 0.f;
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
          float pd;
          const float ds = grad_elem<kDrop>(sS[idx], sD[idx], sLse[r], sDelta[r],
                                            (keep >> e) & 1u, drop.inv_keep, &pd);
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
    for (int j = 0; j < DJ; ++j) from_float(acc[i][j] * scale, &o[tx + 16 * j]);
  }
}

template <typename T, int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop) {
  constexpr int DJ = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;             // [DH][LD]  k^T of this block's key tile
  float* sVt = sKt + DH * LD;    // [DH][LD]  v^T
  float* sQt = sVt + DH * LD;    // [DH][LD]  q^T of the current q tile, pre-scaled
  float* sDOt = sQt + DH * LD;   // [DH][LD]  dO^T
  float* sS = sDOt + DH * LD;    // [BQ][LD]  scores, then Pd, row-major (r * LD + c)
  float* sD = sS + BQ * LD;      // [BQ][LD]  dPd, then dS, row-major
  float* sBias = sD + BQ * LD;   // [BK]
  float* sLse = sBias + BK;      // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int c0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const unsigned bh = (unsigned)(b * H + h);
  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* dob = dout + (long long)b * Tq * H * DH + (long long)h * DH;

  stage_t<T, DH>(sKt, k + (long long)b * k_sb + (long long)h * DH, k_st, c0, Tk, 1.f);
  stage_t<T, DH>(sVt, v + (long long)b * v_sb + (long long)h * DH, v_st, c0, Tk, 1.f);
  if (tid < BK)
    sBias[tid] = (kv_bias != nullptr && c0 + tid < Tk) ? kv_bias[(long long)b * Tk + c0 + tid] : 0.f;

  float acc_k[4][DJ], acc_v[4][DJ];  // columns ty*4 + i, dims tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // In prefix mode rows < c0 see no column of this tile unless c0 < prefix_s.
  const int rstart = (prefix_s >= 0 && c0 >= prefix_s) ? c0 : 0;
  for (int r0 = rstart; r0 < Tq; r0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    stage_t<T, DH>(sQt, qb, q_st, r0, Tq, scale);
    stage_t<T, DH>(sDOt, dob, (long long)H * DH, r0, Tq, 1.f);
    if (tid < BQ) {
      const bool ok = r0 + tid < Tq;
      sLse[tid] = ok ? lse[(long long)bh * Tq + r0 + tid] : 0.f;
      sDelta[tid] = ok ? delta[(long long)bh * Tq + r0 + tid] : 0.f;
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
        sS[rl * LD + cl] = visible(r, c0 + cl, Tq, Tk, prefix_s) ? s[i][j] + sBias[cl] : -INFINITY;
        sD[rl * LD + cl] = dp[i][j];
      }
    }
    __syncthreads();

    {  // element pass: thread (4-column group, row); 8 threads cover one row
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
          float pd;
          const float ds = grad_elem<kDrop>(xsp[e], xdp[e], sLse[rl], sDelta[rl],
                                            (keep >> e) & 1u, drop.inv_keep, &pd);
          xsp[e] = round_like<T>(pd);
          xdp[e] = round_like<T>(ds);
        }
        *ps = xs;
        *pdd = xd;
      }
    }
    __syncthreads();

    // dV += Pd^T dO, dK += dS^T (q scale): columns ty*4 + i, dims tx + 16 j.
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

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
  const float* kv_bias;
  const void *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Tq, Tk, H, prefix_s;
};

template <typename T, int DH, bool kDrop>
cudaError_t launch_typed(const Args& a, Dropout drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  auto kdq = attn_bwd_dq_kernel<T, DH, kDrop>;
  auto kdkv = attn_bwd_dkv_kernel<T, DH, kDrop>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.f / sqrtf((float)DH);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int n_rows = a.B * a.Tq * a.H;
  attn_bwd_delta_kernel<T><<<(n_rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      dout, static_cast<const T*>(a.out), a.delta, n_rows, a.Tq, a.H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  kdq<<<dim3((a.Tq + BQ - 1) / BQ, a.H, a.B), kThreads, smem, stream>>>(
      q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta,
      static_cast<T*>(a.dq), a.Tq, a.Tk, a.H, a.prefix_s, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  kdkv<<<dim3((a.Tk + BK - 1) / BK, a.H, a.B), kThreads, smem, stream>>>(
      q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Tq, a.Tk, a.H, a.prefix_s, scale, drop);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_drop(const Args& a, Dropout drop, cudaStream_t stream) {
  if (drop.threshold == 0) return launch_typed<T, DH, false>(a, drop, stream);
  return launch_typed<T, DH, true>(a, drop, stream);
}

template <typename T>
cudaError_t launch_dh(int Dh, const Args& a, Dropout drop, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_drop<T, 16>(a, drop, stream);
    case 32: return launch_drop<T, 32>(a, drop, stream);
    case 64: return launch_drop<T, 64>(a, drop, stream);
    case 128: return launch_drop<T, 128>(a, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv share it).
// q: (B, Tq, H, Dh) with batch / row strides in elements and (H, Dh)
// contiguous; k, v likewise over Tk; kv_bias: (B, Tk) f32 or null; out, dout,
// dq: (B, Tq, H, Dh) contiguous; dk, dv: (B, Tk, H, Dh) contiguous; lse and
// delta (scratch, written here): (B, H, Tq) f32.  prefix_s < 0 selects dense
// mode.  drop_threshold / inv_keep / seed as in prefix_attention_launch.
// Returns the first cudaError_t of the three launches.
extern "C" int prefix_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, const void* k, long long k_sb,
    long long k_st, const void* v, long long v_sb, long long v_st, const float* kv_bias,
    const void* out, const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Tq, int Tk, int H, int Dh, int prefix_s,
    unsigned drop_threshold, float inv_keep, unsigned long long seed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, kv_bias, out, dout, lse, delta,
               dq, dk, dv, B, Tq, Tk, H, prefix_s};
  const Dropout drop{drop_threshold, inv_keep,
                     make_uint2((unsigned)(seed & 0xFFFFFFFFull), (unsigned)(seed >> 32))};
  if (dtype == 0) return (int)launch_dh<float>(Dh, a, drop, s);
  if (dtype == 1) return (int)launch_dh<__nv_bfloat16>(Dh, a, drop, s);
  return (int)cudaErrorInvalidValue;
}
