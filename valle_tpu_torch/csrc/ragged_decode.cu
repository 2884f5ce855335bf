// Ragged decode attention for Hopper (sm_90a).
//
// Replaces: valle_tpu/ops/ragged_decode.py::_kernel (the Pallas TPU kernel
// behind ragged_decode_attention, pallas_call at ragged_decode.py:248).
//
// Computes, per batch slot b and head h, single-query attention over the KV
// cache columns [0, lengths[b]) only:
//   s_c = (q . k_c) / sqrt(Dh) [* k_scale_c] [+ bias_c]
//   out = sum_c softmax(s)_c [* v_scale_c] * v_c          (f32 output)
// A slot of length 0 (a finished request) reads nothing and yields zeros.
// The cache is int8 with per-(token, head) f32 scales, or f32 / bf16.
//
// What bounds it on the H100: bytes.  Each live column is read once for K
// and once for V (sum_b lengths[b] * H * Dh * 2 * element bytes, plus the
// scales and the bias) against 3.35 TB/s; the arithmetic is 4 flops per byte
// of int8 cache, far below the card's ridge.
//
// What the design does about it: one block per (head, slot); the block reads
// only the live columns, so dead columns and finished slots cost nothing
// (the TPU's pipelined form could not skip their fetches).  Every load is a
// 16-byte vector: G = Dh * sizeof(T) / 16 threads share one column, so a
// 256-thread block keeps 256 / G columns in flight per pass, unrolled four
// times.  Pass 1 writes the logits of all live columns to shared memory,
// pass 2 takes the exact f32 softmax there (max starts at -2e9 as in the
// TPU kernel, so -1e9 bias holes contribute exactly 0), pass 3 reads V.
// Later work: split long rows across blocks (split-K) to fill all 132 SMs
// at small batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr float kInitMax = -2e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Load one 16-byte chunk and widen it to f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = static_cast<float>(c[e]);
}

__device__ __forceinline__ float block_reduce(float x, float* scratch, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch may be reused right after
  return r;
}

template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(kThreads) ragged_decode_kernel(
    const TQ* __restrict__ q, long long q_sb,
    const TKV* __restrict__ k, const TKV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ bias, const int* __restrict__ lengths,
    float* __restrict__ out, int C, int H, float scale) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr int EPT = 16 / sizeof(TKV);  // elements per 16-byte chunk
  constexpr int G = DH / EPT;            // threads per column
  constexpr int NCG = kThreads / G;      // columns per pass
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "bad Dh for this type");

  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;               // DH
  float* s_red = s_q + DH;         // NCG * DH
  float* s_scratch = s_red + NCG * DH;  // kWarps
  float* s_logit = s_scratch + kWarps;  // C

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = min(max(lengths[b], 0), C);
  float* o = out + ((long long)b * H + h) * DH;
  if (len == 0) {
    for (int d = tid; d < DH; d += kThreads) o[d] = 0.f;
    return;
  }
  for (int d = tid; d < DH; d += kThreads)
    s_q[d] = to_float(q[(long long)b * q_sb + (long long)h * DH + d]) * scale;
  __syncthreads();

  const long long hd = (long long)H * DH;
  const int chunk = tid % G, cg = tid / G;
  const TKV* k_base = k + (long long)b * C * hd + (long long)h * DH + chunk * EPT;
  const TKV* v_base = v + (long long)b * C * hd + (long long)h * DH + chunk * EPT;
  const long long sc_base = (long long)b * C * H + h;

  float qreg[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) qreg[e] = s_q[chunk * EPT + e];

  // Pass 1: logits of the live columns.  The loop bound is block-uniform so
  // every lane of a warp takes part in the shuffles.
  float tmax = kInitMax;
  for (int c0 = 0; c0 < len; c0 += kUnroll * NCG) {
    float kv[kUnroll][EPT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * NCG + cg;
      if (c < len) {
        load16(k_base + c * hd, kv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) part = fmaf(qreg[e], kv[u][e], part);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int c = c0 + u * NCG + cg;
      if (c < len && chunk == 0) {
        float s = part;
        if (kQuant) s *= k_scale[sc_base + (long long)c * H];
        if (bias != nullptr) s += bias[(long long)b * C + c];
        s_logit[c] = s;
        tmax = fmaxf(tmax, s);
      }
    }
  }
  const float m = block_reduce(tmax, s_scratch, true);  // also orders s_logit

  // Pass 2: exact softmax numerators; the V scale folds into the probs.
  float psum = 0.f;
  for (int c = tid; c < len; c += kThreads) {
    const float p = expf(s_logit[c] - m);
    psum += p;
    s_logit[c] = kQuant ? p * v_scale[sc_base + (long long)c * H] : p;
  }
  const float l = block_reduce(psum, s_scratch, false);

  // Pass 3: P . V, each thread accumulating one 16-byte chunk of the dims.
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
  for (int c0 = cg; c0 < len; c0 += kUnroll * NCG) {
    float vv[kUnroll][EPT];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * NCG;
      p[u] = 0.f;
      if (c < len) {
        load16(v_base + c * hd, vv[u]);
        p[u] = s_logit[c];
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[e] = fmaf(p[u], vv[u][e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) s_red[cg * DH + chunk * EPT + e] = acc[e];
  __syncthreads();
  const float inv_l = 1.f / l;
  for (int d = tid; d < DH; d += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < NCG; ++g) sum += s_red[g * DH + d];
    o[d] = sum * inv_l;
  }
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch_typed(const void* q, long long q_sb, const void* k, const void* v,
                         const float* ks, const float* vs, const float* bias,
                         const int* lengths, float* out, int B, int C, int H,
                         cudaStream_t stream) {
  constexpr int EPT = 16 / sizeof(TKV);
  constexpr int NCG = kThreads / (DH / EPT);
  const size_t smem = sizeof(float) * ((size_t)DH + (size_t)NCG * DH + kWarps + (size_t)C);
  auto kern = ragged_decode_kernel<TQ, TKV, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), q_sb, static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, bias, lengths, out, C, H,
      1.f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dh(int Dh, const void* q, long long q_sb, const void* k, const void* v,
                      const float* ks, const float* vs, const float* bias,
                      const int* lengths, float* out, int B, int C, int H,
                      cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_typed<TQ, TKV, 16>(q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    case 32: return launch_typed<TQ, TKV, 32>(q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    case 64: return launch_typed<TQ, TKV, 64>(q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    case 128: return launch_typed<TQ, TKV, 128>(q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int Dh, const void* q, long long q_sb, const void* k,
                      const void* v, const float* ks, const float* vs, const float* bias,
                      const int* lengths, float* out, int B, int C, int H,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch_dh<TQ, float>(Dh, q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    case 1: return launch_dh<TQ, __nv_bfloat16>(Dh, q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    case 2: return launch_dh<TQ, int8_t>(Dh, q, q_sb, k, v, ks, vs, bias, lengths, out, B, C, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only).
// q: (B, [1,] H, Dh) with batch stride q_sb elements, (H, Dh) contiguous;
// k, v: (B, C, H, Dh) contiguous; k_scale, v_scale: (B, C, H) f32 or null
// (required iff int8); bias: (B, C) f32 or null; lengths: (B,) int32;
// out: (B, H, Dh) f32.  Returns the cudaError_t of the launch.
extern "C" int ragged_decode_attention_launch(
    const void* q, long long q_sb, int q_dtype, const void* k, const void* v,
    int kv_dtype, const float* k_scale, const float* v_scale, const float* bias,
    const int* lengths, float* out, int B, int C, int H, int Dh, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return (int)launch_kv<float>(kv_dtype, Dh, q, q_sb, k, v, k_scale, v_scale, bias,
                                 lengths, out, B, C, H, s);
  if (q_dtype == 1)
    return (int)launch_kv<__nv_bfloat16>(kv_dtype, Dh, q, q_sb, k, v, k_scale, v_scale,
                                         bias, lengths, out, B, C, H, s);
  return (int)cudaErrorInvalidValue;
}
