// Ragged decode attention for Hopper (sm_90a): split-K over the KV cache.
//
// Replaces: valle_tpu/ops/ragged_decode.py::_kernel (the Pallas TPU kernel
// behind ragged_decode_attention, pallas_call at ragged_decode.py:248).
//
// Computes, per batch slot b and head h, single-query attention over the KV
// cache columns [0, min(lengths[b], C)) only:
//   s_c = (q . k_c) / sqrt(Dh) [* k_scale_c] [+ bias_c]
//   out = sum_c softmax(s)_c [* v_scale_c] * v_c          (f32 output)
// with an exact f32 softmax: a -1e9 bias hole weighs exactly 0 beside a live
// column, and a row made only of holes averages over them (the running max
// starts at -2e9, as in the TPU kernel).  A slot of length 0 (a finished
// request) yields exact zeros.  The cache is int8 with per-(token, head) f32
// scales, or f32 / bf16; q is f32 or bf16; any Dh that is a multiple of 16 up
// to 256.
//
// What bounds it on the H100: bytes.  Each live column is read once for K and
// once for V (sum_b len_b * H * Dh * 2 * element bytes, plus the scales and
// the bias) against 3.35 TB/s; the arithmetic is about 4 flops per byte of
// int8 cache, a matrix-vector product, so the tensor cores do not help.
//
// What the design does about it (times: PERF.md section 6):
// - Split-K, all heads per block.  The grid is (column splits, B).  A block
//   takes one slot and one run of split_cols columns for all H heads: in the
//   (B, C, H, Dh) layout that run is one contiguous slab of split_cols rows of
//   H * Dh elements.  The host picks the plan (ops/ragged_decode.py::
//   split_plan) from B, C, H, Dh, the element size and the SM count, never
//   from lengths, so a launch needs no host read and can be captured in a
//   CUDA graph: about two blocks per SM at B > 1 and one at B = 1 (splits of
//   at least 4 columns; at B = 1 the 2-column splits of two blocks per SM
//   cost the combine more than they gained).  The old grid of (H, B) blocks
//   used 16 SMs at B = 1 and let the longest slot set the time.  A split that
//   starts at or past lengths[b] writes an empty partial (m = -2e9, l = 0,
//   acc = 0) and exits, so finished slots and dead columns cost no reads.
// - A ring of kStages = 2 asynchronous stages in shared memory.  Each stage
//   holds stage_cols columns of K and V (16-byte cp.async.cg, the slab is
//   contiguous), their scales and the bias (16- or 4-byte cp.async): one
//   stage is in flight while the other is consumed.  stage_cols is sized by
//   element size and row width so that the rings of the whole grid fit the
//   SMs' shared memory in one wave (16 int8, 4 f32 columns of 1024 elements
//   at B = 8, C = 1024).  A third stage measured no faster.
// - Warps on rows.  A row of H * Dh elements is cut into head groups of 512
//   bytes (32 lanes x 16 bytes; HPP = 32 / LPH whole heads, or one head of
//   512 * CPH bytes when a head is wider): lane i of head group j reads the
//   16-byte chunk at byte 16 * i + 512 * j of the row (plus 512 * c for a
//   head's c-th lane chunk), so a warp's shared-memory reads are one
//   conflict-free 512-byte sweep.  Each warp owns one head group and
//   cols_per_warp (<= 8) columns of every stage, and takes them in one
//   online-softmax step: all their scores (four partial sums per dot product,
//   then the xor-shuffle reduction over the LPH lanes of the head), one max,
//   one rescale of (l, acc), skipped when no lane's max moved (its factor is
//   exactly 1).  Per-warp work per stage, not bytes in flight, set the time
//   of the first versions (two columns per warp and stage ran no faster
//   than the old kernel).  q (pre-scaled, f32) and the head's online softmax
//   (m, l, acc) stay in registers, so the registers do not grow with H and
//   nothing per column is kept: the cache width C is not capped.  A head
//   whose chunk count G = Dh * size / 16 is not a power of two takes LPH =
//   the next power of two lanes, some idle (Dh 48 in int8: 3 of 4), which
//   keeps every head dim in one code path.  The warps of one head group merge
//   their (m, l, acc) in a fixed order through shared memory at the end.
// - int8 -> f32 without I2F.  A byte x is flipped to x + 128 (one LOP per
//   word), moved by PRMT into the mantissa of 2^23 (0x4B0000xx) and turned
//   into x by one FADD of -(2^23 + 128): exact for every int8, on the
//   full-rate integer and FMA pipes.  I2F runs at 16 per clock per SM, an
//   eighth of the FMA rate, and widened every element of the old kernel.  No
//   integer division by a runtime value either (it compiles to I2F and a
//   reciprocal): strided loops are not unrolled, which would need their trip
//   count, and the warp's head group comes from a subtraction loop.
// - Combine.  A second kernel, grid (H, B), merges the slot's splits in a
//   fixed order: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.  It
//   reads no lengths (a dead split's partial weighs 0), prefetches its
//   partials before M is known, and computes each split's weight once, so it
//   takes one round trip to device memory; 256 threads per block, or 1024
//   when the splits would not fit one round.  No atomics anywhere, so reruns
//   are bit-equal.  The wrapper allocates the partials: acc (B, S, H, Dh)
//   f32, then (m, l) (B, S, H, 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;          // ring depth
constexpr int kMaxColsPerWarp = 8;  // columns a warp takes from each stage, at most
constexpr int kMaxWarps = 16;       // head groups per row, and warps per block
constexpr int kCombinePrefetch = 16;  // partials a combine thread holds per round
constexpr int kMaxSmemBytes = 232448;  // 227 KiB of dynamic shared memory
constexpr float kInitMax = -2e9f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 of one word to f32, exactly, without I2F.
__device__ __forceinline__ void widen_s8x4(uint32_t w, float* out) {
  const uint32_t x = w ^ 0x80808080u;  // each byte b -> b + 128, in [1, 255]
  out[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - 8388736.f;
}

// One 16-byte chunk of a cache row in shared memory, widened to f32.
__device__ __forceinline__ void load_chunk(const int8_t* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  widen_s8x4(x.x, out);
  widen_s8x4(x.y, out + 4);
  widen_s8x4(x.z, out + 8);
  widen_s8x4(x.w, out + 12);
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

struct SplitArgs {
  const void* q;
  long long q_sb;  // batch stride of q in elements; (H, Dh) contiguous
  int q_bf16;
  int q_vec;  // f32 q read in 16-byte pieces (aligned, q_sb % 4 == 0)
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const float* bias;
  const int* lengths;
  float* part_acc;  // (B, S, H, Dh)
  float* part_ml;   // (B, S, H, 2): running max, running sum
  int C, H, Dh, G;  // G: 16-byte chunks per head
  int split_cols, n_splits, stage_cols, cols_per_warp, n_groups, warps_per_group;
  int row_bytes, stage_bytes, scale_bytes;
  int vec_scales;  // scales copied in 16-byte pieces (H % 4 == 0, aligned)
  float scale;
};

// LPH lanes per head (a power of two <= 32), CPH 16-byte chunks per lane and
// head: G <= LPH * CPH.  One warp per (head group, column phase); the launch
// bounds leave ptxas the registers of one 512-thread block (with the default
// bound it spilled in two f32 layouts).
template <typename TKV, int LPH, int CPH>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    ragged_decode_split_kernel(const SplitArgs a) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr int EPT = 16 / sizeof(TKV);  // elements per 16-byte chunk
  constexpr int HPP = 32 / LPH;          // heads per head group
  constexpr int NS = CPH * EPT;          // accumulator floats per lane

  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int H = a.H, Dh = a.Dh;
  const int len = min(max(a.lengths[b], 0), a.C);
  const int c_begin = split * a.split_cols;
  const long long prow = ((long long)b * a.n_splits + split) * H;  // partial row of head 0

  if (c_begin >= len) {  // an empty partial: zero weight in any merge
#pragma unroll 1
    for (int i = tid; i < H * Dh; i += nthreads) a.part_acc[prow * Dh + i] = 0.f;
#pragma unroll 1
    for (int i = tid; i < H; i += nthreads) {
      a.part_ml[2 * (prow + i)] = kInitMax;
      a.part_ml[2 * (prow + i) + 1] = 0.f;
    }
    return;
  }
  const int n_cols = min(a.split_cols, len - c_begin);
  const int W = a.stage_cols, R = a.row_bytes;
  const long long first = (long long)b * a.C + c_begin;  // first column of the slab
  const unsigned char* gk = static_cast<const unsigned char*>(a.k) + first * R;
  const unsigned char* gv = static_cast<const unsigned char*>(a.v) + first * R;
  const float* gbias = a.bias != nullptr ? a.bias + first : nullptr;

  // Stage layout: K (W rows), V (W rows), k scales, v scales, bias.
  auto issue = [&](int t) {
    unsigned char* st = smem + t % kStages * a.stage_bytes;
    const int c0 = t * W, nc = min(W, n_cols - c0);
    const int n16 = nc * R / 16;
    const unsigned char* sk = gk + (long long)c0 * R;
    const unsigned char* sv = gv + (long long)c0 * R;
#pragma unroll 1
    for (int i = tid; i < n16; i += nthreads) {
      cp_async16(st + 16 * i, sk + 16 * i);
      cp_async16(st + W * R + 16 * i, sv + 16 * i);
    }
    if (kQuant) {
      float* dks = reinterpret_cast<float*>(st + 2 * W * R);
      float* dvs = reinterpret_cast<float*>(st + 2 * W * R + a.scale_bytes);
      const float* ks = a.k_scale + (first + c0) * H;
      const float* vs = a.v_scale + (first + c0) * H;
      const int n = nc * H;
      if (a.vec_scales) {
#pragma unroll 1
        for (int i = tid; i < n / 4; i += nthreads) {
          cp_async16(dks + 4 * i, ks + 4 * i);
          cp_async16(dvs + 4 * i, vs + 4 * i);
        }
      } else {
#pragma unroll 1
        for (int i = tid; i < n; i += nthreads) {
          cp_async4(dks + i, ks + i);
          cp_async4(dvs + i, vs + i);
        }
      }
    }
    if (gbias != nullptr) {
      float* db = reinterpret_cast<float*>(st + 2 * W * R + 2 * a.scale_bytes);
#pragma unroll 1
      for (int i = tid; i < nc; i += nthreads) cp_async4(db + i, gbias + c0 + i);
    }
  };

  // The first stages' copies go out before q's loads.  (No division by a
  // runtime value anywhere in the kernel: it would go through I2F.)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t * W < n_cols) issue(t);
    cp_async_commit();
  }

  // This lane's head group (hg), column phase (wc), head and chunks.
  int hg = warp, wc = 0;
  while (hg >= a.n_groups) {
    hg -= a.n_groups;
    ++wc;
  }
  const int cl = lane % LPH, head = hg * HPP + lane / LPH;
  const bool head_ok = head < H;
  const int hh = head_ok ? head : 0;  // a head index safe to read with
  int off[CPH];
  bool ok[CPH];
  float q[CPH][EPT], acc[CPH][EPT];
#pragma unroll
  for (int c = 0; c < CPH; ++c) {
    const int ci = c * LPH + cl;
    ok[c] = head_ok && ci < a.G;
    off[c] = head * Dh * (int)sizeof(TKV) + ci * 16;
    // the lane's own EPT elements of q: 16-byte loads where q is f32 and
    // aligned (generate's q); a lane's scalar loads are 64 bytes apart and
    // lengthened a short block's chain in probes
    const long long qi = (long long)b * a.q_sb + (long long)head * Dh + ci * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      q[c][e] = 0.f;
      acc[c][e] = 0.f;
    }
    if (ok[c] && a.q_vec) {
      const float4* q4 = reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + qi);
#pragma unroll
      for (int j = 0; j < EPT / 4; ++j) {
        const float4 x = q4[j];
        q[c][4 * j] = x.x;
        q[c][4 * j + 1] = x.y;
        q[c][4 * j + 2] = x.z;
        q[c][4 * j + 3] = x.w;
      }
    } else if (ok[c]) {
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        q[c][e] = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi + e])
                           : static_cast<const float*>(a.q)[qi + e];
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) q[c][e] *= a.scale;
  }
  float m = kInitMax, l = 0.f;

  // q . k of one row of the stage, summed over the LPH lanes of the head.
  // (Four partial sums keep the FMA chains short.)
  auto dot = [&](const unsigned char* row) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < CPH; ++c) {
      if (ok[c]) {
        float x[EPT];
        load_chunk(reinterpret_cast<const TKV*>(row + off[c]), x);
#pragma unroll
        for (int e = 0; e < EPT; ++e) part[e & 3] = fmaf(q[c][e], x[e], part[e & 3]);
      }
    }
    float sum = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
    for (int o = LPH / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    return sum;
  };

  for (int t = 0; t * W < n_cols; ++t) {
    if ((t + kStages - 1) * W < n_cols) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const unsigned char* st = smem + t % kStages * a.stage_bytes;
    const float* sks = reinterpret_cast<const float*>(st + 2 * W * R);
    const float* svs = reinterpret_cast<const float*>(st + 2 * W * R + a.scale_bytes);
    const float* sb = reinterpret_cast<const float*>(st + 2 * W * R + 2 * a.scale_bytes);
    const int nc = min(W, n_cols - t * W);
    const int c0 = wc * a.cols_per_warp;
    const int ncw = min(a.cols_per_warp, nc - c0);  // this warp's columns: warp-uniform
    if (ncw > 0) {
      // One online-softmax step over the warp's columns of the stage.
      float sc[kMaxColsPerWarp];
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kMaxColsPerWarp; ++j) {
        if (j < ncw) {
          float x = dot(st + (c0 + j) * R);
          if (kQuant) x *= sks[(c0 + j) * H + hh];
          if (gbias != nullptr) x += sb[c0 + j];
          sc[j] = x;
          m_new = fmaxf(m_new, x);
        }
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
      if (__any_sync(0xffffffffu, m_new != m)) {  // else alpha is exactly 1 in every lane
#pragma unroll
        for (int c = 0; c < CPH; ++c)
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[c][e] *= alpha;
      }
      m = m_new;
      const unsigned char* sv = st + W * R + c0 * R;
#pragma unroll
      for (int j = 0; j < kMaxColsPerWarp; ++j) {
        if (j < ncw) {
          const float p = expf(sc[j] - m_new);
          l += p;
          const float w = kQuant ? p * svs[(c0 + j) * H + hh] : p;  // the V scale folds in
#pragma unroll
          for (int c = 0; c < CPH; ++c) {
            if (ok[c]) {
              float x[EPT];
              load_chunk(reinterpret_cast<const TKV*>(sv + j * R + off[c]), x);
#pragma unroll
              for (int e = 0; e < EPT; ++e) acc[c][e] = fmaf(w, x[e], acc[c][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's issue
  }
  cp_async_wait<0>();

  // Merge the warps of each head group in a fixed order (wc = 0, 1, ...)
  // through the ring's memory, which is free now.
  if (a.warps_per_group > 1) {
    float* red = reinterpret_cast<float*>(smem);
    float* mine = red + (size_t)warp * (NS + 2) * 32;
    mine[lane] = m;
    mine[32 + lane] = l;
#pragma unroll
    for (int c = 0; c < CPH; ++c)
#pragma unroll
      for (int e = 0; e < EPT; ++e) mine[(2 + c * EPT + e) * 32 + lane] = acc[c][e];
    __syncthreads();
    if (wc == 0) {
      for (int w = 1; w < a.warps_per_group; ++w) {
        const float* o = red + (size_t)(w * a.n_groups + hg) * (NS + 2) * 32;
        const float mo = o[lane];
        const float mn = fmaxf(m, mo);
        const float a0 = expf(m - mn), a1 = expf(mo - mn);
        l = l * a0 + o[32 + lane] * a1;
#pragma unroll
        for (int c = 0; c < CPH; ++c)
#pragma unroll
          for (int e = 0; e < EPT; ++e)
            acc[c][e] = acc[c][e] * a0 + o[(2 + c * EPT + e) * 32 + lane] * a1;
        m = mn;
      }
    }
  }
  if (wc == 0 && head_ok) {
    float* pa = a.part_acc + (prow + head) * Dh;
#pragma unroll
    for (int c = 0; c < CPH; ++c) {
      if (ok[c]) {
        float4* dst = reinterpret_cast<float4*>(pa + (c * LPH + cl) * EPT);
#pragma unroll
        for (int j = 0; j < EPT / 4; ++j)
          dst[j] = make_float4(acc[c][4 * j], acc[c][4 * j + 1], acc[c][4 * j + 2],
                               acc[c][4 * j + 3]);
      }
    }
    if (cl == 0) {
      a.part_ml[2 * (prow + head)] = m;
      a.part_ml[2 * (prow + head) + 1] = l;
    }
  }
}

// out[b, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the
// n_splits partials of the slot, in a fixed order: thread (g, d) of the first
// ng * Dh sums the splits s = g (mod ng) of dim d, and the ng sums are added
// in order of g (ng = kThreads / Dh, from the host).  A dead split's empty
// partial weighs e^(-2e9 - M) = 0, so the kernel reads no lengths: each
// thread loads its first kCombinePrefetch partials and one split's (m, l) at
// once; split s < kThreads has its weight computed once, by thread s.
// M = -2e9 means no live split (a slot of length 0): exact zeros.
template <int kThreads>
__global__ void __launch_bounds__(kThreads) ragged_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int H, int Dh, int n_splits, int ng) {
  __shared__ float s_w[kThreads];   // e^(m_s - M)
  __shared__ float s_wl[kThreads];  // e^(m_s - M) l_s
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads / 16];
  __shared__ float s_max[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long row0 = (long long)b * n_splits * H + h;  // split s at row0 + s * H
  int g = 0, d = tid;
  while (d >= Dh) {
    d -= Dh;
    ++g;
  }
  const bool active = g < ng;
  float pre[kCombinePrefetch];
#pragma unroll
  for (int i = 0; i < kCombinePrefetch; ++i) {
    const int s = g + i * ng;
    pre[i] = active && s < n_splits ? part_acc[(row0 + (long long)s * H) * Dh + d] : 0.f;
  }
  float my_m = kInitMax, my_l = 0.f;
  if (tid < n_splits) {
    my_m = part_ml[2 * (row0 + (long long)tid * H)];
    my_l = part_ml[2 * (row0 + (long long)tid * H) + 1];
  }
  float mx = my_m;
#pragma unroll 1
  for (int s = tid + kThreads; s < n_splits; s += kThreads)
    mx = fmaxf(mx, part_ml[2 * (row0 + (long long)s * H)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) s_max[tid >> 5] = mx;
  __syncthreads();
  float M = s_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) M = fmaxf(M, s_max[w]);
  float* o = out + ((long long)b * H + h) * Dh;
  if (M == kInitMax) {
    if (tid < Dh) o[tid] = 0.f;
    return;
  }
  const float my_w = expf(my_m - M);
  s_w[tid] = my_w;
  s_wl[tid] = my_w * my_l;
  __syncthreads();

  float num = 0.f, den = 0.f;
  if (active) {
    // s < kCombinePrefetch * ng <= kThreads: the weights are in shared memory
#pragma unroll
    for (int i = 0; i < kCombinePrefetch; ++i) {
      const int s = g + i * ng;
      if (s < n_splits) {
        den += s_wl[s];
        num = fmaf(s_w[s], pre[i], num);
      }
    }
#pragma unroll 1
    for (int s = g + kCombinePrefetch * ng; s < n_splits; s += ng) {
      const long long r = row0 + (long long)s * H;
      const float w = expf(part_ml[2 * r] - M);
      den = fmaf(w, part_ml[2 * r + 1], den);
      num = fmaf(w, part_acc[r * Dh + d], num);
    }
    s_num[tid] = num;
    if (d == 0) s_den[g] = den;
  }
  __syncthreads();
  if (tid < Dh) {
    num = 0.f;
    den = 0.f;
    for (int gg = 0; gg < ng; ++gg) {
      num += s_num[gg * Dh + tid];
      den += s_den[gg];
    }
    o[tid] = num / den;
  }
}

// The combine in blocks of 256 threads while those hold every split in one
// round of prefetches, else in blocks of 1024.
cudaError_t launch_combine(const float* part_acc, const float* part_ml, float* out, int B, int H,
                           int Dh, int n_splits, cudaStream_t stream) {
  const dim3 grid(H, B);
  if (n_splits <= kCombinePrefetch * (256 / Dh)) {
    ragged_decode_combine_kernel<256><<<grid, 256, 0, stream>>>(part_acc, part_ml, out, H, Dh,
                                                                n_splits, 256 / Dh);
  } else {
    ragged_decode_combine_kernel<1024><<<grid, 1024, 0, stream>>>(part_acc, part_ml, out, H, Dh,
                                                                  n_splits, 1024 / Dh);
  }
  return cudaGetLastError();
}

// Launch one layout, raising its dynamic shared-memory limit once.
template <typename TKV, int LPH, int CPH>
cudaError_t launch_layout(const SplitArgs& a, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream) {
  if (a.n_groups != (a.H + 32 / LPH - 1) / (32 / LPH)) return cudaErrorInvalidValue;
  auto kern = ragged_decode_split_kernel<TKV, LPH, CPH>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return attr;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The lane layout of G chunks per head: LPH = the next power of two (at most
// 32), CPH = chunks per lane.  Dh in [16, 256] gives G in [sizeof(TKV),
// 16 * sizeof(TKV)], so each cache type has five layouts.
template <typename TKV>
cudaError_t launch_split(const SplitArgs& a, dim3 grid, int threads, size_t smem,
                         cudaStream_t s) {
  constexpr int kMinG = sizeof(TKV), kMaxG = 16 * sizeof(TKV);
  const int G = a.G;
  if (G < kMinG || G > kMaxG) return cudaErrorInvalidValue;
  if constexpr (kMinG <= 1) {
    if (G <= 1) return launch_layout<TKV, 1, 1>(a, grid, threads, smem, s);
  }
  if constexpr (kMinG <= 2) {
    if (G <= 2) return launch_layout<TKV, 2, 1>(a, grid, threads, smem, s);
  }
  if (G <= 4) return launch_layout<TKV, 4, 1>(a, grid, threads, smem, s);
  if (G <= 8) return launch_layout<TKV, 8, 1>(a, grid, threads, smem, s);
  if (G <= 16) return launch_layout<TKV, 16, 1>(a, grid, threads, smem, s);
  if constexpr (kMaxG > 16) {
    if (G <= 32) return launch_layout<TKV, 32, 1>(a, grid, threads, smem, s);
  }
  if constexpr (kMaxG > 32) {
    if (G <= 64) return launch_layout<TKV, 32, 2>(a, grid, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only).
// q: (B, [1,] H, Dh) with batch stride q_sb elements, (H, Dh) contiguous;
// k, v: (B, C, H, Dh) contiguous and 16-byte aligned; k_scale, v_scale:
// (B, C, H) f32 or null (required iff int8); bias: (B, C) f32 or null;
// lengths: (B,) int32; partials: B * n_splits * H * (Dh + 2) f32 of scratch;
// out: (B, H, Dh) f32.  split_cols, n_splits, stage_cols, cols_per_warp,
// n_groups and warps_per_group are the host's plan
// (ops/ragged_decode.py::split_plan).
// Launches the split kernel, then the combine kernel, and returns the first
// cudaError_t.
extern "C" int ragged_decode_attention_launch(
    const void* q, long long q_sb, int q_dtype, const void* k, const void* v, int kv_dtype,
    const float* k_scale, const float* v_scale, const float* bias, const int* lengths,
    float* partials, float* out, int B, int C, int H, int Dh, int split_cols, int n_splits,
    int stage_cols, int cols_per_warp, int n_groups, int warps_per_group, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = kv_dtype == 2 ? 1 : kv_dtype == 1 ? 2 : kv_dtype == 0 ? 4 : 0;
  if (elem == 0 || (q_dtype != 0 && q_dtype != 1) || Dh % 16 != 0 || Dh > 256 || B < 1 ||
      C < 1 || H < 1 || split_cols < 1 || n_splits != (C + split_cols - 1) / split_cols ||
      n_groups < 1 || n_groups > kMaxWarps || warps_per_group < 1 ||
      n_groups * warps_per_group > kMaxWarps || cols_per_warp < 1 ||
      cols_per_warp > kMaxColsPerWarp || stage_cols != cols_per_warp * warps_per_group)
    return (int)cudaErrorInvalidValue;
  SplitArgs a;
  a.q = q;
  a.q_sb = q_sb;
  a.q_bf16 = q_dtype == 1;
  a.q_vec = q_dtype == 0 && (uintptr_t)q % 16 == 0 && q_sb % 4 == 0;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.bias = bias;
  a.lengths = lengths;
  a.part_acc = partials;
  a.part_ml = partials + (long long)B * n_splits * H * Dh;
  a.C = C;
  a.H = H;
  a.Dh = Dh;
  a.G = Dh * elem / 16;
  a.split_cols = split_cols;
  a.n_splits = n_splits;
  a.stage_cols = stage_cols;
  a.cols_per_warp = cols_per_warp;
  a.n_groups = n_groups;
  a.warps_per_group = warps_per_group;
  a.row_bytes = H * Dh * elem;
  a.scale_bytes = elem == 1 ? align16(stage_cols * H * 4) : 0;
  a.stage_bytes = 2 * stage_cols * a.row_bytes + 2 * a.scale_bytes + align16(stage_cols * 4);
  a.vec_scales = elem == 1 && H % 4 == 0 && (uintptr_t)k_scale % 16 == 0 &&
                 (uintptr_t)v_scale % 16 == 0;
  a.scale = 1.f / sqrtf((float)Dh);
  const int threads = 32 * n_groups * warps_per_group;
  const int ns = (Dh * elem / 16 > 32 ? 2 : 1) * 16 / elem;  // accumulator floats per lane
  // a split of at most one stage of columns uses one stage of the ring
  const int tiles = (split_cols + stage_cols - 1) / stage_cols;
  const size_t ring = (size_t)(tiles < kStages ? tiles : kStages) * a.stage_bytes;
  const size_t merge = (size_t)threads * (ns + 2) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;

  const dim3 grid(n_splits, B);
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == 0) err = launch_split<float>(a, grid, threads, smem, s);
  if (kv_dtype == 1) err = launch_split<__nv_bfloat16>(a, grid, threads, smem, s);
  if (kv_dtype == 2) err = launch_split<int8_t>(a, grid, threads, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(a.part_acc, a.part_ml, out, B, H, Dh, n_splits, s);
}
