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
// scales, or f32 / bf16; q is f32 or bf16; any Dh: up to 1024 in the lane
// layouts, above it in the strided layout (below); and any number of
// heads.  No Dh is padded: a head that is not a whole number of 16-byte
// chunks is staged into a slot of whole chunks in shared memory whose pad
// bytes are zero.
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
// - Wide heads and wide rows.  A head of more than 32 chunks (Dh above 256
//   in f32, 512 in bf16) gives each lane CPH = 2, 4 or 8 chunks, up to 1024
//   elements; those layouts hold 32 floats of q and 32 of acc per lane, so
//   their blocks take at most 8 warps (kWideWarps), which leaves ptxas 255
//   registers.  A row of more head groups than a block has warps (64 heads
//   of Dh 64 in f32: 32 groups) is cut into head slices: grid dimension z
//   takes slice z's heads, whose bytes of each row the block stages row by
//   row (a warp per row, a lane per 16 bytes); the combine is per head
//   already.  A row of one slice is staged in one contiguous sweep of the
//   slab.
// - Heads that are not whole 16-byte chunks (int8 Dh 8, 40, 72; f32 Dh not a
//   multiple of 4; bf16 Dh not a multiple of 8) are read where they lie in
//   the (B, C, H, Dh) cache: the stage puts each head of a row into a slot
//   of G = ceil(Dh * size / 16) chunks (padded_head_dim on the host), so the
//   lane layouts' reads stay as above.  A head's bytes start at a multiple
//   of u = min(16, the lowest set bit of Dh * size) bytes in every row, so
//   the copy goes in pieces of u bytes (cp.async of 16, 8 or 4 bytes; a
//   plain load and store of 2 or 1); the piece's head is i / pieces per
//   head, a multiply-high by a reciprocal from the host (no division).  Each
//   slot's pad bytes are zeroed once per block and no copy writes them, and
//   q's lanes past Dh hold 0, so the pad adds nothing to a score; the
//   partial row and the output hold the true Dh.  Nothing copies the cache.
// - A head above 1024 elements takes the strided layout
//   (ragged_decode_strided_kernel): a block of 8 warps per (split, slot,
//   head).  Thread t owns the 16-byte chunks t, t + 256, ... of the head
//   (CPT of them, a template argument): their pre-scaled q and their acc
//   stay in registers for the whole split, and the partial row is written
//   once at the end.  A ring of kStridedStages = 3 stages of about 72 KB
//   (stage_cols columns of K and V in slots of whole chunks, their scales
//   and the bias) keeps two stages in flight while one is computed: each
//   column's head goes in one 1-D bulk copy (cp.async.bulk, completing on
//   the stage's mbarrier) where its bytes are whole 16-byte chunks, else in
//   cp.async pieces of u bytes as above.  Per tile: every thread's partial
//   dot products over its chunks, summed by an xor-shuffle over the warp and
//   over the 8 warps in a fixed order through shared memory; then each
//   warp, lane j on column j, takes the tile's online-softmax step (max and
//   sum by xor-shuffle, the same in every lane and warp, so m and l agree in
//   every thread) and broadcasts the weights lane by lane for acc += w_j
//   v_j.  Two barriers a tile.  What bounds it: bytes, K and V read once.
//   In probes at 2 heads of Dh 2048, 72 KB stages ran faster than 36 KB
//   ones (fewer tiles; the live blocks are about one per SM), bulk copies
//   faster than 16-byte cp.async in f32 and bf16 and no slower in int8, and
//   more splits (four blocks per SM) no faster.  A thread holds at most 64
//   floats of q and of acc (strided_max_cpt: int8 4 chunks, bf16 and f32
//   8, so a stage's column is at most 32 KB): a wider head (int8 and bf16
//   Dh above 16384, f32 above 8192) first has its scores computed by
//   ragged_decode_scores_kernel (a block per 8 columns, K read once from
//   device memory, summed in the same order, so the scores are the same
//   bits), and then its V is cut into slices of that many chunks, a block
//   each, which stage and sum only their slice: any Dh runs, acc in
//   registers, K and V still read once.  Its combine spreads the head over
//   blocks of 256 elements and skips dead splits, whose split blocks write
//   only (m, l).
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
constexpr int kMaxWarps = 16;       // head groups per block, and warps per block
constexpr int kWideWarps = 8;       // the same for a layout of 32 floats of acc per lane
constexpr int kMaxG = 256;          // 16-byte chunks per head, at most (32 lanes x 8)
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
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// u bytes (16, 8, 4, 2 or 1; both addresses multiples of u) from device to
// shared memory: cp.async from 4 bytes up, a plain load and store below.
__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src, int u) {
  if (u == 16) {
    cp_async16(dst, src);
  } else if (u == 8) {
    cp_async8(dst, src);
  } else if (u == 4) {
    cp_async4(dst, src);
  } else if (u == 2) {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = *src;
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1-D bulk copies (the TMA unit) that complete on an mbarrier, one per ring
// stage: the issuing thread arms it with the stage's bytes, every thread
// waits on its phase parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// n bytes (a multiple of 16, both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
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

// One cache element to f32 (int8 as in widen_s8x4, without I2F).
__device__ __forceinline__ float elem_to_float(int8_t x) {
  return __uint_as_float(0x4B000000u | ((uint32_t)(uint8_t)x ^ 0x80u)) - 8388736.f;
}
__device__ __forceinline__ float elem_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_to_float(float x) { return x; }

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
  float* scores;    // (B, H, C): the scores of the strided layout's widest heads, or null
  int n_vslices;    // the strided layout: blocks a head's V is cut into (grid x / n_splits)
  int C, H, Dh, G;  // G: 16-byte chunks per head slot in shared memory
  int split_cols, n_splits, stage_cols, cols_per_warp, n_groups, warps_per_group;
  int n_slices, slice_heads;  // head slices of a row (grid z), heads per slice
  int row_bytes;    // a cache row (H * Dh elements) in device memory
  int srow_bytes;   // a row's slice in shared memory: slice_heads slots of 16 * G bytes
                    // (the strided layout: one column's slot)
  int head_bytes;   // Dh * element size, of which a slot's first bytes hold the head
  int unit, pieces;  // copy unit u (bytes) and pieces per head (head_bytes / u)
  unsigned long long pieces_inv;  // ceil(2^32 / pieces): i / pieces = (i * pieces_inv) >> 32
  int stage_bytes, scale_bytes, ring_bytes;
  int slots;  // the lane layouts stage heads that are not whole chunks into slots
  int bulk;   // the strided layout copies each column's head in one bulk copy
  int vec_scales;  // scales copied in 16-byte pieces (H % 4 == 0, aligned)
  float scale;
};

// The warps a block of accumulator floats NS per lane may take.
__host__ __device__ constexpr int layout_warps(int ns) { return ns > 16 ? kWideWarps : kMaxWarps; }

// LPH lanes per head (a power of two <= 32), CPH 16-byte chunks per lane and
// head: G <= LPH * CPH.  One warp per (head group, column phase); the launch
// bounds leave ptxas the registers of one block of layout_warps() warps (with
// the default bound it spilled in two f32 layouts).  kSlots: the head is not
// whole chunks, and the stage puts each head into its slot; a template
// argument, because the untaken slot code cost the whole-chunk kernels 3-7%
// in f32 and bf16 caches (PERF.md section 6).
template <typename TKV, int LPH, int CPH, bool kSlots>
__global__ void __launch_bounds__(layout_warps(CPH * 16 / sizeof(TKV)) * 32, 1)
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
  const int h0 = blockIdx.z * a.slice_heads;       // the slice's first head
  const int n_heads = min(a.slice_heads, H - h0);  // and its heads
  const int len = min(max(a.lengths[b], 0), a.C);
  const int c_begin = split * a.split_cols;
  const long long prow = ((long long)b * a.n_splits + split) * H;  // partial row of head 0

  if (c_begin >= len) {  // an empty partial: zero weight in any merge
#pragma unroll 1
    for (int i = tid; i < n_heads * Dh; i += nthreads) a.part_acc[(prow + h0) * Dh + i] = 0.f;
#pragma unroll 1
    for (int i = tid; i < n_heads; i += nthreads) {
      a.part_ml[2 * (prow + h0 + i)] = kInitMax;
      a.part_ml[2 * (prow + h0 + i) + 1] = 0.f;
    }
    return;
  }
  const int n_cols = min(a.split_cols, len - c_begin);
  const int W = a.stage_cols, R = a.row_bytes, RS = a.srow_bytes;
  const int HB = a.head_bytes, SB = 16 * a.G;  // a head's bytes and its slot's
  const long long first = (long long)b * a.C + c_begin;  // first column of the slab
  const long long slice_off = (long long)h0 * HB;
  const unsigned char* gk = static_cast<const unsigned char*>(a.k) + first * R + slice_off;
  const unsigned char* gv = static_cast<const unsigned char*>(a.v) + first * R + slice_off;
  const float* gbias = a.bias != nullptr ? a.bias + first : nullptr;

  if constexpr (kSlots) {  // zero the slots' pad bytes of the stages in use, once
    const int n_stages = a.split_cols > W ? kStages : 1;
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
#pragma unroll 1
      for (int i = tid; i < 2 * W * a.slice_heads; i += nthreads) {
        unsigned char* slot = smem + s * a.stage_bytes + i * SB;
#pragma unroll 1
        for (int x = HB; x < SB; ++x) slot[x] = 0;
      }
    }
  }

  // Stage layout: K (W rows of RS bytes), V (W rows), k scales, v scales
  // (all H heads), bias.
  auto issue = [&](int t) {
    unsigned char* st = smem + t % kStages * a.stage_bytes;
    const int c0 = t * W, nc = min(W, n_cols - c0);
    const unsigned char* sk = gk + (long long)c0 * R;
    const unsigned char* sv = gv + (long long)c0 * R;
    if constexpr (kSlots) {  // each head's bytes to its slot, u bytes a piece, a warp per row
      const int u = a.unit, ppr = n_heads * a.pieces;  // pieces of the row's slice
#pragma unroll 1
      for (int r = warp; r < nc; r += nthreads >> 5) {
#pragma unroll 1
        for (int i = lane; i < ppr; i += 32) {
          const int hd = (int)(((unsigned long long)i * a.pieces_inv) >> 32);  // i / pieces
          const int dst = r * RS + hd * SB + (i - hd * a.pieces) * u;
          const long long src = (long long)r * R + i * u;
          copy_piece(st + dst, sk + src, u);
          copy_piece(st + W * RS + dst, sv + src, u);
        }
      }
    } else if (a.n_slices == 1) {  // the stage's rows are one contiguous run
      const int n16 = nc * R / 16;
#pragma unroll 1
      for (int i = tid; i < n16; i += nthreads) {
        cp_async16(st + 16 * i, sk + 16 * i);
        cp_async16(st + W * R + 16 * i, sv + 16 * i);
      }
    } else {  // the slice's bytes of each row: a warp per row, a lane per 16 bytes
      const int n16 = n_heads * a.G;
#pragma unroll 1
      for (int r = warp; r < nc; r += nthreads >> 5) {
#pragma unroll 1
        for (int i = lane; i < n16; i += 32) {
          cp_async16(st + r * RS + 16 * i, sk + (long long)r * R + 16 * i);
          cp_async16(st + (W + r) * RS + 16 * i, sv + (long long)r * R + 16 * i);
        }
      }
    }
    if (kQuant) {
      float* dks = reinterpret_cast<float*>(st + 2 * W * RS);
      float* dvs = reinterpret_cast<float*>(st + 2 * W * RS + a.scale_bytes);
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
      float* db = reinterpret_cast<float*>(st + 2 * W * RS + 2 * a.scale_bytes);
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
  const int cl = lane % LPH, hl = hg * HPP + lane / LPH;  // hl: the head within the slice
  const int head = h0 + hl;
  const bool head_ok = hl < n_heads;
  const int hh = head_ok ? head : 0;  // a head index safe to read with
  int off[CPH];
  bool ok[CPH];
  float q[CPH][EPT], acc[CPH][EPT];
#pragma unroll
  for (int c = 0; c < CPH; ++c) {
    const int ci = c * LPH + cl;
    ok[c] = head_ok && ci < a.G;
    off[c] = hl * 16 * a.G + ci * 16;
    // the lane's own EPT elements of q (0 past Dh): 16-byte loads where q is
    // f32 and aligned (generate's q); a lane's scalar loads are 64 bytes
    // apart and lengthened a short block's chain in probes
    const long long qi = (long long)b * a.q_sb + (long long)head * Dh + ci * EPT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      q[c][e] = 0.f;
      acc[c][e] = 0.f;
    }
    if (ok[c] && a.q_vec) {  // Dh % 4 == 0: a piece of 4 lies wholly inside or past Dh
      const float4* q4 = reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + qi);
#pragma unroll
      for (int j = 0; j < EPT / 4; ++j) {
        if (!kSlots || ci * EPT + 4 * j < Dh) {
          const float4 x = q4[j];
          q[c][4 * j] = x.x;
          q[c][4 * j + 1] = x.y;
          q[c][4 * j + 2] = x.z;
          q[c][4 * j + 3] = x.w;
        }
      }
    } else if (ok[c]) {
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        if (!kSlots || ci * EPT + e < Dh)
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
    const float* sks = reinterpret_cast<const float*>(st + 2 * W * RS);
    const float* svs = reinterpret_cast<const float*>(st + 2 * W * RS + a.scale_bytes);
    const float* sb = reinterpret_cast<const float*>(st + 2 * W * RS + 2 * a.scale_bytes);
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
          float x = dot(st + (c0 + j) * RS);
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
      const unsigned char* sv = st + (W + c0) * RS;
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
              load_chunk(reinterpret_cast<const TKV*>(sv + j * RS + off[c]), x);
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
        const int d0 = (c * LPH + cl) * EPT;  // the chunk's first element
        if (!kSlots || (Dh & 3) == 0) {  // 16-byte stores, each wholly inside or past Dh
#pragma unroll
          for (int j = 0; j < EPT / 4; ++j)
            if (!kSlots || d0 + 4 * j < Dh)
              *reinterpret_cast<float4*>(pa + d0 + 4 * j) = make_float4(
                  acc[c][4 * j], acc[c][4 * j + 1], acc[c][4 * j + 2], acc[c][4 * j + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < EPT; ++e)
            if (d0 + e < Dh) pa[d0 + e] = acc[c][e];
        }
      }
    }
    if (cl == 0) {
      a.part_ml[2 * (prow + head)] = m;
      a.part_ml[2 * (prow + head) + 1] = l;
    }
  }
}

// The strided layout (Dh above 1024): grid (n_splits * n_vslices, B, H),
// one block of kWideWarps warps per (split, V slice, slot, head).  Thread t
// owns the head's 16-byte chunks t + 256 i (i < CPT) of its slice: their q
// (pre-scaled, f32, 0 past Dh) and acc live in registers.  A head of at
// most strided_max_cpt() * 256 chunks is one slice and its block scores
// the columns itself (kScored false).  A wider head has its scores from
// ragged_decode_scores_kernel, in the same arithmetic, and is cut into
// slices of strided_max_cpt() * 256 chunks, each a block that stages and
// sums only its slice of V (kScored true): so any Dh runs, with acc in
// registers.  Stage layout: K (W slots of SB bytes, one a column; none when
// kScored), V (W slots), k scales, v scales, bias (W floats each); after the
// ring, the warps' partial scores (kWideWarps x kStridedMaxCols floats),
// then one mbarrier per stage.
constexpr int kStridedThreads = kWideWarps * 32;
constexpr int kStridedStages = 3;     // ring depth: two stages in flight
constexpr int kStridedMaxCols = 32;   // columns of a tile, at most: a lane each
constexpr int kStridedPartBytes = kWideWarps * kStridedMaxCols * (int)sizeof(float);
constexpr int kScoreCols = 8;         // columns of a ragged_decode_scores_kernel block

// Chunks a thread of the strided layout holds, at most: 64 floats of q and
// 64 of acc (int8 4, bf16 8), and a 32 KB column (f32 8).
__host__ __device__ constexpr int strided_max_cpt(int elem) {
  return 64 / (16 / elem) < 8 ? 64 / (16 / elem) : 8;
}

// The registers of two blocks per SM (for a ring of one or two stages)
// while a thread holds at most 32 floats of q and acc.
__host__ __device__ constexpr int strided_min_blocks(int floats) { return floats <= 32 ? 2 : 1; }

template <typename TKV, int CPT, bool kScored>
__global__ void __launch_bounds__(kStridedThreads,
                                  strided_min_blocks((kScored ? 1 : 2) * CPT * 16 / sizeof(TKV)))
    ragged_decode_strided_kernel(const SplitArgs a) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr int EPT = 16 / sizeof(TKV);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  int split = blockIdx.x, vs = 0;  // the V slice: blockIdx.x / n_splits, by subtraction
  if constexpr (kScored) {
#pragma unroll 1
    while (split >= a.n_splits) {
      split -= a.n_splits;
      ++vs;
    }
  }
  const int b = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Dh = a.Dh, G = a.G;
  const int len = min(max(a.lengths[b], 0), a.C);
  const int c_begin = split * a.split_cols;
  const long long prow = ((long long)b * a.n_splits + split) * H + h;  // the partial row
  if (c_begin >= len) {  // an empty partial: weight 0, so the combine skips its acc
    if (tid == 0 && vs == 0) {
      a.part_ml[2 * prow] = kInitMax;
      a.part_ml[2 * prow + 1] = 0.f;
    }
    return;
  }
  const int n_cols = min(a.split_cols, len - c_begin);
  const int W = a.stage_cols, HB = a.head_bytes, SB = a.srow_bytes, u = a.unit;
  const int cbase = vs * CPT * kStridedThreads;  // the slice's first chunk
  const int vb = kScored ? min(HB - 16 * cbase, SB) : HB;  // V bytes a column of the slice
  const int ph = vb >> (__ffs(u) - 1);                     // its pieces of u bytes
  const int v_off = kScored ? 0 : W * SB, sc_off = v_off + W * SB;  // V slots, scales
  const long long R = (long long)H * HB;                 // column stride in bytes
  const long long first = (long long)b * a.C + c_begin;  // first column of the run
  const unsigned char* gk = static_cast<const unsigned char*>(a.k) + first * R + (long long)h * HB;
  const unsigned char* gv = static_cast<const unsigned char*>(a.v) + first * R +
                            (long long)h * HB + 16 * cbase;
  float* s_part = reinterpret_cast<float*>(smem + a.ring_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.ring_bytes + kStridedPartBytes);
  const bool bulk = a.bulk;
  if (bulk) {  // one mbarrier per stage, armed by warp 0's lane 0 at each issue
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStridedStages; ++s) mbar_init(bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // zero the pad bytes of the slots (K and V, or V) of the stages in use, once
  if (vb != align16(vb) && tid < (kScored ? 1 : 2) * W) {
    const int n_stages = n_cols > 2 * W ? 3 : n_cols > W ? 2 : 1;
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
      unsigned char* slot = smem + s * a.stage_bytes + tid * SB;
#pragma unroll 1
      for (int x = vb; x < align16(vb); ++x) slot[x] = 0;
    }
  }

  // Tile t's columns: a bulk copy of each column's head (K and V, or the
  // slice of V), issued by warp 0, lane j on column j; else piece p of
  // column j to byte j * SB + p * u of the slots, the block's threads spread
  // over (j, p) in order.
  auto issue = [&](int t) {
    const int s = t % kStridedStages;
    unsigned char* st = smem + s * a.stage_bytes;
    const int c0 = t * W, nc = min(W, n_cols - c0);
    const unsigned char* sk = gk + c0 * R;
    const unsigned char* sv = gv + c0 * R;
    if (bulk) {
      if (warp == 0) {
        if (lane == 0) mbar_expect_tx(bars + s, (kScored ? 1u : 2u) * nc * vb);
        __syncwarp();
        if (lane < nc) {
          if (!kScored) bulk_copy(st + lane * SB, sk + lane * R, HB, bars + s);
          bulk_copy(st + v_off + lane * SB, sv + lane * R, vb, bars + s);
        }
      }
    } else {
      int j = 0, p = tid;
      while (p >= ph) {  // ph > 64: a few steps
        p -= ph;
        ++j;
      }
      while (j < nc) {
        if (!kScored) copy_piece(st + j * SB + p * u, sk + j * R + p * u, u);
        copy_piece(st + v_off + j * SB + p * u, sv + j * R + p * u, u);
        p += kStridedThreads;
        while (p >= ph) {
          p -= ph;
          ++j;
        }
      }
    }
    float* sc = reinterpret_cast<float*>(st + sc_off);
    if (tid < nc) {
      const long long c = first + c0 + tid;
      if (kQuant) {
        cp_async4(sc + tid, a.k_scale + c * H + h);
        cp_async4(sc + W + tid, a.v_scale + c * H + h);
      }
      if (a.bias != nullptr) cp_async4(sc + 2 * W + tid, a.bias + c);
    }
  };

  // The first stages' copies go out before q's loads.
#pragma unroll
  for (int t = 0; t < kStridedStages - 1; ++t) {
    if (t * W < n_cols) issue(t);
    cp_async_commit();
  }

  bool own[CPT];
  float q[CPT][EPT], acc[CPT][EPT];
  const long long qi = (long long)b * a.q_sb + (long long)h * Dh;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int ci = cbase + tid + i * kStridedThreads;
    own[i] = ci < G;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int d = ci * EPT + e;
      float x = 0.f;
      if (!kScored && d < Dh)
        x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi + d])
                     : static_cast<const float*>(a.q)[qi + d];
      q[i][e] = x * a.scale;
      acc[i][e] = 0.f;
    }
  }
  const bool warp_owns = cbase + warp * 32 < G;  // the warp holds a chunk
  const float* scores = kScored ? a.scores + ((long long)b * H + h) * a.C + c_begin : nullptr;
  float m = kInitMax, l = 0.f;
  unsigned parity = 0;  // bit s: the phase of stage s's next use

  for (int t = 0; t * W < n_cols; ++t) {
    cp_async_wait<kStridedStages - 2>();
    if (bulk) {
      const int s = t % kStridedStages;
      mbar_wait(bars + s, (parity >> s) & 1u);
      parity ^= 1u << s;
    }
    __syncthreads();  // tile t has landed; every thread is done with tile t - 1
    if ((t + kStridedStages - 1) * W < n_cols) issue(t + kStridedStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + t % kStridedStages * a.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + sc_off);
    const int nc = min(W, n_cols - t * W);

    // The warp's share of each column's score: its threads' partial dot
    // products (four sums each), then the xor-shuffle sum over the warp.
    if constexpr (!kScored) {
      if (warp_owns) {
#pragma unroll 1
        for (int j0 = 0; j0 < nc; j0 += 4) {
          float s[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            if (j0 + jj < nc) {
#pragma unroll
              for (int i = 0; i < CPT; ++i) {
                if (own[i]) {
                  float x[EPT];
                  load_chunk(reinterpret_cast<const TKV*>(
                                 st + (j0 + jj) * SB + (tid + i * kStridedThreads) * 16), x);
#pragma unroll
                  for (int e = 0; e < EPT; ++e) part[e & 3] = fmaf(q[i][e], x[e], part[e & 3]);
                }
              }
            }
            s[jj] = (part[0] + part[1]) + (part[2] + part[3]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], o);
          if (lane < 4 && j0 + lane < nc) {
            float mine = s[0];
#pragma unroll
            for (int jj = 1; jj < 4; ++jj)
              if (lane == jj) mine = s[jj];
            s_part[warp * kStridedMaxCols + j0 + lane] = mine;
          }
        }
      } else if (lane < nc) {
        s_part[warp * kStridedMaxCols + lane] = 0.f;
      }
      __syncthreads();  // the partial scores are in
    }

    // The tile's online-softmax step, in every warp alike: lane j holds
    // column j's score (the warps' shares summed in a fixed order).
    float s = kInitMax;
    if (lane < nc) {
      if constexpr (kScored) {
        s = scores[t * W + lane];
      } else {
        const float* sp = s_part + lane;
        s = ((sp[0] + sp[32]) + (sp[64] + sp[96])) + ((sp[128] + sp[160]) + (sp[192] + sp[224]));
      }
      if (kQuant) s *= sc[lane];
      if (a.bias != nullptr) s += sc[2 * W + lane];
    }
    float mt = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    const float p = lane < nc ? expf(s - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l = l * alpha + ps;
    const float w = lane < nc && kQuant ? p * sc[W + lane] : p;  // the V scale folds in
    if (m_new != m) {  // else alpha is exactly 1
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[i][e] *= alpha;
    }
    m = m_new;
    if (warp_owns) {
#pragma unroll 1
      for (int j = 0; j < nc; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          if (own[i]) {
            float x[EPT];
            load_chunk(reinterpret_cast<const TKV*>(
                           st + v_off + j * SB + (tid + i * kStridedThreads) * 16), x);
#pragma unroll
            for (int e = 0; e < EPT; ++e) acc[i][e] = fmaf(wj, x[e], acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* pa = a.part_acc + prow * Dh;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    if (own[i]) {
      const int d0 = (cbase + tid + i * kStridedThreads) * EPT;
      if ((Dh & 3) == 0) {  // 16-byte stores, each wholly inside or past Dh
#pragma unroll
        for (int j = 0; j < EPT / 4; ++j)
          if (d0 + 4 * j < Dh)
            *reinterpret_cast<float4*>(pa + d0 + 4 * j) = make_float4(
                acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          if (d0 + e < Dh) pa[d0 + e] = acc[i][e];
      }
    }
  }
  if (tid == 0 && vs == 0) {
    a.part_ml[2 * prow] = m;
    a.part_ml[2 * prow + 1] = l;
  }
}

// The scores of the strided layout's heads of more than strided_max_cpt() *
// 256 chunks: grid (ceil(C / kScoreCols), B, H), 256 threads, a block per
// run of kScoreCols columns of one slot and head; scores[b, h, c] = q . k_c
// (q pre-scaled) for the columns below the slot's length.  Thread t takes
// the head's chunks t, t + 256, ... in order (q's chunk once, then the
// run's K chunks from device memory: 16-byte loads where the head is whole
// chunks, else element loads), with four partial sums a column, summed as
// ragged_decode_strided_kernel sums them (in pairs, the warp by
// xor-shuffle, the 8 warps in pairs): the same scores as that kernel's,
// bit for bit.  What bounds it: bytes, K read once.
template <typename TKV>
__global__ void __launch_bounds__(kStridedThreads) ragged_decode_scores_kernel(const SplitArgs a) {
  constexpr int EPT = 16 / sizeof(TKV);
  __shared__ float s_part[kWideWarps][kScoreCols];
  const int b = blockIdx.y, h = blockIdx.z, c0 = blockIdx.x * kScoreCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Dh = a.Dh, G = a.G, HB = a.head_bytes;
  const int len = min(max(a.lengths[b], 0), a.C);
  if (c0 >= len) return;  // the strided kernel reads no score at or past the length
  const int nc = min(kScoreCols, len - c0);
  const long long R = (long long)H * HB;
  const unsigned char* gk =
      static_cast<const unsigned char*>(a.k) + ((long long)b * a.C + c0) * R + (long long)h * HB;
  const long long qi = (long long)b * a.q_sb + (long long)h * Dh;
  const bool whole = a.unit == 16;
  float part[kScoreCols][4];
#pragma unroll
  for (int j = 0; j < kScoreCols; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 1
  for (int ci = tid; ci < G; ci += kStridedThreads) {
    float q[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int d = ci * EPT + e;
      float x = 0.f;
      if (d < Dh)
        x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi + d])
                     : static_cast<const float*>(a.q)[qi + d];
      q[e] = x * a.scale;
    }
#pragma unroll
    for (int j = 0; j < kScoreCols; ++j) {
      if (j < nc) {
        const unsigned char* col = gk + j * R;
        float x[EPT];
        if (whole) {
          load_chunk(reinterpret_cast<const TKV*>(col + 16 * ci), x);
        } else {
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            const int d = ci * EPT + e;
            x[e] = d < Dh ? elem_to_float(reinterpret_cast<const TKV*>(col)[d]) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < EPT; ++e) part[j][e & 3] = fmaf(q[e], x[e], part[j][e & 3]);
      }
    }
  }
  float s[kScoreCols];
#pragma unroll
  for (int j = 0; j < kScoreCols; ++j) s[j] = (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < kScoreCols; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kScoreCols; ++j) s_part[warp][j] = s[j];
  }
  __syncthreads();
  if (tid < nc) {
    const float x = ((s_part[0][tid] + s_part[1][tid]) + (s_part[2][tid] + s_part[3][tid])) +
                    ((s_part[4][tid] + s_part[5][tid]) + (s_part[6][tid] + s_part[7][tid]));
    a.scores[((long long)b * H + h) * a.C + c0 + tid] = x;
  }
}

// out[b, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the
// n_splits partials of the slot, in a fixed order: thread (g, d) of the first
// ng * Dh sums the splits s = g (mod ng) of dim d, and the ng sums are added
// in order of g (ng = combine_groups(kThreads, Dh), from the host).  A dead split's empty
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

// The combine of the strided layout (Dh above 1024): grid (ceil(Dh / 256),
// H, B), 256 threads, thread t on element 256 blockIdx.x + t.  Each block
// takes M over the splits, puts each split's weight e^(m_s - M) and l_s in
// shared memory, sums the denominator in order of s, and its element's
// numerator in order of s, eight loads ahead; a split of weight 0 (a dead
// split, whose acc was never written) is skipped.  All its shared memory is
// dynamic: kWideWarps warp maxima, then n_splits weights, then n_splits l.
__global__ void __launch_bounds__(kStridedThreads) ragged_decode_combine_strided_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int H, int Dh, int n_splits) {
  extern __shared__ float s_dyn[];
  float* s_max = s_dyn;
  float* s_weight = s_dyn + kWideWarps;
  float* s_l = s_weight + n_splits;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int d = blockIdx.x * kStridedThreads + tid;
  const long long row0 = (long long)b * n_splits * H + h;  // split s at row0 + s * H
  float mx = kInitMax;
#pragma unroll 1
  for (int s = tid; s < n_splits; s += kStridedThreads)
    mx = fmaxf(mx, part_ml[2 * (row0 + (long long)s * H)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) s_max[tid >> 5] = mx;
  __syncthreads();
  float M = s_max[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) M = fmaxf(M, s_max[w]);
  float* o = out + ((long long)b * H + h) * Dh;
  if (M == kInitMax) {  // no live split: a slot of length 0
    if (d < Dh) o[d] = 0.f;
    return;
  }
#pragma unroll 1
  for (int s = tid; s < n_splits; s += kStridedThreads) {
    const long long r = row0 + (long long)s * H;
    s_weight[s] = expf(part_ml[2 * r] - M);
    s_l[s] = part_ml[2 * r + 1];
  }
  __syncthreads();
  if (d >= Dh) return;
  float den = 0.f, num = 0.f;
  const float* pa = part_acc + row0 * Dh + d;
  const long long stride = (long long)H * Dh;  // between splits
  int s = 0;
#pragma unroll 1
  for (; s + 8 <= n_splits; s += 8) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = s_weight[s + k] != 0.f ? pa[(s + k) * stride] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      den = fmaf(s_weight[s + k], s_l[s + k], den);
      num = fmaf(s_weight[s + k], x[k], num);
    }
  }
#pragma unroll 1
  for (; s < n_splits; ++s) {
    den = fmaf(s_weight[s], s_l[s], den);
    if (s_weight[s] != 0.f) num = fmaf(s_weight[s], pa[s * stride], num);
  }
  o[d] = num / den;
}

// Split groups of a combine block of `threads`: threads / Dh, at most
// threads / 16 (the sizes of s_den and of one round of prefetched weights).
inline int combine_groups(int threads, int Dh) {
  const int ng = threads / Dh;
  return ng < threads / 16 ? ng : threads / 16;
}

// The combine in blocks of 256 threads while those hold every split in one
// round of prefetches (and Dh <= 256), else in blocks of 1024 (Dh <= 1024).
cudaError_t launch_combine(const float* part_acc, const float* part_ml, float* out, int B, int H,
                           int Dh, int n_splits, cudaStream_t stream) {
  const dim3 grid(H, B);
  const int ng256 = combine_groups(256, Dh);
  if (ng256 > 0 && n_splits <= kCombinePrefetch * ng256) {
    ragged_decode_combine_kernel<256><<<grid, 256, 0, stream>>>(part_acc, part_ml, out, H, Dh,
                                                                n_splits, ng256);
  } else {
    ragged_decode_combine_kernel<1024><<<grid, 1024, 0, stream>>>(
        part_acc, part_ml, out, H, Dh, n_splits, combine_groups(1024, Dh));
  }
  return cudaGetLastError();
}

// Launch one layout, raising its dynamic shared-memory limit once.
template <typename TKV, int LPH, int CPH>
cudaError_t launch_layout(const SplitArgs& a, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream) {
  constexpr int HPP = 32 / LPH;
  const int groups = (a.H + HPP - 1) / HPP;  // head groups of a row
  if (a.n_groups * a.warps_per_group > layout_warps(CPH * 16 / sizeof(TKV)) ||
      a.n_slices != (groups + a.n_groups - 1) / a.n_groups ||
      a.slice_heads != (a.n_slices == 1 ? a.H : a.n_groups * HPP))
    return cudaErrorInvalidValue;
  auto kern = a.slots ? ragged_decode_split_kernel<TKV, LPH, CPH, true>
                      : ragged_decode_split_kernel<TKV, LPH, CPH, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(ragged_decode_split_kernel<TKV, LPH, CPH, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes),
      cudaFuncSetAttribute(ragged_decode_split_kernel<TKV, LPH, CPH, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes)};
  if (attr[0] != cudaSuccess) return attr[0];
  if (attr[1] != cudaSuccess) return attr[1];
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The lane layout of G chunks per head: LPH = the next power of two (at most
// 32), CPH = chunks per lane.  Dh up to 1024 gives G up to kMaxTypeG =
// 64 * sizeof(TKV): seven layouts in int8, eight in bf16, nine in f32.
template <typename TKV>
cudaError_t launch_split(const SplitArgs& a, dim3 grid, int threads, size_t smem,
                         cudaStream_t s) {
  constexpr int kMaxTypeG = 64 * sizeof(TKV);
  const int G = a.G;
  if (G < 1 || G > kMaxTypeG) return cudaErrorInvalidValue;
  if (G <= 1) return launch_layout<TKV, 1, 1>(a, grid, threads, smem, s);
  if (G <= 2) return launch_layout<TKV, 2, 1>(a, grid, threads, smem, s);
  if (G <= 4) return launch_layout<TKV, 4, 1>(a, grid, threads, smem, s);
  if (G <= 8) return launch_layout<TKV, 8, 1>(a, grid, threads, smem, s);
  if (G <= 16) return launch_layout<TKV, 16, 1>(a, grid, threads, smem, s);
  if (G <= 32) return launch_layout<TKV, 32, 1>(a, grid, threads, smem, s);
  if (G <= 64) return launch_layout<TKV, 32, 2>(a, grid, threads, smem, s);
  if constexpr (kMaxTypeG > 64) {
    if (G <= 128) return launch_layout<TKV, 32, 4>(a, grid, threads, smem, s);
  }
  if constexpr (kMaxTypeG > 128) {
    if (G <= 256) return launch_layout<TKV, 32, 8>(a, grid, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

// One strided instantiation, raising its dynamic shared-memory limit once.
template <typename TKV, int CPT, bool kScored>
cudaError_t launch_strided_cpt(const SplitArgs& a, int B, size_t smem, cudaStream_t s) {
  auto kern = ragged_decode_strided_kernel<TKV, CPT, kScored>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(a.n_splits * a.n_vslices, B, a.H), kStridedThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The strided layout: its split kernel (CPT = G / 256 rounded up to a power
// of two: three instantiations in int8 and f32, four in bf16; past
// strided_max_cpt() * 256 chunks the scores kernel, then the split kernel
// on slices of V), then its combine.
template <typename TKV>
cudaError_t launch_strided(const SplitArgs& a, int B, float* out, size_t smem, cudaStream_t s) {
  constexpr int kMaxCpt = strided_max_cpt(sizeof(TKV));
  const int G = a.G;
  cudaError_t err = cudaErrorInvalidValue;
  if (G <= 256) {
    if constexpr (sizeof(TKV) < 4) err = launch_strided_cpt<TKV, 1, false>(a, B, smem, s);
  } else if (G <= 512) {
    err = launch_strided_cpt<TKV, 2, false>(a, B, smem, s);
  } else if (G <= 1024) {
    err = launch_strided_cpt<TKV, 4, false>(a, B, smem, s);
  } else if (G <= kMaxCpt * kStridedThreads) {
    if constexpr (kMaxCpt >= 8) err = launch_strided_cpt<TKV, 8, false>(a, B, smem, s);
  } else {
    ragged_decode_scores_kernel<TKV>
        <<<dim3((a.C + kScoreCols - 1) / kScoreCols, B, a.H), kStridedThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = launch_strided_cpt<TKV, kMaxCpt, true>(a, B, smem, s);
  }
  if (err != cudaSuccess) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_decode_combine_strided_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Dh + kStridedThreads - 1) / kStridedThreads, a.H, B);
  ragged_decode_combine_strided_kernel<<<grid, kStridedThreads,
                                         (2 * a.n_splits + kWideWarps) * sizeof(float), s>>>(
      a.part_acc, a.part_ml, out, a.H, a.Dh, a.n_splits);
  return cudaGetLastError();
}

// The copy of a head: Dh * elem bytes that start at a multiple of u bytes in
// every row (the cache is 16-byte aligned), in pieces of u bytes.
void set_head_copy(SplitArgs& a, int elem) {
  a.head_bytes = a.Dh * elem;
  a.G = (a.head_bytes + 15) / 16;
  a.unit = 16;
  while (a.head_bytes % a.unit != 0) a.unit /= 2;
  a.pieces = a.head_bytes / a.unit;
  a.pieces_inv = ((1ull << 32) + a.pieces - 1) / a.pieces;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only).
// q: (B, [1,] H, Dh) with batch stride q_sb elements, (H, Dh) contiguous;
// k, v: (B, C, H, Dh) contiguous and 16-byte aligned, any Dh: up to 1024
// the lane layouts, above it the strided layout, whose plan is n_groups 1,
// warps_per_group 8, stage_cols = cols_per_warp <= 32 and n_slices = H;
// k_scale, v_scale: (B, C, H) f32 or null (required iff int8); bias: (B, C)
// f32 or null; lengths: (B,) int32; partials: B * n_splits * H * (Dh + 2)
// f32 of scratch, and B * H * C more above Dh 1024 (the widest heads'
// scores); out: (B, H, Dh) f32.  split_cols, n_splits, stage_cols, cols_per_warp, n_groups,
// warps_per_group and n_slices are the host's plan
// (ops/ragged_decode.py::split_plan); scale multiplies q . k (the wrapper's
// 1 / sqrt(Dh) in f32).
// Launches the split kernel, then the combine kernel, and returns the first
// cudaError_t.
extern "C" int ragged_decode_attention_launch(
    const void* q, long long q_sb, int q_dtype, const void* k, const void* v, int kv_dtype,
    const float* k_scale, const float* v_scale, const float* bias, const int* lengths,
    float* partials, float* out, int B, int C, int H, int Dh, int split_cols, int n_splits,
    int stage_cols, int cols_per_warp, int n_groups, int warps_per_group, int n_slices,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = kv_dtype == 2 ? 1 : kv_dtype == 1 ? 2 : kv_dtype == 0 ? 4 : 0;
  if (Dh > 1024) {  // the strided layout: one block per (split, slot, head)
    if (elem == 0 || (q_dtype != 0 && q_dtype != 1) || B < 1 || B > 65535 || C < 1 ||
        H < 1 || H > 65535 || split_cols < 1 || n_splits != (C + split_cols - 1) / split_cols ||
        (2 * n_splits + kWideWarps) * sizeof(float) > (size_t)kMaxSmemBytes || n_groups != 1 ||
        warps_per_group != kWideWarps || stage_cols < 1 || stage_cols > kStridedMaxCols ||
        cols_per_warp != stage_cols || n_slices != H)
      return (int)cudaErrorInvalidValue;
    SplitArgs a = {};
    a.q = q;
    a.q_sb = q_sb;
    a.q_bf16 = q_dtype == 1;
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
    set_head_copy(a, elem);
    a.split_cols = split_cols;
    a.n_splits = n_splits;
    a.stage_cols = stage_cols;
    a.cols_per_warp = cols_per_warp;
    // a head of more chunks than a thread holds: scores first, V in slices
    const int slice = strided_max_cpt(elem) * kStridedThreads;
    const bool scored = a.G > slice;
    a.n_vslices = (a.G + slice - 1) / slice;
    if ((long long)n_splits * a.n_vslices > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.scores = scored ? partials + (long long)B * n_splits * H * (Dh + 2) : nullptr;
    a.srow_bytes = 16 * (scored ? slice : a.G);
    a.stage_bytes = (scored ? 1 : 2) * stage_cols * a.srow_bytes + align16(3 * stage_cols * 4);
    const int tiles = (split_cols + stage_cols - 1) / stage_cols;
    a.ring_bytes = (tiles < kStridedStages ? tiles : kStridedStages) * a.stage_bytes;
    a.scale = scale;
    a.bulk = a.unit == 16 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
    const size_t smem = (size_t)a.ring_bytes + kStridedPartBytes + kStridedStages * 8;
    if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaErrorInvalidValue;
    if (kv_dtype == 0) err = launch_strided<float>(a, B, out, smem, s);
    if (kv_dtype == 1) err = launch_strided<__nv_bfloat16>(a, B, out, smem, s);
    if (kv_dtype == 2) err = launch_strided<int8_t>(a, B, out, smem, s);
    return (int)err;
  }
  if (elem == 0 || (q_dtype != 0 && q_dtype != 1) || Dh < 1 || Dh > 1024 ||
      (Dh * elem + 15) / 16 > kMaxG || B < 1 || C < 1 || H < 1 || split_cols < 1 ||
      n_splits != (C + split_cols - 1) / split_cols || n_groups < 1 || warps_per_group < 1 ||
      n_groups * warps_per_group > kMaxWarps || cols_per_warp < 1 || n_slices < 1 ||
      n_slices > 65535 || cols_per_warp > kMaxColsPerWarp ||
      stage_cols != cols_per_warp * warps_per_group)
    return (int)cudaErrorInvalidValue;
  SplitArgs a;
  a.q = q;
  a.q_sb = q_sb;
  a.q_bf16 = q_dtype == 1;
  a.q_vec = q_dtype == 0 && (uintptr_t)q % 16 == 0 && q_sb % 4 == 0 && Dh % 4 == 0;
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
  set_head_copy(a, elem);
  a.split_cols = split_cols;
  a.n_splits = n_splits;
  a.stage_cols = stage_cols;
  a.cols_per_warp = cols_per_warp;
  a.n_groups = n_groups;
  a.warps_per_group = warps_per_group;
  a.n_slices = n_slices;
  int lph = 1;  // lanes per head: G rounded up to a power of two, at most 32
  while (lph < a.G && lph < 32) lph *= 2;
  a.slice_heads = n_slices == 1 ? H : n_groups * (32 / lph);
  a.row_bytes = H * Dh * elem;
  a.srow_bytes = a.slice_heads * 16 * a.G;
  a.slots = a.head_bytes != 16 * a.G;
  a.scale_bytes = elem == 1 ? align16(stage_cols * H * 4) : 0;
  a.stage_bytes = 2 * stage_cols * a.srow_bytes + 2 * a.scale_bytes + align16(stage_cols * 4);
  a.vec_scales = elem == 1 && H % 4 == 0 && (uintptr_t)k_scale % 16 == 0 &&
                 (uintptr_t)v_scale % 16 == 0;
  a.scale = scale;
  const int threads = 32 * n_groups * warps_per_group;
  const int cph = a.G <= 32 ? 1 : a.G <= 64 ? 2 : a.G <= 128 ? 4 : 8;
  const int ns = cph * 16 / elem;  // accumulator floats per lane
  // a split of at most one stage of columns uses one stage of the ring
  const int tiles = (split_cols + stage_cols - 1) / stage_cols;
  const size_t ring = (size_t)(tiles < kStages ? tiles : kStages) * a.stage_bytes;
  const size_t merge = (size_t)threads * (ns + 2) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;

  const dim3 grid(n_splits, B, n_slices);
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == 0) err = launch_split<float>(a, grid, threads, smem, s);
  if (kv_dtype == 1) err = launch_split<__nv_bfloat16>(a, grid, threads, smem, s);
  if (kv_dtype == 2) err = launch_split<int8_t>(a, grid, threads, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine(a.part_acc, a.part_ml, out, B, H, Dh, n_splits, s);
}
