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
//   7. Head dims past 1024 (the split instantiations, *_split_kernel; from
//      257 to 1024 the cluster kernels of point 9 run instead): a
//      warp's 16 rows of O in f32 take Dh / 2 accumulator registers per
//      thread, and a whole-row tile at Dh 512 needs 264 KB of shared memory
//      in f32, over the 227 KB a block may use.  So the head dim is split:
//      the wrapper zero-pads Dh to a multiple of kSplitDh = 128, and a grid
//      dimension takes the nc = Dh / 128 chunks of O, each block holding Dh
//      128's accumulators (and launch bounds) for its chunk.  S needs the
//      whole Dh, so each block recomputes it: every key tile takes nc steps
//      of the two-stage ring, step i staging chunk i of the q tile and the
//      key tile (q is restaged per key tile: it no longer fits beside the
//      ring at Dh 1024) and adding its product to S; the block's own V chunk
//      comes with the tile's first step.  Shared memory stays that of Dh 128
//      plus a second q stage (101.5 KB f32, 69.9 KB bf16) at any Dh.  The
//      cost: S's products nc times, (nc + 1) / 2 times the forward's
//      operations, and q read once per key tile from L2.  Every chunk sums S
//      in the same order, so the LSE (written by chunk 0) is every chunk's.
//   8. Head dim 256 (the wide kernels, *_wide_kernel; the wrapper zero-pads
//      Dh 129-255 to 256), the forward sibling of the backward's wide dQ
//      pass (prefix_attention_bwd.cu point 6; the block shape, launch
//      bounds and exchange are in wide_tile.cuh).  The split design ran S's
//      products twice at Dh 256 (1.5x the operations) and restaged q from L2
//      on every key tile.  Here S is computed once per (q tile, key tile)
//      pair and q is staged once: a block is kWideWarps = 8 warps per (64-row
//      q tile, head, batch); q sits whole in shared memory and K and V stream
//      through a two-stage ring of WK = 16-key tiles (kernel 2's key bias
//      with them).  Per key tile:
//        phase A: warp w computes a 16 x 16 tile of S for rows 16 (w & 3) ..
//          +15 over Dh half w >> 2 (mma_xyt over 128 of the 256 columns);
//          warps w and w ^ 4 swap both n8 tiles of their partials through
//          shared memory and each adds low half + high half, so both hold
//          the whole tile bit for bit.  Each then scales and masks all 16
//          columns (kernel 4's bias read before the product) and takes the
//          rows' running max from them in registers, the same in both warps:
//          this costs 8 more exchanged floats a lane but no second exchange
//          (and barrier) for the max across the two n8 halves.  The warp's
//          own n8 tile (columns 8 (w >> 2) .. +7) then gets its Philox keep
//          bits (counter (col / 4, row, b H + h) as at Dh <= 128) and becomes
//          P, rounded like T against the running max, in a 64 x 16 tile of
//          shared memory; the half-0 warps write the rows' rescale factors
//          exp(m_old - m_new) to a 64-entry table beside it.  Each warp
//          keeps its part of the row sums over its own columns.
//        phase C, after one barrier: warp w owns O's columns 32 w .. 32 w +
//          31 for all 64 rows (64 f32 accumulators a thread), rescales them
//          by the table and adds P V (mma_xz, both operands from shared
//          memory; in f32 each k step into a zeroed fragment added in f32).
//      Three barriers per key tile (the ring, the exchange, P).  Epilogue:
//      the two halves' row sums meet in shared memory (low + high), each row
//      of out and of the LSE has one writer.  Kernel 2 stops at the tile's
//      frontier max(prefix_s, tile end); kernel 4 walks every key tile.
//      Shared memory: 144.9 KB in f32, one block (8 warps) per SM; 77.9 KB
//      in bf16, launch bounds of two blocks (16 warps) per SM (at most 128
//      registers).  The grid (Tq / 64, H, B) has half the split kernel's
//      blocks: at B 4, T 880, H 4, 224 blocks, 1.7 waves of 132 SMs in f32
//      and 0.85 in bf16; at the TTS inference shape (B 8, T 201) 128
//      blocks, under one wave.  64-row tiles ship, chosen by measurement on
//      an H100 (PERF.md, section 6): at these shapes the wide kernel runs
//      within 4% of the Dh-64 kernel at 16 heads on the same FLOPs, or
//      faster (the under-filled inference grid too), so 32-row tiles, which
//      would read K and V twice as often per row, were not needed.  Reruns
//      are bit-equal: no atomics, and every sum has a fixed order.  The row
//      sums now add the two halves of each tile's columns apart, so the LSE
//      agrees with the split kernel's to f32 rounding.  Registers: f32
//      248-252 (launch bounds of one block, at most 255), bf16 126-128; no
//      spill.
//   9. Head dims 257-1024 (the cluster kernels, *_cluster_kernel: the tile
//      body with kCluster; the wrapper zero-pads Dh to a multiple of 128),
//      the forward sibling of the backward's cluster passes
//      (prefix_attention_bwd.cu point 7; the exchange is cluster_tile.cuh's).
//      The split design of point 7 ran S's products nc = Dh / 128 times,
//      (nc + 1) / 2 times the forward's operations (2.5x at Dh 512, 4.5x at
//      1024), and restaged q from L2 for every key tile.  Here a
//      thread-block cluster of nc blocks (at most 8, the portable size)
//      covers each (64-row q tile, head, batch), one block per 128-column
//      slice of the head (kSplitDh): block j, the cluster's
//      rank j, stages its slice of the q tile once and streams its slices of
//      K and V through the two-stage ring in key tiles of KN =
//      fwd_cluster_kn() keys, with the Dh-128 body (4 warps of 16 rows,
//      mma_xyt for S, mma_fz for P V, 64 f32 accumulators a thread for O's
//      slice).  Per key tile:
//        - every block computes its partial of S over its slice (in f32 each
//          k step into a zeroed fragment added in f32), and the partials are
//          summed through distributed shared memory in the fixed order
//          slice 0 + 1 + ... + nc - 1 (reduce-scatter, then all-gather), so
//          every block holds the same S, bit for bit;
//        - every block applies kernel 2's key bias and structural mask, or
//          kernel 4's dense bias (read before the product), after the sum,
//          and runs the same online softmax on it: the row max, the rescale
//          exp(m_old - m_new), the Philox keep bits at counter (col / 4, row,
//          b H + h) and P rounded like T against the running max.  So all
//          blocks agree on P and on the row sums with no second exchange;
//        - each block adds P V_j into its slice of O.
//      Each element of out has one writer, block j of its slice; rank 0
//      alone writes the LSE.  Every block of a cluster takes the same
//      exchanges: kernel 2 stops at the q tile's frontier max(prefix_s, tile
//      end), the same for every slice, and kernel 4 walks every key tile; no
//      loop depends on the slice, and after its last exchange a block waits
//      once more (ClusterExchange::finish).  S's products run once per tile
//      pair: the forward's 4 B H Dh operations per visible pair at any nc.
//      The exchange, a cluster barrier pair and two rounds of remote loads of
//      KN / 2 floats a lane, is the cost the design adds, so the key tile
//      sets the exchanges per q tile: KN = 64 in bf16 (32 floats a lane; 64
//      keys ran 19-34% faster than 32), 16 in f32 (32 keys spilled 20-92
//      bytes at ptxas's 255-register cap beside the 64 accumulators; 64-column
//      slices, which would free them, ran 10-31% slower in 16-block clusters
//      at Dh 1024).  Shared memory: the whole-row tile's at 128 columns and
//      the exchange buffer, 70.1 KB in f32, 101.5 KB in bf16; launch bounds
//      of two blocks per SM (kClusterMinBlocks, at most 255 registers: f32
//      248-253, bf16 220-243; no spill).  Grid (Tq / 64 x nc, H, B),
//      clusters along x, launched with cudaLaunchKernelEx; a launch the card
//      refuses returns its error: nothing falls back.  Reruns are bit-equal:
//      the exchange sums in rank order, and nothing is atomic.
// Later work: wgmma / TMA, and skipping kernel 4's wholly masked key tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include "attention_common.cuh"
#include "cluster_tile.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "wide_tile.cuh"

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

// A split instantiation holds two stages of q's chunk instead of one q tile.
template <typename T, int DH, bool kSplit = false>
constexpr size_t fwd_smem_bytes() {
  return (size_t)((kSplit ? 2 : 1) * BM + 4 * fwd_kn<T, DH>()) * row_stride<T, DH>() * sizeof(T) +
         2 * fwd_kn<T, DH>() * sizeof(float);
}

// The keys of a streamed tile of the cluster forward, one exchange of S's
// partials each, chosen by measurement on an H100 (header point 9).
template <typename T>
__host__ __device__ constexpr int fwd_cluster_kn() {
  return kF32<T> ? 16 : 64;
}

// Shared memory of a cluster forward: the whole-row tile's at its slice of
// kSplitDh columns and its key tile, and the exchange of a warp's S partials
// (KN / 2 floats a lane).
template <typename T>
constexpr size_t fwd_cluster_smem_bytes() {
  constexpr int KN = fwd_cluster_kn<T>();
  return (size_t)(BM + 4 * KN) * row_stride<T, kSplitDh>() * sizeof(T) +
         (2 * KN + cluster_xchg_floats<KN / 2>()) * sizeof(float);
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
// kSplit: the head dim is nc chunks of DH (= kSplitDh) columns, blockIdx.y
// is h * nc + j, and the block writes O's chunk j (chunk 0 also the LSE).
// Each key tile then takes nc steps of the ring, step i staging chunk i of
// the q tile and of the key tile and adding its part of S = q k^T; the first
// step also stages chunk j of the V tile.  Every block of a (q tile, head)
// sums S in the same order, so their P, and the LSE, are equal.  kCluster:
// the head dim is nc slices of DH (= kSplitDh), one block of a
// cluster of nc each (its rank j, the cluster's x index the q tile); the
// block stages its slice of q and streams its slices of K and V in key tiles
// of fwd_cluster_kn(), its partials of S are summed across the cluster
// (cluster_tile.cuh) before the softmax, and it writes O's slice j (rank 0
// also the LSE).
template <typename T, int DH, bool kDrop, bool kBias, bool kSplit = false, bool kCluster = false>
__device__ __forceinline__ void attention_fwd_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, T* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec, int nc = 1) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int KN = kCluster ? fwd_cluster_kn<T>() : fwd_kn<T, DH>();
  static_assert(2 * KN <= kMmaThreads, "one thread per key of a stage's bias");
  constexpr int LDT = row_stride<T, DH>(), TILE = KN * LDT;
  constexpr int NT = KN / 8, DT = DH / 8;  // n8 tiles of a key tile, of Dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [BM][LDT], kSplit: [2][BM][LDT]
  T* sK = sQ + (kSplit ? 2 : 1) * BM * LDT;     // [2][KN][LDT]
  T* sV = sK + 2 * TILE;                        // [2][KN][LDT]
  float* sB = reinterpret_cast<float*>(sV + 2 * TILE);  // [2][KN] kernel 2's key bias
  float* sX = sB + 2 * KN;                      // kCluster: the exchange

  const int r0 = (kCluster ? cluster_index_x() : (int)blockIdx.x) * BM, b = blockIdx.z;
  int h = blockIdx.y, j = 0;  // head, and the block's chunk (slice) of O
  if constexpr (kSplit) {
    h = blockIdx.y / nc;
    j = blockIdx.y - h * nc;
  }
  if constexpr (kCluster) j = cluster_rank();
  const int D = (kSplit || kCluster) ? nc * DH : DH;  // a head's elements in a row
  const int col0 = kCluster ? j * DH : 0;  // the block's first column of the head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  int kend = Tk;  // structural frontier of this q tile
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BM));
  const int n_tiles = (kend + KN - 1) / KN;

  const T* qb = q + (long long)b * q_sb + (long long)h * D + col0;
  const T* kb = k + (long long)b * k_sb + (long long)h * D + col0;
  const T* vb = v + (long long)b * v_sb + (long long)h * D + col0;
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
  // kSplit: step (it, i) of the ring stages chunk i of q and of key tile it
  // into stage (it nc + i) & 1, and at i = 0 the tile's V chunk j and bias
  auto stage_step = [&](int it, int i, int st) {
    stage_rows<T, DH, BM>(sQ + st * BM * LDT, qb + i * DH, q_st, r0, Tq, vec);
    stage_rows<T, DH, KN>(sK + st * TILE, kb + i * DH, k_st, it * KN, kend, vec);
    if (i == 0) {
      stage_rows<T, DH, KN>(sV + (it & 1) * TILE, vb + j * DH, v_st, it * KN, kend, vec);
      stage_bias(it & 1, it * KN);
    }
  };
  if (!kBias && kvb == nullptr && threadIdx.x < 2 * KN) sB[threadIdx.x] = 0.f;
  if constexpr (kSplit) {
    stage_step(0, 0, 0);
  } else {
    stage_rows<T, DH, BM>(sQ, qb, q_st, r0, Tq, vec);
    stage_rows<T, DH, KN>(sK, kb, k_st, 0, kend, vec);
    stage_rows<T, DH, KN>(sV, vb, v_st, 0, kend, vec);
    stage_bias(0, 0);
  }
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
  ClusterExchange xchg{sX, nc};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KN;
    if constexpr (!kSplit) {
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
    }
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
    if constexpr (kSplit) {
      for (int i = 0; i < nc; ++i) {  // S = q k^T, chunk by chunk
        const int st = (it * nc + i) & 1;
        const int i2 = i + 1 < nc ? i + 1 : 0, it2 = i + 1 < nc ? it : it + 1;
        if (it2 < n_tiles) {  // the next step loads while this one computes
          stage_step(it2, i2, st ^ 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        mma_xyt<T, DH, NT, true>(s, sQ + st * BM * LDT + wr * LDT, sK + st * TILE, lane);
        if (i + 1 < nc) __syncthreads();  // the next step's loads overwrite this stage
      }
    } else {
      mma_xyt<T, DH, NT, kCluster>(s, sQ + wr * LDT, cK, lane);  // S = q k^T
      if constexpr (kCluster) xchg.sum(s, warp, lane);          // over the head's slices
    }

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
  if constexpr (kCluster) xchg.finish();

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
      store2(out + (((long long)b * Tq + r) * H + h) * D + j * DH + 8 * n + 2 * t,
             acc[n][2 * half] / l, acc[n][2 * half + 1] / l);
    }
  }
  if (lse != nullptr && t == 0 && j == 0) {
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
}                                                                                                 \
                                                                                                  \
template <typename T, bool kDrop>                                                                 \
__global__ void BOUNDS prefix_attention_split_kernel(                                             \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,              \
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec, int nc) {           \
  attention_fwd_tile<T, kSplitDh, kDrop, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb,      \
                                                      v_st, kv_bias, Bias{}, out, lse, Tq, Tk, H, \
                                                      prefix_s, scale, drop, vec, nc);            \
}                                                                                                 \
                                                                                                  \
template <typename T>                                                                             \
__global__ void BOUNDS flash_bias_fwd_split_kernel(                                               \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H,               \
    float scale, bool vec, int nc) {                                                              \
  attention_fwd_tile<T, kSplitDh, false, true, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, \
                                                     nullptr, bias, out, lse, Tq, Tk, H, -1,      \
                                                     scale, Dropout{}, vec, nc);                  \
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

// Kernel 2 (kSplit: the split instantiation, DH = kSplitDh).
template <typename T, int DH, bool kDrop, bool kSplit>
auto prefix_kernel() {
  constexpr int c = fwd_bounds_class<T, DH>();
  if constexpr (kSplit) {
    static_assert(c == 2, "the split forward takes Dh 128's launch bounds");
    return fit2::prefix_attention_split_kernel<T, kDrop>;
  } else if constexpr (c == 4) return fit4::prefix_attention_kernel<T, DH, kDrop>;
  else if constexpr (c == 2) return fit2::prefix_attention_kernel<T, DH, kDrop>;
  else return any_regs::prefix_attention_kernel<T, DH, kDrop>;
}

// Kernel 4.
template <typename T, int DH, bool kSplit>
auto bias_kernel() {
  constexpr int c = fwd_bounds_class<T, DH>();
  if constexpr (kSplit) {
    static_assert(c == 2, "the split forward takes Dh 128's launch bounds");
    return fit2::flash_bias_fwd_split_kernel<T>;
  } else if constexpr (c == 4) return fit4::flash_bias_fwd_kernel<T, DH>;
  else if constexpr (c == 2) return fit2::flash_bias_fwd_kernel<T, DH>;
  else return any_regs::flash_bias_fwd_kernel<T, DH>;
}

// The cluster kernels (header point 9; kernel 2's
// prefix_attention_cluster_kernel, kernel 4's flash_bias_fwd_cluster_kernel):
// kMmaThreads threads a block, launched in clusters of nc blocks along x,
// launch bounds of kClusterMinBlocks blocks per SM.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) prefix_attention_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec, int nc) {
  attention_fwd_tile<T, kSplitDh, kDrop, false, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias, Bias{}, out, lse, Tq, Tk, H, prefix_s,
      scale, drop, vec, nc);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) flash_bias_fwd_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H,
    float scale, bool vec, int nc) {
  attention_fwd_tile<T, kSplitDh, false, true, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias, out, lse, Tq, Tk, H, -1, scale,
      Dropout{}, vec, nc);
}

// The grid of a cluster launch: (64-row q tiles x nc slices, H, B), a
// cluster of nc blocks along x per q tile.
inline dim3 cluster_fwd_grid(int B, int Tq, int H, int nc) {
  return dim3((Tq + BM - 1) / BM * nc, H, B);
}

// ------------------------------------------------------------ Dh 256

// Shared memory of a wide forward (header point 8): the exchange buffer, the
// row table (each tile's rescale factors, at the end the row maxima), the two
// halves' row sums, two stages of kernel 2's key bias, q whole, two stages of
// K and V, and P.
template <typename T>
constexpr size_t wide_fwd_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T, kWideDh>() * sizeof(T);
  return (size_t)(kWideWarps * kXchg + 3 * WQ + 2 * WK) * sizeof(float) + (WQ + 4 * WK) * row +
         (size_t)WQ * pd_stride<WK>() * sizeof(T);
}

// One (64-row q tile, head, batch) of the forward at Dh 256, arguments and
// kBias / kDrop as attention_fwd_tile.  q stays whole; key tiles of WK = 16
// stream through two stages.  Per tile: warp w computes S for rows 16 (w &
// 3) .. +15 over Dh half w >> 2 and swaps it with warp w ^ 4, so that both
// hold the whole 16 x 16 tile (phase A); both take the rows' running max
// from it, and the warp's own n8 tile (columns 8 (w >> 2) .. +7) becomes P,
// rounded like T, in shared memory beside the rows' rescale factors; after a
// barrier warp w rescales O's columns 32 w .. 32 w + 31 for all 64 rows and
// adds P V (phase C).
template <typename T, bool kDrop, bool kBias>
__device__ __forceinline__ void attention_fwd_wide(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, T* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DH = kWideDh, LDW = row_stride<T, DH>(), LDS = pd_stride<WK>();
  constexpr int TILE = WK * LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);  // [warps][kXchg]
  float* sAl = sX + kWideWarps * kXchg;             // [WQ] rescale factors, then row maxima
  float* sL = sAl + WQ;                             // [2][WQ] the halves' row sums
  float* sB = sL + 2 * WQ;                          // [2][WK] kernel 2's key bias
  T* sQ = reinterpret_cast<T*>(sB + 2 * WK);        // [WQ][LDW]
  T* sK = sQ + WQ * LDW;                            // [2][WK][LDW]
  T* sV = sK + 2 * TILE;                            // [2][WK][LDW]
  T* sP = sV + 2 * TILE;                            // [WQ][LDS]

  const int r0 = blockIdx.x * WQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int half = warp >> 2, wr = 16 * (warp & 3);  // phase A: Dh half, first row
  const unsigned bh = (unsigned)(b * H + h);
  int kend = Tk;  // structural frontier of this q tile
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + WQ));
  const int n_tiles = (kend + WK - 1) / WK;

  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  const float* kvb = (!kBias && kv_bias != nullptr) ? kv_bias + (long long)b * Tk : nullptr;
  // key tile c0 (K, V, and kernel 2's key bias, 0 past kend) into stage st
  auto stage_tile = [&](int st, int c0) {
    stage_rows<T, DH, WK, kWideThreads>(sK + st * TILE, kb, k_st, c0, kend, vec);
    stage_rows<T, DH, WK, kWideThreads>(sV + st * TILE, vb, v_st, c0, kend, vec);
    if constexpr (!kBias) {
      if (kvb != nullptr && threadIdx.x < WK) {
        const int c = c0 + threadIdx.x;
        cp_async4(sB + st * WK + threadIdx.x, c < kend ? kvb + c : kvb, c < kend);
      }
    }
  };
  if (!kBias && kvb == nullptr && threadIdx.x < 2 * WK) sB[threadIdx.x] = 0.f;
  stage_rows<T, DH, WQ, kWideThreads>(sQ, qb, q_st, r0, Tq, vec);
  stage_tile(0, 0);
  cp_async_commit();

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
  float l_a = 0.f, l_b = 0.f;              // this lane's part of their sums over the warp's columns
  float acc[WQ / 16][4][4];                // O: the block's rows x the warp's 32 columns
#pragma unroll
  for (int m = 0; m < WQ / 16; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * WK, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is past tile it - 1's phase C
    if (it + 1 < n_tiles) {  // the next key tile loads while this one computes
      stage_tile(st ^ 1, k0 + WK);
      cp_async_commit();
    }
    const T* cK = sK + st * TILE;
    const T* cV = sV + st * TILE;
    const float* cB = sB + st * WK;
    // kernel 4's biases of both n8 tiles (-inf outside Tq x Tk), read before
    // the product so that their latency hides behind it
    float add[2][4];
    if constexpr (kBias) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb, c = k0 + 8 * n + 2 * t + (e & 1);
          add[n][e] = c < (e < 2 ? lim_a : lim_b) ? bb[r * (int)bias.sq + c * (int)bias.sk]
                                                  : -INFINITY;
        }
    }
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const int dh0 = half * kWideHalf;
    mma_xyt<T, kWideHalf, 2, true, LDW>(s, sQ + wr * LDW + dh0, cK + dh0, lane);  // S = q k^T
    wide_exchange_give(sX, s, warp, lane);
    __syncthreads();
    float s1[2][4];
    wide_exchange_take(sX, s, half, warp, lane, s1);

    // scaled scores (-inf where masked) and the tile's row maxima over all 16
    // columns, the same in both warps of the pair
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * n + 2 * t + (e & 1);
        float x;
        if constexpr (kBias)
          x = (s1[n][e] + add[n][e]) * scale;
        else
          x = k0 + cl < (e < 2 ? lim_a : lim_b) ? s1[n][e] * scale + cB[cl] : -INFINITY;
        s1[n][e] = x;
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
    if (half == 0 && t == 0) {
      sAl[wr + g] = al_a;
      sAl[wr + g + 8] = al_b;
    }

    // the warp's n8 tile becomes P after dropout, rounded like T
    unsigned keep_a = 0xFu, keep_b = 0xFu;
    if constexpr (kDrop) {
      // lane L draws (row wr + L % 16, group L / 16) of this 16 x 8 tile
      const unsigned w = philox_keep4((unsigned)((k0 + 8 * half) >> 2) + (lane >> 4),
                                      (unsigned)(r0 + wr + (lane & 15)), bh, drop.seed,
                                      drop.threshold);
      keep_a = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g) >> (2 * (t & 1));
      keep_b = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g + 8) >> (2 * (t & 1));
    }
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = half ? s1[1][e] : s1[0][e];
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
      pr[e] = round_like<T>(pd);
    }
    store_pair<T>(sP + (wr + g) * LDS + 8 * half + 2 * t, pr[0], pr[1]);
    store_pair<T>(sP + (wr + g + 8) * LDS + 8 * half + 2 * t, pr[2], pr[3]);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < WQ / 16; ++m) {
      const float a0 = sAl[16 * m + g], a1 = sAl[16 * m + g + 8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        acc[m][n][0] *= a0;
        acc[m][n][1] *= a0;
        acc[m][n][2] *= a1;
        acc[m][n][3] *= a1;
      }
    }
    mma_xz<T, WQ / 16, 4, WK, LDS, LDW>(acc, sP, cV + 32 * warp, lane);  // O += P v
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  __syncthreads();  // every warp is past the last phase C's rescale factors
  if (t == 0) {
    sL[half * WQ + wr + g] = l_a;
    sL[half * WQ + wr + g + 8] = l_b;
    if (half == 0) {
      sAl[wr + g] = m_a;
      sAl[wr + g + 8] = m_b;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < WQ / 16; ++m)
#pragma unroll
    for (int half2 = 0; half2 < 2; ++half2) {
      const int rl = 16 * m + g + 8 * half2, r = r0 + rl;
      if (r >= Tq) continue;
      const float l = sL[rl] + sL[WQ + rl];  // low half + high half
      T* o = out + (((long long)b * Tq + r) * H + h) * DH + 32 * warp + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        store2(o + 8 * n, acc[m][n][2 * half2] / l, acc[m][n][2 * half2 + 1] / l);
    }
  if (lse != nullptr && threadIdx.x < WQ && r0 + (int)threadIdx.x < Tq)
    lse[(long long)bh * Tq + r0 + threadIdx.x] =
        sAl[threadIdx.x] + logf(sL[threadIdx.x] + sL[WQ + threadIdx.x]);
}

// The wide kernels (kernel 2's prefix_attention_wide_kernel, kernel 4's
// flash_bias_fwd_wide_kernel), kWideThreads threads a block.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) prefix_attention_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, T* __restrict__ out, float* __restrict__ lse,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec) {
  attention_fwd_wide<T, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                      Bias{}, out, lse, Tq, Tk, H, prefix_s, scale, drop, vec);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) flash_bias_fwd_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H,
    float scale, bool vec) {
  attention_fwd_wide<T, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias,
                                     out, lse, Tq, Tk, H, -1, scale, Dropout{}, vec);
}

// The grid of a wide launch: (64-row q tiles, H, B).
inline dim3 wide_fwd_grid(int B, int Tq, int H) {
  return dim3((Tq + WQ - 1) / WQ, H, B);
}

// The grid of a forward launch: (q tiles, H heads x nc chunks, B).
inline dim3 fwd_grid(int B, int Tq, int H, int nc) {
  return dim3((Tq + BM - 1) / BM, H * nc, B);
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
  if (Dh == kWideDh) {
    auto kern = prefix_attention_wide_kernel<T, true>;
    if (drop.threshold == 0) kern = prefix_attention_wide_kernel<T, false>;
    return launch_wide(kern, wide_fwd_grid(B, Tq, H), wide_fwd_smem_bytes<T>(), stream,
                       static_cast<const T*>(q), q_sb, q_st, static_cast<const T*>(k), k_sb,
                       k_st, static_cast<const T*>(v), v_sb, v_st, kv_bias, static_cast<T*>(out),
                       lse, Tq, Tk, H, prefix_s, scale, drop, vec);
  }
  if (cluster_route(Dh)) {
    const int nc = Dh / kSplitDh;
    auto kern = prefix_attention_cluster_kernel<T, true>;
    if (drop.threshold == 0) kern = prefix_attention_cluster_kernel<T, false>;
    return launch_cluster(kern, cluster_fwd_grid(B, Tq, H, nc), nc, fwd_cluster_smem_bytes<T>(),
                          stream, static_cast<const T*>(q), q_sb, q_st, static_cast<const T*>(k),
                          k_sb, k_st, static_cast<const T*>(v), v_sb, v_st, kv_bias,
                          static_cast<T*>(out), lse, Tq, Tk, H, prefix_s, scale, drop, vec, nc);
  }
  return dispatch_dh(Dh, [&](auto dh, auto split, int nc) {
    constexpr int DH = decltype(dh)::value;
    constexpr bool kSplit = decltype(split)::value;
    auto kern = prefix_kernel<T, DH, true, kSplit>();
    if (drop.threshold == 0) kern = prefix_kernel<T, DH, false, kSplit>();
    const size_t smem = fwd_smem_bytes<T, DH, kSplit>();
    const dim3 grid = fwd_grid(B, Tq, H, nc);
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    if constexpr (kSplit)
      return launch_pass(kern, grid, smem, stream, tq, q_sb, q_st, tk, k_sb, k_st, tv, v_sb, v_st,
                         kv_bias, static_cast<T*>(out), lse, Tq, Tk, H, prefix_s, scale, drop,
                         vec, nc);
    else
      return launch_pass(kern, grid, smem, stream, tq, q_sb, q_st, tk, k_sb, k_st, tv, v_sb, v_st,
                         kv_bias, static_cast<T*>(out), lse, Tq, Tk, H, prefix_s, scale, drop,
                         vec);
  });
}

template <typename T>
cudaError_t launch_bias(int Dh, const void* q, long long q_sb, long long q_st, const void* k,
                        long long k_sb, long long k_st, const void* v, long long v_sb,
                        long long v_st, Bias bias, void* out, float* lse, int B, int Tq, int Tk,
                        int H, float scale, cudaStream_t stream) {
  const bool vec = qkv_aligned<T>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st);
  if (Dh == kWideDh)
    return launch_wide(flash_bias_fwd_wide_kernel<T>, wide_fwd_grid(B, Tq, H),
                       wide_fwd_smem_bytes<T>(), stream, static_cast<const T*>(q), q_sb, q_st,
                       static_cast<const T*>(k), k_sb, k_st, static_cast<const T*>(v), v_sb,
                       v_st, bias, static_cast<T*>(out), lse, Tq, Tk, H, scale, vec);
  if (cluster_route(Dh)) {
    const int nc = Dh / kSplitDh;
    return launch_cluster(flash_bias_fwd_cluster_kernel<T>, cluster_fwd_grid(B, Tq, H, nc), nc,
                          fwd_cluster_smem_bytes<T>(), stream, static_cast<const T*>(q), q_sb,
                          q_st, static_cast<const T*>(k), k_sb, k_st, static_cast<const T*>(v),
                          v_sb, v_st, bias, static_cast<T*>(out), lse, Tq, Tk, H, scale, vec, nc);
  }
  return dispatch_dh(Dh, [&](auto dh, auto split, int nc) {
    constexpr int DH = decltype(dh)::value;
    constexpr bool kSplit = decltype(split)::value;
    auto kern = bias_kernel<T, DH, kSplit>();
    const size_t smem = fwd_smem_bytes<T, DH, kSplit>();
    const dim3 grid = fwd_grid(B, Tq, H, nc);
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    if constexpr (kSplit)
      return launch_pass(kern, grid, smem, stream, tq, q_sb, q_st, tk, k_sb, k_st, tv, v_sb, v_st,
                         bias, static_cast<T*>(out), lse, Tq, Tk, H, scale, vec, nc);
    else
      return launch_pass(kern, grid, smem, stream, tq, q_sb, q_st, tk, k_sb, k_st, tv, v_sb, v_st,
                         bias, static_cast<T*>(out), lse, Tq, Tk, H, scale, vec);
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

// The resources of one wide kernel (Dh 256): dtype as above, bias: kernel 4's
// forward (else kernel 2), drop: kernel 2 with dropout.  info: registers,
// local (spilled) bytes, dynamic shared memory bytes, threads a block,
// resident blocks per SM.  Returns a cudaError_t.
extern "C" int prefix_attention_wide_info(int dtype, int bias, int drop, int* info) {
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    constexpr size_t smem = wide_fwd_smem_bytes<T>();
    if (bias) return wide_kernel_info(flash_bias_fwd_wide_kernel<T>, smem, info);
    if (drop) return wide_kernel_info(prefix_attention_wide_kernel<T, true>, smem, info);
    return wide_kernel_info(prefix_attention_wide_kernel<T, false>, smem, info);
  };
  if (dtype == 0) return pick(float{});
  if (dtype == 1) return pick(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// The resources of one cluster kernel as head dim Dh (257-1024, a multiple of
// 128) launches it: dtype, bias and drop as in prefix_attention_wide_info.
// info: registers, local (spilled) bytes, dynamic shared memory bytes,
// threads a block, resident blocks per SM, the clusters that can be resident
// at once, the blocks of a cluster, and the keys of a streamed tile (one
// exchange).  Returns a cudaError_t.
extern "C" int prefix_attention_cluster_info(int dtype, int bias, int drop, int Dh, int* info) {
  if (!cluster_route(Dh)) return (int)cudaErrorInvalidValue;
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    const int nc = Dh / kSplitDh;
    constexpr size_t smem = fwd_cluster_smem_bytes<T>();
    info[6] = nc;
    info[7] = fwd_cluster_kn<T>();
    if (bias) return cluster_kernel_info(flash_bias_fwd_cluster_kernel<T>, nc, smem, info);
    if (drop) return cluster_kernel_info(prefix_attention_cluster_kernel<T, true>, nc, smem, info);
    return cluster_kernel_info(prefix_attention_cluster_kernel<T, false>, nc, smem, info);
  };
  if (dtype == 0) return pick(float{});
  if (dtype == 1) return pick(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
