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
//   6. Head dim 256 (the wide passes, *_wide_kernel; the wrapper zero-pads Dh
//      129-255 to 256; the block shape, launch bounds and the Dh-half
//      exchange are in wide_tile.cuh, shared with the forward's wide
//      kernels, prefix_attention.cu point 8).  The bound is the one above, 10 B H Dh operations
//      per visible pair (dense B 4, T 880, H 4: 31.7 G a call, the Dh-64
//      kernel's at 16 heads), and as at Dh <= 128 each pass computes S and
//      dP once per (q tile, key tile) pair: no grid dimension over chunks of
//      the output.  A 16-row warp's dK and dV at Dh 256 would take 256
//      registers a thread, so a block is kWideWarps = 8 warps and every
//      streamed tile takes two phases:
//        phase A: warp w computes a 16 x 16 tile of S and dP (S^T and dP^T
//          in the dK/dV pass) over Dh half w >> 2 (mma_xyt over 128 of the
//          256 columns); warps w and w ^ 4 swap one n8 tile of partials
//          through shared memory and each adds low half + high half for its
//          own n8 tile (the reduction over Dh in two chunks, nothing
//          computed twice), runs the element pass of point 3 on it in
//          registers, and writes dS (Pd^T and dS^T), rounded like T, to a
//          small tile;
//        phase C, after one barrier: warp w owns output columns 32 w .. 32 w
//          + 31 of the whole head and adds dS K (Pd^T dO and dS^T q) over
//          all of the block's rows (keys), both operands read from shared
//          memory (mma_xz).
//      dQ pass: a block of 64 q rows holds q and dO whole and streams key
//      tiles of 16 through two stages; a warp's dQ is 64 x 32 (64
//      registers).  dK/dV pass: a block of 32 keys holds K and V whole and
//      streams q tiles of 32 rows (with their LSE and delta) through two
//      stages; a warp's dK and dV are 32 x 32 each (64 registers).  Shared
//      memory: 209.0 / 213.5 KB (dQ / dK-dV) in f32, one block (8 warps) per
//      SM; 110.0 / 112.5 KB in bf16, launch bounds of two blocks (16 warps)
//      per SM (at most 128 registers).  Three barriers per streamed tile.
//      Grids (Tq / 64, H, B) and (Tk / 32, H, B): at B 4, T 880, H 4 they
//      are 224 and 448 blocks, 1.7 and 3.4 waves of 132 SMs in f32 and 0.85
//      and 1.7 in bf16; the last partial wave is the tail, which nothing
//      balances.  Bit-equal reruns: every sum has a fixed order (the two
//      halves low + high; k steps in order, in f32 each into a zeroed
//      fragment), no atomics, one writer per element of dq, dk, dv and
//      d(bias).
//   7. Head dims above 256 (no shipped configuration) run the cluster passes
//      (*_cluster_kernel; tile bodies attn_bwd_*_tile with kCluster) up to
//      Dh 1024.  Whole-row f32 tiles take 396 KB of shared memory at Dh
//      512, more than a block may use, and dQ, dK and dV are separable over
//      Dh where S and dP are not.  So a thread-block cluster covers each
//      tile of the output, one block per slice of the head (the wrapper
//      zero-pads Dh to a multiple of 128): block j, the cluster's rank j,
//      is the whole-row pass on slice j.  Slices are 128 columns, so the dQ
//      pass's clusters are Dh / 128 blocks (at most 8, the portable size);
//      the f32 dK/dV pass takes slices of 64 (cluster_slice_dh(): Dh 128's
//      128 accumulator registers beside the exchange spilled), so its
//      clusters are Dh / 64 blocks, 16 at Dh 1024, above the portable size
//      (cudaFuncAttributeNonPortableClusterSizeAllowed; the H100 schedules
//      them).  The dQ pass stages its slice of q and dO and streams its
//      slice of K and V; the dK/dV pass stages its slice of K and V and
//      streams its slice of q and dO.  For each streamed tile the block
//      computes its partials of S and dP (S^T and dP^T) over its slice,
//      each k step into a zeroed fragment added in f32; the partials are
//      summed across the cluster through distributed shared memory in the
//      fixed order slice 0 + slice 1 + ... (cluster_tile.cuh: a
//      reduce-scatter, then an all-gather), so every block holds the same S
//      and dP, bit for bit; each block then runs the element pass of point
//      3 on them in registers and adds its slice of dQ (dK and dV).  S and
//      dP are computed once per tile pair: a pass's products are the
//      bound's 10 B H Dh operations per visible pair at any nc.  Every block
//      of a cluster walks the same tiles (the dQ frontier max(prefix_s,
//      tile end) and the q tiles that can see a key tile depend on the
//      tile, not on the slice), so all take the same exchanges and none
//      leaves a barrier early.  Rank 0 alone writes kernel 4's d(bias).
//      One exchange per streamed tile of 16 keys (dQ) or 16 q rows (dK/dV).
//      Shared memory: the whole-row pass's at its slice and one exchange
//      buffer of 8 KB: 107.3 / 59.3 KB (dQ / dK-dV) in f32, 59.3 KB in
//      bf16; launch bounds of two blocks per SM (at most 255 registers).
//      Grids (Tq / 64 x nc, H, B) and (Tk / 64 x nc_dkv, H, B), clusters
//      along x.  A launch the card refuses returns its error: nothing falls
//      back.
//      Past Dh 1024 the split passes (*_split_kernel, kSplit) stay: a grid
//      dimension takes the nc chunks and each block recomputes S and dP
//      over the whole head, step i of the ring staging chunk i of the
//      block's own tiles and the streamed ones, so S and dP's products run
//      nc times ((2 nc + 1) / 3 of the dQ pass's operations, (2 nc + 2) / 4
//      of the dK/dV pass's); the f32 dK/dV pass takes chunks of 64
//      (dkv_split_dh()) and q tiles of dkv_rows() rows; chunk 0 writes
//      d(bias).  Shared memory: 185.9 / 104.7 KB in f32, 95.7 / 104.7 KB
//      in bf16, at any Dh.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include <type_traits>

#include "attention_common.cuh"
#include "cluster_tile.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "wide_tile.cuh"

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

// q rows of a streamed tile whose S^T / dP^T a warp of the dK/dV pass holds
// at once (f32 at Dh = 128: 8, or it spills).
template <typename T, int DH>
__host__ __device__ constexpr int dkv_rows() {
  return DH <= 64 ? BN : (kF32<T> ? 8 : 16);
}

// The head-dim chunk of the split dK/dV pass: kSplitDh, or 64 in f32, where
// Dh 128's dK and dV accumulators (128 registers a thread) beside the split's
// staging spilled 36-60 bytes under ptxas's 255-register cap (measured with
// the staging inlined at two call sites; untried since).
template <typename T>
__host__ __device__ constexpr int dkv_split_dh() {
  return kF32<T> ? 64 : kSplitDh;
}

// Shared memory of either pass: four tiles (two stages of the streamed pair)
// plus the two that stay, and the dK/dV pass's two stages of LSE and delta.
// A split instantiation (DH = kSplitDh) has two stages of the two tiles that
// stay, and two stages of the block's own chunk of the streamed operands of
// its second products (K for dQ; q and dO for dK / dV), whose tiles are
// dkv_rows() rows in the dK/dV pass.
template <typename T, int DH, bool kSplit = false, bool kDq = true>
constexpr size_t bwd_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T, DH>() * sizeof(T);
  if constexpr (!kSplit) return (2 * BM + 4 * BN) * row + 4 * BN * sizeof(float);
  if constexpr (kDq) return (4 * BM + 6 * BN) * row;
  return (4 * BM + 8 * dkv_rows<T, DH>()) * row + 4 * dkv_rows<T, DH>() * sizeof(float);
}

// The slice of the head that one block of a cluster pass owns: kSplitDh,
// or in the f32 dK/dV pass dkv_split_dh() = 64 (Dh 128's dK and dV
// accumulators hold 128 registers a thread, and beside the exchange the
// pass spilled under ptxas's 255-register cap).
template <typename T, bool kDq>
__host__ __device__ constexpr int cluster_slice_dh() {
  return kDq ? kSplitDh : dkv_split_dh<T>();
}

// The cluster passes take the head dims of cluster_route() (cluster_tile.cuh);
// at kClusterMaxDh the f32 dK/dV pass has kClusterMax slices of 64.
static_assert(kClusterMaxDh / 64 == kClusterMax, "the f32 dK/dV clusters reach Dh 1024");

// Shared memory of a cluster pass: the whole-row pass's at its slice, and
// the exchange of a warp's S and dP fragments (dQ: two n8 tiles of each;
// dK/dV: dkv_rows() = 16 q rows; 16 floats a lane either way).
template <typename T, bool kDq>
constexpr size_t cluster_smem_bytes() {
  constexpr int DH = cluster_slice_dh<T, kDq>();
  constexpr int n = 8 * ((kDq ? BN : dkv_rows<T, DH>()) / 8);
  return bwd_smem_bytes<T, DH, false, kDq>() + cluster_xchg_floats<n>() * sizeof(float);
}

// The dQ pass of one (64-row q tile, head, batch).  kBias: kernel 4 (dense
// bias, no structural mask, writes d(bias) when dbias is not null);
// otherwise kernel 3.  kSplit: the head dim is nc chunks of DH (=
// kSplitDh), blockIdx.y is h * nc + j and the block writes dQ's chunk j
// (chunk 0 also d(bias)); each key tile takes nc steps of the ring, step i
// staging chunk i of q, dO, K and V and adding its part of S and dP, the
// first step also the tile's K chunk j for dQ += dS K.  kCluster: the head
// dim is nc slices of DH (= kSplitDh), one block of a cluster of nc each
// (its rank j, the cluster's x index the q tile); the block stages and
// streams its slice alone, and its partials of S and dP are summed across
// the cluster (cluster_tile.cuh) before the element pass; it writes dQ's
// slice j (rank 0 also d(bias)).
template <typename T, int DH, bool kDrop, bool kBias, bool kSplit = false, bool kCluster = false>
__device__ __forceinline__ void attn_bwd_dq_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ dbias, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec, int nc = 1) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int LDT = row_stride<T, DH>(), TILE = BN * LDT;
  constexpr int NT = BN / 8, DT = DH / 8;  // n8 tiles of a key tile, of Dh
  constexpr int S = kSplit ? 2 : 1;        // stages of the q and dO tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [S][BM][LDT]
  T* sDO = sQ + S * BM * LDT;              // [S][BM][LDT]
  T* sK = sDO + S * BM * LDT;              // [2][BN][LDT]
  T* sV = sK + 2 * TILE;                   // [2][BN][LDT]
  T* sKj = sV + 2 * TILE;                  // kSplit: [2][BN][LDT], K's chunk j
  float* sX = reinterpret_cast<float*>(sV + 2 * TILE);  // kCluster: the exchange

  const int r0 = (kCluster ? cluster_index_x() : (int)blockIdx.x) * BM, b = blockIdx.z;
  int h = blockIdx.y, j = 0;  // head, and the block's chunk (slice) of dQ
  if constexpr (kSplit) {
    h = blockIdx.y / nc;
    j = blockIdx.y - h * nc;
  }
  if constexpr (kCluster) j = cluster_rank();
  const int D = (kSplit || kCluster) ? nc * DH : DH;  // a head's elements in a row
  const int col0 = kCluster ? j * DH : 0;  // the block's first column of the head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  int kend = Tk;
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + BM));
  const int n_tiles = (kend + BN - 1) / BN;

  const T* qb = q + (long long)b * q_sb + (long long)h * D + col0;
  const T* dob = dout + (long long)b * Tq * H * D + (long long)h * D + col0;
  const T* kb = k + (long long)b * k_sb + (long long)h * D + col0;
  const T* vb = v + (long long)b * v_sb + (long long)h * D + col0;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;
  // kSplit: step (it, i) stages chunk i of the q, dO, K and V tiles into
  // stage (it nc + i) & 1, and at i = 0 K's chunk j of key tile it
  auto stage_step = [&](int it, int i, int st) {
    stage_rows<T, DH, BM>(sQ + st * BM * LDT, qb + i * DH, q_st, r0, Tq, vec);
    stage_rows<T, DH, BM>(sDO + st * BM * LDT, dob + i * DH, (long long)H * D, r0, Tq, vec);
    stage_rows<T, DH, BN>(sK + st * TILE, kb + i * DH, k_st, it * BN, kend, vec);
    stage_rows<T, DH, BN>(sV + st * TILE, vb + i * DH, v_st, it * BN, kend, vec);
    if (i == 0) stage_rows<T, DH, BN>(sKj + (it & 1) * TILE, kb + j * DH, k_st, it * BN, kend, vec);
  };
  if constexpr (kSplit) {
    stage_step(0, 0, 0);
  } else {
    stage_rows<T, DH, BM>(sQ, qb, q_st, r0, Tq, vec);
    stage_rows<T, DH, BM>(sDO, dob, (long long)H * D, r0, Tq, vec);
    stage_rows<T, DH, BN>(sK, kb, k_st, 0, kend, vec);
    stage_rows<T, DH, BN>(sV, vb, v_st, 0, kend, vec);
  }
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
  ClusterExchange xchg{sX, nc};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    if constexpr (!kSplit) {
      if (it + 1 < n_tiles) {  // the next K / V tile loads while this one computes
        stage_rows<T, DH, BN>(sK + ((it + 1) & 1) * TILE, kb, k_st, k0 + BN, kend, vec);
        stage_rows<T, DH, BN>(sV + ((it + 1) & 1) * TILE, vb, v_st, k0 + BN, kend, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const T* cK = (kSplit ? sKj : sK) + (it & 1) * TILE;  // the K of dQ += dS K
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
      if constexpr (kSplit) {
        for (int i = 0; i < nc; ++i) {  // S = q k^T and dPd = dO v^T, chunk by chunk
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
          mma_xyt<T, DH, NT, true>(dp, sDO + st * BM * LDT + wr * LDT, sV + st * TILE, lane);
          if (i + 1 < nc) __syncthreads();  // the next step's loads overwrite this stage
        }
      } else {
        mma_xyt<T, DH, NT, kCluster>(s, sQ + wr * LDT, cK, lane);   // S = q k^T
        mma_xyt<T, DH, NT, kCluster>(dp, sDO + wr * LDT, cV, lane); // dPd = dO v^T
        if constexpr (kCluster) xchg.sum(s, dp, warp, lane);  // over the head's slices
      }

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
            if (dbias != nullptr && j == 0 && r < Tq && c < Tk)
              dbias[(bh4 * Tq + r) * Tk + c] = ds;
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
  if constexpr (kCluster) xchg.finish();

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= Tq) continue;
      T* o = dq + (((long long)b * Tq + r) * H + h) * D + j * DH + 8 * n + 2 * t;
      from_float(acc[n][2 * half] * post, &o[0]);
      from_float(acc[n][2 * half + 1] * post, &o[1]);
    }
  }
}

// The dK/dV pass of one (64-column key tile, head, batch); kBias as in
// attn_bwd_dq_tile.  A warp owns 16 key columns and computes S^T and dP^T
// for them against NR q rows at a time.  kSplit: as in attn_bwd_dq_tile,
// the block writes chunk j of dK and dV; the streamed q tiles are NR rows,
// each taking nc steps of the ring (chunk i of K, V, q and dO; at i = 0
// also chunk j of the tile's q and dO, and its LSE and delta).  kCluster:
// as in attn_bwd_dq_tile, the block holds slice j of K and V, streams slice
// j of q and dO, and writes slice j of dK and dV; each NR rows' partials
// of S^T and dP^T are summed across the cluster.
template <typename T, int DH, bool kDrop, bool kBias, bool kSplit = false, bool kCluster = false>
__device__ __forceinline__ void attn_bwd_dkv_tile(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec, int nc = 1) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int NR = dkv_rows<T, DH>();
  constexpr int TR = kSplit ? NR : BN;  // rows of a streamed q tile
  constexpr int LDT = row_stride<T, DH>(), TILE = TR * LDT;
  constexpr int RT = NR / 8, DT = DH / 8;
  constexpr int S = kSplit ? 2 : 1;  // stages of the K and V tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [S][BM][LDT]
  T* sV = sK + S * BM * LDT;               // [S][BM][LDT]
  T* sQ = sV + S * BM * LDT;               // [2][TR][LDT]
  T* sDO = sQ + 2 * TILE;                  // [2][TR][LDT]
  T* sQj = sDO + 2 * TILE;                 // kSplit: [2][TR][LDT], q's chunk j
  T* sDOj = sQj + (kSplit ? 2 : 0) * TILE; // kSplit: [2][TR][LDT], dO's chunk j
  float* sL = reinterpret_cast<float*>(sDOj + (kSplit ? 2 : 0) * TILE);  // [2][TR] lse
  float* sDl = sL + 2 * TR;                                              // [2][TR] delta
  float* sX = sDl + 2 * TR;  // kCluster: the exchange

  const int c0 = (kCluster ? cluster_index_x() : (int)blockIdx.x) * BM, b = blockIdx.z;
  int h = blockIdx.y, j = 0;  // head, and the block's chunk (slice) of dK and dV
  if constexpr (kSplit) {
    h = blockIdx.y / nc;
    j = blockIdx.y - h * nc;
  }
  if constexpr (kCluster) j = cluster_rank();
  const int D = (kSplit || kCluster) ? nc * DH : DH;  // a head's elements in a row
  const int col0 = kCluster ? j * DH : 0;  // the block's first column of the head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  const T* qb = q + (long long)b * q_sb + (long long)h * D + col0;
  const T* dob = dout + (long long)b * Tq * H * D + (long long)h * D + col0;
  const T* kb = k + (long long)b * k_sb + (long long)h * D + col0;
  const T* vb = v + (long long)b * v_sb + (long long)h * D + col0;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;

  // In prefix mode rows < c0 see no column of this tile unless c0 < prefix_s.
  const int rstart = (!kBias && prefix_s >= 0 && c0 >= prefix_s) ? c0 : 0;
  const int n_tiles = (Tq - rstart + TR - 1) / TR;

  // LSE and delta of rows [r0, r0 + TR) into stage `st` (zero past Tq).
  auto stage_rowstats = [&](int st, int r0) {
    if (threadIdx.x >= 2 * TR) return;
    const int i = threadIdx.x % TR, r = r0 + i;
    const bool ok = r < Tq;
    const float* src = threadIdx.x < TR ? lse : delta;
    float* dst = (threadIdx.x < TR ? sL : sDl) + st * TR + i;
    if (vec)
      cp_async4(dst, ok ? src + bh4 * Tq + r : src, ok);
    else
      *dst = ok ? src[bh4 * Tq + r] : 0.f;
  };
  // kSplit: step (it, i) stages chunk i of the K, V, q and dO tiles into
  // stage (it nc + i) & 1, and at i = 0 q and dO's chunk j of q tile it and
  // its LSE and delta
  auto stage_step = [&](int it, int i, int st) {
    const int r0 = rstart + it * TR;
    stage_rows<T, DH, BM>(sK + st * BM * LDT, kb + i * DH, k_st, c0, Tk, vec);
    stage_rows<T, DH, BM>(sV + st * BM * LDT, vb + i * DH, v_st, c0, Tk, vec);
    stage_rows<T, DH, TR>(sQ + st * TILE, qb + i * DH, q_st, r0, Tq, vec);
    stage_rows<T, DH, TR>(sDO + st * TILE, dob + i * DH, (long long)H * D, r0, Tq, vec);
    if (i == 0) {
      stage_rows<T, DH, TR>(sQj + (it & 1) * TILE, qb + j * DH, q_st, r0, Tq, vec);
      stage_rows<T, DH, TR>(sDOj + (it & 1) * TILE, dob + j * DH, (long long)H * D, r0, Tq, vec);
      stage_rowstats(it & 1, r0);
    }
  };

  if constexpr (kSplit) {
    stage_step(0, 0, 0);
  } else {
    stage_rows<T, DH, BM>(sK, kb, k_st, c0, Tk, vec);
    stage_rows<T, DH, BM>(sV, vb, v_st, c0, Tk, vec);
    stage_rows<T, DH, BN>(sQ, qb, q_st, rstart, Tq, vec);
    stage_rows<T, DH, BN>(sDO, dob, (long long)H * D, rstart, Tq, vec);
    stage_rowstats(0, rstart);
  }
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
  ClusterExchange xchg{sX, nc};

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = rstart + it * TR, st = it & 1;
    if constexpr (!kSplit) {
      if (it + 1 < n_tiles) {  // the next q tile loads while this one computes
        stage_rows<T, DH, BN>(sQ + (st ^ 1) * TILE, qb, q_st, r0 + BN, Tq, vec);
        stage_rows<T, DH, BN>(sDO + (st ^ 1) * TILE, dob, (long long)H * D, r0 + BN, Tq, vec);
        stage_rowstats(st ^ 1, r0 + BN);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    // the q and dO of dV += Pd^T dO and dK += dS^T q
    const T* cQ = (kSplit ? sQj : sQ) + st * TILE;
    const T* cDO = (kSplit ? sDOj : sDO) + st * TILE;
    const float* cL = sL + st * TR;
    const float* cDl = sDl + st * TR;

#pragma unroll 1
    for (int rc = 0; rc < TR && r0 + rc < Tq; rc += NR) {
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
      if constexpr (kSplit) {
        for (int i = 0; i < nc; ++i) {  // S^T = k q^T and dPd^T = v dO^T, chunk by chunk
          const int ss = (it * nc + i) & 1;
          const int i2 = i + 1 < nc ? i + 1 : 0, it2 = i + 1 < nc ? it : it + 1;
          if (it2 < n_tiles) {  // the next step loads while this one computes
            stage_step(it2, i2, ss ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          mma_xyt<T, DH, RT, true>(s, sK + ss * BM * LDT + wc * LDT, sQ + ss * TILE, lane);
          mma_xyt<T, DH, RT, true>(dp, sV + ss * BM * LDT + wc * LDT, sDO + ss * TILE, lane);
          if (i + 1 < nc) __syncthreads();  // the next step's loads overwrite this stage
        }
      } else {
        mma_xyt<T, DH, RT, kCluster>(s, sK + wc * LDT, cQ + rc * LDT, lane);   // S^T = k q^T
        mma_xyt<T, DH, RT, kCluster>(dp, sV + wc * LDT, cDO + rc * LDT, lane); // dPd^T = v dO^T
        if constexpr (kCluster) xchg.sum(s, dp, warp, lane);  // over the head's slices
      }

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
  if constexpr (kCluster) xchg.finish();

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half ? cb : ca;
      if (c >= Tk) continue;
      const long long off = (((long long)b * Tk + c) * H + h) * D + j * DH + 8 * n + 2 * t;
      from_float(acc_k[n][2 * half] * post, &dk[off]);
      from_float(acc_k[n][2 * half + 1] * post, &dk[off + 1]);
      from_float(acc_v[n][2 * half], &dv[off]);
      from_float(acc_v[n][2 * half + 1], &dv[off + 1]);
    }
  }
}

// ------------------------------------------------------------ Dh 256

// The wide passes (header point 6): Dh = kWideDh whole, kWideWarps warps a
// block, S and dP computed once per (q tile, key tile) pair (the block shape,
// launch bounds and exchange are in wide_tile.cuh).
constexpr int WC = 32;  // dK/dV pass: keys of a block (2 m16 tiles)
constexpr int WR = 32;  // dK/dV pass: q rows of a streamed tile

// Shared memory of a wide pass: the exchange buffer, then the dQ pass's q
// and dO (whole), two stages of K and V, and dS; or the dK/dV pass's K and V
// (whole), two stages of q and dO, Pd^T and dS^T, and two stages of LSE and
// delta.
template <typename T, bool kDq>
constexpr size_t wide_smem_bytes() {
  constexpr size_t row = (size_t)row_stride<T, kWideDh>() * sizeof(T);
  constexpr size_t xchg = (size_t)kWideWarps * kXchg * sizeof(float);
  if constexpr (kDq) return xchg + (2 * WQ + 4 * WK) * row + WQ * pd_stride<WK>() * sizeof(T);
  return xchg + 4 * WR * sizeof(float) + (2 * WC + 4 * WR) * row +
         2 * WC * pd_stride<WR>() * sizeof(T);
}

// The dQ pass of one (64-row q tile, head, batch) at Dh 256, arguments as
// attn_bwd_dq_tile.  q and dO stay whole; key tiles of 16 stream through two
// stages.  Per tile: warp w computes S and dP for rows 16 (w & 3) .. +15
// over Dh half w >> 2 (phase A), the element pass of its n8 tile writes dS
// (and kernel 4's d(bias)), and after a barrier warp w adds dS K to dQ's
// columns 32 w .. 32 w + 31 for all 64 rows (phase C).
template <typename T, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dq_wide(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    float* __restrict__ dbias, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DH = kWideDh, LDW = row_stride<T, DH>(), LDS = pd_stride<WK>();
  constexpr int TILE = WK * LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);                // [warps][kXchg]
  T* sQ = reinterpret_cast<T*>(sX + kWideWarps * kXchg);         // [WQ][LDW]
  T* sDO = sQ + WQ * LDW;                                         // [WQ][LDW]
  T* sK = sDO + WQ * LDW;                                         // [2][WK][LDW]
  T* sV = sK + 2 * TILE;                                          // [2][WK][LDW]
  T* sDS = sV + 2 * TILE;                                         // [WQ][LDS]

  const int r0 = blockIdx.x * WQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int half = warp >> 2, wr = 16 * (warp & 3);  // phase A: Dh half, first row
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  int kend = Tk;
  if (!kBias && prefix_s >= 0) kend = min(Tk, max(prefix_s, r0 + WQ));
  const int n_tiles = (kend + WK - 1) / WK;

  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* dob = dout + (long long)b * Tq * H * DH + (long long)h * DH;
  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;

  stage_rows<T, DH, WQ, kWideThreads>(sQ, qb, q_st, r0, Tq, vec);
  stage_rows<T, DH, WQ, kWideThreads>(sDO, dob, (long long)H * DH, r0, Tq, vec);
  stage_rows<T, DH, WK, kWideThreads>(sK, kb, k_st, 0, kend, vec);
  stage_rows<T, DH, WK, kWideThreads>(sV, vb, v_st, 0, kend, vec);
  cp_async_commit();

  const int ra = r0 + wr + g, rb = ra + 8;
  const float lse_a = ra < Tq ? lse[bh4 * Tq + ra] : 0.f;
  const float lse_b = rb < Tq ? lse[bh4 * Tq + rb] : 0.f;
  const float dl_a = ra < Tq ? delta[bh4 * Tq + ra] : 0.f;
  const float dl_b = rb < Tq ? delta[bh4 * Tq + rb] : 0.f;

  float acc[WQ / 16][4][4];  // dQ: the block's rows x the warp's 32 columns
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
    if (it + 1 < n_tiles) {  // the next K / V tile loads while this one computes
      stage_rows<T, DH, WK, kWideThreads>(sK + (st ^ 1) * TILE, kb, k_st, k0 + WK, kend, vec);
      stage_rows<T, DH, WK, kWideThreads>(sV + (st ^ 1) * TILE, vb, v_st, k0 + WK, kend, vec);
      cp_async_commit();
    }
    const T* cK = sK + st * TILE;
    const T* cV = sV + st * TILE;
    const int cn = k0 + 8 * half;  // the first column of the warp's element-pass tile
    unsigned keep_a = 0xFu, keep_b = 0xFu;
    if constexpr (kDrop) {
      // lane L draws (row wr + L % 16, group L / 16) of this 16 x 8 tile
      const unsigned w = philox_keep4((unsigned)(cn >> 2) + (lane >> 4),
                                      (unsigned)(r0 + wr + (lane & 15)), bh, drop.seed,
                                      drop.threshold);
      keep_a = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g) >> (2 * (t & 1));
      keep_b = __shfl_sync(0xffffffffu, w, (t >> 1) * 16 + g + 8) >> (2 * (t & 1));
    }
    float add[4];  // kernel 4's biases, read before the products
    if constexpr (kBias) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        add[e] = bias_at(bb, bias, e < 2 ? ra : rb, cn + 2 * t + (e & 1), Tq, Tk);
    }

    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    const int dh0 = half * kWideHalf;
    mma_xyt<T, kWideHalf, 2, true, LDW>(s, sQ + wr * LDW + dh0, cK + dh0, lane);    // S = q k^T
    mma_xyt<T, kWideHalf, 2, true, LDW>(dp, sDO + wr * LDW + dh0, cV + dh0, lane);  // dPd
    wide_exchange_give(sX, s, dp, half, warp, lane);
    __syncthreads();
    float s1[4], dp1[4];
    wide_exchange_take(sX, s, dp, half, warp, lane, s1, dp1);

    // element pass: s1 becomes dS, rounded like T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb, c = cn + 2 * t + (e & 1);
      const float lr = e < 2 ? lse_a : lse_b, dl = e < 2 ? dl_a : dl_b;
      float ds;
      if constexpr (kBias) {
        const float x = (s1[e] + add[e]) * scale;
        const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
        ds = (dp1[e] - dl) * p * scale;
        if (dbias != nullptr && r < Tq && c < Tk) dbias[(bh4 * Tq + r) * Tk + c] = ds;
      } else {
        const float kvb = (kv_bias != nullptr && c < Tk) ? kv_bias[(long long)b * Tk + c] : 0.f;
        const float x =
            (c < kend && visible(r, c, Tq, Tk, prefix_s)) ? s1[e] * scale + kvb : -INFINITY;
        const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
        float dpd = dp1[e];
        if constexpr (kDrop) {
          const bool keep = (((e < 2 ? keep_a : keep_b) >> (e & 1)) & 1u) != 0;
          dpd = keep ? dpd * drop.inv_keep : 0.f;
        }
        ds = p * (dpd - dl);
      }
      s1[e] = round_like<T>(ds);
    }
    store_pair<T>(sDS + (wr + g) * LDS + 8 * half + 2 * t, s1[0], s1[1]);
    store_pair<T>(sDS + (wr + g + 8) * LDS + 8 * half + 2 * t, s1[2], s1[3]);
    __syncthreads();
    mma_xz<T, WQ / 16, 4, WK, LDS, LDW>(acc, sDS, cK + 32 * warp, lane);  // dQ += dS k
  }

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int m = 0; m < WQ / 16; ++m)
#pragma unroll
    for (int half2 = 0; half2 < 2; ++half2) {
      const int r = r0 + 16 * m + g + 8 * half2;
      if (r >= Tq) continue;
      T* o = dq + (((long long)b * Tq + r) * H + h) * DH + 32 * warp + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        from_float(acc[m][n][2 * half2] * post, &o[8 * n]);
        from_float(acc[m][n][2 * half2 + 1] * post, &o[8 * n + 1]);
      }
    }
}

// The dK/dV pass of one (32-column key tile, head, batch) at Dh 256,
// arguments as attn_bwd_dkv_tile.  K and V stay whole; q tiles of 32 rows
// (with dO, LSE and delta) stream through two stages.  Per tile: warp w
// computes S^T and dP^T for keys 16 (w & 1) .. +15 and q rows 16 ((w >> 1)
// & 1) .. +15 over Dh half w >> 2 (phase A), the element pass of its n8 tile
// writes Pd^T and dS^T, and after a barrier warp w adds Pd^T dO and dS^T q
// to dV's and dK's columns 32 w .. 32 w + 31 for all 32 keys (phase C).
template <typename T, bool kDrop, bool kBias>
__device__ __forceinline__ void attn_bwd_dkv_wide(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, Bias bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  static_assert(!(kDrop && kBias), "the dense-bias route has no dropout");
  constexpr int DH = kWideDh, LDW = row_stride<T, DH>(), LDP = pd_stride<WR>();
  constexpr int TILE = WR * LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sX = reinterpret_cast<float*>(smem_raw);  // [warps][kXchg]
  float* sL = sX + kWideWarps * kXchg;              // [2][WR] lse
  float* sDl = sL + 2 * WR;                         // [2][WR] delta
  T* sK = reinterpret_cast<T*>(sDl + 2 * WR);       // [WC][LDW]
  T* sV = sK + WC * LDW;                            // [WC][LDW]
  T* sQ = sV + WC * LDW;                            // [2][WR][LDW]
  T* sDO = sQ + 2 * TILE;                           // [2][WR][LDW]
  T* sP = sDO + 2 * TILE;                           // [WC][LDP] Pd^T
  T* sDS = sP + WC * LDP;                           // [WC][LDP] dS^T

  const int c0 = blockIdx.x * WC, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int half = warp >> 2, wc = 16 * (warp & 1), wq = 16 * ((warp >> 1) & 1);
  const unsigned bh = (unsigned)(b * H + h);
  const long long bh4 = (long long)b * H + h;
  const T* qb = q + (long long)b * q_sb + (long long)h * DH;
  const T* dob = dout + (long long)b * Tq * H * DH + (long long)h * DH;
  const T* kb = k + (long long)b * k_sb + (long long)h * DH;
  const T* vb = v + (long long)b * v_sb + (long long)h * DH;
  const float* bb = nullptr;
  if constexpr (kBias) bb = bias.p + (long long)b * bias.sb + (long long)h * bias.sh;

  // In prefix mode rows < c0 see no column of this tile unless c0 < prefix_s.
  const int rstart = (!kBias && prefix_s >= 0 && c0 >= prefix_s) ? c0 : 0;
  const int n_tiles = (Tq - rstart + WR - 1) / WR;

  // the q tile at r0 (q, dO, and its LSE and delta, zero past Tq) into stage st
  auto stage_q_tile = [&](int st, int r0) {
    stage_rows<T, DH, WR, kWideThreads>(sQ + st * TILE, qb, q_st, r0, Tq, vec);
    stage_rows<T, DH, WR, kWideThreads>(sDO + st * TILE, dob, (long long)H * DH, r0, Tq, vec);
    if (threadIdx.x < 2 * WR) {
      const int i = threadIdx.x % WR, r = r0 + i;
      const bool ok = r < Tq;
      const float* src = threadIdx.x < WR ? lse : delta;
      float* dst = (threadIdx.x < WR ? sL : sDl) + st * WR + i;
      if (vec)
        cp_async4(dst, ok ? src + bh4 * Tq + r : src, ok);
      else
        *dst = ok ? src[bh4 * Tq + r] : 0.f;
    }
  };
  stage_rows<T, DH, WC, kWideThreads>(sK, kb, k_st, c0, Tk, vec);
  stage_rows<T, DH, WC, kWideThreads>(sV, vb, v_st, c0, Tk, vec);
  stage_q_tile(0, rstart);
  cp_async_commit();

  const int ca = c0 + wc + g, cb = ca + 8;
  float kvb_a = 0.f, kvb_b = 0.f;
  if constexpr (!kBias) {
    if (kv_bias != nullptr) {
      if (ca < Tk) kvb_a = kv_bias[(long long)b * Tk + ca];
      if (cb < Tk) kvb_b = kv_bias[(long long)b * Tk + cb];
    }
  }

  float acc_k[WC / 16][4][4], acc_v[WC / 16][4][4];  // the block's keys x the warp's columns
#pragma unroll
  for (int m = 0; m < WC / 16; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][n][e] = acc_v[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = rstart + it * WR, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is past tile it - 1's phase C
    if (it + 1 < n_tiles) {  // the next q tile loads while this one computes
      stage_q_tile(st ^ 1, r0 + WR);
      cp_async_commit();
    }
    const T* cQ = sQ + st * TILE;
    const T* cDO = sDO + st * TILE;
    const float* cL = sL + st * WR;
    const float* cDl = sDl + st * WR;
    const int rl = wq + 8 * half;  // the first q row of the warp's element-pass tile
    unsigned keep = 0xFu;  // bits: (ca, 2t), (ca, 2t + 1), (cb, 2t), (cb, 2t + 1)
    if constexpr (kDrop) {
      // lane L draws (row L % 8, group L / 8) of this 8 x 16 tile
      const unsigned w = philox_keep4((unsigned)((c0 + wc) >> 2) + (lane >> 3),
                                      (unsigned)(r0 + rl + (lane & 7)), bh, drop.seed,
                                      drop.threshold);
      const int src = (g >> 2) * 8 + 2 * t, bit = g & 3;
      keep = ((__shfl_sync(0xffffffffu, w, src) >> bit) & 1u) |
             (((__shfl_sync(0xffffffffu, w, src + 1) >> bit) & 1u) << 1) |
             (((__shfl_sync(0xffffffffu, w, src + 16) >> bit) & 1u) << 2) |
             (((__shfl_sync(0xffffffffu, w, src + 17) >> bit) & 1u) << 3);
    }
    float add[4];  // each score's additive term (bias; -inf where masked)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + rl + 2 * t + (e & 1), c = e < 2 ? ca : cb;
      if constexpr (kBias)
        add[e] = bias_at(bb, bias, r, c, Tq, Tk);
      else
        add[e] = visible(r, c, Tq, Tk, prefix_s) ? (e < 2 ? kvb_a : kvb_b) : -INFINITY;
    }

    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    const int dh0 = half * kWideHalf;
    mma_xyt<T, kWideHalf, 2, true, LDW>(s, sK + wc * LDW + dh0, cQ + wq * LDW + dh0,
                                        lane);  // S^T = k q^T
    mma_xyt<T, kWideHalf, 2, true, LDW>(dp, sV + wc * LDW + dh0, cDO + wq * LDW + dh0,
                                        lane);  // dPd^T = v dO^T
    wide_exchange_give(sX, s, dp, half, warp, lane);
    __syncthreads();
    float s1[4], dp1[4];
    wide_exchange_take(sX, s, dp, half, warp, lane, s1, dp1);

    // element pass: s1 becomes Pd^T and dp1 dS^T, rounded like T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rl + 2 * t + (e & 1);
      const float lr = cL[i], dl = cDl[i];
      if constexpr (kBias) {
        const float x = (s1[e] + add[e]) * scale;
        const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
        dp1[e] = round_like<T>((dp1[e] - dl) * p * scale);
        s1[e] = round_like<T>(p);
      } else {
        const float x = s1[e] * scale + add[e];
        const float p = (x == -INFINITY) ? 0.f : __expf(x - lr);
        float pd = p, dpd = dp1[e];
        if constexpr (kDrop) {
          const bool kept = ((keep >> e) & 1u) != 0;
          pd = kept ? p * drop.inv_keep : 0.f;
          dpd = kept ? dpd * drop.inv_keep : 0.f;
        }
        dp1[e] = round_like<T>(p * (dpd - dl));
        s1[e] = round_like<T>(pd);
      }
    }
    store_pair<T>(sP + (wc + g) * LDP + rl + 2 * t, s1[0], s1[1]);
    store_pair<T>(sP + (wc + g + 8) * LDP + rl + 2 * t, s1[2], s1[3]);
    store_pair<T>(sDS + (wc + g) * LDP + rl + 2 * t, dp1[0], dp1[1]);
    store_pair<T>(sDS + (wc + g + 8) * LDP + rl + 2 * t, dp1[2], dp1[3]);
    __syncthreads();
    mma_xz<T, WC / 16, 4, WR, LDP, LDW>(acc_v, sP, cDO + 32 * warp, lane);   // dV += Pd^T dO
    mma_xz<T, WC / 16, 4, WR, LDP, LDW>(acc_k, sDS, cQ + 32 * warp, lane);   // dK += dS^T q
  }

  const float post = kBias ? 1.f : scale;  // kernel 4's dS already carries the scale
#pragma unroll
  for (int m = 0; m < WC / 16; ++m)
#pragma unroll
    for (int half2 = 0; half2 < 2; ++half2) {
      const int c = c0 + 16 * m + g + 8 * half2;
      if (c >= Tk) continue;
      const long long off = (((long long)b * Tk + c) * H + h) * DH + 32 * warp + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        from_float(acc_k[m][n][2 * half2] * post, &dk[off + 8 * n]);
        from_float(acc_k[m][n][2 * half2 + 1] * post, &dk[off + 8 * n + 1]);
        from_float(acc_v[m][n][2 * half2], &dv[off + 8 * n]);
        from_float(acc_v[m][n][2 * half2 + 1], &dv[off + 8 * n + 1]);
      }
    }
}

// The wide pass kernels (kernel 3's attn_bwd_*_wide_kernel, kernel 4's
// flash_bias_bwd_*_wide_kernel), kWideThreads threads a block.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) attn_bwd_dq_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec) {
  attn_bwd_dq_wide<T, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                    Bias{}, dout, lse, delta, dq, nullptr, Tq, Tk, H, prefix_s,
                                    scale, drop, vec);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) attn_bwd_dkv_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec) {
  attn_bwd_dkv_wide<T, kDrop, false>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias,
                                     Bias{}, dout, lse, delta, dk, dv, Tq, Tk, H, prefix_s,
                                     scale, drop, vec);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) flash_bias_bwd_dq_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias,
    int Tq, int Tk, int H, float scale, bool vec) {
  attn_bwd_dq_wide<T, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias,
                                   dout, lse, delta, dq, dbias, Tq, Tk, H, -1, scale, Dropout{},
                                   vec);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T>) flash_bias_bwd_dkv_wide_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
    int H, float scale, bool vec) {
  attn_bwd_dkv_wide<T, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias,
                                    dout, lse, delta, dk, dv, Tq, Tk, H, -1, scale, Dropout{},
                                    vec);
}

// The cluster pass kernels (header point 7; kernel 3's
// attn_bwd_*_cluster_kernel, kernel 4's flash_bias_bwd_*_cluster_kernel):
// kMmaThreads threads a block, launched in clusters of nc blocks along x,
// and launch bounds of kClusterMinBlocks = 2 blocks per SM (at most 255
// registers; two f32 blocks' shared memory fill the SM).

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) attn_bwd_dq_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec, int nc) {
  attn_bwd_dq_tile<T, kSplitDh, kDrop, false, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias, Bias{}, dout, lse, delta, dq, nullptr,
      Tq, Tk, H, prefix_s, scale, drop, vec, nc);
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) attn_bwd_dkv_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    const float* __restrict__ kv_bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,
    bool vec, int nc) {
  attn_bwd_dkv_tile<T, cluster_slice_dh<T, false>(), kDrop, false, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, kv_bias, Bias{}, dout, lse, delta, dk, dv, Tq,
      Tk, H, prefix_s, scale, drop, vec, nc);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) flash_bias_bwd_dq_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias,
    int Tq, int Tk, int H, float scale, bool vec, int nc) {
  attn_bwd_dq_tile<T, kSplitDh, false, true, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias, dout, lse, delta, dq, dbias, Tq,
      Tk, H, -1, scale, Dropout{}, vec, nc);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kClusterMinBlocks) flash_bias_bwd_dkv_cluster_kernel(
    const T* __restrict__ q, long long q_sb, long long q_st,
    const T* __restrict__ k, long long k_sb, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_st,
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
    int H, float scale, bool vec, int nc) {
  attn_bwd_dkv_tile<T, cluster_slice_dh<T, false>(), false, true, false, true>(
      q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, nullptr, bias, dout, lse, delta, dk, dv, Tq,
      Tk, H, -1, scale, Dropout{}, vec, nc);
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
                                                                                                  \
template <typename T, bool kDrop>                                                                 \
__global__ void BOUNDS attn_bwd_dq_split_kernel(                                                  \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, const T* __restrict__ dout,                                \
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,           \
    int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop, bool vec, int nc) {           \
  attn_bwd_dq_tile<T, kSplitDh, kDrop, false, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,  \
                                                    kv_bias, Bias{}, dout, lse, delta, dq,        \
                                                    nullptr, Tq, Tk, H, prefix_s, scale, drop,    \
                                                    vec, nc);                                     \
}                                                                                                 \
                                                                                                  \
template <typename T, bool kDrop>                                                                 \
__global__ void BOUNDS attn_bwd_dkv_split_kernel(                                                 \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    const float* __restrict__ kv_bias, const T* __restrict__ dout,                                \
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,           \
    T* __restrict__ dv, int Tq, int Tk, int H, int prefix_s, float scale, Dropout drop,           \
    bool vec, int nc) {                                                                           \
  attn_bwd_dkv_tile<T, dkv_split_dh<T>(), kDrop, false, true>(q, q_sb, q_st, k, k_sb, k_st, v,    \
                                                              v_sb, v_st, kv_bias, Bias{}, dout,  \
                                                              lse, delta, dk, dv, Tq, Tk, H,      \
                                                              prefix_s, scale, drop, vec, nc);    \
}                                                                                                 \
                                                                                                  \
template <typename T>                                                                             \
__global__ void BOUNDS flash_bias_bwd_dq_split_kernel(                                            \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,                         \
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbias,               \
    int Tq, int Tk, int H, float scale, bool vec, int nc) {                                       \
  attn_bwd_dq_tile<T, kSplitDh, false, true, true>(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st,   \
                                                   nullptr, bias, dout, lse, delta, dq, dbias,    \
                                                   Tq, Tk, H, -1, scale, Dropout{}, vec, nc);     \
}                                                                                                 \
                                                                                                  \
template <typename T>                                                                             \
__global__ void BOUNDS flash_bias_bwd_dkv_split_kernel(                                           \
    const T* __restrict__ q, long long q_sb, long long q_st,                                      \
    const T* __restrict__ k, long long k_sb, long long k_st,                                      \
    const T* __restrict__ v, long long v_sb, long long v_st,                                      \
    Bias bias, const T* __restrict__ dout, const float* __restrict__ lse,                         \
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,      \
    int H, float scale, bool vec, int nc) {                                                       \
  attn_bwd_dkv_tile<T, dkv_split_dh<T>(), false, true, true>(q, q_sb, q_st, k, k_sb, k_st, v,     \
                                                             v_sb, v_st, nullptr, bias, dout, lse, \
                                                             delta, dk, dv, Tq, Tk, H, -1, scale,  \
                                                             Dropout{}, vec, nc);                  \
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

// The kernel of each pass (kSplit: the split instantiation, DH = kSplitDh,
// or dkv_split_dh() for the dK/dV pass, under Dh 128's launch bounds).
template <typename T, int DH, bool kDrop, bool kSplit>
auto dq_kernel() {
  constexpr int c = bounds_class<T, DH, kDrop, false, true>();
  if constexpr (kSplit) {
    static_assert(c == 1, "the split passes take Dh 128's launch bounds");
    return fit1::attn_bwd_dq_split_kernel<T, kDrop>;
  } else if constexpr (c == 4) return fit4::attn_bwd_dq_kernel<T, DH, kDrop>;
  else if constexpr (c == 1) return fit1::attn_bwd_dq_kernel<T, DH, kDrop>;
  else return any_regs::attn_bwd_dq_kernel<T, DH, kDrop>;
}

template <typename T, int DH, bool kDrop, bool kSplit>
auto dkv_kernel() {
  constexpr int c = bounds_class<T, DH, kDrop, false, false>();
  if constexpr (kSplit) {
    return fit1::attn_bwd_dkv_split_kernel<T, kDrop>;
  } else if constexpr (c == 4) return fit4::attn_bwd_dkv_kernel<T, DH, kDrop>;
  else if constexpr (c == 1) return fit1::attn_bwd_dkv_kernel<T, DH, kDrop>;
  else return any_regs::attn_bwd_dkv_kernel<T, DH, kDrop>;
}

template <typename T, int DH, bool kSplit>
auto bias_dq_kernel() {
  constexpr int c = bounds_class<T, DH, false, true, true>();
  if constexpr (kSplit) {
    static_assert(c == 1, "the split passes take Dh 128's launch bounds");
    return fit1::flash_bias_bwd_dq_split_kernel<T>;
  } else if constexpr (c == 4) return fit4::flash_bias_bwd_dq_kernel<T, DH>;
  else if constexpr (c == 1) return fit1::flash_bias_bwd_dq_kernel<T, DH>;
  else return any_regs::flash_bias_bwd_dq_kernel<T, DH>;
}

template <typename T, int DH, bool kSplit>
auto bias_dkv_kernel() {
  constexpr int c = bounds_class<T, DH, false, true, false>();
  if constexpr (kSplit) {
    return fit1::flash_bias_bwd_dkv_split_kernel<T>;
  } else if constexpr (c == 4) return fit4::flash_bias_bwd_dkv_kernel<T, DH>;
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

// Launch one pass, with nc appended to the arguments of a split kernel.
template <bool kSplit, typename K, typename... A>
cudaError_t launch_split_pass(K kern, dim3 grid, size_t smem, cudaStream_t stream, int nc,
                              A... args) {
  if constexpr (kSplit)
    return launch_pass(kern, grid, smem, stream, args..., nc);
  else
    return launch_pass(kern, grid, smem, stream, args...);
}

// The dQ and dK/dV passes of kernel 4 (kBias) or kernel 3 at Dh 256.
template <typename T, bool kBias>
cudaError_t launch_wide_passes(const Args& a, Dropout drop, float scale, cudaStream_t stream,
                               bool vec) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const dim3 gq((a.Tq + WQ - 1) / WQ, a.H, a.B), gk((a.Tk + WC - 1) / WC, a.H, a.B);
  constexpr size_t smem_dq = wide_smem_bytes<T, true>(), smem_dkv = wide_smem_bytes<T, false>();
  cudaError_t err;
  if constexpr (kBias) {
    err = launch_wide(flash_bias_bwd_dq_wide_kernel<T>, gq, smem_dq, stream, q, a.q_sb, a.q_st,
                      k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.bias, dout, a.lse, a.delta, dq,
                      a.dbias, a.Tq, a.Tk, a.H, scale, vec);
    if (err != cudaSuccess) return err;
    return launch_wide(flash_bias_bwd_dkv_wide_kernel<T>, gk, smem_dkv, stream, q, a.q_sb,
                       a.q_st, k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.bias, dout, a.lse,
                       a.delta, dk, dv, a.Tq, a.Tk, a.H, scale, vec);
  } else {
    auto kdq = attn_bwd_dq_wide_kernel<T, true>;
    auto kdkv = attn_bwd_dkv_wide_kernel<T, true>;
    if (drop.threshold == 0) {
      kdq = attn_bwd_dq_wide_kernel<T, false>;
      kdkv = attn_bwd_dkv_wide_kernel<T, false>;
    }
    err = launch_wide(kdq, gq, smem_dq, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb,
                      a.v_st, a.kv_bias, dout, a.lse, a.delta, dq, a.Tq, a.Tk, a.H, a.prefix_s,
                      scale, drop, vec);
    if (err != cudaSuccess) return err;
    return launch_wide(kdkv, gk, smem_dkv, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v,
                       a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H,
                       a.prefix_s, scale, drop, vec);
  }
}

// The dQ and dK/dV passes of kernel 4 (kBias) or kernel 3 at head dim Dh in
// clusters, one block per slice of the head (cluster_slice_dh(); header
// point 7): grids (Tq / 64 x nc, H, B) and (Tk / 64 x nc_dkv, H, B).
template <typename T, bool kBias>
cudaError_t launch_cluster_passes(int Dh, const Args& a, Dropout drop, float scale,
                                  cudaStream_t stream, bool vec) {
  const int nc = Dh / cluster_slice_dh<T, true>(), nc_dkv = Dh / cluster_slice_dh<T, false>();
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const dim3 gq((a.Tq + BM - 1) / BM * nc, a.H, a.B), gk((a.Tk + BM - 1) / BM * nc_dkv, a.H, a.B);
  constexpr size_t smem_dq = cluster_smem_bytes<T, true>();
  constexpr size_t smem_dkv = cluster_smem_bytes<T, false>();
  cudaError_t err;
  if constexpr (kBias) {
    err = launch_cluster(flash_bias_bwd_dq_cluster_kernel<T>, gq, nc, smem_dq, stream, q, a.q_sb,
                         a.q_st, k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.bias, dout, a.lse,
                         a.delta, dq, a.dbias, a.Tq, a.Tk, a.H, scale, vec, nc);
    if (err != cudaSuccess) return err;
    return launch_cluster(flash_bias_bwd_dkv_cluster_kernel<T>, gk, nc_dkv, smem_dkv, stream, q,
                          a.q_sb, a.q_st, k, a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.bias, dout,
                          a.lse, a.delta, dk, dv, a.Tq, a.Tk, a.H, scale, vec, nc_dkv);
  } else {
    auto kdq = attn_bwd_dq_cluster_kernel<T, true>;
    auto kdkv = attn_bwd_dkv_cluster_kernel<T, true>;
    if (drop.threshold == 0) {
      kdq = attn_bwd_dq_cluster_kernel<T, false>;
      kdkv = attn_bwd_dkv_cluster_kernel<T, false>;
    }
    err = launch_cluster(kdq, gq, nc, smem_dq, stream, q, a.q_sb, a.q_st, k, a.k_sb, a.k_st, v,
                         a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta, dq, a.Tq, a.Tk, a.H,
                         a.prefix_s, scale, drop, vec, nc);
    if (err != cudaSuccess) return err;
    return launch_cluster(kdkv, gk, nc_dkv, smem_dkv, stream, q, a.q_sb, a.q_st, k, a.k_sb,
                          a.k_st, v, a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta, dk, dv,
                          a.Tq, a.Tk, a.H, a.prefix_s, scale, drop, vec, nc_dkv);
  }
}

// The three passes of kernel 4 (kBias) or kernel 3: the delta pass, then
// the dQ and dK/dV passes, at Dh 256 the wide ones, above it up to
// kClusterMaxDh the cluster ones, at any other head dim through dispatch_dh
// (whole up to 128, split above the clusters' reach).
template <typename T, bool kBias>
cudaError_t launch_bwd(int Dh, const Args& a, Dropout drop, float scale, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const bool vec = rows_aligned(a.q, a.q_sb, a.q_st, es) && rows_aligned(a.k, a.k_sb, a.k_st, es) &&
                   rows_aligned(a.v, a.v_sb, a.v_st, es) &&
                   rows_aligned(a.dout, (long long)a.Tq * a.H * Dh, (long long)a.H * Dh, es);
  const int n_rows = a.B * a.Tq * a.H;
  cudaError_t err =
      launch(attn_bwd_delta_kernel<T>, dim3((n_rows + kThreads / 32 - 1) / (kThreads / 32)), 0,
             stream, static_cast<const T*>(a.dout), static_cast<const T*>(a.out), a.delta, n_rows,
             a.Tq, a.H, Dh);
  if (err != cudaSuccess) return err;
  if (Dh == kWideDh) return launch_wide_passes<T, kBias>(a, drop, scale, stream, vec);
  if (cluster_route(Dh))
    return launch_cluster_passes<T, kBias>(Dh, a, drop, scale, stream, vec);
  return dispatch_dh(Dh, [&](auto dh, auto split, int nc) {
    constexpr int DH = decltype(dh)::value;
    constexpr bool kSplit = decltype(split)::value;
    constexpr int DKV = kSplit ? dkv_split_dh<T>() : DH;  // the dK/dV pass's chunk
    const int nc_dkv = nc * DH / DKV;
    const size_t smem_dq = bwd_smem_bytes<T, DH, kSplit, true>();
    const size_t smem_dkv = bwd_smem_bytes<T, DKV, kSplit, false>();
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    T* dq = static_cast<T*>(a.dq);
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    const dim3 gq((a.Tq + BM - 1) / BM, a.H * nc, a.B);
    const dim3 gk((a.Tk + BM - 1) / BM, a.H * nc_dkv, a.B);
    if constexpr (kBias) {
      auto kdq = bias_dq_kernel<T, DH, kSplit>();
      auto kdkv = bias_dkv_kernel<T, DKV, kSplit>();
      err = launch_split_pass<kSplit>(kdq, gq, smem_dq, stream, nc, q, a.q_sb, a.q_st, k, a.k_sb,
                                      a.k_st, v, a.v_sb, a.v_st, a.bias, dout, a.lse, a.delta, dq,
                                      a.dbias, a.Tq, a.Tk, a.H, scale, vec);
      if (err != cudaSuccess) return err;
      return launch_split_pass<kSplit>(kdkv, gk, smem_dkv, stream, nc_dkv, q, a.q_sb, a.q_st, k,
                                       a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.bias, dout, a.lse,
                                       a.delta, dk, dv, a.Tq, a.Tk, a.H, scale, vec);
    } else {
      auto kdq = dq_kernel<T, DH, true, kSplit>();
      auto kdkv = dkv_kernel<T, DKV, true, kSplit>();
      if (drop.threshold == 0) {
        kdq = dq_kernel<T, DH, false, kSplit>();
        kdkv = dkv_kernel<T, DKV, false, kSplit>();
      }
      err = launch_split_pass<kSplit>(kdq, gq, smem_dq, stream, nc, q, a.q_sb, a.q_st, k, a.k_sb,
                                      a.k_st, v, a.v_sb, a.v_st, a.kv_bias, dout, a.lse, a.delta,
                                      dq, a.Tq, a.Tk, a.H, a.prefix_s, scale, drop, vec);
      if (err != cudaSuccess) return err;
      return launch_split_pass<kSplit>(kdkv, gk, smem_dkv, stream, nc_dkv, q, a.q_sb, a.q_st, k,
                                       a.k_sb, a.k_st, v, a.v_sb, a.v_st, a.kv_bias, dout, a.lse,
                                       a.delta, dk, dv, a.Tq, a.Tk, a.H, a.prefix_s, scale, drop,
                                       vec);
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

// The resources of one wide pass kernel (Dh 256): dtype as above, bias: kernel
// 4 (else kernel 3), drop: kernel 3 with dropout, dkv: the dK/dV pass (else
// dQ).  info: registers, local (spilled) bytes, dynamic shared memory bytes,
// threads a block, resident blocks per SM.  Returns a cudaError_t.
extern "C" int prefix_attention_bwd_wide_info(int dtype, int bias, int drop, int dkv, int* info) {
  auto query = [&](auto kern, size_t smem) { return wide_kernel_info(kern, smem, info); };
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    const size_t sq = wide_smem_bytes<T, true>(), sk = wide_smem_bytes<T, false>();
    if (bias) return dkv ? query(flash_bias_bwd_dkv_wide_kernel<T>, sk)
                         : query(flash_bias_bwd_dq_wide_kernel<T>, sq);
    if (drop) return dkv ? query(attn_bwd_dkv_wide_kernel<T, true>, sk)
                         : query(attn_bwd_dq_wide_kernel<T, true>, sq);
    return dkv ? query(attn_bwd_dkv_wide_kernel<T, false>, sk)
               : query(attn_bwd_dq_wide_kernel<T, false>, sq);
  };
  if (dtype == 0) return pick(float{});
  if (dtype == 1) return pick(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// The resources of one cluster pass kernel as head dim Dh (257-1024, a
// multiple of 128) launches it: dtype, bias, drop and dkv as in
// prefix_attention_bwd_wide_info.  info: registers, local (spilled) bytes,
// dynamic shared memory bytes, threads a block, resident blocks per SM, the
// clusters that can be resident at once, and the blocks of a cluster.
// Returns a cudaError_t.
extern "C" int prefix_attention_bwd_cluster_info(int dtype, int bias, int drop, int dkv, int Dh,
                                                 int* info) {
  if (!cluster_route(Dh)) return (int)cudaErrorInvalidValue;
  int nc = 0;
  auto query = [&](auto kern, size_t smem) {
    info[6] = nc;
    return cluster_kernel_info(kern, nc, smem, info);
  };
  auto pick = [&](auto tag) -> int {
    using T = decltype(tag);
    nc = Dh / (dkv ? cluster_slice_dh<T, false>() : cluster_slice_dh<T, true>());
    const size_t sq = cluster_smem_bytes<T, true>(), sk = cluster_smem_bytes<T, false>();
    if (bias) return dkv ? query(flash_bias_bwd_dkv_cluster_kernel<T>, sk)
                         : query(flash_bias_bwd_dq_cluster_kernel<T>, sq);
    if (drop) return dkv ? query(attn_bwd_dkv_cluster_kernel<T, true>, sk)
                         : query(attn_bwd_dq_cluster_kernel<T, true>, sq);
    return dkv ? query(attn_bwd_dkv_cluster_kernel<T, false>, sk)
               : query(attn_bwd_dq_cluster_kernel<T, false>, sq);
  };
  if (dtype == 0) return pick(float{});
  if (dtype == 1) return pick(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
