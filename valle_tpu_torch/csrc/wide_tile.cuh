// The wide tiles of head dim 256, shared by the forward's wide kernels
// (prefix_attention.cu, header point 8) and the backward's wide passes
// (prefix_attention_bwd.cu, header point 6): the block shape, the launch
// bounds, and the exchange through which two warps that each computed a 16 x
// 16 tile of products over one half of Dh add their halves.
#pragma once

#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

// Dh = kWideDh whole, kWideWarps warps a block; in phase A warp w computes
// its products over Dh half w >> 2 (kWideHalf columns).
constexpr int kWideDh = 256;
constexpr int kWideHalf = kWideDh / 2;  // the Dh columns of a phase-A warp
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int WQ = 64;  // forward and dQ pass: q rows of a block (4 m16 tiles)
constexpr int WK = 16;  // forward and dQ pass: keys of a streamed tile
constexpr int kXchg = 8 * 32;  // floats a warp hands its partner: 2 x 4 per lane

// Blocks per SM that the launch bounds ask ptxas to fit: f32 takes one
// (shared memory holds one block), bf16 two (at most 128 registers, no
// spill; with one block of more registers both bf16 passes ran slower).
template <typename T>
constexpr int kWideMinBlocks = kF32<T> ? 1 : 2;

// Row stride of a tile of P (forward), Pd^T or dS^T (backward) of W columns:
// 8 elements past W, 8 mod 32 words in f32 (W = 16, 32) and an odd number of
// 16-byte units in bf16.
template <int W>
__host__ __device__ constexpr int pd_stride() {
  return W + 8;
}

// Phase A of a wide backward pass splits Dh between warps w and w ^ 4 (half =
// w >> 2), each holding a 16 x 16 partial of S and dP (two n8 tiles) over its
// 128 columns.  The element pass of n8 tile `half` is the warp's own: it hands
// the other tile to its partner through sx, takes the partner's, and adds
// the two halves low + high, in that order, into s1 / dp1.
__device__ __forceinline__ void wide_exchange_give(float* sx, const float (&s)[2][4],
                                                   const float (&dp)[2][4], int half, int warp,
                                                   int lane) {
  float* o = sx + warp * kXchg + lane;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[32 * e] = half ? s[0][e] : s[1][e];
    o[32 * (4 + e)] = half ? dp[0][e] : dp[1][e];
  }
}

__device__ __forceinline__ void wide_exchange_take(const float* sx, const float (&s)[2][4],
                                                   const float (&dp)[2][4], int half, int warp,
                                                   int lane, float (&s1)[4], float (&dp1)[4]) {
  const float* o = sx + (warp ^ 4) * kXchg + lane;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float rs = o[32 * e], rd = o[32 * (4 + e)];
    s1[e] = half ? rs + s[1][e] : s[0][e] + rs;
    dp1[e] = half ? rd + dp[1][e] : dp[0][e] + rd;
  }
}

// The forward's exchange: the warp hands its partner both n8 tiles of its S
// partial and adds the partner's, low half + high half, into the whole 16 x
// 16 tile s1.  Both warps of the pair then hold the same s1, bit for bit.
__device__ __forceinline__ void wide_exchange_give(float* sx, const float (&s)[2][4], int warp,
                                                   int lane) {
  float* o = sx + warp * kXchg + lane;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[32 * (4 * n + e)] = s[n][e];
}

__device__ __forceinline__ void wide_exchange_take(const float* sx, const float (&s)[2][4],
                                                   int half, int warp, int lane,
                                                   float (&s1)[2][4]) {
  const float* o = sx + (warp ^ 4) * kXchg + lane;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = o[32 * (4 * n + e)];
      s1[n][e] = half ? r + s[n][e] : s[n][e] + r;
    }
}

// Give a wide kernel its shared memory: the dynamic size, and the largest
// carveout, so that two bf16 blocks fit on an SM.
template <typename K>
cudaError_t prepare_wide(K kern, size_t smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename... P, typename... A>
cudaError_t launch_wide(void (*kern)(P...), dim3 grid, size_t smem, cudaStream_t stream,
                        A... args) {
  const cudaError_t err = prepare_wide(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kWideThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The resources of a wide kernel launched with `smem` bytes: registers, local
// (spilled) bytes, dynamic shared memory bytes, threads a block and resident
// blocks per SM, into info[0..4].  Returns a cudaError_t.
template <typename K>
int wide_kernel_info(K kern, size_t smem, int* info) {
  cudaError_t err = prepare_wide(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kWideThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)smem;
  info[3] = kWideThreads;
  info[4] = blocks;
  return 0;
}

}  // namespace
