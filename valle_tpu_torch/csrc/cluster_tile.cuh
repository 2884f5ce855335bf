// Thread-block clusters over a head's Dh (sm_90): the blocks of a cluster
// each own one slice of the head's columns, compute their partial of a
// tile of products (S, dP) over that slice, and sum the partials through
// distributed shared memory, in the fixed order slice 0 + slice 1 + ... +
// slice nc - 1, so that every block of the cluster holds the same sums, bit
// for bit.  The backward's cluster passes (prefix_attention_bwd.cu, header
// point 7) sum S and dP with it, the forward's cluster kernels
// (prefix_attention.cu, header point 9) S alone; both take the head dims of
// cluster_route().
//
// The exchange runs on the cluster barrier (barrier.cluster arrive / wait,
// which every thread of every block of the cluster must take in turn) with
// one buffer a block:
//   wait      every block has read the previous exchange's buffers
//             (skipped at the first exchange);
//   store     the block's partials into its own buffer;
//   arrive    (release) and wait (acquire): every block's partials are in;
//   reduce    block j reads its share of the floats (j, j + nc, ...) from
//             the nc buffers through mapa / ld.shared::cluster, adds them
//             in rank order and stores the sums in its own buffer, in
//             place of its partials of the same floats;
//   arrive    and wait: every block's sums are in;
//   gather    read each float's sum from the block that made it;
//   arrive    (release): this block has read them.
// The last arrive's wait comes at the next exchange, after the element
// pass and the products of a whole tile, so it rarely waits; one buffer
// instead of two keeps two f32 blocks on an SM.  After the last exchange a
// block waits once more before it exits, so that no peer reads the shared
// memory of a block that has gone.  Every block of a cluster must take the
// same number of exchanges: the callers' loops are the same for every slice.
#pragma once

#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "mma_tile.cuh"
#include "wide_tile.cuh"

namespace {

// Blocks of a cluster: at most kClusterMax; above kClusterPortable the
// kernel needs cudaFuncAttributeNonPortableClusterSizeAllowed (the H100
// schedules 16; cluster_kernel_info reports whether such clusters fit).
constexpr int kClusterPortable = 8;
constexpr int kClusterMax = 16;

// The head dims that run in clusters, forward and backward: multiples of
// kSplitDh above the wide kernels' Dh 256 up to kClusterMaxDh, where slices
// of 128 columns fill kClusterPortable blocks (and the backward's f32 dK/dV
// pass, in slices of 64, kClusterMax).  Past it the split instantiations run.
constexpr int kClusterMaxDh = kClusterPortable * kSplitDh;

inline bool cluster_route(int Dh) {
  return Dh > kWideDh && Dh % kSplitDh == 0 && Dh <= kClusterMaxDh;
}

// The launch bounds of a cluster kernel: two blocks of kMmaThreads per SM (at
// most 255 registers a thread; two f32 blocks' shared memory fill the SM).
constexpr int kClusterMinBlocks = 2;

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The cluster's index along the grid's x axis (blockIdx.x / cluster size).
__device__ __forceinline__ int cluster_index_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `addr` (a shared::cta address of this
// block) in the block of rank `rank`.
__device__ __forceinline__ unsigned cluster_map(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Floats of a block's exchange buffer for N floats a lane of each of its
// kMmaWarps warps.
template <int N>
constexpr int cluster_xchg_floats() {
  return kMmaWarps * 32 * N;
}

// One warp's side of the exchange of N floats a lane through `buf`
// (cluster_xchg_floats<N>() floats of the block's shared memory): lane L of
// warp w keeps float i at (w N + i) 32 + L, so that a warp's stores and
// loads are conflict-free.  The sum is a reduce-scatter, then an
// all-gather: block j adds floats j, j + nc, ... of every block's partials,
// in rank order, and writes the sums over its own partials there (no other
// block reads those slots of its buffer); then every block reads each float
// from the block that summed it.  A block reads 2 N floats a lane in all,
// where reading every partial would take nc N.
struct ClusterExchange {
  float* buf;
  int nc;                // blocks of the cluster
  bool pending = false;  // an exchange whose "read" arrive has no wait yet

  template <int N>
  __device__ __forceinline__ void sum(float (&x)[N], int warp, int lane) {
    if (pending) cluster_wait();  // every block has read the previous exchange
    float* mine = buf + warp * N * 32 + lane;  // float i at mine[32 i]
#pragma unroll
    for (int i = 0; i < N; ++i) mine[32 * i] = x[i];
    cluster_arrive();
    cluster_wait();  // every block's partials are in
    const unsigned base = smem_addr(mine);
#pragma unroll 2
    for (int i = cluster_rank(); i < N; i += nc) {  // this block's floats: rank order
      const unsigned a = base + 128u * i;
      float total = 0.f;
#pragma unroll
      for (int r0 = 0; r0 < kClusterMax; r0 += 8) {  // eight ranks' loads in flight
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < nc) v[r] = ld_cluster(cluster_map(a, r0 + r));
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r0 + r < nc) total = r0 + r == 0 ? v[r] : total + v[r];
      }
      mine[32 * i] = total;
    }
    cluster_arrive();
    cluster_wait();  // every block's sums are in
    int owner = 0;  // the block that summed float i: i mod nc
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = ld_cluster(cluster_map(base + 128u * i, owner));
      owner = owner + 1 == nc ? 0 : owner + 1;
    }
    cluster_arrive();  // this block has read them
    pending = true;
  }

  // S and dP's C fragments (NT n8 tiles each) summed as one exchange.
  template <int NT>
  __device__ __forceinline__ void sum(float (&s)[NT][4], float (&dp)[NT][4], int warp,
                                      int lane) {
    float x[8 * NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[4 * n + e] = s[n][e];
        x[4 * (NT + n) + e] = dp[n][e];
      }
    sum(x, warp, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = x[4 * n + e];
        dp[n][e] = x[4 * (NT + n) + e];
      }
  }

  // S's C fragments (NT n8 tiles) alone.
  template <int NT>
  __device__ __forceinline__ void sum(float (&s)[NT][4], int warp, int lane) {
    float x[4 * NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * n + e] = s[n][e];
    sum(x, warp, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = x[4 * n + e];
  }

  // Before the block exits: every peer has read its last partials.
  __device__ __forceinline__ void finish() {
    if (pending) cluster_wait();
    pending = false;
  }
};

// Set a cluster kernel's attributes: `smem` bytes of dynamic shared memory,
// the largest carveout (so that two blocks fit an SM), and clusters above
// the portable size where nc needs them.
template <typename K>
cudaError_t prepare_cluster(K kern, int nc, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || nc <= kClusterPortable) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The launch of clusters of (nc, 1, 1) blocks of kMmaThreads threads over
// `grid` with `smem` bytes of dynamic shared memory (cfg points at attr, so
// the object is not copied).
struct ClusterLaunch {
  cudaLaunchAttribute attr = {};
  cudaLaunchConfig_t cfg = {};

  ClusterLaunch(dim3 grid, int nc, size_t smem, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)nc;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kMmaThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// Launch `kern` over `grid` in clusters of nc blocks.  A launch the card
// refuses (clusters that do not fit) returns its error; nothing falls back.
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kern)(P...), dim3 grid, int nc, size_t smem,
                           cudaStream_t stream, A... args) {
  cudaError_t err = prepare_cluster(kern, nc, smem);
  if (err != cudaSuccess) return err;
  const ClusterLaunch launch(grid, nc, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kern, static_cast<P>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The resources of a cluster kernel launched in clusters of nc blocks with
// `smem` bytes: registers, local (spilled) bytes, dynamic shared memory
// bytes, threads a block, resident blocks per SM and the clusters that can
// be resident at once on the card (cudaOccupancyMaxActiveClusters), into
// info[0..5].  Returns a cudaError_t.
template <typename K>
int cluster_kernel_info(K kern, int nc, size_t smem, int* info) {
  cudaError_t err = prepare_cluster(kern, nc, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kMmaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const ClusterLaunch launch(dim3(nc * 1024), nc, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &launch.cfg);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)smem;
  info[3] = kMmaThreads;
  info[4] = blocks;
  info[5] = clusters;
  return 0;
}

}  // namespace
