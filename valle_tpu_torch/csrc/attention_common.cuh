// Shared by the attention forward (prefix_attention.cu) and backward
// (prefix_attention_bwd.cu) kernels: the element conversions, the dense bias
// and dropout arguments, the head-dim dispatch and a plain launch helper.
// The tensor-core tiles are in mma_tile.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a block launched by launch()

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// Kernel 4's dense f32 bias: element (b, h, r, c) at
// p[b * sb + h * sh + r * sq + c * sk], stride 0 on a broadcast dimension.
struct Bias {
  const float* p;
  long long sb, sh, sq, sk;
};

struct Dropout {
  unsigned threshold;  // keep when bits >= threshold; 0 = no dropout
  float inv_keep;      // 1 / (1 - rate)
  uint2 seed;
};

// The head-dim chunk of the split instantiations of kernels 2-4 and the
// slice of their cluster kernels: a head dim above 128 runs as Dh / kSplitDh
// chunks of 128 columns (the wrapper zero-pads it to a multiple of 128).
constexpr int kSplitDh = 128;

// f(std::integral_constant<int, DH>, split, nc) for the supported head dims:
// Dh in {16, 32, 64, 128} whole (split false, nc 1), or a multiple of
// kSplitDh above it in nc = Dh / kSplitDh chunks of DH = kSplitDh (split
// std::true_type).  The forward and the backward take their wide kernels at
// Dh 256 and their cluster kernels from 257 to 1024 (cluster_route() of
// cluster_tile.cuh) before they dispatch here, so both reach the split
// instantiations only past Dh 1024.
template <typename F>
cudaError_t dispatch_dh(int Dh, F&& f) {
  switch (Dh) {
    case 16: return f(std::integral_constant<int, 16>{}, std::false_type{}, 1);
    case 32: return f(std::integral_constant<int, 32>{}, std::false_type{}, 1);
    case 64: return f(std::integral_constant<int, 64>{}, std::false_type{}, 1);
    case 128: return f(std::integral_constant<int, 128>{}, std::false_type{}, 1);
    default:
      if (Dh > kSplitDh && Dh % kSplitDh == 0)
        return f(std::integral_constant<int, kSplitDh>{}, std::true_type{}, Dh / kSplitDh);
      return cudaErrorInvalidValue;
  }
}

// Launch `kern` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it is above the default 48 KiB.
template <typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, size_t smem, cudaStream_t stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
