// Philox4x32-10 (Salmon et al., SC'11): the attention dropout bits of the
// port, shared by the forward (prefix_attention.cu) and backward
// (prefix_attention_bwd.cu) kernels.  valle_tpu_torch/ops/philox.py is the
// plain PyTorch twin and documents the counter layout:
//   key = (seed low word, seed high word), counter = (col / 4, row, b*H + h, 0),
//   bits of column col = output word col % 4; keep when bits >= threshold.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The keep bits of columns 4g .. 4g+3 of one row, as a 4-bit mask (bit e set
// = column 4g + e kept).
__device__ __forceinline__ unsigned philox_keep4(unsigned group, unsigned row, unsigned bh,
                                                 uint2 key, unsigned threshold) {
  const uint4 w = philox4x32_10(make_uint4(group, row, bh, 0u), key);
  return (unsigned)(w.x >= threshold) | ((unsigned)(w.y >= threshold) << 1) |
         ((unsigned)(w.z >= threshold) << 2) | ((unsigned)(w.w >= threshold) << 3);
}
