"""Philox4x32-10 in plain PyTorch: the attention dropout bits of the port.

The JAX kernel seeds the TPU's hardware generator per (batch, head, q-window)
tile (``valle_tpu/ops/fused_attention.py::_tile_seed``); that stream cannot be
reproduced off the TPU, and it ties the bits to a tile size.  The port draws
each keep bit from a counter-based Philox4x32-10 (Salmon et al., SC'11):

  key     = the 64-bit seed of one attention call (low word, high word);
  counter = (col // 4, row, b * H + h, 0);
  bits    = word ``col % 4`` of the output.

A column is kept when its bits are at or above ``round(rate * 2**32)``, as
``_keep_mask`` of the JAX kernel does.  The bits depend on the element only,
never on a tiling, so the forward kernel, the backward kernel and this plain
version give the identical mask (``csrc/philox.cuh`` is the CUDA twin).

Tensors hold uint32 values in int64.  A 32 x 32 -> 64-bit product overflows
int64, so ``_mulhilo`` splits one factor into 16-bit halves: every partial
product stays below 2**49.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from valle_tpu_torch.parallel import dist

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product m * c, for m < 2**32 and uint32 c."""
    t = m * (c & 0xFFFF)
    u = m * (c >> 16)
    low = t + ((u & 0xFFFF) << 16)
    return (u >> 16) + (low >> 32), low & MASK32


def philox4x32(c0, c1, c2, c3, key0: int, key1: int, rounds: int = 10):
    """Philox4x32 on int64 tensors of uint32 counters (broadcastable);
    returns the four output words."""
    k0, k1 = key0 & MASK32, key1 & MASK32
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep when bits >= this: P(keep) = 1 - rate (the JAX ``_keep_mask``)."""
    return min(2**32 - 1, round(rate * 2**32))


def dropout_keep_mask(seed: int, b: int, h: int, tq: int, tk: int, rate: float,
                      device=None) -> torch.Tensor:
    """(B, H, Tq, Tk) bool keep mask of one attention call."""
    ng = (tk + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    grp = torch.arange(ng, **i64).view(1, 1, 1, ng)
    row = torch.arange(tq, **i64).view(1, 1, tq, 1)
    bh = torch.arange(b * h, **i64).view(b, h, 1, 1)
    shape = (b, h, tq, ng)
    words = philox4x32(grp.expand(shape), row.expand(shape), bh.expand(shape),
                       torch.zeros((), **i64), seed & MASK32, seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(b, h, tq, 4 * ng)[..., :tk]
    return bits >= keep_threshold(rate)


SEED_RANGE = 2**63 - 1
RANK_STRIDE = 0x9E3779B97F4A7C15  # 2**64 / golden ratio, odd


def fold_rank(seed: int, rank: int) -> int:
    """``seed`` moved to rank ``rank``'s stream: the identity at rank 0, and
    a seed of its own at every other rank (data-parallel ranks draw
    independent dropout bits, as the JAX kernels fold the mesh position into
    their seed, ``valle_tpu/ops/fused_attention.py:296-300``)."""
    return (seed + rank * RANK_STRIDE) % SEED_RANGE


def draw_seed(gen: Optional[torch.Generator]) -> int:
    """A 63-bit seed from ``gen`` (a CPU generator, so no device sync), or
    from torch's default CPU generator when ``gen`` is None, folded with
    this process's rank in its process group (0 without one)."""
    seed = int(torch.randint(0, SEED_RANGE, (), generator=gen))
    return fold_rank(seed, dist.process_index())
