"""Philox4x32-10 of the port (``ops/philox.py``), the source of the attention
dropout bits that kernels 2 and 3 draw in CUDA (``csrc/philox.cuh``): the
Random123 known-answer vectors, equality with a pure-Python integer Philox
on random counters and keys, the element-to-counter layout of the keep mask,
and the keep rate.  Integer results are compared exactly; the keep rate
within 4 sigma of 1 - rate.
"""

import numpy as np
import pytest
import torch

from valle_tpu_torch.ops.philox import (
    dropout_keep_mask,
    draw_seed,
    keep_threshold,
    philox4x32,
)

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85


def _philox_int(c, k):
    """Philox4x32-10 in Python integers, straight from the definition."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + W0) & 0xFFFFFFFF, (k[1] + W1) & 0xFFFFFFFF]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & 0xFFFFFFFF, p1 & 0xFFFFFFFF,
             ((p0 >> 32) ^ c[3] ^ k[1]) & 0xFFFFFFFF, p0 & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_known_answer_vectors(counter, key, want):
    got = philox4x32(*(torch.tensor(c, dtype=torch.int64) for c in counter), *key)
    assert tuple(int(w) for w in got) == want
    assert tuple(_philox_int(counter, key)) == want


def test_plain_version_equals_integer_philox_on_random_counters():
    rng = np.random.RandomState(0)
    counters = rng.randint(0, 2**32, (64, 4), dtype=np.uint64).astype(np.int64)
    keys = rng.randint(0, 2**32, (64, 2), dtype=np.uint64).astype(np.int64)
    for c, k in zip(counters, keys):
        got = philox4x32(*(torch.tensor(int(x)) for x in c), int(k[0]), int(k[1]))
        assert [int(w) for w in got] == _philox_int([int(x) for x in c], [int(x) for x in k])
    # one batched call over all counters with one key
    got = torch.stack(philox4x32(*(torch.from_numpy(counters[:, i]) for i in range(4)),
                                 int(keys[0, 0]), int(keys[0, 1])), 1)
    want = [_philox_int([int(x) for x in c], [int(x) for x in keys[0]]) for c in counters]
    assert got.tolist() == want


def test_keep_mask_layout():
    """Element (b, h, row, col) keeps when word col % 4 of
    Philox((col // 4, row, b * H + h, 0), seed) is at or above the threshold."""
    seed, b, h, tq, tk, rate = (7 << 40) + 12345, 2, 3, 9, 13, 0.3
    mask = dropout_keep_mask(seed, b, h, tq, tk, rate)
    assert mask.shape == (b, h, tq, tk) and mask.dtype == torch.bool
    thr = keep_threshold(rate)
    key = [seed & 0xFFFFFFFF, seed >> 32]
    for idx in np.random.RandomState(1).randint(0, [b, h, tq, tk], (40, 4)):
        bi, hi, r, c = (int(i) for i in idx)
        word = _philox_int([c // 4, r, bi * h + hi, 0], key)[c % 4]
        assert bool(mask[bi, hi, r, c]) == (word >= thr)


def test_keep_rate_within_four_sigma():
    rate = 0.1
    mask = dropout_keep_mask(draw_seed(torch.Generator().manual_seed(3)), 2, 4, 256, 250, rate)
    n = mask.numel()
    assert abs(float(mask.float().mean()) - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)
    assert keep_threshold(0.0) == 0 and keep_threshold(1.0) == 2**32 - 1


def test_seeds_come_from_the_generator():
    a = [draw_seed(torch.Generator().manual_seed(5)) for _ in range(2)]
    gen = torch.Generator().manual_seed(5)
    b = [draw_seed(gen) for _ in range(2)]
    assert a[0] == a[1] == b[0] != b[1]
    assert all(0 <= s < 2**63 for s in a + b)
