"""The f32 arithmetic of the attention backward kernel (kernels 3 and 4's
backward, ``valle_tpu_torch/csrc/prefix_attention_bwd.cu``), mirrored in numpy.

The kernel runs its f32 products on the tensor cores as 3xTF32: each operand
x splits into big = tf32_rna(x) and small = tf32_rna(x - big), and a product
sums small*big + big*small + big*big in f32, one k step of 8 into a zeroed
fragment that is then added to the f32 accumulator.  The CUDA kernel runs
only on the card; this pins its numeric design here: on seeded f32 matrices
the mirror stays within a small multiple of a plain f32 product's error and
well inside the tolerance the card's check holds the kernel to, while a
single TF32 product does not.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tol_float32() -> float:
    """``TOL["float32"]`` of chip_smoke.py, the limit of the kernel checks."""
    line = re.search(r"^TOL = (\{.*\})$", (ROOT / "chip_smoke.py").read_text(), re.M).group(1)
    return float(ast.literal_eval(line)["float32"])


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 mantissa bits), ties away from zero, as the kernel
    does it: add half a TF32 ulp to the bits and clear the 13 low bits."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna((x - big).astype(np.float32))


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernel sums it: per k step of 8, the three TF32 products
    (small*big, big*small, big*big, in that order) into a zeroed f32 part,
    which is then added to the f32 accumulator."""
    (ab, a_s), (bb, bs) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + 8, a.shape[1])):
            for x, y in ((a_s, bb), (ab, bs), (ab, bb)):
                part = (part + np.outer(x[:, k], y[k])).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


def product_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b summed in f32, one k at a time (the CUDA-core FMA order)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc + np.outer(a[:, k], b[k])).astype(np.float32)
    return acc


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), one, 1 + ulp, 0.0], np.float32)
    got = tf32_rna(x)
    assert np.array_equal(got, want)
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    big, small = split(np.random.RandomState(0).randn(1000).astype(np.float32))
    x = big.astype(np.float64) + small.astype(np.float64)
    assert np.abs(x - (big + small)).max() == 0.0  # big + small is exact in f32


@pytest.mark.parametrize("k", [16, 64, 128, 880])
def test_3xtf32_product_keeps_f32_accuracy(k):
    rng = np.random.RandomState(k)
    a = rng.randn(32, k).astype(np.float32)
    b = rng.randn(k, 24).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()

    def err(c):
        return float(np.abs(c.astype(np.float64) - exact).max() / scale)

    e3, e32 = err(product_3xtf32(a, b)), err(product_f32(a, b))
    e1 = err(tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64))
    tol = _tol_float32()
    # 3xTF32 is f32-accurate: a small multiple of the plain f32 product's
    # error, and a tenth of the kernel checks' f32 limit at most
    assert e3 <= 4 * e32 + 1e-7, (e3, e32)
    assert e3 <= tol / 10, (e3, tol)
    # one TF32 product is not: outside the limit, 100 times the f32 error
    assert e1 > tol and e1 > 100 * e32, (e1, e32, tol)
