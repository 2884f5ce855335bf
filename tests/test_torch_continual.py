"""The continual task (``valle_tpu_torch.sample.continual``) against the JAX
package's ``valle_tpu.sample.continual`` on the CPU, with the JAX init
bridged into the port (d=64, 4 heads, 2 layers, Q=4) and the same numpy
inputs.  The port runs its NAR passes through kernel 2's plain version
(``attn_impl="flash"``), JAX through XLA.

  - the batched call equals the JAX batched call, codes and lengths, for
    VALL-E at prefix mode 0 and VALL-F at prefix mode 1: rows of 470, 101 and 301
    frames padded to 470, so the per-row prefix min(y_lens // 2, 225) takes
    the 225 cap on one row and each row's own half on the others;
  - each row of the port's batched call equals the JAX batch-1 call on that
    row alone, cut to its true text and code lengths;
  - the regenerated region is shifted left per row: codebook 1 of the
    output is the input's codebook 1 from the row's prefix on, and zero past
    the row's length.
Codes are compared for equality (greedy argmax on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.sample import continual as jax_continual
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.sample import continual
from valle_tpu_torch.utils.bridge import state_dict_from_jax

B, S, T, Q = 3, 9, 470, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    x_lens = np.array([9, 5, 7], np.int32)
    y = rng.randint(0, 1024, (B, T, Q)).astype(np.int32)
    y_lens = np.array([470, 101, 301], np.int32)
    for b in range(B):
        x[b, x_lens[b]:] = 0
        y[b, y_lens[b]:] = 0
    return x, x_lens, y, y_lens


@pytest.fixture(scope="module", params=[("valle", 0), ("vallf", 1)],
                ids=lambda p: f"{p[0]}-prefix{p[1]}")
def jax_run(request):
    variant, prefix_mode = request.param
    kw = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, prefix_mode=prefix_mode,
              model_name="VALL-F" if variant == "vallf" else "VALL-E")
    model = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    x, x_lens, y, y_lens = (jnp.asarray(a) for a in _inputs())
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, x, x_lens, y, y_lens, train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(prefix_mode))
    out = jax_continual(model, variables, x, x_lens, y, y_lens)
    rows = []  # the batch-1 calls, each row cut to its true lengths
    for b in range(B):
        xl, yl = int(x_lens[b]), int(y_lens[b])
        one = jax_continual(model, variables, x[b:b + 1, :xl], x_lens[b:b + 1], y[b:b + 1, :yl])
        rows.append((np.asarray(one["codes"][0]), int(one["lengths"][0])))
    variables = jax.tree.map(np.asarray, variables)
    return kw, variant, variables, np.asarray(out["codes"]), np.asarray(out["lengths"]), rows


def _port_out(jax_run):
    kw, variant, variables, *_ = jax_run
    cfg = ModelConfig(attn_impl="flash", **kw)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, variant, device="cpu"))
    x, x_lens, y, y_lens = (torch.from_numpy(a).long() for a in _inputs())
    return continual(model, x, x_lens, y, y_lens)


def test_batched_continual_matches_jax(jax_run):
    *_, want_codes, want_lens, _ = jax_run
    out = _port_out(jax_run)
    np.testing.assert_array_equal(out["lengths"].numpy(), want_lens)
    np.testing.assert_array_equal(out["codes"].numpy(), want_codes)
    np.testing.assert_array_equal(want_lens, [470 - 225, 101 - 50, 301 - 150])
    _, _, y, y_lens = _inputs()
    plen = np.minimum(y_lens // 2, 225)
    for b in range(B):
        n = want_lens[b]
        np.testing.assert_array_equal(out["codes"][b, :n, 0].numpy(), y[b, plen[b]:y_lens[b], 0])
        assert not out["codes"][b, n:].any()


def test_each_row_matches_the_jax_batch_1_call(jax_run):
    rows = jax_run[-1]
    out = _port_out(jax_run)
    for b, (want, n) in enumerate(rows):
        assert int(out["lengths"][b]) == n
        np.testing.assert_array_equal(out["codes"][b, :n].numpy(), want[:n])
