"""Continuous batching of the port (``valle_tpu_torch/sample/continuous.py``)
against the JAX package's (``valle_tpu/sample/continuous.py``) on the CPU.

The same bridged weights and numpy requests (10 requests, text 3-6 tokens,
prompts 2-5 frames, ``stop_lens`` 4-21) go through JAX ``serve_continuous``
(batch 4, chunk 8, admission width 4: slots are refilled mid-run) and the
port's, greedy with EOS forbidden, in int8 and model-dtype caches, the
port's decode reads plain and through kernel 1's plain version
(``ragged_decode``; JAX's reads are the plain ones, its ragged kernel would
run in interpret mode): every request's codes and length are equal to
JAX's, and to the port's own ``generate`` of the same requests.  The
partial-batch and ``cap_steps`` restart cases of
``tests/test_continuous.py`` are held against the port's ``generate``.  At
the attention module, the per-slot ``cache_index`` write (columns that
differ per slot) gives JAX's caches and outputs (int8 values bit-equal,
float values and scales within 1e-6: XLA may turn the scale's division by
127 into a product with the reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.nn.attention import MultiheadAttention as JaxMHA
from valle_tpu.sample.continuous import serve_continuous as jax_serve_continuous
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.nn.attention import MultiheadAttention
from valle_tpu_torch.sample import generate
from valle_tpu_torch.sample.continuous import serve_continuous
from valle_tpu_torch.utils.bridge import state_dict_from_jax

Q, S, P, R = 4, 6, 5, 10
MAX_NEW = 24
SCHED = dict(batch_size=4, cap_steps=256, chunk=8, admit_width=4, top_k=1, forbid_eos=True,
             nar_bucket=MAX_NEW)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests():
    rng = np.random.RandomState(0)
    return {"x": rng.randint(1, 512, (R, S)).astype(np.int32),
            "x_lens": rng.randint(3, S + 1, R).astype(np.int32),
            "prompts": rng.randint(0, 1024, (R, P, Q)).astype(np.int32),
            "prompt_lens": rng.randint(2, P + 1, R).astype(np.int32),
            "stop_lens": rng.randint(4, MAX_NEW - 2, R).astype(np.int32)}


@pytest.fixture(scope="module", params=["int8", "model"])
def jax_run(request):
    kw = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q,
              kv_cache_dtype=request.param)
    model = JaxVALLE(JaxConfig(**kw))
    req = _requests()
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, jnp.asarray(req["x"]), jnp.asarray(req["x_lens"]),
        jnp.asarray(req["prompts"]), jnp.full((R,), P, jnp.int32), train_stage=0,
        deterministic=True, nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(0))
    out = jax_serve_continuous(model, variables, jax.random.PRNGKey(9), req, **SCHED)
    return kw, jax.tree.map(np.asarray, variables), out


def _port(kw, variables):
    cfg = ModelConfig(attn_impl="flash", **kw)
    return get_model(cfg, device="cpu",
                     state_dict=state_dict_from_jax(variables, cfg, "valle", device="cpu"))


def _generate(model, req, n=R, stop_lens=None):
    t = {k: torch.from_numpy(v[:n]).long() for k, v in req.items()}
    return generate(model, t["x"], t["x_lens"], t["prompts"], t["prompt_lens"], top_k=1,
                    max_new_tokens=MAX_NEW, forbid_eos=True,
                    stop_lens=t["stop_lens"] if stop_lens is None else torch.from_numpy(stop_lens))


def _assert_same(out, codes, lengths):
    assert len(out) == len(lengths)
    for i, o in enumerate(out):
        assert o["length"] == int(lengths[i]), f"request {i}: length"
        np.testing.assert_array_equal(o["codes"], np.asarray(codes)[i, :o["length"]],
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("ragged", [False, True], ids=["plain_read", "ragged_read"])
def test_continuous_matches_jax_and_generate(jax_run, ragged):
    kw, variables, want = jax_run
    model = _port(kw, variables)
    req = _requests()
    got = serve_continuous(model, req, generator=torch.Generator().manual_seed(9),
                           ragged_decode=ragged, **SCHED)
    assert [o["length"] for o in got] == [o["length"] for o in want]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["codes"], np.asarray(w["codes"]), err_msg=f"request {i}")
    ref = _generate(model, req)
    _assert_same(got, ref["codes"].numpy(), ref["lengths"].numpy())


def test_continuous_partial_batch(jax_run):
    """R < batch_size: padding rows fill the spare slots and are dropped."""
    kw, variables, _ = jax_run
    model = _port(kw, variables)
    req = {k: v[:2] for k, v in _requests().items()}
    req["stop_lens"] = np.full((2,), 8, np.int32)
    got = serve_continuous(model, req, batch_size=4, cap_steps=64, chunk=8, top_k=1,
                           forbid_eos=True, nar_bucket=MAX_NEW, ragged_decode=True)
    ref = _generate(model, req, n=2)
    _assert_same(got, ref["codes"].numpy(), ref["lengths"].numpy())


def test_continuous_cap_steps_restart(jax_run):
    """A step budget barely above the longest request blocks admission
    almost at once: the queue drains through several fresh states, with no
    request dropped."""
    kw, variables, _ = jax_run
    model = _port(kw, variables)
    req = _requests()
    req["stop_lens"] = np.random.RandomState(3).randint(4, 10, R).astype(np.int32)
    got = serve_continuous(model, req, batch_size=4, cap_steps=int(req["stop_lens"].max()) + 2,
                           chunk=4, admit_width=4, top_k=1, forbid_eos=True, nar_bucket=MAX_NEW,
                           ragged_decode=True)
    ref = _generate(model, req)
    _assert_same(got, ref["codes"].numpy(), ref["lengths"].numpy())


@pytest.mark.parametrize("int8", [True, False], ids=["int8_cache", "model_cache"])
def test_per_slot_cache_index_matches_jax(int8):
    """One decode step of the attention module with slots writing at
    columns 3, 0 and 6 of a 7-column stacked cache (layer 1 of 2)."""
    b, c, d, h = 3, 7, 16, 2
    rng = np.random.RandomState(5)
    x = rng.randn(b, 1, d).astype(np.float32)
    cols = np.array([3, 0, 6], np.int32)
    shape = (2, b, c, h, d // h)
    if int8:
        cache = (rng.randint(-127, 128, shape).astype(np.int8),
                 rng.randint(-127, 128, shape).astype(np.int8),
                 rng.rand(*shape[:-1]).astype(np.float32) * 0.01,
                 rng.rand(*shape[:-1]).astype(np.float32) * 0.01)
    else:
        cache = tuple(rng.randn(*shape).astype(np.float32) for _ in range(2))
    bias = np.where(np.arange(c)[None, :] <= cols[:, None], 0.0, -1e9).astype(np.float32)
    bias = bias[:, None, None, :]
    jmha = JaxMHA(d, h)
    variables = jmha.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, want_cache, _ = jax.jit(lambda v, *a: jmha.apply(
        v, a[0], attn_bias=a[1], kv_cache=(*a[2:-1], 1), cache_index=a[-1]))(
        variables, jnp.asarray(x), jnp.asarray(bias), *map(jnp.asarray, cache), jnp.asarray(cols))
    p = jax.tree.map(np.asarray, variables["params"])
    mha = MultiheadAttention(d, h)
    mha.load_state_dict({"in_proj_weight": torch.from_numpy(p["in_proj"]["kernel"].T.copy()),
                         "in_proj_bias": torch.from_numpy(p["in_proj"]["bias"]),
                         "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
                         "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"])})
    got_cache = tuple(torch.from_numpy(a.copy()) for a in cache)
    with torch.inference_mode():
        got, new_cache, _ = mha(torch.from_numpy(x), attn_bias=torch.from_numpy(bias),
                                kv_cache=(*got_cache, 1),
                                cache_index=torch.from_numpy(cols))
    assert all(n is g for n, g in zip(new_cache, got_cache))  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for g, w in zip(got_cache, want_cache):
        w = np.asarray(w)
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    written = np.zeros(shape[:3], bool)
    written[1, np.arange(b), cols] = True
    np.testing.assert_array_equal(got_cache[0].numpy()[~written], cache[0][~written])
