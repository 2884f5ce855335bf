"""``valle_tpu_torch/nn/scaling.py`` against ``valle_tpu/nn/scaling.py``.

The same seeded numpy inputs go through each JAX function (one ``jax.jit``
per reference call) and its port:

  - forwards: the identity forwards equal exactly; ``double_swish``,
    ``basic_norm``, ``softmax`` and ``whitening_metric`` within 1e-6
    relative in f32 (bf16 outputs within one bf16 ulp);
  - gradients (``jax.vjp`` with a seeded cotangent against ``backward``):
    within 1e-5 x the tensor's largest |gradient| in f32 and 2e-2 x it in
    bf16, where JAX's code casts;
  - ``whiten`` with the limit below and above the input's metric;
  - the random ops exactly on injected masks and draws (``random_clamp``'s
    ``reflect`` extrapolation within 2 f32 ulps: XLA contracts its
    multiply-add into one FMA); from a generator,
    the clamped share within 4 sigma of ``prob``, and ``random_cast_to_half``
    keeping the mean;
  - ``SRLinear`` / ``SRConv1d``: output, updated ``u`` and the gradients of
    ``weight`` and ``sigma`` against the flax modules, with the flax
    variables bridged in (``utils/bridge.py::sr_state_dict_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from valle_tpu.nn import scaling as J
from valle_tpu_torch.nn import scaling as P
from valle_tpu_torch.utils.bridge import sr_state_dict_from_jax

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape=(4, 6, 16), seed=0):
    """x with channels that trip every balancer branch (large, tiny, mostly
    positive, mostly negative), and a cotangent g."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    x[..., 0] *= 40.0  # above max_abs
    x[..., 1] *= 0.01  # below min_abs
    x[..., 2] += 2.0  # mostly positive
    x[..., 3] -= 2.0  # mostly negative
    g = rng.randn(*shape).astype(np.float32)
    return x, g


def _pair(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return np.asarray(t.detach().float()) if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _jax_vjp(fn, *args):
    """fn's output and its gradient with respect to the first argument at
    the cotangent (the last argument), in one jitted call."""
    def run(*a):
        y, vjp = jax.vjp(lambda x: fn(x, *a[1:-1]), a[0])
        return y, vjp(a[-1])[0]
    return jax.jit(run)(*args)


def _torch_vjp(fn, x, g, *args):
    x = x.clone().requires_grad_(True)
    y = fn(x, *args)
    y.backward(g)
    return y, x.grad


def _close_grad(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL[dtype] * scale)


def _close_fwd(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:  # one bf16 ulp
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_double_swish(dtype):
    x, g = _inputs()
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    # without autograd: JAX's primal in the input dtype
    _close_fwd(P.double_swish(xt), jax.jit(J.double_swish)(xj), dtype)
    # with autograd: JAX's fwd rule, f32 rounded to the input dtype
    yj, dj = _jax_vjp(J.double_swish, xj, gj)
    yt, dt = _torch_vjp(P.double_swish, xt, gt)
    assert yt.dtype == DTYPES[dtype][1]
    _close_fwd(yt, yj, dtype)
    _close_grad(dt, dj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prob", [1.0, 0.25])
def test_activation_balancer(dtype, prob):
    x, g = _inputs()
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    kw = dict(channel_dim=-1, min_positive=0.45, max_positive=0.55, max_abs=6.0, prob=prob)
    yj, dj = _jax_vjp(lambda a: J.activation_balancer(a, **kw), xj, gj)
    yt, dt = _torch_vjp(lambda a: P.activation_balancer(a, **kw), xt, gt)
    np.testing.assert_array_equal(_np(yt), _np(yj))  # identity forward
    assert not np.array_equal(_np(dt), _np(gt))  # the balancer moved the gradient
    _close_grad(dt, dj, dtype)
    # apply=False (eval) is a pure no-op
    assert P.activation_balancer(xt, apply=False) is xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_balanced_double_swish(dtype):
    x, g = _inputs(seed=1)
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    yj, dj = _jax_vjp(J.balanced_double_swish, xj, gj)
    yt, dt = _torch_vjp(P.balanced_double_swish, xt, gt)
    _close_fwd(yt, yj, dtype)
    _close_grad(dt, dj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_basic_norm(dtype):
    x, g = _inputs(seed=2)
    (xj, xt), (gj, _) = _pair(x, dtype), _pair(g, dtype)
    eps = np.log(np.float32(0.25))

    def jfn(a, e, gg):
        y, vjp = jax.vjp(J.basic_norm, a, e)
        return (y, *vjp(gg))

    yj, dxj, dej = jax.jit(jfn)(xj, jnp.asarray(eps), jnp.asarray(g, jnp.float32))
    assert yj.dtype == jnp.float32  # JAX promotes x with the f32 eps_log
    xt = xt.clone().requires_grad_(True)
    et = torch.tensor(eps).requires_grad_(True)
    yt = P.basic_norm(xt, et)
    assert yt.dtype == torch.float32
    _close_fwd(yt, yj, dtype)
    yt.backward(torch.from_numpy(g))
    _close_grad(xt.grad, dxj, dtype)
    _close_grad(et.grad, dej, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax(dtype):
    x, g = _inputs(seed=3)
    x = x * 0.3
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    _close_fwd(P.softmax(xt, -1), jax.jit(J.softmax, static_argnums=1)(xj, -1), dtype)
    yj, dj = _jax_vjp(lambda a: J.softmax(a, 1), xj, gj)
    yt, dt = _torch_vjp(lambda a: P.softmax(a, 1), xt, gt)
    _close_fwd(yt, yj, dtype)
    _close_grad(dt, dj, dtype)


def test_whitening_metric():
    x, _ = _inputs(shape=(50, 16), seed=4)
    for groups in (1, 4):
        want = jax.jit(J.whitening_metric, static_argnums=1)(jnp.asarray(x), groups)
        got = P.whitening_metric(torch.from_numpy(x), groups)
        _close_fwd(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["below", "above"])
def test_whiten(dtype, side):
    x, g = _inputs(shape=(50, 16), seed=5)
    metric = float(J.whitening_metric(jnp.asarray(x), 2))
    limit = metric * (0.5 if side == "below" else 2.0)
    (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
    yj, dj = _jax_vjp(lambda a: J.whiten(a, 2, limit, 0.1), xj, gj)
    yt, dt = _torch_vjp(lambda a: P.whiten(a, 2, limit, 0.1), xt, gt)
    np.testing.assert_array_equal(_np(yt), _np(yj))
    if side == "above":  # no penalty: the gradient passes as it is
        np.testing.assert_array_equal(_np(dt), _np(gt))
    else:
        assert not np.array_equal(_np(dt), _np(gt))
    _close_grad(dt, dj, dtype)


def test_max_eig():
    x, g = _inputs(shape=(40, 12), seed=6)
    direction = np.random.RandomState(7).randn(12).astype(np.float32)
    want = jax.jit(J.max_eig_direction_update)(jnp.asarray(x), jnp.asarray(direction))
    got = P.max_eig_direction_update(torch.from_numpy(x), torch.from_numpy(direction))
    for a, b in zip(got, want):
        _close_fwd(a, b, "float32")
    coeffs, new_dir = want[0], want[1]
    yj, dj = _jax_vjp(lambda a, c, d: J.max_eig_limit(a, c, d, -1, 0.1), jnp.asarray(x),
                      coeffs, new_dir, jnp.asarray(g))
    yt, dt = _torch_vjp(lambda a: P.max_eig_limit(a, got[0], got[1], -1, 0.1),
                        torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt), _np(yj))
    _close_grad(dt, dj, "float32")


def test_penalize_abs_values_gt():
    x, g = _inputs(seed=8)
    yj, dj = _jax_vjp(lambda a: J.penalize_abs_values_gt(a, 1.5, 0.3), jnp.asarray(x),
                      jnp.asarray(g))
    yt, dt = _torch_vjp(lambda a: P.penalize_abs_values_gt(a, 1.5, 0.3), torch.from_numpy(x),
                        torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt), _np(yj))
    _close_grad(dt, dj, "float32")


def test_scaled_init():
    want = J.scaled_init(jax.nn.initializers.ones, 0.01)(jax.random.PRNGKey(0), (3, 4))
    got = P.scaled_init(nn.init.ones_, 0.01)(torch.empty(3, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reflect", [0.0, 0.1])
def test_random_clamp_core_on_injected_mask(reflect):
    x, g = _inputs(seed=9)
    mask = np.random.RandomState(10).rand(*x.shape) < 0.5
    yj, dj = _jax_vjp(lambda a, m: J._random_clamp_core(a, m, -0.5, 0.8, reflect),
                      jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    yt, dt = _torch_vjp(lambda a: P.random_clamp_core(a, torch.from_numpy(mask), -0.5, 0.8,
                                                      reflect),
                        torch.from_numpy(x), torch.from_numpy(g))
    if reflect == 0.0:
        np.testing.assert_array_equal(_np(yt), _np(yj))
        np.testing.assert_array_equal(_np(dt), _np(dj))
    else:
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2 ** -22, atol=0)
        np.testing.assert_allclose(_np(dt), _np(dj), rtol=2 ** -22, atol=0)


def test_random_clamp_from_generator():
    n, prob = 20000, 0.3
    x = torch.full((n,), 2.0)
    y = P.random_clamp(x, torch.Generator().manual_seed(0), max=1.0, prob=prob)
    share = float((y == 1.0).float().mean())
    assert abs(share - prob) <= 4 * np.sqrt(prob * (1 - prob) / n), share
    again = P.random_clamp(x, torch.Generator().manual_seed(0), max=1.0, prob=prob)
    assert torch.equal(y, again)


def test_random_cast_to_half():
    rng = np.random.RandomState(11)
    x = (rng.randn(4000) * 4e-6).astype(np.float32)  # most below min_abs 5e-6
    key = jax.random.PRNGKey(3)
    draws = np.asarray(jax.random.uniform(key, x.shape))
    want = jax.jit(J.random_cast_to_half)(jnp.asarray(x), key)
    got = P.random_cast_to_half(torch.from_numpy(x), rand=torch.from_numpy(draws))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # from a generator it keeps the mean: sum of 20 draws of x against 20 x
    big = torch.from_numpy(np.tile(x, 20))
    cast = P.random_cast_to_half(big, torch.Generator().manual_seed(0)).double()
    sd = float(np.sqrt((5e-6 * np.abs(x) - x ** 2).clip(min=0).sum() * 20))
    assert abs(float(cast.sum() - big.double().sum())) <= 4 * sd


def test_random_grad():
    x, _ = _inputs(seed=12)
    g = (np.random.RandomState(13).randn(*x.shape) * 4e-6).astype(np.float16)
    key = jax.random.PRNGKey(5)
    draws = np.asarray(jax.random.uniform(key, x.shape))
    xj = jnp.asarray(x, jnp.float16)
    yj, dj = _jax_vjp(lambda a, k: J.random_grad(a, k), xj, key, jnp.asarray(g))
    yt, dt = _torch_vjp(lambda a: P.random_grad(a, rand=torch.from_numpy(draws)),
                        torch.from_numpy(x).half(), torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(dt), _np(dj))
    # f32 gradients pass as they are
    _, d32 = _torch_vjp(lambda a: P.random_grad(a), torch.from_numpy(x),
                        torch.from_numpy(g.astype(np.float32)))
    np.testing.assert_array_equal(d32.numpy(), g.astype(np.float32))


@pytest.mark.parametrize("kind", ["linear", "conv_stride1", "conv_stride2"])
def test_spectral_reparam_modules(kind):
    rng = np.random.RandomState(14)
    if kind == "linear":
        jmod, pmod = J.SRLinear(12, 10), P.SRLinear(12, 10)
        x = rng.randn(3, 5, 12).astype(np.float32)
    else:
        stride = 1 if kind == "conv_stride1" else 2
        jmod, pmod = (J.SRConv1d(6, 8, 3, stride=stride),
                      P.SRConv1d(6, 8, 3, stride=stride))
        x = rng.randn(2, 6, 11).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree.map(np.array, variables)
    variables["params"]["sigma"] = np.array([1.7], np.float32)
    variables["params"]["bias"] = rng.randn(*variables["params"]["bias"].shape).astype(
        np.float32)

    def run(params, spectral, xx):
        def f(p):
            y, upd = jmod.apply({"params": p, "spectral": spectral}, xx, mutable=["spectral"])
            return jnp.sum(y * jnp.cos(y)), (y, upd["spectral"]["u"])
        (_, (y, u)), grads = jax.value_and_grad(f, has_aux=True)(params)
        return y, u, grads

    y, u_new, grads = jax.jit(run)(variables["params"], variables["spectral"], jnp.asarray(x))
    pmod.load_state_dict(sr_state_dict_from_jax(variables, device="cpu"))
    pmod.train()
    yt = pmod(torch.from_numpy(x))
    (yt * torch.cos(yt)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))
    np.testing.assert_allclose(pmod.u.numpy(), np.asarray(u_new), rtol=1e-5, atol=1e-6)
    for name in ("weight", "sigma", "bias"):
        _close_grad(getattr(pmod, name).grad, grads[name], "float32")
    # eval mode leaves u alone
    before = pmod.u.clone()
    pmod.eval()
    with torch.no_grad():
        pmod(torch.from_numpy(x))
    assert torch.equal(pmod.u, before)
