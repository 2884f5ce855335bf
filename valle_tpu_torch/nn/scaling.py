"""The icefall / Zipformer training-stability toolkit: the twin of
``valle_tpu/nn/scaling.py``.

Each ``jax.custom_vjp`` of the JAX module is a ``torch.autograd.Function``
here with the same forward and backward:

  - ``activation_balancer``: identity forward; the backward nudges the
    gradient towards balanced per-channel sign proportions and magnitudes;
  - ``double_swish``: x * sigmoid(x - 1) with its analytic derivative;
  - ``whiten``: identity forward; the backward adds the gradient of
    relu(whitening_metric - limit), rescaled to grad_scale * |g|;
  - ``max_eig_limit``: identity forward; the backward adds the gradient of
    the variance share of a power-iteration direction;
  - ``softmax``: the backward in f32;
  - ``penalize_abs_values_gt``, ``random_clamp`` and ``random_grad``.

The plain functions come across too: ``balanced_double_swish``,
``whitening_metric``, ``max_eig_direction_update``, ``basic_norm``,
``scaled_init`` and ``random_cast_to_half``, and the spectral-reparametrised
layers ``SRLinear`` / ``SRConv1d`` as modules.

Where JAX takes a ``jax.random`` key the port takes a CPU
``torch.Generator``, as its dropout does (``nn/dropout.py``): a seed drawn
from it seeds a generator on the tensor's device.  Each random op keeps a
core that takes the draws (``random_clamp_core`` the mask,
``random_cast_to_half`` and ``random_grad`` the uniform draws), as JAX's
``_random_clamp_core`` does, so that a caller can inject them.

Two points where JAX's eval and train forwards differ are kept:

  - ``double_swish`` computes x * sigmoid(x - 1) in the input dtype when
    autograd does not record (JAX's primal), and in f32 rounded to the input
    dtype when it does (JAX's ``_dswish_fwd``, which a JAX gradient runs):
    the two differ in bf16 only;
  - ``softmax`` likewise: in the input dtype without autograd, in f32
    rounded to the input dtype with it.

Both follow ``jax.nn``'s formulas step by step (``_sigmoid``,
``_softmax_steps``), because ``torch.sigmoid`` and ``torch.softmax`` round a
bf16 input once where JAX rounds at each step.

``activation_balancer`` fires at every call and divides its gains by
``prob``, as JAX's does; the reference fires at random with probability
``prob`` (ROADMAP queue 3).

All of it is plain PyTorch: the JAX module computes in ``jnp`` outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from valle_tpu_torch.ops.philox import draw_seed


def _device_uniform(shape, device, rng: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) f32 draws on ``device``, from a generator there seeded by
    ``rng`` (a CPU generator; torch's default when None)."""
    gen = torch.Generator(device=device).manual_seed(draw_seed(rng))
    return torch.rand(shape, generator=gen, device=device)


# ----------------------------------------------------------- ActivationBalancer


def _compute_scale_factor(x, channel_dim, min_abs, max_abs, gain_factor, max_factor):
    dims = [d for d in range(x.dim()) if d != channel_dim]
    x_abs_mean = x.abs().mean(dim=dims).float()
    if min_abs == 0.0:
        below = 0.0
    else:
        below = ((min_abs - x_abs_mean) * (gain_factor / min_abs)).clamp(0, max_factor)
    above = ((x_abs_mean - max_abs) * (gain_factor / max_abs)).clamp(0, max_factor)
    return below - above


def _compute_sign_factor(x, channel_dim, min_positive, max_positive, gain_factor, max_factor):
    dims = [d for d in range(x.dim()) if d != channel_dim]
    proportion_positive = (x > 0).float().mean(dim=dims)
    factor1 = (((min_positive - proportion_positive) * (gain_factor / min_positive))
               .clamp(0, max_factor) if min_positive != 0.0 else 0.0)
    factor2 = (((proportion_positive - max_positive) * (gain_factor / (1.0 - max_positive)))
               .clamp(0, max_factor) if max_positive != 1.0 else 0.0)
    return factor1 - factor2


class _Balancer(torch.autograd.Function):
    """Identity; the backward subtracts |g| * factor, factor per channel."""

    @staticmethod
    def forward(ctx, x, scale_factor, sign_factor, channel_dim):
        ctx.channel_dim = channel_dim
        ctx.save_for_backward(x > 0, scale_factor,
                              *(() if sign_factor is None else (sign_factor,)))
        return x

    @staticmethod
    def backward(ctx, g):
        xgt0, scale_factor, *sign = ctx.saved_tensors
        shape = [1] * g.dim()
        shape[ctx.channel_dim] = g.shape[ctx.channel_dim]
        factor = scale_factor.reshape(shape) * (xgt0.to(g.dtype) - 0.5)
        if sign:
            factor = sign[0].reshape(shape) + factor
        return g - g.abs() * factor.to(g.dtype), None, None, None


def activation_balancer(x: torch.Tensor, *, channel_dim: int = -1, min_positive: float = 0.05,
                        max_positive: float = 0.95, max_factor: float = 0.04,
                        sign_gain_factor: float = 0.01, scale_gain_factor: float = 0.02,
                        min_abs: float = 0.2, max_abs: float = 100.0, prob: float = 1.0,
                        apply: bool = True) -> torch.Tensor:
    """Identity with gradient balancing.  ``prob`` divides the gains, as the
    reference divides them by its firing probability; ``apply=False`` is a
    pure no-op (eval), and so is a call that autograd does not record."""
    if not (apply and torch.is_grad_enabled() and x.requires_grad):
        return x
    if channel_dim < 0:
        channel_dim += x.dim()
    xd = x.detach()
    sign_factor = None
    if min_positive != 0.0 or max_positive != 1.0:
        sign_factor = _compute_sign_factor(xd, channel_dim, min_positive, max_positive,
                                           gain_factor=sign_gain_factor / prob,
                                           max_factor=max_factor)
    scale_factor = _compute_scale_factor(xd, channel_dim, min_abs, max_abs,
                                         gain_factor=scale_gain_factor / prob,
                                         max_factor=max_factor)
    return _Balancer.apply(x, scale_factor, sign_factor, channel_dim)


# ------------------------------------------------------------------ DoubleSwish


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-z)) step by step in z's dtype: ``jax.nn.sigmoid``'s
    formula, whose bf16 roundings ``torch.sigmoid`` does not make."""
    return 1.0 / (1.0 + torch.exp(-z))


class _DoubleSwish(torch.autograd.Function):
    """f32 forward rounded to the input dtype, saving the derivative in the
    input dtype (JAX's ``_dswish_fwd`` / ``_dswish_bwd``)."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        s = _sigmoid(xf - 1.0)
        y = xf * s
        ctx.save_for_backward((y * (1 - s) + s).to(x.dtype))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (deriv,) = ctx.saved_tensors
        return g * deriv


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x - 1): through the f32 autograd Function while autograd
    records, in the input dtype otherwise (module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _DoubleSwish.apply(x)
    return x * _sigmoid(x - 1.0)


def balanced_double_swish(x: torch.Tensor, *, channel_dim: int = -1, max_abs: float = 10.0,
                          prob: float = 0.25, apply: bool = True) -> torch.Tensor:
    """ActivationBalancer -> DoubleSwish."""
    x = activation_balancer(x, channel_dim=channel_dim, max_abs=max_abs, prob=prob, apply=apply)
    return double_swish(x)


# ---------------------------------------------------------------------- Whiten


def whitening_metric(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """1.0 when the covariance's eigenvalues are equal, larger otherwise."""
    x = x.reshape(-1, x.shape[-1]).float()
    num_frames, num_channels = x.shape
    cpg = num_channels // num_groups
    x = x.reshape(num_frames, num_groups, cpg).transpose(0, 1)
    x = x - x.mean(dim=1, keepdim=True)
    covar = torch.einsum("gtc,gtd->gcd", x, x)
    covar_mean_diag = torch.diagonal(covar, dim1=1, dim2=2).sum() / (num_groups * cpg)
    covarsq_mean_diag = (covar ** 2).sum() / (num_groups * cpg)
    return covarsq_mean_diag / (covar_mean_diag ** 2 + 1e-20)


def _penalty_grad(fn: Callable[[torch.Tensor], torch.Tensor], xd: torch.Tensor) -> torch.Tensor:
    """d fn / dx at the f32 copy of ``xd`` (JAX's ``jax.grad`` in a bwd rule)."""
    with torch.enable_grad():
        x32 = xd.detach().float().requires_grad_(True)
        return torch.autograd.grad(fn(x32), x32)[0]


def _added_gradient(g: torch.Tensor, pgrad: torch.Tensor, grad_scale: float) -> torch.Tensor:
    """g + pgrad rescaled to grad_scale * |g|."""
    scale = grad_scale * (g.float().reshape(-1).norm() / (pgrad.reshape(-1).norm() + 1e-20))
    return g + (pgrad * scale).to(g.dtype)


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_groups, whitening_limit, grad_scale):
        ctx.args = (num_groups, whitening_limit, grad_scale)
        ctx.save_for_backward(x.detach())
        return x

    @staticmethod
    def backward(ctx, g):
        num_groups, whitening_limit, grad_scale = ctx.args
        (xd,) = ctx.saved_tensors
        pgrad = _penalty_grad(
            lambda x32: F.relu(whitening_metric(x32, num_groups) - whitening_limit), xd)
        return _added_gradient(g, pgrad, grad_scale), None, None, None


def whiten(x: torch.Tensor, num_groups: int, whitening_limit: float,
           grad_scale: float) -> torch.Tensor:
    """Identity forward; the backward adds a whitening penalty's gradient."""
    return _Whiten.apply(x, num_groups, whitening_limit, grad_scale)


# ---------------------------------------------------------------------- MaxEig


def max_eig_direction_update(x: torch.Tensor, direction: torch.Tensor, channel_dim: int = -1
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One power-iteration step; returns (coeffs, new_direction,
    variance_proportion)."""
    nc = x.shape[channel_dim]
    x = torch.movedim(x, channel_dim, -1).reshape(-1, nc).float()
    x = x - x.mean(dim=0)
    direction = direction / (direction.norm() + 1e-20)
    coeffs = (x @ direction)[:, None]
    new_direction = (x * coeffs).sum(dim=0) / ((coeffs ** 2).sum() + 1e-20)
    x_var = (x ** 2).mean()
    x_residual = x - coeffs * new_direction[None, :]
    variance_proportion = (x_var - (x_residual ** 2).mean()) / (x_var + 1e-20)
    return coeffs, new_direction, variance_proportion


class _MaxEigLimit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeffs, direction, channel_dim, grad_scale):
        ctx.args = (channel_dim, grad_scale)
        ctx.save_for_backward(x.detach(), coeffs.detach(), direction.detach())
        return x

    @staticmethod
    def backward(ctx, g):
        channel_dim, grad_scale = ctx.args
        xd, coeffs, direction = ctx.saved_tensors

        def variance_proportion(x):
            nc = x.shape[channel_dim]
            xf = torch.movedim(x, channel_dim, -1).reshape(-1, nc)
            xf = xf - xf.mean(dim=0)
            x_var = (xf ** 2).mean()
            x_residual = xf - coeffs * direction[None, :]
            return (x_var - (x_residual ** 2).mean()) / (x_var + 1e-20)

        pgrad = _penalty_grad(variance_proportion, xd)
        return _added_gradient(g, pgrad, grad_scale), None, None, None, None


def max_eig_limit(x: torch.Tensor, coeffs: torch.Tensor, direction: torch.Tensor,
                  channel_dim: int, grad_scale: float) -> torch.Tensor:
    """Identity forward; the backward pushes x away from the top eigen
    direction (``coeffs``, ``direction`` from ``max_eig_direction_update``)."""
    return _MaxEigLimit.apply(x, coeffs, direction, channel_dim, grad_scale)


# ------------------------------------------------------------------- BasicNorm


def basic_norm(x: torch.Tensor, eps_log: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """x * (mean(x^2) + exp(eps_log))^-0.5.  The mean is taken in x's dtype
    and the rest in f32, so the result is f32 (JAX promotes x with the f32
    ``eps_log``; torch would keep a bf16 x's dtype against a 0-dim eps)."""
    ms = (x * x).mean(dim=channel_dim, keepdim=True).float()
    scales = (ms + eps_log.float().exp()) ** -0.5
    return x.float() * scales


# --------------------------------------------------------------------- softmax


def _softmax_steps(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``'s steps: exp(x - max) in x's dtype over its sum
    taken in f32 and rounded to x's dtype."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.float().sum(dim=dim, keepdim=True).to(x.dtype)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ans = _softmax_steps(x.float(), dim)
        ctx.dim = dim
        ctx.save_for_backward(ans)
        return ans.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        xg = g.float() * ans
        xg = xg - ans * xg.sum(dim=ctx.dim, keepdim=True)
        return xg.to(g.dtype), None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax with an f32 backward (f32 forward too while autograd records,
    as JAX's fwd rule; module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Softmax.apply(x, dim)
    return _softmax_steps(x, dim)


# ---------------------------------------------------------------- misc helpers


class _PenalizeAbsValuesGt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.args = (limit, penalty)
        ctx.save_for_backward(x.detach())
        return x

    @staticmethod
    def backward(ctx, g):
        limit, penalty = ctx.args
        (xd,) = ctx.saved_tensors
        extra = torch.sign(xd) * (xd.abs() > limit).to(g.dtype) * penalty
        return g + extra, None, None


def penalize_abs_values_gt(x: torch.Tensor, limit: float, penalty: float) -> torch.Tensor:
    """Identity; the backward adds the gradient of penalty * sum(relu(|x| -
    limit))."""
    return _PenalizeAbsValuesGt.apply(x, limit, penalty)


def scaled_init(init_fn: Callable[[torch.Tensor], torch.Tensor], scale: float):
    """An in-place initialiser that runs ``init_fn`` and multiplies by
    ``scale`` (ScaledLinear / ScaledConv's initial scale)."""

    def f(tensor: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            init_fn(tensor)
            return tensor.mul_(scale)

    return f


# ------------------------------------------------------------- random_clamp


class _RandomClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, min_v, max_v, reflect):
        ans = torch.where(mask, x.clamp(min_v, max_v), x)
        ctx.reflect = reflect
        ctx.save_for_backward(ans == x)
        if reflect != 0.0:
            ans = ans * (1.0 + reflect) - x * reflect
        return ans

    @staticmethod
    def backward(ctx, g):
        (is_same,) = ctx.saved_tensors
        x_grad = g * is_same.to(g.dtype)
        if ctx.reflect != 0.0:
            x_grad = x_grad * (1.0 + ctx.reflect) - g * ctx.reflect
        return x_grad, None, None, None, None


def random_clamp_core(x: torch.Tensor, mask: torch.Tensor, min_v: float, max_v: float,
                      reflect: float) -> torch.Tensor:
    """Clamp where ``mask``; the gradient passes only where the output equals
    the input, with the ``reflect`` extrapolation (JAX's
    ``_random_clamp_core``)."""
    return _RandomClamp.apply(x, mask, min_v, max_v, reflect)


def random_clamp(x: torch.Tensor, rng: Optional[torch.Generator] = None, min=None, max=None,
                 prob: float = 0.5, reflect: float = 0.0) -> torch.Tensor:
    """Clamp each element to [min, max] with probability ``prob``, the mask
    drawn from ``rng`` (a CPU generator)."""
    min_v = -math.inf if min is None else min
    max_v = math.inf if max is None else max
    mask = _device_uniform(x.shape, x.device, rng) < prob
    return random_clamp_core(x, mask, min_v, max_v, reflect)


# -------------------------------------------------------------- RandomGrad


def random_cast_to_half(x: torch.Tensor, rng: Optional[torch.Generator] = None,
                        min_abs: float = 5.0e-06, rand: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Expectation-preserving cast to float16: an element with |x| < min_abs
    becomes +-min_abs with probability |x| / min_abs, else 0.  ``rand``: the
    U[0, 1) draws (x's shape), drawn from ``rng`` when None."""
    if rand is None:
        rand = _device_uniform(x.shape, x.device, rng)
    x_abs = x.abs()
    is_too_small = x_abs < min_abs
    random_val = min_abs * torch.sign(x) * (rand * min_abs < x_abs)
    return torch.where(is_too_small, random_val, x).to(torch.float16)


class _RandomGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng, rand, min_abs):
        ctx.rng, ctx.rand, ctx.min_abs = rng, rand, min_abs
        return x

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float16:
            g = random_cast_to_half(g.float(), ctx.rng, ctx.min_abs, ctx.rand)
        return g, None, None, None


def random_grad(x: torch.Tensor, rng: Optional[torch.Generator] = None,
                min_abs: float = 5.0e-06, rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Identity forward; a float16 gradient goes through
    ``random_cast_to_half`` (draws from ``rng`` at the backward, or
    ``rand``)."""
    return _RandomGrad.apply(x, rng, rand, min_abs)


# ------------------------------------------- SRLinear / SRConv1d (arXiv 2303.06296)


def _normed_randn(n: int) -> torch.Tensor:
    v = torch.randn(n, generator=torch.Generator().manual_seed(0))
    return v / v.norm().clamp(min=1e-12)


class _SpectralReparam(nn.Module):
    """``W_eff = (sigma / sigma_spectral(W)) * W`` with the spectral norm
    estimated by one power-iteration step per call from the buffer ``u``,
    which train mode updates (JAX updates its ``spectral`` collection when it
    is mutable).  Gradients reach ``W`` through the spectral estimate's final
    product only, as in JAX (u and v are detached)."""

    def __init__(self, out_features: int, flat_in: int, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, flat_in))
        nn.init.kaiming_uniform_(self.weight, nonlinearity="relu")  # flax's kaiming_uniform
        self.sigma = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.register_buffer("u", _normed_randn(flat_in))

    def effective_weight(self) -> torch.Tensor:
        w = self.weight
        with torch.no_grad():
            v = w @ self.u
            v = v / v.norm().clamp(min=1e-12)
            u_new = w.t() @ v
            u_new = u_new / u_new.norm().clamp(min=1e-12)
            if self.training:
                self.u.copy_(u_new)
        sigma = torch.einsum("c,cd,d->", v, w, u_new)
        return (self.sigma / sigma) * w


class SRLinear(_SpectralReparam):
    """Spectral-reparametrised linear layer.  Parameters ``weight`` (out, in),
    ``sigma`` (1,), ``bias`` (out,); buffer ``u`` (in,)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__(out_features, in_features, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.effective_weight().t()
        return y if self.bias is None else y + self.bias


class SRConv1d(_SpectralReparam):
    """Spectral-reparametrised 1-D convolution over (B, C, T).  Parameters
    ``weight`` (out, in * kernel_size), ``sigma``, ``bias``; buffer ``u``
    (in * kernel_size,).  ``padding`` is "SAME" or "VALID", as in
    ``lax.conv_general_dilated``."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int = 1,
                 padding: str = "SAME", use_bias: bool = True):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        super().__init__(out_features, in_features * kernel_size, use_bias)
        self.in_features, self.out_features = in_features, out_features
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        w = self.effective_weight().reshape(self.out_features, self.in_features, k)
        if self.padding == "SAME":
            t = x.shape[-1]
            total = max((-(-t // s) - 1) * s + k - t, 0)
            x = F.pad(x, (total // 2, total - total // 2))
        y = F.conv1d(x, w, stride=s)
        return y if self.bias is None else y + self.bias[None, :, None]
