"""Dense layer with int8 weights (serving): the twin of ``valle_tpu/nn/qdense.py``.

  - :class:`Dense` is ``nn.Linear`` with the JAX ``Dense``'s surface: a
    compute ``dtype`` that input, weight and bias are cast to (flax's
    ``promote_dtype``), and an optional quantized state, an int8 ``weight``
    buffer with f32 per-output-row scales ``weight_scale``.  Quantized, it
    computes ``(x @ int8_weight) * scale + bias`` (W8), or with
    ``act_quant=True`` quantizes the activations per row at run time and
    multiplies int8 by int8 with int32 sums (W8A8).  Unquantized,
    ``act_quant`` changes nothing, as in JAX.
  - :func:`quantize_variables` turns the selected weights of a model, in
    place, into that state (per-output-row symmetric int8), with JAX's
    ``DEFAULT_TARGETS`` and ``scopes``.

Weights use PyTorch's (out, in) layout, so a scale belongs to a weight ROW.
The JAX targets ``in_proj`` (self-attention) and ``q_proj`` / ``kv_proj``
(cross-attention) are the port's packed ``in_proj_weight`` of
``MultiheadAttention``; quantization is per row, so the packed weight's
scales are JAX's q_proj and kv_proj scales concatenated.

Scales stay f32 whatever the model's compute dtype (flax keeps the
``qscale`` collection apart from the compute dtype): ``Module.to(dtype)``
casts them back after the cast, and int8 tensors are never cast.  Quantize
from the f32 weights, before the model is cast for compute
(``models.get_model(..., quantize=True)`` does it in that order).

Under tensor parallelism (``parallel/mesh.py``) a ``Dense`` keeps a slice
of its output rows (``shard_outputs_``, with their scales and bias) or of
its input columns (``shard_inputs_``): then its products are partial sums,
added over the model group before the scale and the bias, and under W8A8
the per-row activation amax is taken over the whole input width (a MAX over
the group) before the rounding, so the int8 values and the int32 sums are
those of the unsharded layer.

The int8 x int8 product is a plain matrix product, which the JAX package
leaves to XLA outside any Pallas kernel.  On the card it is
``torch._int_mm`` (cuBLASLt, int8 tensor cores), with its shape rules met
by zero padding inside :func:`int8_matmul`; on the CPU its plain version
sums in f64, which is exact for int8 products over K <= 2^38.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from valle_tpu_torch.parallel import dist

# Module names whose weight is quantized by default: the decoder stacks'
# projections and FFN and the AR prediction head.  Embedding tables and the
# AdaLN projections stay in the model dtype.
DEFAULT_TARGETS = (
    "in_proj",
    "q_proj",
    "kv_proj",
    "out_proj",
    "linear1",
    "linear2",
    "ar_predict_layer",
)
SCALE_SUFFIX = "_scale"
# torch._int_mm on CUDA takes more than 16 rows and inner and output sizes
# that are multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8
INV_127 = 1.0 / 127.0  # XLA's rewrite of "/ 127" (torch rounds the scalar to f32)


def _quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Out, In) -> (int8 weight, (..., Out) f32 per-row scale).

    The JAX function on the transposed layout: amax per output row in f32,
    ``scale = max(amax, 1e-8) / 127``, round half to even (``torch.round``
    rounds like ``jnp.round``), clip to +-127.  The division by 127 is a
    product with the f32 reciprocal, as XLA compiles it under ``jit`` (the
    JAX CLIs quantize under ``jit``)."""
    w = weight.detach().float()
    scale = w.abs().amax(dim=-1).clamp(min=1e-8) * INV_127
    q = torch.round(w / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def int_mm_reference(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Plain version of ``torch._int_mm``: (M, K) int8 x (K, N) int8 ->
    (M, N) int32, exact (f64 sums of int8 products are exact)."""
    return (a8.double() @ b8.double()).to(torch.int32)


def _padded_int_mm(a8: torch.Tensor, w8: torch.Tensor, int_mm) -> torch.Tensor:
    """``a8 @ w8.T`` through ``int_mm`` (``torch._int_mm``'s signature), with
    rows padded to more than 16 and K and N to multiples of 8 by zeros, which
    add nothing to the sums; the result is sliced back to (M, N)."""
    m, k = a8.shape
    n = w8.shape[0]
    up = lambda v: -(-v // INT_MM_MULTIPLE) * INT_MM_MULTIPLE  # noqa: E731
    mp = up(max(m, INT_MM_MIN_ROWS))
    kp, np_ = up(k), up(n)
    if (mp, kp) != (m, k):
        a8 = F.pad(a8, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w8 = F.pad(w8, (0, kp - k, 0, np_ - n))
    return int_mm(a8, w8.t())[:m, :n]


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 activations x (N, K) int8 weight -> (M, N) int32 sums:
    ``torch._int_mm`` on a CUDA tensor (counted in ``int8_matmul.launches``),
    the plain version on a CPU one."""
    if not a8.is_cuda:
        return int_mm_reference(a8, w8.t())
    out = _padded_int_mm(a8, w8, torch._int_mm)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def _w8a8_matmul(x, w8, w_scale, out_dtype, group=None):
    """Dynamic per-row activation quantization + int8 x int8 product.

    x: (..., In) float; w8: (Out, In) int8; w_scale: (Out,) f32.  The JAX
    function's arithmetic in its order, as compiled under ``jit``.  With a
    ``group`` x and w8 hold this rank's slice of the input width: the row
    amax is the MAX over the group and the int32 sums are added over it
    before the scales."""
    xf = x.float()
    amax = dist.all_reduce_(xf.abs().amax(dim=-1, keepdim=True), "max", group)
    xs = amax.clamp(min=1e-8) * INV_127
    x8 = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    y = int8_matmul(x8.reshape(-1, x8.shape[-1]), w8)
    y = dist.all_reduce_(y, "sum", group).reshape(*x.shape[:-1], w8.shape[0])
    return (y.float() * xs * w_scale).to(out_dtype)


def linear(x, weight, bias=None, scale=None, act_quant: bool = False, dtype=None, group=None):
    """The JAX ``Dense``'s product.  ``dtype``: the compute dtype that x,
    the weight and the bias are cast to (None: x's own, and a float weight
    is used as it is).  ``scale`` given: ``weight`` is int8 and the product
    is W8 (``x @ w8.to(x.dtype)``, times the scale cast to x's dtype) or,
    with ``act_quant``, W8A8.  ``group``: x and the weight hold this rank's
    slice of the input width (row parallel); the partial products are summed
    over the group before the scale and the bias."""
    # the casts are made only where the dtypes differ: each is a launch, and
    # decoding calls this a few hundred times per step
    if dtype is not None and x.dtype != dtype:
        x = x.to(dtype)
    if scale is None:
        if dtype is not None and weight.dtype != dtype:  # e.g. tied to an f32 embedding
            weight = weight.to(dtype)
        if dtype is not None and bias is not None and bias.dtype != dtype:
            bias = bias.to(dtype)
        if group is None:
            return F.linear(x, weight, bias)
        y = dist.all_reduce_(F.linear(x, weight), "sum", group)
    elif act_quant:
        y = _w8a8_matmul(x, weight, scale, x.dtype, group)
    else:
        y = dist.all_reduce_(F.linear(x, weight.to(x.dtype)), "sum", group) * scale.to(x.dtype)
    if bias is not None:
        y = y + (bias if bias.dtype == y.dtype else bias.to(y.dtype))
    return y


def select_(module: nn.Module, name: str, dim: int, index: torch.Tensor) -> None:
    """Keep entries ``index`` of the parameter or buffer ``name`` of
    ``module`` along ``dim``, in place (a missing one stays None)."""
    t = getattr(module, name)
    if t is None:
        return
    part = t.detach().index_select(dim, index.to(t.device)).contiguous()
    if name in module._parameters:
        module._parameters[name] = nn.Parameter(part, requires_grad=t.requires_grad)
    else:
        module._buffers[name] = part


def shard_range(n: int, index: int, size: int) -> torch.Tensor:
    """Entries ``[index n / size, (index + 1) n / size)``; ``n`` must divide
    by ``size``."""
    if n % size:
        raise ValueError(f"{n} does not split over {size} model shards")
    k = n // size
    return torch.arange(index * k, (index + 1) * k)


def quantize_weight_(module: nn.Module, name: str) -> None:
    """Replace the float parameter ``name`` of ``module`` by an int8 buffer
    of the same name and its f32 row scales ``name + "_scale"``."""
    q, scale = _quantize_kernel(getattr(module, name))
    delattr(module, name)
    module.register_buffer(name, q)
    module.register_buffer(name + SCALE_SUFFIX, scale)


class Int8Weights:
    """Mixin of the modules whose weights may be int8 (``Dense``,
    ``MultiheadAttention``): keeps their scales f32 through
    ``Module.to(dtype)``, and takes an int8 weight and its scale from a
    state dict that has them (``utils/bridge.py`` of a quantized JAX tree),
    as the JAX layer takes them from the bound ``qscale`` collection."""

    quantizable: Tuple[str, ...] = ()

    def _apply(self, fn, recurse=True):
        scales = {k: v for k, v in self._buffers.items()
                  if k.endswith(SCALE_SUFFIX) and v is not None}
        super()._apply(fn, recurse)
        for k, v in scales.items():  # moved by fn, but never cast
            self._buffers[k] = v.to(self._buffers[k].device)
        return self

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in self.quantizable:
            in_dict = prefix + name + SCALE_SUFFIX in state_dict
            quantized = getattr(self, name + SCALE_SUFFIX) is not None
            if in_dict and not quantized:
                quantize_weight_(self, name)  # its values come from the dict next
            elif quantized and not in_dict:
                raise ValueError(f"{prefix}{name} is int8 here, but the state dict has no "
                                 f"{prefix}{name}{SCALE_SUFFIX}")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Dense(Int8Weights, nn.Linear):
    """``nn.Linear`` with the JAX ``Dense``'s surface (module docstring)."""

    quantizable = ("weight",)

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 act_quant: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, features, bias=use_bias)
        self.act_quant = act_quant
        self.compute_dtype = dtype
        self.tp_group = None  # set by shard_inputs_: the group of the partial sums
        self.register_buffer("weight_scale", None)

    def shard_outputs_(self, index: int, size: int) -> None:
        """Column parallel: keep output features ``index`` of ``size`` equal
        parts, with their bias and scales."""
        rows = shard_range(self.out_features, index, size)
        for name in ("weight", "bias", "weight_scale"):
            select_(self, name, 0, rows)
        self.out_features = len(rows)

    def shard_inputs_(self, index: int, size: int, group) -> None:
        """Row parallel: keep input features ``index`` of ``size`` equal
        parts; the partial outputs are summed over ``group`` before the
        scales and the bias, which stay whole."""
        select_(self, "weight", 1, shard_range(self.in_features, index, size))
        self.in_features //= size
        self.tp_group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.weight_scale, self.act_quant,
                      self.compute_dtype, self.tp_group)


def quantize_variables(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS,
                       scopes: Optional[Sequence[str]] = None) -> nn.Module:
    """Quantize the selected float weights of ``model`` to int8, in place.

    targets: JAX module names whose kernel is quantized: a ``Dense`` of that
      name, and ``in_proj`` / ``q_proj`` + ``kv_proj`` for the packed
      in-projection of a self- / cross-attention (q_proj and kv_proj share
      one weight here, so a cross-attention takes both or neither).
    scopes: if given, only modules whose dotted path has one of these
      components are touched (e.g. ``("nar_decoder",)``).

    Returns the model."""
    for path, mod in list(model.named_modules()):
        parts = path.split(".")
        if scopes is not None and not any(s in parts for s in scopes):
            continue
        if isinstance(mod, Dense) and parts[-1] in targets and mod.weight_scale is None:
            quantize_weight_(mod, "weight")
        elif isinstance(mod, Int8Weights) and "in_proj_weight" in mod.quantizable:
            names = ("q_proj", "kv_proj") if mod.cross_attention else ("in_proj",)
            picked = [n in targets for n in names]
            if any(picked) and not all(picked):
                raise ValueError(f"{path}: q_proj and kv_proj are one packed weight here; "
                                 "target both or neither")
            if all(picked) and mod.in_proj_weight_scale is None:
                quantize_weight_(mod, "in_proj_weight")
    return model
