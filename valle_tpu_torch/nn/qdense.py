"""Dense layer: the twin of ``valle_tpu/nn/qdense.py``, float path only.

The JAX module also serves int8 weight-quantized kernels and a W8A8 path;
those wait for a later slice of the port, and ``act_quant=True`` raises here.
Weights use PyTorch's (out, in) layout and the reference's parameter names.
"""

from __future__ import annotations

from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` with the JAX ``Dense``'s constructor surface."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 act_quant: bool = False):
        if act_quant:
            raise NotImplementedError(
                "act_quant (W8A8) is not ported yet; only the float path is"
            )
        super().__init__(in_features, features, bias=use_bias)
