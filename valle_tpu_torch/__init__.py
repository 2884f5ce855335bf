"""valle_tpu_torch: the PyTorch/CUDA port of tpu-valle for NVIDIA Hopper.

The JAX package ``valle_tpu`` is the reference this port is held against;
each module here mirrors the module of the same path there.  The port never
imports JAX or ``valle_tpu``: it keeps its own copy of what it needs.

Entry points (``models.get_model``, ``sample.generate``, the weight bridge in
``utils.bridge``) put tensors on ``cuda`` unless the caller passes
``device="cpu"``, and raise when CUDA is missing and no device was given.
"""

__version__ = "0.1.0"
