#!/usr/bin/env python3
"""How far int8 weights move the full-width VALL-E's prefill logits, in the
JAX package and in the port, on the CPU.

    python3 scripts/quant_logit_error.py [--dtype bfloat16] [--batch 2]

Initialises the default ``ModelConfig`` (d=1024, 16 heads, 12 + 12 layers)
with JAX, bridges the weights into the port (``utils/bridge.py``), and runs
the AR prefill of seeded requests (text 64 tokens, prompts of 225 frames)
unquantized, W8 and W8A8 through both packages (JAX's ``quantize_variables``
and ``Dense``; the port's ``get_model(..., quantize=True)``).  Prints one
JSON line: for each package and mode the largest logit difference from the
same package's unquantized logits over the largest of those, and the port's
distance from JAX in each mode.  ``tests/test_quantize.py`` bounds ONE
Dense layer at 0.01 (W8) and 0.02 (W8A8); this shows what the whole model
gives.  Takes about 2 minutes and 6 GB.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import tests.conftest  # noqa: F401  (JAX on the CPU)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from valle_tpu.models import VALLE as JaxVALLE
    from valle_tpu.models import ModelConfig as JaxConfig
    from valle_tpu.nn.qdense import quantize_variables
    from valle_tpu.sample import _prefill_kv as jax_prefill_kv
    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.sample import _prefill_kv
    from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax

    rng = np.random.RandomState(args.seed)
    b, s, p_len = args.batch, 64, 225
    inputs = (rng.randint(1, 512, (b, s)).astype(np.int32),
              rng.randint(40, s + 1, b).astype(np.int32),
              rng.randint(0, 1024, (b, p_len, 8)).astype(np.int32),
              rng.randint(150, p_len + 1, b).astype(np.int32))
    model = JaxVALLE(JaxConfig())
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, *map(jnp.asarray, inputs), train_stage=0,
        deterministic=True, nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(args.seed))
    variables = jax.tree.map(np.asarray, variables)
    quantized = jax.tree.map(np.asarray, jax.jit(quantize_variables)(variables))
    sd = {k: torch.from_numpy(v) for k, v in
          numpy_state_dict_from_jax(variables, ModelConfig(), "valle").items()}
    logits = {}
    for mode in ("none", "w8", "w8a8"):
        act_quant = mode == "w8a8"
        jmodel = JaxVALLE(JaxConfig(dtype=args.dtype, act_quant=act_quant))
        out = jax.jit(lambda v, *a: jax_prefill_kv(jmodel, v, *a)[0])(
            variables if mode == "none" else quantized, *map(jnp.asarray, inputs))
        logits["jax", mode] = np.asarray(out.astype(jnp.float32))
        port = get_model(ModelConfig(dtype=args.dtype, act_quant=act_quant), device="cpu",
                         state_dict=sd, quantize=mode != "none")
        with torch.inference_mode():
            out = _prefill_kv(port, *(torch.from_numpy(a).long() for a in inputs))[0]
        logits["port", mode] = out.float().numpy()
        del port
    rel = lambda a, ref: float(np.abs(a - ref).max() / np.abs(ref).max())  # noqa: E731
    print(json.dumps({
        "dtype": args.dtype, "batch": b,
        "rel_err_vs_unquantized": {f"{side} {mode}": rel(logits[side, mode], logits[side, "none"])
                                   for side in ("jax", "port") for mode in ("w8", "w8a8")},
        "port_vs_jax": {mode: rel(logits["port", mode], logits["jax", mode])
                        for mode in ("none", "w8", "w8a8")}}))


if __name__ == "__main__":
    main()
