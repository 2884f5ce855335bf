#!/usr/bin/env python3
"""Reproduce the deadlock of Pallas's TPU interpret mode that the port's
test files guard against (``tests/test_torch_stall_guard.py``), on the CPU.

    python3 scripts/stall_repro.py --iterations 12 [--jit]

Loops the two interpret-mode calls that ``tests/test_torch_transformer_tts.py``
once made op by op (the ``"flash"`` value-and-grad and the greedy inference
of its tiny model), called op by op or each under one ``jax.jit``, and prints
one line per call.  A process that stalls prints every thread's stack after
``--limit`` seconds and exits 1.  Start several at once, from the repo's
root, to load the CPU as xdist does.
"""

import argparse
import faulthandler
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _reproduce(iterations: int, jit: bool, limit: float) -> None:
    import tests.conftest  # noqa: F401  (JAX on the CPU)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental.pallas import tpu as pltpu

    from tests.test_torch_transformer_tts import KW, STEPS, _data
    from valle_tpu.models import ModelConfig, TransformerTTS

    data = tuple(jnp.asarray(a) for a in _data())
    variables = jax.tree.map(np.array, TransformerTTS(ModelConfig(**KW)).init(  # as the test had
        {"params": jax.random.PRNGKey(0)}, *data, deterministic=True))
    model = TransformerTTS(ModelConfig(attn_impl="flash", **KW))

    def grad(params):
        return jax.value_and_grad(
            lambda p: model.apply({"params": p}, *data, deterministic=True)["loss"])(params)

    def infer(v):
        return model.apply(v, data[0], data[1], max_steps=STEPS, method="inference")["mel"]

    if jit:
        grad, infer = jax.jit(grad), jax.jit(infer)
    calls = {"grad": lambda: float(grad(variables["params"])[0]),
             "inference": lambda: np.asarray(infer(variables))}
    for i in range(iterations):
        for name, call in calls.items():
            faulthandler.dump_traceback_later(limit, exit=True)
            t0 = time.perf_counter()
            with pltpu.force_tpu_interpret_mode():
                call()
            faulthandler.cancel_dump_traceback_later()
            print(f"pid {os.getpid()} iteration {i} {name} {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(f"pid {os.getpid()} done", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=12)
    parser.add_argument("--jit", action="store_true", help="each call under one jax.jit")
    parser.add_argument("--limit", type=float, default=400.0, help="seconds per call")
    args = parser.parse_args()
    _reproduce(args.iterations, args.jit, args.limit)
