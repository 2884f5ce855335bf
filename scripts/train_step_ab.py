#!/usr/bin/env python3
"""Time the port's full-width VALL-E training step in several checkouts of
the repo, one fresh process each, on one CUDA card.

    python3 scripts/train_step_ab.py PARENT . . PARENT [--steps N]

Give the checkouts in an order that cancels drift (parent, change, change,
parent).  Each process imports ``valle_tpu_torch`` from its checkout, builds
the kernels of the training path there, makes the default VALL-E
(d=1024, 16 heads, 12 + 12 layers, Q=8, f32, ``attn_impl="fused"``, dropout
0.1) from seed 0, and runs 2 warm-up steps and N timed steps (default 10)
on one random batch of the train shapes of ``chip_smoke.py`` (A=2
micro-batches of B=4; text 96-128 of S=128 tokens; audio 601-752 of T=752
frames), with ScaledAdam (lr 0.05, clipping 2.0, betas (0.9, 0.95)) and Eden
(warm-up 200).  It then counts the device operations (kernels, copies,
fills) of one more step under ``torch.profiler``.  Prints one JSON line per
checkout, then one with the medians per checkout and the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import functools, json, sys, time
import numpy as np
import torch
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
from valle_tpu_torch.train.step import init_train_state, make_train_step

steps = int(sys.argv[1])
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build(["prefix_attention", "prefix_attention_bwd"])
cfg = ModelConfig(attn_impl="fused")
torch.manual_seed(0)
model = get_model(cfg)
rng = np.random.RandomState(5)
a, b, s, t = 2, 4, 128, 752
x_lens = rng.randint(3 * s // 4, s + 1, (a, b))
y_lens = rng.randint(int(0.8 * t), t + 1, (a, b))
x_lens[:, 0], y_lens[:, 0] = s, t
arrays = {"text_tokens": rng.randint(1, cfg.num_text_tokens, (a, b, s)),
          "text_tokens_lens": x_lens,
          "audio_features": rng.randint(0, cfg.num_audio_tokens, (a, b, t, cfg.num_quantizers)),
          "audio_features_lens": y_lens}
batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
state = init_train_state(model, functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0,
                                                  betas=(0.9, 0.95)))
step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200))
gen = torch.Generator().manual_seed(0)
for _ in range(2):
    state, _ = step(state, batch, gen, 0)
torch.cuda.synchronize()
times, losses = [], []
for _ in range(steps):
    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen, 0)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    losses.append(float(metrics["loss"]))
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    step(state, batch, gen, 0)
    torch.cuda.synchronize()
ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps({"step_s": times, "step_s_median": float(np.median(times)),
                  "losses": losses, "device_ops_per_step": ops}))
"""


def main() -> int:
    args = sys.argv[1:]
    steps = 10
    if "--steps" in args:
        i = args.index("--steps")
        steps = int(args[i + 1])
        del args[i:i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    medians = {}
    for i, root in enumerate(args):
        root = str(Path(root).resolve())
        run = subprocess.run([sys.executable, "-c", CHILD, str(steps)], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        result = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "root": root, **result}), flush=True)
        medians.setdefault(root, []).append(result["step_s_median"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"medians_by_root": medians, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
