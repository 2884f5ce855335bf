#!/usr/bin/env python3
"""Time kernel 1 (ragged decode attention) and the decode loop of
``generate`` in several checkouts of the repo, one fresh process each, on one
CUDA card.

    python3 scripts/ragged_ab.py PARENT . . PARENT [--decode-only]

Give the checkouts in an order that cancels drift (parent, change, change,
parent).  Each process imports ``valle_tpu_torch`` and ``chip_smoke`` (for
its timers) from its checkout, builds kernel 1 there, and times, on inputs
made here from one seed:

- kernel 1 at the cases of ``chip_smoke.py``'s phase 3: int8, f32 and bf16
  caches at B=8, C=1024 (3,583 live columns), the generate shapes (int8,
  B=8 and B=1, C=768, 673 live columns, two finished slots at B=8), a long
  int8 cache (B=1, C=40,000) and head dims 48 and 96; a case that a
  checkout's wrapper refuses (the parent caps C at 32,768 and Dh at
  {16, 32, 64, 128}) is recorded as null;
- one full-width VALL-E ``generate`` (the default ModelConfig, int8 cache,
  ``ragged_decode=True``, 8 requests, 384 new frames, greedy) as
  ``chip_smoke.py`` drives it: the decode ms per step (the call's wall time
  less the prefill and NAR passes, over the steps) and, from
  ``torch.profiler``, kernel 1's device ms over the whole call.

``--decode-only`` skips the kernel cases and the profile and times three
``generate`` calls instead of one (decode ms per step: their median, and
each), for a quick check of the decode loop's host cost.

Each kernel time is the CUDA-event median of 5 windows of back-to-back calls
and the device time per call (every kernel whose name holds
``ragged_decode``), as ``chip_smoke.py`` takes them.  Prints one JSON line
per checkout, then one with each case's device ms per checkout in the order
given, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import numpy as np
import torch
DECODE_ONLY = "--decode-only" in sys.argv
sys.path.insert(0, ".")
import chip_smoke as cs
from valle_tpu_torch.nn.attention import quantize_kv
from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops.ragged_decode import ragged_decode_attention

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build(["ragged_decode", "prefix_attention"])
P3 = [0, 1024, 517, 300, 1, 777, 64, 900]
GEN = [673, 0, 673, 673, 0, 673, 673, 673]
cases = [("phase3", 8, 1024, 16, 64, P3, c) for c in ("int8", "float32", "bfloat16")]
cases += [("generate B=8", 8, 768, 16, 64, GEN, "int8"), ("generate B=1", 1, 768, 16, 64, [673], "int8"),
          ("long cache B=1", 1, 40000, 16, 64, [40000], "int8")]
cases += [(f"dh {dh}", 8, 1024, h, dh, P3, c) for h, dh in ((16, 48), (8, 96))
          for c in ("int8", "float32", "bfloat16")]
if DECODE_ONLY:
    cases = []
rng = np.random.RandomState(0)
res = {}
for name, b, c, h, dh, lens, cache in cases:
    qf = torch.from_numpy(rng.randn(b, 1, h, dh).astype(np.float32)).to(dev)
    kf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    vf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    bias = torch.from_numpy(np.where(rng.rand(b, c) < 0.1, -1e9, 0.0).astype(np.float32)).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        args = (qf, k, v, lengths, bias, ks, vs)
    else:
        dt = getattr(torch, cache)
        args = (qf.to(dt), kf.to(dt), vf.to(dt), lengths, bias, None, None)
    key = f"{name} {cache} cache"
    try:
        fn = lambda: ragged_decode_attention(*args)
        fn()
    except ValueError as e:  # refused by this checkout's wrapper
        res[key] = {"refused": str(e)}
        continue
    res[key] = {**cs.cuda_time(fn), "device_ms": cs.device_ms(fn, ["ragged_decode"])}
    del args, kf, vf

from torch.profiler import ProfilerActivity, profile
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.sample import _nar_refine, _prefill_kv, generate
cfg = ModelConfig(attn_impl="flash", kv_cache_dtype="int8")
torch.manual_seed(0)
model = get_model(cfg)
rng = np.random.RandomState(2)
b, s, p, max_new = 8, 64, 225, 384
x_lens = rng.randint(40, s + 1, b)
prompt_lens = rng.randint(150, p + 1, b)
stop_lens = rng.randint(128, max_new + 1, b)
stop_lens[0] = max_new
x = torch.from_numpy(rng.randint(1, cfg.num_text_tokens, (b, s))).to(dev)
prompts = torch.from_numpy(rng.randint(0, cfg.num_audio_tokens, (b, p, cfg.num_quantizers))).to(dev)
xl, pl, sl = (torch.from_numpy(a).to(dev) for a in (x_lens, prompt_lens, stop_lens))
kw = dict(top_k=1, forbid_eos=True, ragged_decode=True, max_new_tokens=max_new, stop_lens=sl)
run = lambda: generate(model, x, xl, prompts, pl, generator=torch.Generator(device=dev).manual_seed(0), **kw)
run()
totals = []
for _ in range(3 if DECODE_ONLY else 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    totals.append(time.perf_counter() - t0)
total_s = float(np.median(totals))
steps = min(max_new, int(stop_lens.max()) + 1)
def prefill():
    with torch.inference_mode():
        _prefill_kv(model, x, xl, prompts, pl)
def nar():
    with torch.inference_mode():
        _nar_refine(model, x, xl, prompts, pl, out["codes"][..., 0], out["lengths"])
prefill_ms = cs.cuda_time(prefill, iters=3, windows=3, warmup=1)["ms"]
nar_ms = cs.cuda_time(nar, iters=1, windows=3, warmup=1)["ms"]
k1 = []
if not DECODE_ONLY:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    k1 = [e for e in prof.key_averages()
          if "ragged_decode" in e.key and e.self_device_time_total > 0]
res["generate"] = {"generate_s": total_s, "prefill_ms": prefill_ms, "nar_ms": nar_ms,
                   "decode_steps": steps,
                   "decode_ms_per_step": (total_s * 1e3 - prefill_ms - nar_ms) / steps,
                   "decode_ms_per_step_each": [(t * 1e3 - prefill_ms - nar_ms) / steps
                                               for t in totals],
                   "kernel1_device_ms_per_call": sum(e.self_device_time_total for e in k1) / 1e3,
                   "kernel1_launches": {e.key[:80]: e.count for e in k1}}
print(json.dumps(res))
"""


def main() -> int:
    flags = [a for a in sys.argv[1:] if a == "--decode-only"]
    args = [a for a in sys.argv[1:] if a != "--decode-only"]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for checkout in args:
        root = Path(checkout).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD, *flags], cwd=root, capture_output=True,
                              text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(res)
        print(json.dumps({"checkout": checkout, "cases": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    summary = {case: [r[case].get("device_ms") for r in rows] for case in rows[0]
               if case != "generate"}
    summary["generate decode_ms_per_step"] = [r["generate"]["decode_ms_per_step"] for r in rows]
    summary["generate decode_ms_per_step_each"] = [
        r["generate"]["decode_ms_per_step_each"] for r in rows]
    summary["generate kernel1_device_ms_per_call"] = [
        r["generate"]["kernel1_device_ms_per_call"] for r in rows]
    print(json.dumps({"checkouts": args, "nvidia_smi": smi, "device_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
