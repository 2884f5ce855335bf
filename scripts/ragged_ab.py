#!/usr/bin/env python3
"""Time kernel 1 (ragged decode attention) and the decode loop of
``generate`` in several checkouts of the repo, one fresh process each, on one
CUDA card.

    python3 scripts/ragged_ab.py PARENT . . PARENT [--decode-only | --kernels-only |
                                                   --smoke-phases]

Give the checkouts in an order that cancels drift (parent, change, change,
parent).  Each process imports ``valle_tpu_torch`` and ``chip_smoke`` (for
its timers) from its checkout, builds kernel 1 there, and times, on inputs
made here from one seed:

- kernel 1 at the cases of ``chip_smoke.py``'s phase 3: int8, f32 and bf16
  caches at B=8, C=1024 (3,583 live columns), the generate shapes (int8,
  B=8 and B=1, C=768, 673 live columns, two finished slots at B=8), a long
  int8 cache (B=1, C=40,000) and head dims 48 and 96; and at the head
  dims of its head-dim phase that are not whole 16-byte chunks or past
  1024 (B=8, C=512, 1,792 live columns, rows of about 1,024 elements): Dh
  8, 40, 50 and 72, Dh 1025, 1100 and 2048, and Dh 16388 at one head (B=4,
  C=256, 394 live columns: past the chunks a strided thread holds), each in
  int8, f32 and bf16 caches, with the plain version's and SDPA's event ms
  (``chip_smoke.ragged_library_ms``) beside them; a case that a checkout's
  wrapper refuses is recorded with the reason;
- one full-width VALL-E ``generate`` (the default ModelConfig, int8 cache,
  ``ragged_decode=True``, 8 requests, 384 new frames, greedy) as
  ``chip_smoke.py`` drives it: the decode ms per step (the call's wall time
  less the prefill and NAR passes, over the steps) and, from
  ``torch.profiler``, kernel 1's device ms over the whole call.

``--kernels-only`` times the kernel cases alone (no ``generate``; only
kernel 1 is built).  ``--smoke-phases`` times nothing but the seconds of
``chip_smoke.py``'s two kernel-1 phases (``check_ragged_decode`` and
``check_ragged_head_dims``, each as that checkout's script has it), after
one matmul has set up the card.  ``--decode-only`` skips the kernel cases and the
profile and times three ``generate`` calls instead of one (decode ms per
step: their median, and each), for a quick check of the decode loop's host
cost.

Each kernel time is the CUDA-event median of 5 windows of back-to-back calls
(the whole call: a wrapper's pad of the cache too) and the device time per
call (every kernel whose name holds ``ragged_decode``), as ``chip_smoke.py``
takes them, with the device time of every kernel the call launches
(``all_device_ms``: a pad's copies too).  Prints one JSON line per
checkout, then one with each case's device ms and event ms per checkout in
the order given, and the card's name and power limit.
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
KERNELS_ONLY = "--kernels-only" in sys.argv
SMOKE_PHASES = "--smoke-phases" in sys.argv
sys.path.insert(0, ".")
import chip_smoke as cs
from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops.ragged_decode import (ragged_decode_attention,
                                              ragged_decode_attention_reference)

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
KERNEL_1_ONLY = KERNELS_ONLY or SMOKE_PHASES
cuda_build.build(["ragged_decode"] + ([] if KERNEL_1_ONLY else ["prefix_attention"]))
if SMOKE_PHASES:
    import contextlib, io
    x = torch.randn(256, 256, device=dev)
    (x @ x).sum().item()
    res = {}
    for phase in (cs.check_ragged_decode, cs.check_ragged_head_dims):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            phase(dev)
        res[phase.__name__] = {"seconds": time.perf_counter() - t0}
    print(json.dumps(res))
    sys.exit(0)
P3 = [0, 1024, 517, 300, 1, 777, 64, 900]
GEN = [673, 0, 673, 673, 0, 673, 673, 673]
cases = [("phase3", 8, 1024, 16, 64, P3, c) for c in ("int8", "float32", "bfloat16")]
cases += [("generate B=8", 8, 768, 16, 64, GEN, "int8"), ("generate B=1", 1, 768, 16, 64, [673], "int8"),
          ("long cache B=1", 1, 40000, 16, 64, [40000], "int8")]
cases += [(f"dh {dh}", 8, 1024, h, dh, P3, c) for h, dh in ((16, 48), (8, 96))
          for c in ("int8", "float32", "bfloat16")]
HD = [0, 512, 259, 150, 1, 388, 32, 450]
cases += [(f"dh {dh} x {h} heads", 8, 512, h, dh, HD, c)
          for dh, h in ((8, 128), (40, 25), (50, 20), (72, 14), (1025, 1), (1100, 1), (2048, 2))
          for c in ("int8", "float32", "bfloat16")]
cases += [("dh 16388 x 1 heads", 4, 256, 1, 16388, [0, 256, 131, 7], c)
          for c in ("int8", "float32", "bfloat16")]
if DECODE_ONLY:
    cases = []


def all_device_ms(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


rng = np.random.RandomState(0)
res = {}
for name, b, c, h, dh, lens, cache in cases:
    args, kv_lib = cs.ragged_inputs(dev, rng, b, c, h, dh, lens, cache)
    key = f"{name} {cache} cache"
    try:
        fn = lambda: ragged_decode_attention(*args)
        fn()
    except ValueError as e:  # refused by this checkout's wrapper
        res[key] = {"refused": str(e)}
        continue
    res[key] = {**cs.cuda_time(fn), "device_ms": cs.device_ms(fn, ["ragged_decode"]),
                "all_device_ms": all_device_ms(fn)}
    if "heads" in name:  # the head-dim cases: the plain version and SDPA beside
        plain = ragged_decode_attention_reference
        res[key]["plain_ms"] = cs.cuda_time(lambda: plain(*args))["ms"]
        res[key]["library_ms"] = cs.ragged_library_ms(args, kv_lib, lens)
    del args, kv_lib
if KERNELS_ONLY:
    print(json.dumps(res))
    sys.exit(0)

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
    options = ("--decode-only", "--kernels-only", "--smoke-phases")
    flags = [a for a in sys.argv[1:] if a in options]
    args = [a for a in sys.argv[1:] if a not in options]
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
    events = {case: [r[case].get("ms") for r in rows] for case in rows[0] if case != "generate"}
    seconds = {case: [r[case].get("seconds") for r in rows] for case in rows[0]
               if "seconds" in rows[0][case]}
    yardsticks = {case: {k: [r[case].get(k) for r in rows] for k in ("plain_ms", "library_ms")}
                  for case in rows[0] if "plain_ms" in rows[0][case]}
    if "generate" in rows[0]:
        for key in ("decode_ms_per_step", "decode_ms_per_step_each",
                    "kernel1_device_ms_per_call"):
            summary[f"generate {key}"] = [r["generate"][key] for r in rows]
    print(json.dumps({"checkouts": args, "nvidia_smi": smi, "device_ms": summary,
                      "event_ms": events, "plain_and_sdpa_ms": yardsticks, "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
