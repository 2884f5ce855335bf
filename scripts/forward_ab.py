#!/usr/bin/env python3
"""Time the port's attention kernels in several checkouts of the repo, one
fresh process each, on one CUDA card.

    python3 scripts/forward_ab.py PARENT . . PARENT

Give the checkouts in an order that cancels drift (parent, change, change,
parent).  Each process imports ``valle_tpu_torch`` and ``chip_smoke`` from
its checkout, builds the attention kernels there, and times, on the same
seeded inputs and shapes as ``chip_smoke.py``:

- kernel 2's forward with dropout 0.1 and the LSE output (B=4, H=16, Dh=64,
  T=880): dense in f32 and bf16, prefix (S=128) in f32;
- kernel 4's forward: the Transformer TTS decoder's causal + padding bias
  (B=4, T=938) in f32 and bf16, and the inference shape (B=8, T=201) in f32;
- the backward of kernel 3 (dense, f32, rate 0.1) and of kernel 4 (decoder,
  f32), which the forward's changes must leave as they were;
- at 4 heads of Dh 256 (``chip_smoke.DH256_H``), in f32 and bf16: kernel 2
  dense (T=880, rate 0.1) and in dense cross-attention (752 audio rows
  against the 128 text keys), kernel 4 on the decoder bias and at the inference shape
  (B=8, T=201, the (1, 1, T, T) bias broadcast over batch and heads).

Each time is the CUDA-event median of 5 windows of back-to-back calls and
the device time per call from ``torch.profiler``, as ``chip_smoke.py`` takes
them.  Prints one JSON line per checkout, then one with each case's device
ms per checkout in the order given, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops import flash_attention as fl
from valle_tpu_torch.ops import fused_attention as fa

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build(["prefix_attention", "prefix_attention_bwd"])
rng = np.random.RandomState(0)
train = {name: (tq, tk, ps, kb) for name, tq, tk, ps, kb in cs._attention_cases(rng)}
calls = {}
for name, dtype in (("dense_self", "float32"), ("dense_self", "bfloat16"), ("prefix", "float32")):
    tq, tk, ps, kb = train[name]
    q, k, v = cs._qkv(rng, dev, getattr(torch, dtype), tq, tk)
    kb = torch.from_numpy(np.ascontiguousarray(kb)).to(dev)
    seed = int(rng.randint(0, 2**62))
    args = (q, k, v, kb, ps, cs.DROPOUT, seed)
    calls[f"kernel2 {name} T={tq} rate 0.1 {dtype}"] = (
        lambda args=args: fa._forward(*args, with_lse=True), ["prefix_attention_kernel"])
    if name == "dense_self" and dtype == "float32":
        out, lse = fa._forward(*args, with_lse=True)
        dout = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(dev)
        kw = dict(prefix_s=ps, dropout_rate=cs.DROPOUT, dropout_seed=seed)
        calls[f"kernel3 backward {name} T={tq} rate 0.1 {dtype}"] = (
            lambda a=(q, k, v, kb, out, dout, lse), kw=kw:
            fa.fused_prefix_attention_backward(*a, **kw), ["attn_bwd_"])
h, dh = cs.TTS_H, cs.TTS_DH
n = cs.INF_STEPS + 1
for label, b, t, bias, dtype in (
        ("decoder", cs.TTS_B, cs.TTS_T, cs._decoder_bias(rng, cs.TTS_B, cs.TTS_T, int(0.8 * cs.TTS_T)),
         "float32"),
        ("decoder", cs.TTS_B, cs.TTS_T, cs._decoder_bias(rng, cs.TTS_B, cs.TTS_T, int(0.8 * cs.TTS_T)),
         "bfloat16"),
        ("inference", cs.INF_B, n, cs._inference_bias(n, cs.INF_STEPS // 2), "float32")):
    q, k, v = (torch.from_numpy(rng.randn(b, t, h, dh).astype(np.float32)).to(dev, getattr(torch, dtype))
               for _ in range(3))
    bias = torch.from_numpy(bias).to(dev)
    calls[f"kernel4 {label} B={b} T={t} {dtype}"] = (
        lambda a=(q, k, v, bias): fl._forward(*a, with_lse=True), ["flash_bias_fwd"])
    if label == "decoder" and dtype == "float32":
        out, lse = fl._forward(q, k, v, bias, with_lse=True)
        dout = torch.from_numpy(rng.randn(b, t, h, dh).astype(np.float32)).to(dev)
        calls[f"kernel4 backward {label} B={b} T={t} {dtype}"] = (
            lambda a=(q, k, v, bias, out, dout, lse): fl.flash_attention_biased_backward(*a),
            ["flash_bias_bwd_", "attn_bwd_delta"])
h, dh = cs.DH256_H, cs.DH256_DH
fwd2 = ["prefix_attention_split_kernel", "prefix_attention_wide_kernel"]
for dtype in ("float32", "bfloat16"):
    dt = getattr(torch, dtype)
    t = cs.TRAIN_S + cs.TRAIN_T
    kb = torch.from_numpy(cs._train_key_bias(rng, cs.TRAIN_S, cs.TRAIN_T)).to(dev)
    q, k, v = (torch.from_numpy(rng.randn(cs.TRAIN_B, t, h, dh).astype(np.float32)).to(dev, dt)
               for _ in range(3))
    seed = int(rng.randint(0, 2**62))
    calls[f"kernel2 dh256 dense T={t} rate 0.1 {dtype}"] = (
        lambda a=(q, k, v, kb, None, cs.DROPOUT, seed): fa._forward(*a, with_lse=True), fwd2)
    qc, kc, vc = (x[:, :n_].contiguous() for x, n_ in ((q, cs.TRAIN_T), (k, cs.TRAIN_S),
                                                        (v, cs.TRAIN_S)))
    calls[f"kernel2 dh256 cross Tq={cs.TRAIN_T} Tk={cs.TRAIN_S} {dtype}"] = (
        lambda a=(qc, kc, vc, kb[:, :cs.TRAIN_S].contiguous(), None, 0.0, seed):
        fa._forward(*a, with_lse=True), fwd2)
    for label, b, t, bias in (
            ("decoder", cs.TTS_B, cs.TTS_T,
             cs._decoder_bias(rng, cs.TTS_B, cs.TTS_T, int(0.8 * cs.TTS_T))),
            ("inference", cs.INF_B, n, cs._inference_bias(n, cs.INF_STEPS // 2))):
        q, k, v = (torch.from_numpy(rng.randn(b, t, h, dh).astype(np.float32)).to(dev, dt)
                   for _ in range(3))
        bias = torch.from_numpy(bias).to(dev)
        calls[f"kernel4 dh256 {label} B={b} T={t} {dtype}"] = (
            lambda a=(q, k, v, bias): fl._forward(*a, with_lse=True), ["flash_bias_fwd"])
res = {}
for case, (fn, names) in calls.items():
    res[case] = {**cs.cuda_time(fn, iters=10), "device_ms": cs.device_ms(fn, names, iters=10)}
print(json.dumps(res))
"""


def main() -> int:
    args = sys.argv[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for checkout in args:
        root = Path(checkout).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                              text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append(res)
        print(json.dumps({"checkout": checkout, "cases": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"checkouts": args, "nvidia_smi": smi,
                      "device_ms": {case: [r[case]["device_ms"] for r in rows]
                                    for case in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
