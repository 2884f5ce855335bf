#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``valle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (no phase is caught: the first failure
ends the run with a non-zero exit code):

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
     (TF32 is switched off for matmuls and cuDNN);
  2. build: the three kernel sources from ``valle_tpu_torch/csrc`` with
     ``nvcc``, in parallel, with each one's most registers and spilled bytes,
     and per attention kernel (forward and backward) its registers, spills
     and tensor-core (HMMA) instructions: every forward kernel and backward
     pass must use the tensor cores and none may spill; per kernel 1
     instantiation (split and combine kernels) its registers, spills and I2F
     instructions: none may spill, and no int8-cache instantiation may hold
     an I2F;
  3. kernel 1 (ragged decode attention, split-K and combine) against its
     plain PyTorch version, with a bit-equal rerun: int8 / f32 / bf16 caches
     at B=8, C=1024; the generate shapes (B=8 and B=1, C=768, 673 live
     columns, two finished slots at B=8); a long cache (B=1, C=40,000); and
     head dims 48 and 96 in all three cache types;
  4. kernel 2 (prefix-LM / dense attention) against its plain version in
     prefix, causal, dense self- and cross-attention modes;
  5. kernel 2 with dropout 0.1 and its LSE output at the training shapes
     (prefix and dense, T=880, in f32; dense in bf16), against the plain
     version with the same Philox bits, with a bit-equal rerun, and the keep
     rate within 4 sigma of 0.9;
  6. kernel 3 (the backward) against its plain version in four mask modes,
     at rates 0 and 0.1, in f32 and bf16, with a bit-equal rerun;
  7. kernel 4 (dense-bias attention, forward and backward) against its plain
     version: the Transformer TTS decoder's causal + padding bias at the
     training shapes in f32 and bf16, a soft per-head bias and a (1, 1, Tq,
     Tk) bias with d(bias), Tq != Tk, and the inference shape, with
     bit-equal reruns; then kernels 2, 3 and 4, forward and backward, at
     head dims 16, 32, 48, 96 and 128 on a small shape (48 and 96 through
     the wrappers' zero padding), likewise;
  8. generate: full-width VALL-E (the default ModelConfig, seeded random
     weights) ``generate`` on 8 requests, with launch counts, the prefill and
     decode logits held against a CPU copy of the model, and timings;
  9. train: full-width VALL-E training steps (AR + NAR, dropout 0.1,
     ScaledAdam + Eden, B=4, S=128, T=752, accumulation 2) with launch counts
     per step, a bit-equal repeated step, and one micro-batch's loss and
     gradients at dropout 0 held against a CPU copy of the model that
     follows the card's ReLU gates, at the initial and the trained weights;
 10. tts_train: full-width Transformer TTS baseline training steps
     (``attn_impl="flash"``, attention dropout 0, B=4, S=128, T=938 mel
     frames) with launch counts per step, a bit-equal repeated step, and the
     loss and gradients in eval mode held against a CPU copy by the same
     ReLU-gate method;
 11. tts_inference: the same model's greedy mel loop on 8 requests for 200
     steps, with launch counts and the first steps' mels held against a CPU
     copy;
 12. a ``kernels`` summary line, then the last line
     ``{"ok": true, "device": {...}}``.

Kernel 2 and 4 cases carry their time over SDPA's and, in f32, the bound
with the products as 3xTF32 on the tensor cores; backward cases also the
names of SDPA's backward kernels (``torch.profiler``).  Kernel times are the
median of 5 windows of back-to-back calls (CUDA events), with the fastest
and slowest window as the spread, and beside them the device time per call
from ``torch.profiler``, which leaves out the host's launch overhead.  Exits
non-zero without CUDA, and where the port's package is not beside it.  Needs
one card, no network.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
KERNELS = ["ragged_decode", "prefix_attention", "prefix_attention_bwd"]  # kernel 4 is in 2 / 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense; f32 on the CUDA cores without TF32, and f32-accurate products as
# 3xTF32 (three TF32 products at 495 TFLOP/s each)
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
                  "tf32x3": 495e12 / 3}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGIT_ATOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time(fn, iters: int = 50, windows: int = 5, warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn()``: the median over ``windows``
    windows of ``iters`` back-to-back calls each (CUDA events), with the
    fastest and slowest window as the spread."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return {"ms": float(np.median(per_call)), "ms_min": min(per_call), "ms_max": max(per_call)}


def device_ms(fn, kernel_names, iters: int = 20):
    """Device milliseconds per call of ``fn()`` spent in the kernels whose
    names contain one of ``kernel_names``, from ``torch.profiler`` (CUPTI):
    the mean device time per launch of each such kernel, summed over the
    kernels that one call launches once each.  The mean is taken over the
    launches the profiler recorded, because it can miss some: its total
    over 5 calls of a one-kernel wrapper has come out at a fifth to four
    fifths of the event time.  None when it records no device time.  Unlike :func:`cuda_time` this leaves out the host's launch
    overhead between calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_launch = [e.self_device_time_total / e.count for e in prof.key_averages()
                  if e.count and e.self_device_time_total > 0
                  and any(n in e.key for n in kernel_names)]
    return sum(per_launch) / 1e3 if per_launch else None


def ptxas_summary(log_path) -> dict:
    """Most registers of any kernel instantiation and the spilled bytes,
    from ``nvcc -Xptxas -v``."""
    text = log_path.read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", text)]
    return {"max_registers": max(regs, default=0), "spill_bytes": sum(spills)}


_ATTN_KERNEL = re.compile(r"(attn_bwd_dq_kernel|attn_bwd_dkv_kernel|flash_bias_bwd_dq_kernel|"
                          r"flash_bias_bwd_dkv_kernel|attn_bwd_delta_kernel|"
                          r"prefix_attention_kernel|flash_bias_fwd_kernel)"
                          r"I(f|13__nv_bfloat16)E?(?:Li(\d+)E)?(?:Lb([01])E)?")


def kernel_label(mangled: str):
    """``attn_bwd_dq_kernel<float32, 64, drop>`` for a mangled attention
    kernel name (forward or backward), or None for another kernel."""
    m = _ATTN_KERNEL.search(mangled)
    if m is None:
        return None
    args = ["float32" if m.group(2) == "f" else "bfloat16"]
    if m.group(3):
        args.append(m.group(3))
    if m.group(4) == "1":
        args.append("drop")
    return f"{m.group(1)}<{', '.join(args)}>"


_RAGGED_KERNEL = re.compile(r"ragged_decode_split_kernelI(a|f|13__nv_bfloat16)Li(\d+)ELi(\d+)E"
                            r"|ragged_decode_combine_kernelILi(\d+)E")


def ragged_label(mangled: str):
    """``ragged_decode_split_kernel<int8, 4, 1>`` (cache type, lanes per
    head, chunks per lane) or ``ragged_decode_combine_kernel<256>`` (threads)
    for a mangled kernel 1 name, or None for another kernel."""
    m = _RAGGED_KERNEL.search(mangled)
    if m is None:
        return None
    if m.group(4) is not None:
        return f"ragged_decode_combine_kernel<{m.group(4)}>"
    kv = {"a": "int8", "f": "float32"}.get(m.group(1), "bfloat16")
    return f"ragged_decode_split_kernel<{kv}, {m.group(2)}, {m.group(3)}>"


def kernel_resources(lib_path, log_path, label=kernel_label, opcodes=(("hmma", "HMMA"),)) -> dict:
    """Per kernel instantiation of one built source that ``label`` names:
    registers and spilled bytes (``nvcc -Xptxas -v``) and, for each (key,
    opcode) of ``opcodes``, the instructions of that opcode in its SASS
    (``cuobjdump -sass`` of the built library; the tensor-core HMMA of the
    attention kernels by default)."""
    import os
    import shutil
    from pathlib import Path

    res, name = {}, None
    for line in log_path.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = label(m.group(1))
            if name is not None:
                res.setdefault(name, {"registers": 0, "spill_bytes": 0,
                                      **{key: 0 for key, _ in opcodes}})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            res[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = label(m.group(1))
        elif name is not None:
            for key, op in opcodes:
                if re.search(rf"\b{op}", line):
                    res[name][key] += 1
    return res


def top_device_kernels(fn, n: int = 3, iters: int = 3) -> list:
    """The ``n`` kernels with the most device time in ``iters`` calls of
    ``fn()`` (``torch.profiler``), with their device ms per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return [{"name": e.key[:160], "device_ms_per_call": e.self_device_time_total / 1e3 / iters}
            for e in top]


def bound(n_bytes: float, n_ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of the memory and the compute time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3


RAGGED_NAMES = ["ragged_decode_split_kernel", "ragged_decode_combine_kernel"]
PHASE3_LENS = [0, 1024, 517, 300, 1, 777, 64, 900]  # B=8, C=1024: 3,583 live columns
GENERATE_LENS = [673, 0, 673, 673, 0, 673, 673, 673]  # B=8, C=768: two finished slots


def ragged_cases():
    """(name, b, c, h, dh, lengths, caches) of phase 3."""
    all3 = ("int8", "float32", "bfloat16")
    return [
        ("phase3", 8, 1024, 16, 64, PHASE3_LENS, all3),
        ("generate B=8", 8, 768, 16, 64, GENERATE_LENS, ("int8",)),
        ("generate B=1", 1, 768, 16, 64, [673], ("int8",)),
        ("long cache B=1", 1, 40000, 16, 64, [40000], ("int8",)),
        ("dh 48", 8, 1024, 16, 48, PHASE3_LENS, all3),
        ("dh 96", 8, 1024, 8, 96, PHASE3_LENS, all3),
    ]


def ragged_inputs(dev, rng, b, c, h, dh, lens, cache):
    """(args of ragged_decode_attention, dequantized k and v in q's dtype)
    on the card: f32 q, K and V from ``rng``, 10% bias holes; int8 caches
    quantized per (token, head), others cast."""
    import torch

    from valle_tpu_torch.nn.attention import quantize_kv

    qf = torch.from_numpy(rng.randn(b, 1, h, dh).astype(np.float32)).to(dev)
    kf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    vf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    bias = torch.from_numpy(np.where(rng.rand(b, c) < 0.1, -1e9, 0.0).astype(np.float32)).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    if cache == "int8":
        k, ks = quantize_kv(kf)
        v, vs = quantize_kv(vf)
        return (qf, k, v, lengths, bias, ks, vs), (k.float() * ks[..., None],
                                                   v.float() * vs[..., None])
    dt = getattr(torch, cache)
    q, k, v = qf.to(dt), kf.to(dt), vf.to(dt)
    return (q, k, v, lengths, bias, None, None), (k, v)


def check_ragged_decode(dev):
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops.ragged_decode import (
        _cached_plan, ragged_decode_attention, ragged_decode_attention_reference)

    rng = np.random.RandomState(SEED)
    results = []
    for name, b, c, h, dh, lens, caches in ragged_cases():
        for cache in caches:
            args, (k_lib, v_lib) = ragged_inputs(dev, rng, b, c, h, dh, lens, cache)
            q, k, lengths, bias = args[0], args[1], args[3], args[4]
            tol = TOL["bfloat16" if cache == "bfloat16" else "float32"]
            op_type = "int8" if cache == "int8" else cache
            got = ragged_decode_attention(*args)
            again = ragged_decode_attention(*args)
            want = ragged_decode_attention_reference(*args)
            torch.cuda.synchronize()
            case = f"{name} {cache} cache"
            err = float((got - want).abs().max())
            assert torch.isfinite(got).all(), case
            assert torch.equal(got, again), f"kernel 1 ({case}) is not bit-reproducible"
            dead = [i for i, n in enumerate(lens) if n == 0]
            assert all(float(got[i].abs().max()) == 0.0 for i in dead), \
                "a length-0 slot must give exact zeros"
            assert err <= tol, f"kernel 1 ({case}) disagrees with its plain version: {err}"
            timing = cuda_time(lambda: ragged_decode_attention(*args))
            timing["device_ms"] = device_ms(lambda: ragged_decode_attention(*args), RAGGED_NAMES)
            plain_ms = cuda_time(lambda: ragged_decode_attention_reference(*args), iters=20)["ms"]
            # yardstick: one SDPA call on the same (dequantized) data and mask, over
            # the slots of length > 0 (a length-0 slot has no finite column for SDPA)
            col = torch.arange(c, device=dev)[None, :]
            mask = torch.where(col < lengths[:, None].long(), bias, float("-inf"))
            live_slots = torch.tensor([i for i, n in enumerate(lens) if n > 0], device=dev)
            mask = mask[live_slots][:, None, None, :].to(q.dtype)
            ql, kl, vl = (t[live_slots].transpose(1, 2).contiguous()
                          for t in (q, k_lib.to(q.dtype), v_lib.to(q.dtype)))
            library_ms = cuda_time(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask))["ms"]
            live = int(sum(min(max(n, 0), c) for n in lens))
            elem = k.element_size()
            n_bytes = (live * h * dh * 2 * elem + (live * h * 4 * 2 if cache == "int8" else 0)
                       + live * 4 + b * 4 + b * h * dh * (q.element_size() + 4))
            bound_ms, bound_by = bound(n_bytes, 4.0 * live * h * dh, op_type)
            plan = _cached_plan(b, c, h, dh, elem, torch.cuda.current_device())
            results.append({"case": case, "b": b, "c": c, "h": h, "dh": dh,
                            "live_columns": live, "plan": plan._asdict(), "max_abs_err": err,
                            "tol": tol, "bit_equal_rerun": True, **timing, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by,
                            "bound_share": bound_ms / timing["device_ms"]
                            if timing["device_ms"] else None})
            del args, k_lib, v_lib, ql, kl, vl, mask
    emit({"phase": "kernel1_ragged_decode", "device_ms_is": "split + combine kernels per call",
          "cases": results})
    return results[0]


# ---------------------------------------------------------------- phase 4


def _visible_columns(tq: int, tk: int, prefix_s) -> int:
    if prefix_s is None:
        return tq * tk
    rows = np.arange(tq)
    cols = np.where(rows < prefix_s, prefix_s, np.maximum(prefix_s, rows + 1))
    return int(np.minimum(cols, tk).sum())


def check_prefix_attention(dev, res):
    """Kernel 2 against its plain version in prefix, causal and dense modes.
    ``res``: the forward kernels' registers, spills and HMMA counts."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops.fused_attention import (
        fused_prefix_attention, fused_prefix_attention_reference)
    from valle_tpu_torch.ops.masks import AttnMaskSpec

    rng = np.random.RandomState(SEED + 1)
    h, dh, b = 16, 64, 8
    s, p = 64, 226
    x_lens = rng.randint(40, s + 1, b)
    p_lens = rng.randint(150, p + 1, b)

    def key_pad(tk, lens):
        """(B, Tk) bias: -1e9 past each row's length."""
        col = np.arange(tk)[None, :]
        return np.where(col < lens[:, None], 0.0, -1e9).astype(np.float32)

    prefix_bias = np.concatenate([
        key_pad(s, x_lens),
        np.where(np.arange(p)[None, :] >= p - p_lens[:, None], 0.0, -1e9).astype(np.float32),
    ], 1)  # text padding + right-aligned prompt (filler on the left)
    cases = [
        ("prefix", s + p, s + p, s, prefix_bias, "float32"),
        ("prefix_bf16", s + p, s + p, s, prefix_bias, "bfloat16"),
        ("causal", p, p, 0, prefix_bias[:, s:], "float32"),
        ("dense_nar", 673, 673, None, key_pad(673, rng.randint(450, 674, b)), "float32"),
        ("dense_self", 900, 900, None, key_pad(900, rng.randint(600, 901, b)), "float32"),
        ("dense_cross", 700, 64, None, key_pad(64, x_lens), "float32"),
    ]
    results = {}
    for name, tq, tk, prefix_s, kv_bias, dtype in cases:
        dt = getattr(torch, dtype)
        q = torch.from_numpy(rng.randn(b, tq, h, dh).astype(np.float32)).to(dev, dt)
        k = torch.from_numpy(rng.randn(b, tk, h, dh).astype(np.float32)).to(dev, dt)
        v = torch.from_numpy(rng.randn(b, tk, h, dh).astype(np.float32)).to(dev, dt)
        kb = torch.from_numpy(np.ascontiguousarray(kv_bias)).to(dev)
        got = fused_prefix_attention(q, k, v, kb, prefix_s=prefix_s)
        want = fused_prefix_attention_reference(q, k, v, kb, prefix_s)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert torch.isfinite(got).all(), name
        assert err <= TOL[dtype], f"kernel 2 ({name}) disagrees with its plain version: {err}"
        timing = cuda_time(lambda: fused_prefix_attention(q, k, v, kb, prefix_s=prefix_s), iters=20)
        timing["device_ms"] = device_ms(lambda: fused_prefix_attention(q, k, v, kb,
                                                                       prefix_s=prefix_s),
                                        ["prefix_attention_kernel"])
        plain_ms = cuda_time(lambda: fused_prefix_attention_reference(q, k, v, kb, prefix_s),
                             iters=3)["ms"]
        mask = AttnMaskSpec(kb, prefix_s).dense(tq).to(dt)  # built outside the timing
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_time(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                               iters=20)["ms"]
        vis = _visible_columns(tq, tk, prefix_s)
        n_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() + kb.numel() * 4
        n_ops = 4.0 * b * h * dh * vis
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        results[name] = {"case": name, "b": b, "tq": tq, "tk": tk, "prefix_s": prefix_s,
                         "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype], **timing,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "ms_over_library": timing["ms"] / library_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         **_tf32x3_bound(dtype, n_bytes, n_ops),
                         "kernel": res.get(f"prefix_attention_kernel<{dtype}, {dh}>"),
                         "tflops": n_ops / timing["ms"] / 1e9}
    emit({"phase": "kernel2_prefix_attention", "cases": list(results.values())})


# ------------------------------------------------------- phases 5 and 6
# The training shapes: B=4, H=16, Dh=64; the AR decoder runs the prefix mode
# over [128 text ; 752 audio] = 880 rows, the NAR decoder the dense mode.

TRAIN_B, TRAIN_S, TRAIN_T, TRAIN_H, TRAIN_DH = 4, 128, 752, 16, 64
DROPOUT = 0.1


def _train_key_bias(rng, tq_text: int, tq_audio: int):
    """(B, S + T) bias: text padded past a length in [3S/4, S], audio past a
    length in [0.8 T, T]; the first row of the batch is full."""
    x_lens = rng.randint(3 * tq_text // 4, tq_text + 1, TRAIN_B)
    y_lens = rng.randint(int(0.8 * tq_audio), tq_audio + 1, TRAIN_B)
    x_lens[0], y_lens[0] = tq_text, tq_audio
    text = np.arange(tq_text)[None, :] >= x_lens[:, None]
    audio = np.arange(tq_audio)[None, :] >= y_lens[:, None]
    return np.where(np.concatenate([text, audio], 1), -1e9, 0.0).astype(np.float32)


def _attention_cases(rng):
    """(name, tq, tk, prefix_s, (B, Tk) key bias) at the training shapes."""
    full = _train_key_bias(rng, TRAIN_S, TRAIN_T)
    t = TRAIN_S + TRAIN_T
    return [
        ("prefix", t, t, TRAIN_S, full),
        ("causal", TRAIN_T, TRAIN_T, 0, full[:, TRAIN_S:]),
        ("dense_self", t, t, None, full),
        ("dense_cross", TRAIN_T, TRAIN_S, None, full[:, :TRAIN_S]),
    ]


def _qkv(rng, dev, dt, tq, tk):
    import torch

    shape_q, shape_k = (TRAIN_B, tq, TRAIN_H, TRAIN_DH), (TRAIN_B, tk, TRAIN_H, TRAIN_DH)
    return tuple(torch.from_numpy(rng.randn(*shp).astype(np.float32)).to(dev, dt)
                 for shp in (shape_q, shape_k, shape_k))


def check_dropout_forward(dev, res):
    """Kernel 2 with dropout and the LSE output, at the training shapes: prefix
    and dense in f32, dense in bf16.  ``res`` as in
    :func:`check_prefix_attention`."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.masks import AttnMaskSpec
    from valle_tpu_torch.ops.philox import dropout_keep_mask

    rng = np.random.RandomState(SEED + 3)
    cases = {name: (tq, tk, prefix_s, kv_bias)
             for name, tq, tk, prefix_s, kv_bias in _attention_cases(rng)}
    results = {}
    for name, dtype in (("prefix", "float32"), ("dense_self", "float32"),
                        ("dense_self", "bfloat16")):
        tq, tk, prefix_s, kv_bias = cases[name]
        key = name if dtype == "float32" else f"{name} {dtype}"
        dt = getattr(torch, dtype)
        q, k, v = _qkv(rng, dev, dt, tq, tk)
        kb = torch.from_numpy(np.ascontiguousarray(kv_bias)).to(dev)
        seed = int(rng.randint(0, 2**62))
        args = (q, k, v, kb, prefix_s, DROPOUT, seed)
        got, lse = fa._forward(*args, with_lse=True)
        again, lse_again = fa._forward(*args, with_lse=True)
        want, want_lse = fa.attention_forward_reference(*args)
        keep = dropout_keep_mask(seed, TRAIN_B, TRAIN_H, tq, tk, DROPOUT, device=dev)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        n = keep.numel()
        keep_rate = float(keep.float().mean())
        sigma = float(np.sqrt(DROPOUT * (1 - DROPOUT) / n))
        assert torch.isfinite(got).all() and torch.isfinite(lse).all(), key
        assert torch.equal(got, again) and torch.equal(lse, lse_again), \
            f"kernel 2 with dropout ({key}) is not bit-reproducible"
        assert err <= TOL[dtype], f"kernel 2 with dropout ({key}) disagrees: {err}"
        assert lse_err <= TOL["float32"], f"kernel 2 LSE ({key}) disagrees: {lse_err}"
        assert abs(keep_rate - (1 - DROPOUT)) <= 4 * sigma, (keep_rate, sigma)
        del want, want_lse, keep, again, lse_again
        timing = cuda_time(lambda: fa._forward(*args, with_lse=True), iters=20)
        timing["device_ms"] = device_ms(lambda: fa._forward(*args, with_lse=True),
                                        ["prefix_attention_kernel"])
        plain_ms = cuda_time(lambda: fa.attention_forward_reference(*args), iters=2,
                             windows=3)["ms"]
        mask = AttnMaskSpec(kb, prefix_s).dense(tq).to(dt)
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_time(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, dropout_p=DROPOUT), iters=20)["ms"]
        vis = _visible_columns(tq, tk, prefix_s)
        n_bytes = ((q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
                   + kb.numel() * 4 + lse.numel() * 4)
        n_ops = 4.0 * TRAIN_B * TRAIN_H * TRAIN_DH * vis
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        results[key] = {"case": key, "b": TRAIN_B, "tq": tq, "tk": tk, "prefix_s": prefix_s,
                        "dtype": dtype, "rate": DROPOUT, "max_abs_err": err,
                        "lse_max_abs_err": lse_err, "tol": TOL[dtype], "bit_equal_rerun": True,
                        "keep_rate": keep_rate, "keep_rate_sigma": sigma, **timing,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "ms_over_library": timing["ms"] / library_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        **_tf32x3_bound(dtype, n_bytes, n_ops),
                        "kernel": res.get(f"prefix_attention_kernel<{dtype}, {TRAIN_DH}, drop>"),
                        "tflops": n_ops / timing["ms"] / 1e9}
        del q, k, v, got, lse
    emit({"phase": "kernel2_dropout", "cases": list(results.values())})
    return results


def _tf32x3_bound(dtype: str, n_bytes: float, n_ops: float) -> dict:
    """For f32: the bound with the products on the tensor cores as 3xTF32."""
    if dtype != "float32":
        return {}
    ms, by = bound(n_bytes, n_ops, "tf32x3")
    return {"bound_ms_tf32x3": ms, "bound_by_tf32x3": by}


def check_backward(dev, res):
    """Kernel 3 against its plain version with the same mask, in four mask
    modes, at rates 0 and 0.1, in f32 and bf16; two runs must be bit-equal.
    ``res``: the backward kernels' registers, spills and HMMA counts."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.masks import AttnMaskSpec

    rng = np.random.RandomState(SEED + 4)
    results = {}
    for name, tq, tk, prefix_s, kv_bias in _attention_cases(rng):
        kb = torch.from_numpy(np.ascontiguousarray(kv_bias)).to(dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = _qkv(rng, dev, dt, tq, tk)
            dout = torch.from_numpy(rng.randn(TRAIN_B, tq, TRAIN_H, TRAIN_DH).astype(np.float32))
            dout = dout.to(dev, dt)
            for rate in (0.0, DROPOUT):
                seed = int(rng.randint(0, 2**62))
                out, lse = fa._forward(q, k, v, kb, prefix_s, rate, seed, with_lse=True)
                kw = dict(prefix_s=prefix_s, dropout_rate=rate, dropout_seed=seed)
                got = fa.fused_prefix_attention_backward(q, k, v, kb, out, dout, lse, **kw)
                again = fa.fused_prefix_attention_backward(q, k, v, kb, out, dout, lse, **kw)
                want = fa.attention_backward_reference(q, k, v, kb, out, dout, lse, prefix_s,
                                                       rate, seed)
                torch.cuda.synchronize()
                errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                        for g, w in zip(got, want)]
                case = f"{name} {dtype} rate {rate}"
                assert all(torch.isfinite(g).all() for g in got), case
                assert all(torch.equal(g, a) for g, a in zip(got, again)), \
                    f"kernel 3 ({case}) is not bit-reproducible"
                assert max(errs) <= TOL[dtype], f"kernel 3 ({case}) disagrees: {errs}"
                del want, again
                call = lambda: fa.fused_prefix_attention_backward(q, k, v, kb, out, dout, lse, **kw)
                timing = cuda_time(call, iters=10)
                timing["device_ms"] = device_ms(call, ["attn_bwd_"], iters=5)
                plain_ms = cuda_time(lambda: fa.attention_backward_reference(
                    q, k, v, kb, out, dout, lse, prefix_s, rate, seed), iters=1, windows=3)["ms"]
                # yardstick: SDPA's backward at the same rate on the dense mask
                mask = AttnMaskSpec(kb, prefix_s).dense(tq).to(dt)
                ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, dropout_p=rate)
                dol = dout.transpose(1, 2)
                lib_call = lambda: torch.autograd.grad(  # noqa: E731
                    ol, (ql, kl, vl), dol, retain_graph=True)
                library_ms = cuda_time(lib_call, iters=10)["ms"]
                library_kernels = top_device_kernels(lib_call)
                del ol, ql, kl, vl, lib_call
                vis = _visible_columns(tq, tk, prefix_s)
                n_bytes = ((q.numel() * 4 + k.numel() * 4) * q.element_size()
                           + kb.numel() * 4 + lse.numel() * 4)
                n_ops = 10.0 * TRAIN_B * TRAIN_H * TRAIN_DH * vis
                bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
                drop = ", drop" if rate > 0 else ""
                results[case] = {
                    "case": case, "b": TRAIN_B, "tq": tq, "tk": tk, "prefix_s": prefix_s,
                    "dtype": dtype, "rate": rate, "max_abs_err": max(errs),
                    "err_is": "max |kernel - plain| / max |plain|, worst of dq, dk, dv",
                    "tol": TOL[dtype], "bit_equal_rerun": True, **timing, "plain_ms": plain_ms,
                    "library_ms": library_ms, "ms_over_library": timing["ms"] / library_ms,
                    "library_kernels": library_kernels,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    **_tf32x3_bound(dtype, n_bytes, n_ops),
                    "kernels": {label: res.get(label) for label in (
                        f"attn_bwd_dq_kernel<{dtype}, {TRAIN_DH}{drop}>",
                        f"attn_bwd_dkv_kernel<{dtype}, {TRAIN_DH}{drop}>")},
                    "tflops": n_ops / timing["ms"] / 1e9}
    emit({"phase": "kernel3_backward", "cases": list(results.values())})
    return results


# ---------------------------------------------------------------- phase 7
# The Transformer TTS shapes: training B=4, H=16, Dh=64 over T=938 mel frames
# (10 s at 24 kHz, hop 256) with S=128 text tokens; inference B=8 over
# 200 + 1 frames.

TTS_B, TTS_S, TTS_T, TTS_H, TTS_DH = 4, 128, 938, 16, 64
INF_B, INF_S, INF_STEPS = 8, 64, 200


def _decoder_bias(rng, b: int, t: int, lo: int):
    """(B, 1, T, T) {0, -1e9}: causal plus key padding past a length in
    [lo, t]; the first row of the batch is full."""
    lens = rng.randint(lo, t + 1, b)
    lens[0] = t
    col = np.arange(t)
    masked = (col[None, :] > col[:, None])[None] | (col[None, None, :] >= lens[:, None, None])
    return np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]


def _inference_bias(n: int, step: int):
    """(1, 1, n, n) bias of inference step ``step``: row r sees columns
    <= min(r, step)."""
    col = np.arange(n)
    masked = (col[None, :] > col[:, None]) | (col[None, :] > step)
    return np.where(masked, -1e9, 0.0).astype(np.float32)[None, None]


def check_flash_bias(dev, fwd_res, res):
    """Kernel 4 forward and backward against its plain version, with
    bit-equal reruns, in f32 and bf16, at the training and inference shapes
    of the Transformer TTS decoder, with soft and broadcast biases, Tq != Tk,
    and d(bias) on and off.  ``fwd_res`` / ``res``: the forward / backward
    kernels' registers, spills and HMMA counts."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops import flash_attention as fl

    rng = np.random.RandomState(SEED + 6)
    b, t, h, dh = TTS_B, TTS_T, TTS_H, TTS_DH
    dec = _decoder_bias(rng, b, t, int(0.8 * t))
    n = INF_STEPS + 1
    soft = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    cases = [  # (name, B, Tq, Tk, bias, dtype, d(bias))
        ("decoder float32", b, t, t, dec, "float32", False),
        ("decoder bfloat16", b, t, t, dec, "bfloat16", False),
        ("soft per-head float32 d(bias)", b, t, t, soft(b, h, t, t), "float32", True),
        ("broadcast (1,1,Tq,Tk) float32 d(bias)", b, t, t, soft(1, 1, t, t), "float32", True),
        ("tq 500 != tk float32", b, 500, t, soft(b, 1, 500, t), "float32", False),
        ("inference float32", INF_B, n, n, _inference_bias(n, INF_STEPS // 2), "float32", False),
    ]
    results = {}
    for name, bb, tq, tk, bias_np, dtype, bias_grad in cases:
        dt = getattr(torch, dtype)
        q = torch.from_numpy(soft(bb, tq, h, dh)).to(dev, dt)
        k = torch.from_numpy(soft(bb, tk, h, dh)).to(dev, dt)
        v = torch.from_numpy(soft(bb, tk, h, dh)).to(dev, dt)
        dout = torch.from_numpy(soft(bb, tq, h, dh)).to(dev, dt)
        bias = torch.from_numpy(bias_np).to(dev)
        out, lse = fl._forward(q, k, v, bias, with_lse=True)
        out2, lse2 = fl._forward(q, k, v, bias, with_lse=True)
        want, want_lse = fl.flash_attention_forward_reference(q, k, v, bias)
        got = fl.flash_attention_biased_backward(q, k, v, bias, out, dout, lse,
                                                 bias_grad=bias_grad)
        again = fl.flash_attention_biased_backward(q, k, v, bias, out, dout, lse,
                                                   bias_grad=bias_grad)
        want_b = fl.flash_attention_backward_reference(q, k, v, bias, out, dout, lse, bias_grad)
        torch.cuda.synchronize()
        fwd_err = float((out.float() - want.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        got, again, want_b = ([g for g in x if g is not None] for x in (got, again, want_b))
        errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip(got, want_b)]
        bit_equal = (torch.equal(out, out2) and torch.equal(lse, lse2)
                     and all(torch.equal(g, a) for g, a in zip(got, again)))
        assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in got), name
        assert bit_equal, f"kernel 4 ({name}) is not bit-reproducible"
        assert fwd_err <= TOL[dtype], f"kernel 4 forward ({name}) disagrees: {fwd_err}"
        rounding = {}
        if dtype == "bfloat16":
            # the bf16 output must be the f32 result with P and the output
            # rounded to bf16, as the TPU kernels round them: within half a
            # bf16 ulp (<= 2^-8 |x|) of the output plus half an ulp of each
            # probability times |v| (<= 2^-8 (P |v|)) of the plain version in
            # f32, plus the f32 tolerance
            want32 = fl.flash_attention_forward_reference(q.float(), k.float(), v.float(),
                                                          bias)[0]
            pv_abs = fl.flash_attention_forward_reference(q.float(), k.float(),
                                                          v.float().abs(), bias)[0]
            excess = float(((out.float() - want32).abs()
                            - 2.0**-8 * (want32.abs() + pv_abs)).max())
            assert excess <= TOL["float32"], f"kernel 4 bf16 forward ({name}) is off: {excess}"
            rounding = {"bf16_excess_over_rounding": excess, "bf16_excess_tol": TOL["float32"]}
            del want32, pv_abs
        assert lse_err <= TOL["float32"], f"kernel 4 LSE ({name}) disagrees: {lse_err}"
        assert max(errs) <= TOL[dtype], f"kernel 4 backward ({name}) disagrees: {errs}"
        del out2, lse2, want, want_lse, again, want_b, got

        fwd = lambda: fl._forward(q, k, v, bias, with_lse=True)  # noqa: E731
        bwd = lambda: fl.flash_attention_biased_backward(  # noqa: E731
            q, k, v, bias, out, dout, lse, bias_grad=bias_grad)
        t_fwd = cuda_time(fwd, iters=10)
        t_fwd["device_ms"] = device_ms(fwd, ["flash_bias_fwd"], iters=5)
        t_bwd = cuda_time(bwd, iters=5)
        t_bwd["device_ms"] = device_ms(bwd, ["flash_bias_bwd_", "attn_bwd_delta"], iters=3)
        plain_fwd = cuda_time(lambda: fl.flash_attention_forward_reference(q, k, v, bias),
                              iters=2, windows=3)["ms"]
        plain_bwd = cuda_time(lambda: fl.flash_attention_backward_reference(
            q, k, v, bias, out, dout, lse, bias_grad), iters=1, windows=3)["ms"]
        # yardstick: SDPA with the float mask bias * scale is the same function
        mask = (bias * (1.0 / dh ** 0.5)).to(dt)
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lib_fwd = cuda_time(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                            iters=10)["ms"]
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        lib_call = lambda: torch.autograd.grad(  # noqa: E731
            ol, (ql, kl, vl), dout.transpose(1, 2), retain_graph=True)
        lib_bwd = cuda_time(lib_call, iters=5)["ms"]
        lib_kernels = top_device_kernels(lib_call)
        del ol, ql, kl, vl, mask, lib_call
        pairs = bb * h * tq * tk
        elem = q.element_size()
        qkv_bytes = (q.numel() + k.numel() + v.numel()) * elem
        f_bytes = qkv_bytes + q.numel() * elem + bias.numel() * 4 + lse.numel() * 4
        f_bound = bound(f_bytes, 4.0 * pairs * dh, dtype)
        b_bytes = (2 * qkv_bytes + 2 * q.numel() * elem + bias.numel() * 4 + lse.numel() * 4
                   + (pairs * 4 if bias_grad else 0))
        b_bound = bound(b_bytes, 10.0 * pairs * dh, dtype)
        shape = {"b": bb, "h": h, "tq": tq, "tk": tk, "dh": dh, "bias_shape": list(bias.shape),
                 "dtype": dtype, "bias_grad": bias_grad, "tol": TOL[dtype],
                 "bit_equal_rerun": bit_equal}
        results[name] = {
            "forward": {"case": name, **shape, "max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
                        **rounding,
                        **t_fwd, "plain_ms": plain_fwd, "library_ms": lib_fwd,
                        "ms_over_library": t_fwd["ms"] / lib_fwd,
                        "bound_ms": f_bound[0], "bound_by": f_bound[1],
                        **_tf32x3_bound(dtype, f_bytes, 4.0 * pairs * dh),
                        "kernel": fwd_res.get(f"flash_bias_fwd_kernel<{dtype}, {dh}>"),
                        "tflops": 4.0 * pairs * dh / t_fwd["ms"] / 1e9},
            "backward": {"case": name, **shape, "max_abs_err": max(errs),
                         "err_is": "max |kernel - plain| / max |plain|, worst of dq, dk, dv"
                                   + (", d(bias)" if bias_grad else ""),
                         **t_bwd, "plain_ms": plain_bwd, "library_ms": lib_bwd,
                         "library_is": "SDPA backward, dq dk dv only",
                         "ms_over_library": t_bwd["ms"] / lib_bwd,
                         "library_kernels": lib_kernels,
                         "bound_ms": b_bound[0], "bound_by": b_bound[1],
                         **_tf32x3_bound(dtype, b_bytes, 10.0 * pairs * dh),
                         "kernels": {label: res.get(label) for label in (
                             f"flash_bias_bwd_dq_kernel<{dtype}, {dh}>",
                             f"flash_bias_bwd_dkv_kernel<{dtype}, {dh}>")},
                         "tflops": 10.0 * pairs * dh / t_bwd["ms"] / 1e9},
        }
        del q, k, v, dout, bias, out, lse
    emit({"phase": "kernel4_flash_bias", "cases": list(results.values())})
    return results


HEAD_DIM_CASE = (2, 4, 200, 48)  # B, H, T, prefix_s


def check_head_dims(dev):
    """Kernels 2, 3 and 4, forward and backward, at the head dims the
    training shapes do not reach (16, 32, 128, and 48 and 96, which the
    wrappers zero-pad to 64 and 128; the scale is not a power of two but at
    16 and 64), in f32 and bf16: kernels 2 / 3 in prefix mode at rate 0.1
    and in dense mode at rate 0, kernel 4 with a causal + padding bias, each
    against its plain version with a bit-equal rerun."""
    import torch

    from valle_tpu_torch.ops import flash_attention as fl
    from valle_tpu_torch.ops import fused_attention as fa

    rng = np.random.RandomState(SEED + 8)
    b, h, t, prefix_s = HEAD_DIM_CASE
    key_bias = np.where(np.arange(t)[None, :] >= rng.randint(3 * t // 4, t + 1, b)[:, None],
                        -1e9, 0.0).astype(np.float32)
    kb = torch.from_numpy(key_bias).to(dev)
    dec = torch.from_numpy(_decoder_bias(rng, b, t, 3 * t // 4)).to(dev)
    results = []
    for dh in (16, 32, 48, 96, 128):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v, dout = (torch.from_numpy(rng.randn(b, t, h, dh).astype(np.float32)).to(dev, dt)
                             for _ in range(4))
            for mode, rate in (("prefix", DROPOUT), ("dense", 0.0), ("kernel4 decoder bias", 0.0)):
                if mode == "kernel4 decoder bias":
                    fwd = lambda: fl._forward(q, k, v, dec, with_lse=True)  # noqa: E731
                    want_out, want_lse = fl.flash_attention_forward_reference(q, k, v, dec)
                    out, lse = fwd()
                    call = lambda: fl.flash_attention_biased_backward(  # noqa: E731
                        q, k, v, dec, out, dout, lse)[:3]
                    want = fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse)[:3]
                else:
                    ps = prefix_s if mode == "prefix" else None
                    seed = int(rng.randint(0, 2**62))
                    fwd = lambda: fa._forward(q, k, v, kb, ps, rate, seed,  # noqa: E731
                                              with_lse=True)
                    want_out, want_lse = fa.attention_forward_reference(q, k, v, kb, ps, rate,
                                                                        seed)
                    out, lse = fwd()
                    kw = dict(prefix_s=ps, dropout_rate=rate, dropout_seed=seed)
                    call = lambda: fa.fused_prefix_attention_backward(  # noqa: E731
                        q, k, v, kb, out, dout, lse, **kw)
                    want = fa.attention_backward_reference(q, k, v, kb, out, dout, lse, ps, rate,
                                                           seed)
                out2, lse2 = fwd()
                got, again = call(), call()
                torch.cuda.synchronize()
                case = f"dh {dh} {mode} {dtype} rate {rate}"
                fwd_err = float((out.float() - want_out.float()).abs().max())
                lse_err = float((lse - want_lse).abs().max())
                errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                        for g, w in zip(got, want)]
                assert torch.isfinite(out).all() and torch.isfinite(lse).all(), case
                assert torch.equal(out, out2) and torch.equal(lse, lse2), \
                    f"forward ({case}) is not bit-reproducible"
                assert fwd_err <= TOL[dtype], f"forward ({case}) disagrees: {fwd_err}"
                assert lse_err <= TOL["float32"], f"forward LSE ({case}) disagrees: {lse_err}"
                assert all(torch.isfinite(g).all() for g in got), case
                assert all(torch.equal(g, a) for g, a in zip(got, again)), \
                    f"backward ({case}) is not bit-reproducible"
                assert max(errs) <= TOL[dtype], f"backward ({case}) disagrees: {errs}"
                results.append({"case": case, "b": b, "h": h, "t": t, "dh": dh,
                                "forward_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
                                "max_abs_err": max(errs), "tol": TOL[dtype],
                                "bit_equal_rerun": True})
    emit({"phase": "kernel2_3_4_head_dims",
          "err_is": "forward: max |kernel - plain|; backward (max_abs_err): max |kernel - plain| "
                    "/ max |plain|, worst of dq, dk, dv", "cases": results})
    return results


# ---------------------------------------------------------------- phase 8


def teacher_forced_logits(model, x, x_lens, prompts, prompt_lens, tokens, ragged: bool):
    """Prefill logits and the logits of len(tokens) decode steps fed the given
    codebook-1 tokens, through the same helpers as ``generate``."""
    import torch

    from valle_tpu_torch.sample import _decode_bias, _make_cache, _prefill_kv

    bos = int(model.cfg.prepend_bos)
    with torch.inference_mode():
        logits, (k_pre, v_pre), memory, key_pad, mem_bias, tpre = _prefill_kv(
            model, x, x_lens, prompts, prompt_lens)
        steps = tokens.shape[1]
        cache = _make_cache(model.cfg.kv_cache_dtype, k_pre, v_pre, tpre + steps)
        out = [logits.float().cpu()]
        for t in range(steps):
            kv_lengths = None
            if ragged:
                kv_lengths = torch.full((x.shape[0],), tpre + t + 1, dtype=torch.int32,
                                        device=x.device)
            logits, cache = model.ar_decode_step(
                tokens[:, t: t + 1], (prompt_lens + bos + t)[:, None], cache, tpre + t,
                _decode_bias(~key_pad, tpre + steps, t), memory, mem_bias,
                kv_lengths=kv_lengths)
            out.append(logits.float().cpu())
    return torch.stack(out, 1)  # (B, 1 + steps, V+1)


def main_path(dev):
    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.sample import _nar_refine, _prefill_kv, generate

    cfg = ModelConfig(attn_impl="flash", kv_cache_dtype="int8")  # full width
    torch.manual_seed(SEED)
    model = get_model(cfg)
    rng = np.random.RandomState(SEED + 2)
    b, s, p, max_new = 8, 64, 225, 384
    x_lens = rng.randint(40, s + 1, b)
    prompt_lens = rng.randint(150, p + 1, b)
    stop_lens = rng.randint(128, max_new + 1, b)
    stop_lens[0] = max_new  # one request runs the whole budget
    x = torch.from_numpy(rng.randint(1, cfg.num_text_tokens, (b, s))).to(dev)
    prompts = rng.randint(0, cfg.num_audio_tokens, (b, p, cfg.num_quantizers))
    prompts = torch.from_numpy(prompts).to(dev)
    x_lens_t, prompt_lens_t, stop_lens_t = (torch.from_numpy(a).to(dev)
                                            for a in (x_lens, prompt_lens, stop_lens))
    kw = dict(top_k=1, forbid_eos=True, ragged_decode=True, max_new_tokens=max_new,
              stop_lens=stop_lens_t)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    generate(model, x, x_lens_t, prompts, prompt_lens_t, generator=gen, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = generate(model, x, x_lens_t, prompts, prompt_lens_t, generator=gen, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    codes, lengths = out["codes"], out["lengths"]
    assert tuple(codes.shape) == (b, max_new, cfg.num_quantizers), tuple(codes.shape)
    assert int(codes.min()) >= 0 and int(codes.max()) < cfg.num_audio_tokens
    assert lengths.cpu().tolist() == stop_lens.tolist(), (lengths.tolist(), stop_lens.tolist())
    steps = min(max_new, int(stop_lens.max()) + 1)  # the last step's logits go unused
    n_layers = cfg.num_layers
    want = {"ragged_decode": n_layers * steps,
            "prefix_attention": n_layers + (cfg.num_quantizers - 1) * cfg.nar_num_layers,
            "prefix_attention_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"

    # phase timings, outside the counted run
    def prefill():
        with torch.inference_mode():
            _prefill_kv(model, x, x_lens_t, prompts, prompt_lens_t)

    def nar():
        with torch.inference_mode():
            _nar_refine(model, x, x_lens_t, prompts, prompt_lens_t, codes[..., 0], lengths)

    prefill_ms = cuda_time(prefill, iters=3, windows=3, warmup=1)["ms"]
    nar_ms = cuda_time(nar, iters=1, windows=3, warmup=1)["ms"]
    decode_ms_per_step = (total_s * 1e3 - prefill_ms - nar_ms) / steps

    # prefill and 8 decode steps against a CPU copy (plain versions, TF32 off)
    cpu_model = get_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    forced = codes[:, :8, 0]
    gpu_logits = teacher_forced_logits(model, x, x_lens_t, prompts, prompt_lens_t, forced, True)
    cpu_logits = teacher_forced_logits(
        cpu_model, x.cpu(), x_lens_t.cpu(), prompts.cpu(), prompt_lens_t.cpu(), forced.cpu(), False)
    logit_err = float((gpu_logits - cpu_logits).abs().max())
    assert torch.isfinite(gpu_logits).all()
    assert logit_err <= LOGIT_ATOL, f"GPU logits differ from the CPU copy by {logit_err}"

    frames = int(lengths.sum())
    emit({"phase": "main_path", "model": "VALL-E default ModelConfig (d=1024, 16 heads, "
          "12+12 layers, Q=8), attn_impl=flash, kv_cache int8, ragged_decode",
          "batch": b, "text_lens": x_lens.tolist(), "prompt_lens": prompt_lens.tolist(),
          "stop_lens": stop_lens.tolist(), "decode_steps": steps, "launches": launches,
          "generate_s": total_s, "prefill_ms": prefill_ms,
          "decode_ms_per_step": decode_ms_per_step,
          "nar_ms_per_pass": nar_ms / (cfg.num_quantizers - 1),
          "frames_per_s": frames / total_s, "audio_s_per_s": frames / 75.0 / total_s,
          "peak_mem_gib": peak_gib, "logit_max_abs_err_vs_cpu": logit_err,
          "logit_atol": LOGIT_ATOL})
    return launches


# ---------------------------------------------------------------- phase 9

TRAIN_A, TRAIN_STEPS = 2, 5
# The dropout-0 check of one micro-batch on the card against a CPU copy.  The
# feed-forward ReLU is the model's one kink: a pre-activation within rounding
# of 0 can land on the other side of 0 when f32 sums run in another order,
# and that moves a whole row of the layer's linear1 gradient.  So the CPU copy
# follows the card's ReLU gates.  The gates that flipped are held to a share
# of all gates (FLIP_SHARE) and their |pre-activation| to FLIP_ATOL; the
# gradients of the same piecewise-linear function are then held per
# parameter: the largest element's error over max |g_cpu| (GRAD_RTOL) and the
# 2-norm error over |g_cpu| (GRAD_NORM_RTOL).  On an H100 the readings were
# 57 flips of 346 M gates at |h| <= 1.2e-6, element error <= 5.2e-6 and
# 2-norm error <= 2.7e-6, at the initial and at the trained weights; each
# limit is about 10x its reading.
LOSS_RTOL = 1e-5
FLIP_SHARE = 1e-6
FLIP_ATOL = 1e-5
GRAD_RTOL = 5e-5
GRAD_NORM_RTOL = 2e-5


def _train_batch(cfg, rng, dev):
    """A (A, B, ...) batch of random tokens: text 96-128 tokens, audio
    602-752 frames; the first row of each micro-batch has the full lengths."""
    import torch

    a, b, s, t = TRAIN_A, TRAIN_B, TRAIN_S, TRAIN_T
    x_lens = rng.randint(3 * s // 4, s + 1, (a, b))
    y_lens = rng.randint(int(0.8 * t), t + 1, (a, b))
    x_lens[:, 0], y_lens[:, 0] = s, t
    arrays = {
        "text_tokens": rng.randint(1, cfg.num_text_tokens, (a, b, s)),
        "text_tokens_lens": x_lens,
        "audio_features": rng.randint(0, cfg.num_audio_tokens, (a, b, t, cfg.num_quantizers)),
        "audio_features_lens": y_lens,
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def profile_breakdown(fn) -> dict:
    """One call of ``fn()`` under ``torch.profiler``: wall seconds, device
    busy seconds, the device time by kernel family and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()  # device kernels, not annotated spans
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    families = {"kernel2 (prefix_attention)": ("prefix_attention_kernel",),
                "kernel3 (prefix_attention_bwd)": ("attn_bwd_",),
                "kernel4 (flash_attention)": ("flash_bias_fwd",),
                "kernel4 (flash_attention_bwd)": ("flash_bias_bwd_",),
                "matmul (cuBLAS / CUTLASS)": ("gemm", "Gemm", "cutlass", "xmma", "sm90_")}
    by_family = {name: 0.0 for name in families}
    by_family["other"] = 0.0
    for e in kernels:
        fam = next((f for f, keys in families.items() if any(k in e.key for k in keys)), "other")
        by_family[fam] += e.self_device_time_total / 1e6
    busy = sum(by_family.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "device_s_by_family": by_family,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_s": e.self_device_time_total / 1e6} for e in top]}


def _relu_pairs(model):
    """(name, producer, consumer) of every ReLU of ``model`` in eval mode:
    the feed-forward block of each layer (linear1 -> linear2) and the two
    ReLUs of the Transformer TTS mel prenet (dropout is off in eval mode)."""
    from valle_tpu_torch.nn.layers import TransformerLayer

    for name, mod in model.named_modules():
        if isinstance(mod, TransformerLayer):
            yield name, mod.linear1, mod.linear2
    prenet = getattr(model, "decoder_prenet", None)
    if prenet is not None:
        yield "decoder_prenet.1", prenet[0], prenet[3]
        yield "decoder_prenet.4", prenet[3], prenet[6]


def _relu_gate_hooks(model, gates: dict, flips: dict) -> list:
    """Hooks on every ReLU of ``model`` (:func:`_relu_pairs`).  With
    ``gates`` empty they record, per ReLU, which inputs are above 0 (as CPU
    tensors).  Given another run's ``gates`` they make the ReLU follow them:
    the producer's output h is moved |h| + 1 up where the gate is open and
    down where it is shut, and the move is taken back off before the
    consumer, so the block computes h * gate with the gradient gate;
    ``flips`` gets, per ReLU, the number of gates that differ from this run's
    own and the largest |h| among them.  Returns the hook handles."""
    import torch

    record = not gates
    handles = []
    for name, producer, consumer in _relu_pairs(model):
        moved = []

        def after_linear1(mod, args, out, name=name, moved=moved):
            h = out.detach()
            if record:
                assert name not in gates, f"{name} ran twice"
                gates[name] = (h > 0).cpu()
                return None
            gate = gates[name].to(h.device)
            flipped = (h > 0) != gate
            flips[name] = {"gates": int(flipped.sum()),
                           "max_abs_h": float(h[flipped].abs().max()) if flipped.any() else 0.0}
            shift = h.abs() + 1.0
            moved.append(torch.where(gate, shift, torch.zeros_like(shift)))
            return out + torch.where(gate, shift, -shift)

        def before_linear2(mod, args, moved=moved):
            return None if record else (args[0] - moved.pop(),)

        handles.append(producer.register_forward_hook(after_linear1))
        handles.append(consumer.register_forward_pre_hook(before_linear2))
    return handles


def _micro_grads(model, batch, gates: dict, flips: dict, forward_kw: dict):
    """Loss and per-parameter gradients of micro-batch 0 at dropout 0, with
    the ReLU gates recorded into or taken from ``gates``."""
    model.eval()
    model.zero_grad(set_to_none=True)
    handles = _relu_gate_hooks(model, gates, flips)
    try:
        out = model(*(batch[k][0] for k in ("text_tokens", "text_tokens_lens", "audio_features",
                                            "audio_features_lens")),
                    train_stage=0, **forward_kw)
        out["loss"].backward()
    finally:
        for handle in handles:
            handle.remove()
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(out["loss"].detach()), grads


def _grad_errors(grads_gpu: dict, grads_cpu: dict):
    """Per parameter: the largest element's error over max |g_cpu|, and the
    2-norm error over |g_cpu|."""
    assert set(grads_gpu) == set(grads_cpu)
    elem = {n: float((grads_gpu[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
            for n, g in grads_cpu.items()}
    norm = {n: float((grads_gpu[n] - g).norm() / g.norm().clamp(min=1e-30))
            for n, g in grads_cpu.items()}
    return elem, norm


def gradient_check(model, batch, weights: str, phase: str = "train_gradient_check",
                   **forward_kw) -> dict:
    """One micro-batch's loss and gradients at dropout 0 on the card against
    a CPU copy of the model (plain versions) that follows the card's ReLU
    gates; fails past LOSS_RTOL, FLIP_SHARE, FLIP_ATOL, GRAD_RTOL or
    GRAD_NORM_RTOL.  The same comparison with the CPU copy on its own gates
    is reported beside it, unchecked, to show what the flipped gates alone
    move."""
    from valle_tpu_torch.models import get_model

    t0 = time.perf_counter()
    gates, flips = {}, {}
    loss_gpu, grads_gpu = _micro_grads(model, batch, gates, flips, forward_kw)
    cpu_model = get_model(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss_cpu, grads_cpu = _micro_grads(cpu_model, cpu_batch, gates, flips, forward_kw)
    _, grads_own = _micro_grads(cpu_model, cpu_batch, {}, {}, forward_kw)
    del cpu_model
    grad_err, grad_norm_err = _grad_errors(grads_gpu, grads_cpu)
    own_err, own_norm_err = _grad_errors(grads_gpu, grads_own)
    del grads_gpu, grads_cpu, grads_own
    worst = sorted(grad_err, key=grad_err.get, reverse=True)[:5]
    own_worst = sorted(own_err, key=own_err.get, reverse=True)[:5]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    flip_h = max(f["max_abs_h"] for f in flips.values())
    n_gates = sum(g.numel() for g in gates.values())
    n_flips = sum(f["gates"] for f in flips.values())
    check = {"phase": phase, "weights": weights,
             "dropout0_loss_gpu": loss_gpu, "dropout0_loss_cpu": loss_cpu,
             "dropout0_loss_rel_err": loss_err, "loss_rtol": LOSS_RTOL,
             "relu_gates": n_gates, "flipped_gates": n_flips, "flip_share": FLIP_SHARE,
             "flipped_gates_by_layer": {n: f["gates"] for n, f in flips.items() if f["gates"]},
             "flipped_max_abs_h": flip_h, "flip_atol": FLIP_ATOL,
             "worst_grads": {n: grad_err[n] for n in worst},
             "max_grad_rel_err": grad_err[worst[0]],
             "max_grad_norm_rel_err": max(grad_norm_err.values()),
             "median_grad_rel_err": float(np.median(list(grad_err.values()))),
             "grad_rtol": GRAD_RTOL, "grad_norm_rtol": GRAD_NORM_RTOL,
             "own_gates_worst_grads": {n: own_err[n] for n in own_worst},
             "own_gates_max_grad_norm_rel_err": max(own_norm_err.values()),
             "own_gates_median_grad_rel_err": float(np.median(list(own_err.values()))),
             "n_grads": len(grad_err), "seconds": time.perf_counter() - t0}
    emit(check)
    assert loss_err <= LOSS_RTOL, (loss_gpu, loss_cpu)
    assert n_flips <= FLIP_SHARE * n_gates, f"{n_flips} of {n_gates} ReLU gates flipped"
    assert flip_h <= FLIP_ATOL, f"a ReLU gate flipped at |h| = {flip_h}"
    assert grad_err[worst[0]] <= GRAD_RTOL, (worst[0], grad_err[worst[0]])
    assert max(grad_norm_err.values()) <= GRAD_NORM_RTOL, max(grad_norm_err.values())
    return check


def train_path(dev, k2d, k3):
    """Full-width VALL-E training steps (AR + NAR, dropout 0.1, ScaledAdam,
    Eden) through kernels 2 and 3, with launch counts, a bit-equal repeated
    step, and one micro-batch's loss and gradients at dropout 0 held against
    a CPU copy of the model at the initial and at the trained weights."""
    import copy
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    cfg = ModelConfig(attn_impl="fused")  # full width, dropout 0.1, f32
    torch.manual_seed(SEED)
    model = get_model(cfg)
    rng = np.random.RandomState(SEED + 5)
    batch = _train_batch(cfg, rng, dev)
    nar_stage = cfg.num_quantizers // 2
    checks = [gradient_check(model, batch, "initial", nar_stage=nar_stage)]

    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    state = init_train_state(model, make_opt, train_stage=0)
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(SEED)

    state, metrics = step(state, batch, gen, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = TRAIN_A * (cfg.num_layers + cfg.nar_num_layers)
    losses, step_s, launches = [], [], []
    for _ in range(TRAIN_STEPS):
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)), losses
    want = {"ragged_decode": 0, "prefix_attention": per_step, "prefix_attention_bwd": per_step,
            "flash_attention": 0, "flash_attention_bwd": 0}
    assert all(c == want for c in launches), f"launch counts {launches}, expected {want} per step"

    breakdown = profile_breakdown(lambda: step(state, batch, gen, 0))

    # the same state and generator state give bit-equal losses and parameters
    twin = copy.deepcopy(state)
    _, m1 = step(state, batch, torch.Generator().manual_seed(SEED + 1), 0)
    _, m2 = step(twin, batch, torch.Generator().manual_seed(SEED + 1), 0)
    repeat_equal = float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(state.model.parameters(), twin.model.parameters()))
    assert repeat_equal, (float(m1["loss"]), float(m2["loss"]))
    del twin
    checks.append(gradient_check(model, batch, f"after {state.step} steps at dropout {cfg.dropout}",
                                 nar_stage=nar_stage))

    med = float(np.median(step_s))
    frames = TRAIN_A * TRAIN_B * TRAIN_T
    # derived: kernel ms at the training shapes x launches
    k2_ms = (k2d["prefix"]["ms"] + k2d["dense_self"]["ms"]) * per_step / 2
    k3_ms = (k3["prefix float32 rate 0.1"]["ms"]
             + k3["dense_self float32 rate 0.1"]["ms"]) * per_step / 2
    emit({"phase": "train_path", "model": "VALL-E default ModelConfig (d=1024, 16 heads, "
          "12+12 layers, Q=8), attn_impl=fused, dropout 0.1, f32, train_stage 0",
          "params": n_params, "accumulation": TRAIN_A, "batch": TRAIN_B, "text_tokens": TRAIN_S,
          "frames": TRAIN_T, "optimizer": "ScaledAdam lr 0.05 clip 2.0 betas (0.9, 0.95), Eden "
          "warmup 200", "losses": losses, "step_s": step_s, "step_s_median": med,
          "frames_per_s": frames / med, "audio_s_per_s": frames / 75.0 / med,
          "peak_mem_gib": peak_gib, "launches_per_step": launches[0],
          "kernel2_ms_per_step": k2_ms, "kernel3_ms_per_step": k3_ms,
          "kernel2_share": k2_ms / 1e3 / med, "kernel3_share": k3_ms / 1e3 / med,
          "profiled_step": breakdown, "repeat_bit_equal": repeat_equal,
          "dropout0_max_grad_rel_err": [c["max_grad_rel_err"] for c in checks],
          "dropout0_flipped_gates": [c["flipped_gates"] for c in checks]})
    return launches[0]


# -------------------------------------------------------- phases 10 and 11

TTS_STEPS = 5
CHECK_STEPS = 8  # inference steps held against the CPU copy


def _counters():
    from valle_tpu_torch.ops.flash_attention import (
        flash_attention_biased, flash_attention_biased_backward)
    from valle_tpu_torch.ops.fused_attention import (
        fused_prefix_attention, fused_prefix_attention_backward)
    from valle_tpu_torch.ops.ragged_decode import ragged_decode_attention

    return {"ragged_decode": ragged_decode_attention,
            "prefix_attention": fused_prefix_attention,
            "prefix_attention_bwd": fused_prefix_attention_backward,
            "flash_attention": flash_attention_biased,
            "flash_attention_bwd": flash_attention_biased_backward}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _tts_batch(cfg, rng, dev):
    """A (1, B, ...) batch: text 96-128 tokens, synthetic mels (standard
    normal, 100 bins) of 750-938 frames; the first row has the full
    lengths."""
    import torch

    b, s, t = TTS_B, TTS_S, TTS_T
    x_lens = rng.randint(3 * s // 4, s + 1, (1, b))
    y_lens = rng.randint(int(0.8 * t), t + 1, (1, b))
    x_lens[:, 0], y_lens[:, 0] = s, t
    arrays = {
        "text_tokens": rng.randint(1, cfg.num_text_tokens, (1, b, s)),
        "text_tokens_lens": x_lens,
        "audio_features": rng.randn(1, b, t, cfg.num_mel_bins).astype(np.float32),
        "audio_features_lens": y_lens,
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def tts_train_path(dev):
    """Full-width Transformer TTS baseline training steps through kernels 2,
    3 and 4, with launch counts per step, a bit-equal repeated step, and the
    loss and gradients in eval mode held against a CPU copy."""
    import copy
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    # the default widths (d=1024, 16 heads, 12 + 12 layers, FFN 4096, 100 mel
    # bins), f32; attention dropout 0 keeps the decoder self-attention on
    # kernel 4, while the prenet (0.5) and positional (0.1) dropouts stay on
    cfg = ModelConfig(model_name="Transformer", attn_impl="flash", dropout=0.0)
    torch.manual_seed(SEED)
    model = get_model(cfg)
    batch = _tts_batch(cfg, np.random.RandomState(SEED + 7), dev)
    check = gradient_check(model, batch, "initial", phase="tts_gradient_check")

    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    state = init_train_state(model, make_opt, train_stage=0)
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(SEED)

    state, metrics = step(state, batch, gen, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for _ in range(TTS_STEPS):
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)), losses
    n = cfg.num_layers
    want = {"ragged_decode": 0, "prefix_attention": 2 * n, "prefix_attention_bwd": 2 * n,
            "flash_attention": n, "flash_attention_bwd": n}
    assert all(c == want for c in launches), f"launch counts {launches}, expected {want} per step"

    breakdown = profile_breakdown(lambda: step(state, batch, gen, 0))

    twin = copy.deepcopy(state)
    _, m1 = step(state, batch, torch.Generator().manual_seed(SEED + 1), 0)
    _, m2 = step(twin, batch, torch.Generator().manual_seed(SEED + 1), 0)
    repeat_equal = float(m1["loss"]) == float(m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(state.model.parameters(), twin.model.parameters()))
    assert repeat_equal, (float(m1["loss"]), float(m2["loss"]))
    del twin, state, model

    med = float(np.median(step_s))
    frames = TTS_B * TTS_T
    emit({"phase": "tts_train", "model": "Transformer TTS default ModelConfig (d=1024, 16 heads, "
          "12 encoder + 12 decoder layers, FFN 4096, 100 mel bins), attn_impl=flash, attention "
          "dropout 0, prenet dropout 0.5, positional dropout 0.1, f32",
          "params": n_params, "batch": TTS_B, "text_tokens": TTS_S, "frames": TTS_T,
          "text_lens": batch["text_tokens_lens"][0].tolist(),
          "frame_lens": batch["audio_features_lens"][0].tolist(),
          "optimizer": "ScaledAdam lr 0.05 clip 2.0 betas (0.9, 0.95), Eden warmup 200",
          "losses": losses, "step_s": step_s, "step_s_median": med,
          "frames_per_s": frames / med, "audio_s_per_s": frames * 256 / 24000 / med,
          "peak_mem_gib": peak_gib, "launches_per_step": launches[0],
          "profiled_step": breakdown, "repeat_bit_equal": repeat_equal,
          "eval_max_grad_rel_err": check["max_grad_rel_err"],
          "eval_flipped_gates": check["flipped_gates"]})
    return launches[0]


def tts_inference_path(dev):
    """The Transformer TTS baseline's greedy mel loop at full width on 8
    requests for INF_STEPS steps, with launch counts and the first
    CHECK_STEPS mels held against a CPU copy."""
    import torch

    from valle_tpu_torch.models import ModelConfig, get_model

    cfg = ModelConfig(model_name="Transformer", attn_impl="flash")
    torch.manual_seed(SEED)
    model = get_model(cfg)
    rng = np.random.RandomState(SEED + 8)
    x_lens = rng.randint(INF_S * 5 // 8, INF_S + 1, INF_B)  # 40-64 tokens
    x = torch.from_numpy(rng.randint(1, cfg.num_text_tokens, (INF_B, INF_S))).to(dev)
    x_lens_t = torch.from_numpy(x_lens).to(dev)

    model.inference(x, x_lens_t, max_steps=4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = model.inference(x, x_lens_t, max_steps=INF_STEPS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.num_layers
    want = {"ragged_decode": 0, "prefix_attention": n + n * INF_STEPS, "prefix_attention_bwd": 0,
            "flash_attention": n * INF_STEPS, "flash_attention_bwd": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"
    mel, lengths = out["mel"], out["lengths"]
    assert tuple(mel.shape) == (INF_B, INF_STEPS, cfg.num_mel_bins), tuple(mel.shape)
    assert torch.isfinite(mel).all()
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= INF_STEPS

    # the first steps against a CPU copy: step i reads frames <= i only, so a
    # shorter loop gives the same first frames
    cpu_model = get_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu = cpu_model.inference(x.cpu(), x_lens_t.cpu(), max_steps=CHECK_STEPS)
    del cpu_model
    mel_err = float((mel[:, :CHECK_STEPS].cpu() - cpu["mel"]).abs().max())
    assert mel_err <= LOGIT_ATOL, f"GPU mels differ from the CPU copy by {mel_err}"
    assert lengths.cpu().clamp(max=CHECK_STEPS).tolist() == cpu["lengths"].tolist(), (
        lengths.tolist(), cpu["lengths"].tolist())
    emit({"phase": "tts_inference", "model": "Transformer TTS default ModelConfig, "
          "attn_impl=flash, f32, greedy, full recompute per step", "batch": INF_B,
          "text_lens": x_lens.tolist(), "max_steps": INF_STEPS, "launches": launches,
          "lengths": lengths.tolist(), "call_s": total_s, "ms_per_step": total_s * 1e3 / INF_STEPS,
          "frames_per_s": INF_B * INF_STEPS / total_s, "peak_mem_gib": peak_gib,
          "mel_max_abs_err_vs_cpu": mel_err, "checked_steps": CHECK_STEPS,
          "mel_atol": LOGIT_ATOL})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from valle_tpu_torch.ops import cuda_build  # fails where the package is absent

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    seconds = cuda_build.build(KERNELS)
    fwd_log = cuda_build.log_path("prefix_attention")
    fwd = kernel_resources(fwd_log.with_suffix(".so"), fwd_log)
    bwd_log = cuda_build.log_path("prefix_attention_bwd")
    bwd = kernel_resources(bwd_log.with_suffix(".so"), bwd_log)
    k1_log = cuda_build.log_path("ragged_decode")
    k1 = kernel_resources(k1_log.with_suffix(".so"), k1_log, ragged_label, (("i2f", "I2F"),))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": seconds,
          "ptxas": {name: ptxas_summary(cuda_build.log_path(name)) for name in KERNELS},
          "kernel1_kernels": k1, "forward_kernels": fwd, "backward_kernels": bwd})
    # kernel 1: five lane layouts per cache type, and the combine kernel in two sizes
    assert len(k1) == 17, f"expected 17 kernel 1 kernels, found {sorted(k1)}"
    assert all(r["spill_bytes"] == 0 for r in k1.values()), "ptxas spills in kernel 1"
    assert all(r["i2f"] == 0 for n, r in k1.items() if "int8" in n), \
        "an int8-cache instantiation of kernel 1 converts with I2F"
    # kernel 2: f32 / bf16 x Dh 16 / 32 / 64 / 128 x dropout or not; kernel 4 without
    assert len(fwd) == 24, f"expected 24 forward kernels, found {sorted(fwd)}"
    assert all(r["hmma"] > 0 for r in fwd.values()), "a forward kernel runs no tensor-core MMA"
    assert all(r["spill_bytes"] == 0 for r in fwd.values()), "ptxas spills in the forward"
    passes = {n: r for n, r in bwd.items() if "delta" not in n}
    assert len(passes) == 48, f"expected 48 backward pass kernels, found {sorted(passes)}"
    assert all(r["hmma"] > 0 for r in passes.values()), "a backward pass runs no tensor-core MMA"
    assert all(r["spill_bytes"] == 0 for r in bwd.values()), "ptxas spills in the backward"

    k1 = check_ragged_decode(dev)
    check_prefix_attention(dev, fwd)
    k2d = check_dropout_forward(dev, fwd)
    k3 = check_backward(dev, bwd)
    k4 = check_flash_bias(dev, fwd, bwd)
    check_head_dims(dev)
    paths = {"generate": main_path(dev), "train_step": train_path(dev, k2d, k3),
             "tts_train_step": tts_train_path(dev), "tts_inference": tts_inference_path(dev)}

    def entry(name, source, replaces, res, path):
        by_path = {p: counts[name] for p, counts in paths.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path[path], "launches_by_path": by_path, "case": res["case"],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "ms_spread": [res["ms_min"], res["ms_max"]], "device_ms": res["device_ms"],
                "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res["library_ms"]}

    emit({"kernels": [
        entry("ragged_decode", "valle_tpu_torch/csrc/ragged_decode.cu",
              "valle_tpu/ops/ragged_decode.py:56", k1, "generate"),
        entry("prefix_attention", "valle_tpu_torch/csrc/prefix_attention.cu",
              "valle_tpu/ops/fused_attention.py:110", k2d["dense_self"], "train_step"),
        entry("prefix_attention_bwd", "valle_tpu_torch/csrc/prefix_attention_bwd.cu",
              "valle_tpu/ops/fused_attention.py:139", k3["dense_self float32 rate 0.1"],
              "train_step"),
        entry("flash_attention", "valle_tpu_torch/csrc/prefix_attention.cu",
              "valle_tpu/ops/flash_attention.py:46", k4["decoder float32"]["forward"],
              "tts_train_step"),
        entry("flash_attention_bwd", "valle_tpu_torch/csrc/prefix_attention_bwd.cu",
              "valle_tpu/ops/flash_attention.py:46", k4["decoder float32"]["backward"],
              "tts_train_step"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
