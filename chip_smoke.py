#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``valle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (no phase is caught: the first failure
ends the run with a non-zero exit code):

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
     (TF32 is switched off for matmuls and cuDNN);
  2. build: both kernels from ``valle_tpu_torch/csrc`` with ``nvcc``;
  3. kernel 1 (ragged decode attention) against its plain PyTorch version at
     decode shapes, int8 / f32 / bf16 caches, with timings;
  4. kernel 2 (prefix-LM / dense attention) against its plain version in
     prefix, causal, dense self- and cross-attention modes, with timings;
  5. main path: full-width VALL-E (the default ModelConfig, seeded random
     weights) ``generate`` on 8 requests, with launch counts, the prefill and
     decode logits held against a CPU copy of the model, and timings;
  6. a ``kernels`` summary line, then the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero without CUDA, and where the port's package is not beside it.
Needs one card, no network; every timing is taken with CUDA events or after
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}  # dense, no TF32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGIT_ATOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, op_type: str):
    """(bound_ms, bound_by): the larger of the memory and the compute time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3


def check_ragged_decode(dev):
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.nn.attention import quantize_kv
    from valle_tpu_torch.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)

    rng = np.random.RandomState(SEED)
    b, c, h, dh = 8, 1024, 16, 64
    lens = np.array([0, c, 517, 300, 1, 777, 64, 900], np.int32)
    qf = torch.from_numpy(rng.randn(b, 1, h, dh).astype(np.float32)).to(dev)
    kf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    vf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
    bias = torch.from_numpy(np.where(rng.rand(b, c) < 0.1, -1e9, 0.0).astype(np.float32)).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    live = int(lens.sum())
    results = []
    for cache in ("int8", "float32", "bfloat16"):
        if cache == "int8":
            q = qf
            k, ks = quantize_kv(kf)
            v, vs = quantize_kv(vf)
            elem, op_type, tol = 1, "int8", TOL["float32"]
            k_lib, v_lib = (k.float() * ks[..., None]), (v.float() * vs[..., None])
        else:
            dt = getattr(torch, cache)
            q, k, v, ks, vs = qf.to(dt), kf.to(dt), vf.to(dt), None, None
            elem, op_type, tol = k.element_size(), cache, TOL[cache]
            k_lib, v_lib = k, v
        args = (q, k, v, lengths, bias, ks, vs)
        got = ragged_decode_attention(*args)
        want = ragged_decode_attention_reference(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.isfinite(got).all(), cache
        assert float(got[0].abs().max()) == 0.0, "a length-0 slot must give exact zeros"
        assert err <= tol, f"kernel 1 ({cache} cache) disagrees with its plain version: {err}"
        ms = cuda_ms(lambda: ragged_decode_attention(*args))
        plain_ms = cuda_ms(lambda: ragged_decode_attention_reference(*args))
        # yardstick: one SDPA call on the same (dequantized) data and mask
        col = torch.arange(c, device=dev)[None, :]
        mask = torch.where(col < lengths[:, None].long(), bias, float("-inf"))[:, None, None, :]
        mask = mask.to(q.dtype)
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k_lib.to(q.dtype), v_lib.to(q.dtype)))
        # slot 0 (length 0) has no finite column for SDPA, so the yardstick skips it
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            ql[1:], kl[1:], vl[1:], attn_mask=mask[1:]))
        n_bytes = (live * h * dh * 2 * elem + (live * h * 4 * 2 if cache == "int8" else 0)
                   + live * 4 + b * 4 + b * h * dh * (q.element_size() + 4))
        bound_ms, bound_by = bound(n_bytes, 4.0 * live * h * dh, op_type)
        results.append({"case": f"{cache} cache", "b": b, "c": c, "h": h, "dh": dh,
                        "live_columns": live, "max_abs_err": err, "tol": tol, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by})
    emit({"phase": "kernel1_ragged_decode", "cases": results})
    return results[0]


# ---------------------------------------------------------------- phase 4


def _visible_columns(tq: int, tk: int, prefix_s) -> int:
    if prefix_s is None:
        return tq * tk
    rows = np.arange(tq)
    cols = np.where(rows < prefix_s, prefix_s, np.maximum(prefix_s, rows + 1))
    return int(np.minimum(cols, tk).sum())


def check_prefix_attention(dev):
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
        ms = cuda_ms(lambda: fused_prefix_attention(q, k, v, kb, prefix_s=prefix_s))
        plain_ms = cuda_ms(lambda: fused_prefix_attention_reference(q, k, v, kb, prefix_s), iters=5)
        mask = AttnMaskSpec(kb, prefix_s).dense(tq).to(dt)  # built outside the timing
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask))
        vis = _visible_columns(tq, tk, prefix_s)
        n_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() + kb.numel() * 4
        bound_ms, bound_by = bound(n_bytes, 4.0 * b * h * dh * vis, dtype)
        results[name] = {"case": name, "b": b, "tq": tq, "tk": tk, "prefix_s": prefix_s,
                         "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype], "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "tflops": 4.0 * b * h * dh * vis / ms / 1e9}
    emit({"phase": "kernel2_prefix_attention", "cases": list(results.values())})
    return results["dense_nar"]


# ---------------------------------------------------------------- phase 5


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
    from valle_tpu_torch.ops.fused_attention import fused_prefix_attention
    from valle_tpu_torch.ops.ragged_decode import ragged_decode_attention
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
    ragged_decode_attention.launches = 0
    fused_prefix_attention.launches = 0
    t0 = time.perf_counter()
    out = generate(model, x, x_lens_t, prompts, prompt_lens_t, generator=gen, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"ragged_decode": ragged_decode_attention.launches,
                "prefix_attention": fused_prefix_attention.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    codes, lengths = out["codes"], out["lengths"]
    assert tuple(codes.shape) == (b, max_new, cfg.num_quantizers), tuple(codes.shape)
    assert int(codes.min()) >= 0 and int(codes.max()) < cfg.num_audio_tokens
    assert lengths.cpu().tolist() == stop_lens.tolist(), (lengths.tolist(), stop_lens.tolist())
    steps = min(max_new, int(stop_lens.max()) + 1)  # the last step's logits go unused
    n_layers = cfg.num_layers
    want = {"ragged_decode": n_layers * steps,
            "prefix_attention": n_layers + (cfg.num_quantizers - 1) * cfg.nar_num_layers}
    assert launches == want, f"launch counts {launches}, expected {want}"

    # phase timings, outside the counted run
    def prefill():
        with torch.inference_mode():
            _prefill_kv(model, x, x_lens_t, prompts, prompt_lens_t)

    def nar():
        with torch.inference_mode():
            _nar_refine(model, x, x_lens_t, prompts, prompt_lens_t, codes[..., 0], lengths)

    prefill_ms = cuda_ms(prefill, iters=3, warmup=1)
    nar_ms = cuda_ms(nar, iters=2, warmup=1)
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
    seconds = cuda_build.build(["ragged_decode", "prefix_attention"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": seconds})

    k1 = check_ragged_decode(dev)
    k2 = check_prefix_attention(dev)
    launches = main_path(dev)

    def entry(name, source, replaces, res):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"]}

    emit({"kernels": [
        entry("ragged_decode", "valle_tpu_torch/csrc/ragged_decode.cu",
              "valle_tpu/ops/ragged_decode.py:56", k1),
        entry("prefix_attention", "valle_tpu_torch/csrc/prefix_attention.cu",
              "valle_tpu/ops/fused_attention.py:110", k2),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
