#!/usr/bin/env python3
"""Time kernels 2-4's split instantiations (head dims above 256) on one CUDA
card, at the shapes and operations of the Dh-256 rows of PERF.md section 6.

    python3 scripts/split_tiles_time.py [--out FILE]

At Dh 512 (2 heads) and Dh 1024 (1 head), so that H * Dh = 1024 as in the
default VALL-E and the Transformer TTS, in f32 and bf16:

- kernel 2's forward with its LSE and kernel 3 (the backward) on dense
  self-attention, B=4, T=880 (``chip_smoke.TRAIN_S + TRAIN_T``), dropout 0.1;
- kernel 4's forward and backward on the TTS decoder's causal + padding
  bias, B=4, T=938.

Each call is held against its plain version (TOL, a bit-equal rerun; the
forward's LSE at the f32 bar) and timed as ``chip_smoke.py`` times the Dh-256
rows (``_measure``): CUDA-event ms (median of 5 windows), device ms from
``torch.profiler`` (the backward also per pass), the plain version's ms,
SDPA's ms on the same dense mask (its backward: one ``autograd.grad``
call), and the bound: the rows' operations (4 B H Dh T^2 forward, 10 B H
Dh T^2 backward) over the type's peak, or bytes, whichever is larger.  The
profiler also names the kernels each call launches, which must be the split
instantiations.  Prints one JSON line per case, then the card's name and
power limit; ``--out`` writes the cases as one JSON file as well.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

HEAD_DIMS = ((512, 2), (1024, 1))  # (Dh, heads)


def main() -> int:
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops import cuda_build
    from valle_tpu_torch.ops import flash_attention as fl
    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.masks import AttnMaskSpec

    if not torch.cuda.is_available():
        print("split_tiles_time: CUDA is not available", file=sys.stderr)
        return 2
    out_path = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build(["prefix_attention", "prefix_attention_bwd"])
    rng = np.random.RandomState(cs.SEED + 16)
    t = cs.TRAIN_S + cs.TRAIN_T
    kb = torch.from_numpy(cs._train_key_bias(rng, cs.TRAIN_S, cs.TRAIN_T)).to(dev)
    dec = torch.from_numpy(cs._decoder_bias(rng, cs.TTS_B, cs.TTS_T, int(0.8 * cs.TTS_T))).to(dev)

    def sdpa_grad(q, k, v, dout, mask, rate):
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, dropout_p=rate)
        return lambda: torch.autograd.grad(ol, (ql, kl, vl), dout.transpose(1, 2),
                                           retain_graph=True)

    def fwd_bytes(q, k, bias):
        return ((2 * q.numel() + 2 * k.numel()) * q.element_size() + bias.numel() * 4
                + q.shape[0] * q.shape[1] * q.shape[2] * 4)

    def launched(fn, want):
        names = cs.launched_kernels(fn)
        for name in want:
            assert any(name in n for n in names), f"no {name} among {sorted(names)}"
        return sorted(n for n in names if any(w in n for w in want))

    results = []
    for dh, h in HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v, dout = (torch.from_numpy(rng.randn(cs.TRAIN_B, t, h, dh).astype(np.float32))
                             .to(dev, dt) for _ in range(4))
            seed = int(rng.randint(0, 2**62))
            args = (q, k, v, kb, None, cs.DROPOUT, seed)
            mask = AttnMaskSpec(kb, None).dense(t).to(dt)
            ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
            fwd = lambda: fa._forward(*args, with_lse=True)  # noqa: E731
            res = cs._measure_forward(
                f"kernel 2 dense self T={t} H={h} Dh={dh} rate {cs.DROPOUT} {dtype}", fwd,
                fa.attention_forward_reference(*args), ["prefix_attention_split_kernel"],
                lambda: fa.attention_forward_reference(*args),
                lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                       dropout_p=cs.DROPOUT),
                fwd_bytes(q, k, kb), 4.0 * cs.TRAIN_B * h * dh * t * t, dtype, {})
            res["cuda_kernels"] = launched(fwd, ["prefix_attention_split_kernel"])
            results.append(res)
            print(json.dumps(res), flush=True)
            out, lse = fwd()
            kw = dict(prefix_s=None, dropout_rate=cs.DROPOUT, dropout_seed=seed)
            k3 = lambda: fa.fused_prefix_attention_backward(  # noqa: E731
                q, k, v, kb, out, dout, lse, **kw)
            res = cs._measure(
                f"kernel 3 dense self T={t} H={h} Dh={dh} rate {cs.DROPOUT} {dtype}", k3,
                fa.attention_backward_reference(q, k, v, kb, out, dout, lse, None, cs.DROPOUT,
                                                seed),
                True, ["attn_bwd_"], lambda: fa.attention_backward_reference(
                    q, k, v, kb, out, dout, lse, None, cs.DROPOUT, seed),
                sdpa_grad(q, k, v, dout, mask, cs.DROPOUT),
                q.numel() * 8 * q.element_size() + kb.numel() * 4 + cs.TRAIN_B * h * t * 8,
                10.0 * cs.TRAIN_B * h * dh * t * t, dtype, {})
            res["cuda_kernels"] = launched(k3, ["attn_bwd_dq_split_kernel",
                                                "attn_bwd_dkv_split_kernel"])
            res["device_ms_by_pass"] = {
                name: cs.device_ms(k3, [name], iters=5)
                for name in ("attn_bwd_delta", "attn_bwd_dq_split", "attn_bwd_dkv_split")}
            results.append(res)
            print(json.dumps(res), flush=True)
            del q, k, v, dout, out, lse, mask, ql, kl, vl
            q, k, v, dout = (torch.from_numpy(rng.randn(cs.TTS_B, cs.TTS_T, h, dh)
                                              .astype(np.float32)).to(dev, dt) for _ in range(4))
            mask = dec.to(dt)
            ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
            fwd = lambda: fl._forward(q, k, v, dec, with_lse=True)  # noqa: E731
            res = cs._measure_forward(
                f"kernel 4 TTS decoder B={cs.TTS_B} T={cs.TTS_T} H={h} Dh={dh} {dtype}", fwd,
                fl.flash_attention_forward_reference(q, k, v, dec),
                ["flash_bias_fwd_split_kernel"],
                lambda: fl.flash_attention_forward_reference(q, k, v, dec),
                lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                fwd_bytes(q, k, dec), 4.0 * cs.TTS_B * h * dh * cs.TTS_T * cs.TTS_T, dtype, {})
            res["cuda_kernels"] = launched(fwd, ["flash_bias_fwd_split_kernel"])
            results.append(res)
            print(json.dumps(res), flush=True)
            out, lse = fwd()
            k4 = lambda: fl.flash_attention_biased_backward(  # noqa: E731
                q, k, v, dec, out, dout, lse)[:3]
            res = cs._measure(
                f"kernel 4 backward TTS decoder B={cs.TTS_B} T={cs.TTS_T} H={h} Dh={dh} {dtype}",
                k4, fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse)[:3],
                True, ["flash_bias_bwd_", "attn_bwd_delta"],
                lambda: fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse),
                sdpa_grad(q, k, v, dout, mask, 0.0),
                q.numel() * 8 * q.element_size() + dec.numel() * 4 + cs.TTS_B * h * cs.TTS_T * 8,
                10.0 * cs.TTS_B * h * dh * cs.TTS_T * cs.TTS_T, dtype, {})
            res["cuda_kernels"] = launched(k4, ["flash_bias_bwd_dq_split_kernel",
                                                "flash_bias_bwd_dkv_split_kernel"])
            res["device_ms_by_pass"] = {
                name: cs.device_ms(k4, [name], iters=5)
                for name in ("attn_bwd_delta", "flash_bias_bwd_dq_split",
                             "flash_bias_bwd_dkv_split")}
            results.append(res)
            print(json.dumps(res), flush=True)
            del q, k, v, dout, out, lse, mask, ql, kl, vl
    smi = cs._smi()
    print(json.dumps({"nvidia_smi": smi, "cases": len(results)}), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps({"nvidia_smi": smi, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
