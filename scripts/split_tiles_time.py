#!/usr/bin/env python3
"""Time kernels 2-4 above head dim 256 (the forward's and the backward's
cluster kernels, or in an older checkout its split ones) on one CUDA card,
at the shapes and operations of the Dh-256 rows of PERF.md section 6.

    python3 scripts/split_tiles_time.py [--backward-only | --forward-only] [--out FILE]
    python3 scripts/split_tiles_time.py --checkouts PARENT . . PARENT
                                        [--backward-only | --forward-only] [--out FILE]

At Dh 512 (2 heads) and Dh 1024 (1 head), so that H * Dh = 1024 as in the
default VALL-E and the Transformer TTS, in f32 and bf16:

- kernel 2's forward with its LSE and kernel 3 (the backward) on dense
  self-attention, B=4, T=880 (``chip_smoke.TRAIN_S + TRAIN_T``), dropout 0.1;
- kernel 4's forward and backward on the TTS decoder's causal + padding
  bias, B=4, T=938.

Each call is held against its plain version (TOL, a bit-equal rerun; the
forward's LSE at the f32 bar) and timed as ``chip_smoke.py`` times the Dh-256
rows (``_measure``): CUDA-event ms (median of 5 windows), device ms from
``torch.profiler`` (the backward also per pass: delta, dQ, dK/dV), the plain
version's ms, SDPA's ms on the same dense mask (its backward: one
``autograd.grad`` call), and the bound: the rows' operations (4 B H Dh T^2
forward, 10 B H Dh T^2 backward) over the type's peak, or bytes, whichever
is larger.  The profiler also names the kernels each call launches, which
must be the forward's kernel on the route the checkout's ``forward_plan``
gives and the backward's passes on the route of its ``backward_plan`` (the
split kernels in a checkout that has no such plan); each forward row lists
its kernel's registers, spills and HMMA from the checkout's build log.
``--backward-only`` / ``--forward-only`` time one direction's rows alone.
Prints one JSON line per case, then the card's name and power limit;
``--out`` writes the cases as one JSON file as well.

``--checkouts`` runs the same cases in each checkout given (one fresh
process each, importing ``valle_tpu_torch`` and ``chip_smoke`` from that
checkout; give them in an order that cancels drift: parent, change, change,
parent), after building every distinct checkout's kernels side by side, and
prints one more line: each case's device ms (and per pass) and event ms per
checkout in the order given.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

HEAD_DIMS = ((512, 2), (1024, 1))  # (Dh, heads)
SOURCES = ["prefix_attention", "prefix_attention_bwd"]


def _arg(name):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


def measure(backward_only: bool, forward_only: bool = False) -> list:
    """The cases in the checkout whose ``chip_smoke`` is importable."""
    import numpy as np
    import torch
    from torch.nn import functional as F

    import chip_smoke as cs
    from valle_tpu_torch.ops import cuda_build
    from valle_tpu_torch.ops import flash_attention as fl
    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.masks import AttnMaskSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(SOURCES)
    log = cuda_build.log_path("prefix_attention")
    fwd_res = cs.kernel_resources(log.with_suffix(".so"), log)
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

    def route_of(plan_name, dh, dt):
        plan = getattr(fa, plan_name, None)
        return plan(dh, dt).route if plan is not None else "split"

    def forward_row(res, call, kernel, dtype, route):
        """The route's forward kernel, and its registers, spills and HMMA."""
        res["route"] = route
        res["cuda_kernels"] = launched(call, [kernel])
        res["kernels"] = {k: r for k, r in fwd_res.items() if k.startswith(f"{kernel}<{dtype}")}
        return res

    def backward_row(res, call, prefix, route):
        """The route's pass kernels, and device ms per pass."""
        passes = {"delta": "attn_bwd_delta", "dq": f"{prefix}_dq_{route}",
                  "dkv": f"{prefix}_dkv_{route}"}
        res["route"] = route
        res["cuda_kernels"] = launched(call, [f"{passes['dq']}_kernel",
                                              f"{passes['dkv']}_kernel"])
        res["device_ms_by_pass"] = {p: cs.device_ms(call, [name], iters=5)
                                    for p, name in passes.items()}
        return res

    results = []

    def emit(res):
        results.append(res)
        print(json.dumps(res), flush=True)

    for dh, h in HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            route, froute = route_of("backward_plan", dh, dt), route_of("forward_plan", dh, dt)
            q, k, v, dout = (torch.from_numpy(rng.randn(cs.TRAIN_B, t, h, dh).astype(np.float32))
                             .to(dev, dt) for _ in range(4))
            seed = int(rng.randint(0, 2**62))
            args = (q, k, v, kb, None, cs.DROPOUT, seed)
            mask = AttnMaskSpec(kb, None).dense(t).to(dt)
            ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
            fwd = lambda: fa._forward(*args, with_lse=True)  # noqa: E731
            if not backward_only:
                kernel = f"prefix_attention_{froute}_kernel"
                res = cs._measure_forward(
                    f"kernel 2 dense self T={t} H={h} Dh={dh} rate {cs.DROPOUT} {dtype}", fwd,
                    fa.attention_forward_reference(*args), [kernel],
                    lambda: fa.attention_forward_reference(*args),
                    lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                           dropout_p=cs.DROPOUT),
                    fwd_bytes(q, k, kb), 4.0 * cs.TRAIN_B * h * dh * t * t, dtype, {})
                emit(forward_row(res, fwd, kernel, dtype, froute))
            out, lse = fwd()
            kw = dict(prefix_s=None, dropout_rate=cs.DROPOUT, dropout_seed=seed)
            k3 = lambda: fa.fused_prefix_attention_backward(  # noqa: E731
                q, k, v, kb, out, dout, lse, **kw)
            if not forward_only:
                res = cs._measure(
                    f"kernel 3 dense self T={t} H={h} Dh={dh} rate {cs.DROPOUT} {dtype}", k3,
                    fa.attention_backward_reference(q, k, v, kb, out, dout, lse, None,
                                                    cs.DROPOUT, seed),
                    True, ["attn_bwd_"], lambda: fa.attention_backward_reference(
                        q, k, v, kb, out, dout, lse, None, cs.DROPOUT, seed),
                    sdpa_grad(q, k, v, dout, mask, cs.DROPOUT),
                    q.numel() * 8 * q.element_size() + kb.numel() * 4 + cs.TRAIN_B * h * t * 8,
                    10.0 * cs.TRAIN_B * h * dh * t * t, dtype, {})
                emit(backward_row(res, k3, "attn_bwd", route))
            del q, k, v, dout, out, lse, mask, ql, kl, vl
            q, k, v, dout = (torch.from_numpy(rng.randn(cs.TTS_B, cs.TTS_T, h, dh)
                                              .astype(np.float32)).to(dev, dt) for _ in range(4))
            mask = dec.to(dt)
            ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
            fwd = lambda: fl._forward(q, k, v, dec, with_lse=True)  # noqa: E731
            if not backward_only:
                kernel = f"flash_bias_fwd_{froute}_kernel"
                res = cs._measure_forward(
                    f"kernel 4 TTS decoder B={cs.TTS_B} T={cs.TTS_T} H={h} Dh={dh} {dtype}", fwd,
                    fl.flash_attention_forward_reference(q, k, v, dec), [kernel],
                    lambda: fl.flash_attention_forward_reference(q, k, v, dec),
                    lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                    fwd_bytes(q, k, dec), 4.0 * cs.TTS_B * h * dh * cs.TTS_T * cs.TTS_T, dtype,
                    {})
                emit(forward_row(res, fwd, kernel, dtype, froute))
            out, lse = fwd()
            k4 = lambda: fl.flash_attention_biased_backward(  # noqa: E731
                q, k, v, dec, out, dout, lse)[:3]
            if not forward_only:
                res = cs._measure(
                    f"kernel 4 backward TTS decoder B={cs.TTS_B} T={cs.TTS_T} H={h} Dh={dh} "
                    f"{dtype}", k4,
                    fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse)[:3],
                    True, ["flash_bias_bwd_", "attn_bwd_delta"],
                    lambda: fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse),
                    sdpa_grad(q, k, v, dout, mask, 0.0),
                    q.numel() * 8 * q.element_size() + dec.numel() * 4
                    + cs.TTS_B * h * cs.TTS_T * 8,
                    10.0 * cs.TTS_B * h * dh * cs.TTS_T * cs.TTS_T, dtype, {})
                emit(backward_row(res, k4, "flash_bias_bwd", route))
            del q, k, v, dout, out, lse, mask, ql, kl, vl
    return results


def compare(checkouts, flags) -> dict:
    """Build each distinct checkout's kernels side by side, then run the
    cases in each checkout in turn; each case's numbers per checkout, and
    under "runs" every case of every run as ``measure`` gives it."""
    roots = [str(Path(c).resolve()) for c in checkouts]
    build = ("import sys; sys.path.insert(0, '.'); from valle_tpu_torch.ops import cuda_build; "
             f"cuda_build.build({SOURCES!r})")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=r) for r in dict.fromkeys(roots)]
    assert all(p.wait() == 0 for p in procs), "a checkout's kernels did not build"
    runs = []
    for root in roots:
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--root", root, "--out", f.name]
            subprocess.run(cmd + flags, cwd=root, check=True)
            runs.append(json.loads(Path(f.name).read_text())["cases"])
    by_case = {"runs": [{"checkout": c, "cases": cases} for c, cases in zip(checkouts, runs)]}
    for checkout, cases in zip(checkouts, runs):
        for c in cases:
            by_case.setdefault(c["case"], []).append({
                "checkout": checkout, "device_ms": c["device_ms"], "ms": c["ms"],
                **({"route": c["route"]} if "route" in c else {}),
                **({"by_pass": c["device_ms_by_pass"]} if "device_ms_by_pass" in c else {})})
    return by_case


def main() -> int:
    root = _arg("--root")
    sys.path.insert(0, root or str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("split_tiles_time: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    backward_only, forward_only = "--backward-only" in sys.argv, "--forward-only" in sys.argv
    out_path = _arg("--out")
    if "--checkouts" in sys.argv:
        i = sys.argv.index("--checkouts") + 1
        checkouts = []
        while i < len(sys.argv) and not sys.argv[i].startswith("--"):
            checkouts.append(sys.argv[i])
            i += 1
        by_case = compare(checkouts, [f for f in ("--backward-only", "--forward-only")
                                      if f in sys.argv])
        smi = cs._smi()
        summary = {c: runs for c, runs in by_case.items() if c != "runs"}
        print(json.dumps({"checkouts": checkouts, "cases": summary, "nvidia_smi": smi}),
              flush=True)
        if out_path:
            Path(out_path).write_text(json.dumps({"nvidia_smi": smi, "checkouts": checkouts,
                                                  "cases": by_case}))
        return 0
    results = measure(backward_only, forward_only)
    smi = cs._smi()
    print(json.dumps({"nvidia_smi": smi, "cases": len(results)}), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps({"nvidia_smi": smi, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
