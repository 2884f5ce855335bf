#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``valle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (no phase is caught: the first failure
ends the run with a non-zero exit code):

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
     (TF32 is switched off for matmuls and cuDNN);
  2. build: the three kernel sources from ``valle_tpu_torch/csrc`` with
     ``nvcc``, in parallel (no kernel runs until all three are built and
     scanned, so no timed call shares the host with nvcc), with each one's
     most registers and spilled bytes,
     and per attention kernel (forward and backward) its registers, spills
     and tensor-core (HMMA) instructions: every forward kernel and backward
     pass (the wide, cluster and split instantiations of head dims above 128
     too) must use the tensor cores and none may spill; per kernel 1 instantiation (split and
     combine kernels, lane layouts up to 8 chunks per lane, for whole-chunk
     heads and for heads staged into slots, the strided layout of heads
     past 1024 and its combine) its registers, spills and
     I2F instructions: none may spill, and no int8-cache instantiation may
     hold an I2F;
  3. kernel 1 (ragged decode attention, split-K and combine) against its
     plain PyTorch version, with a bit-equal rerun: int8 / f32 / bf16 caches
     at B=8, C=1024; the generate shapes (B=8 and B=1, C=768, 673 live
     columns, two finished slots at B=8); a long cache (B=1, C=40,000);
     head dims 48 and 96 in all three cache types; and path v's 4 heads of
     Dh 256 at the generate shape (B=8, int8);
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
     head dims 16, 32, 48, 72, 96, 128, 144, 192, 256, 384, 512, 1024 and
     1152 on a small shape (48, 72, 96, 144 and 192 through the wrappers'
     zero padding; at 144, 192 and 256 the wide kernels of the forward and
     the backward, from 384 to 1024 the cluster kernels of both with no
     split kernel, at 1152 the split instantiations: each case's kernels are
     read from the profiler, and each cluster kernel reports its registers,
     spills, shared memory and resident clusters), likewise; kernel 1 at head dims 8,
     40, 50, 72, 144, 192, 320, 512, 1025, 1100 and 2048 in int8 / f32 /
     bf16 caches (8, 40, 50 and 72 in int8 and 50 in bf16 staged into slots
     of whole 16-byte chunks, the profiler showing no pad or copy of the
     cache and no kernel but kernel 1's; 1025, 1100 and 2048 through the
     redesigned strided layout, read from the profiler) and at 64 heads
     of Dh 64 in f32 (two head slices), likewise; kernels 2, 3 and 4 at 4
     heads of Dh 256 on the training shapes (dense T=880; the TTS decoder),
     kernel 2 in dense cross-attention (752 rows against 128 keys) and
     kernel 4's forward at the TTS inference shape (B=8, T=201, a broadcast
     (1, 1, T, T) bias), f32 and bf16, timed against their plain versions
     and SDPA, the forward's LSE held at the f32 bar, with the backward's
     device time per pass and each wide kernel's and pass's registers,
     shared memory and resident warps per SM (at least 8, no spill); kernel 1's
     strided layout is timed against SDPA too;
  8. generate: full-width VALL-E (the default ModelConfig, seeded random
     weights) ``generate`` on 8 requests, with launch counts, the prefill and
     decode logits held against a CPU copy of the model, and timings; then
     the 8 results' codes decoded to waveforms by the full-width EnCodec
     (seeded random weights) in f32, held against a CPU copy of the codec,
     and in bf16 with int16 output, held against f32 at the bar of
     ``tests/test_encodec_parity.py``, with the codec's decode time and the
     text-to-wav rate;
  9. train: full-width VALL-E training steps (AR + NAR, dropout 0.1,
     ScaledAdam + Eden, B=4, S=128, T=752, accumulation 2) with launch counts
     per step, a bit-equal repeated step, and one micro-batch's loss and
     gradients at dropout 0 held against a CPU copy of the model that
     follows the card's ReLU gates, at the initial and at the trained
     weights;
 10. tts_train: full-width Transformer TTS baseline training steps
     (``attn_impl="flash"``, attention dropout 0, B=4, S=128, T=938 mel
     frames) with launch counts per step, a bit-equal repeated step, and the
     loss and gradients in eval mode held against a CPU copy by the same
     ReLU-gate method;
 11. tts_inference: the same model's greedy mel loop on 8 requests for 200
     steps, with launch counts and the first steps' mels held against a CPU
     copy;
 8v-11x. paths v-x, each right after its 16-head twin: generate_dh256 (v:
     phase 8's generate at ``nhead=4``, Dh 256, without the codec, in f32
     and then in bf16 on the same weights (int8 KV both); launches of
     kernels 1 and 2, f32 logits against a CPU copy at phase 8's bar, bf16
     logits against the same copy at ``BF16_LOGIT_RTOL``, timings beside
     phase 8's), train_dh256 (w: phase 9's step at ``nhead=4`` in f32 and
     bf16, launches, a bit-equal repeated step, step seconds beside phase
     9's, an f32 gradient check of micro-batch 0 as phase 9's),
     tts_dh256_train and tts_dh256_inference (x: phases 10 and 11 at
     ``nhead=4``: launches of kernels 2, 3 and 4, a bit-equal repeated step,
     phase 10's gradient check, 20 greedy mel steps all held against a CPU
     copy);
 11n. tts_scaling_train (path n): the same baseline with ``scaling_xformers``
     (balanced DoubleSwish, identity / balanced basic norms) in train mode,
     its balancers active: one micro-batch's train-mode loss and gradients
     (every dropout at 0 on both copies) against a CPU copy, f32 steps (24 /
     24 / 12 / 12 launches of kernels 2 / 3 / 4 / 4-backward) with a
     bit-equal repeated step, bf16 steps under ``remat full`` (48 / 24 / 24 /
     12), step seconds beside phase 10's;
 11o. tts_scaling_inference (path o): its greedy mel loop, as phase 11;
 11q. visualize (path q): ``VALLE.visualize_forward`` of the full-width
     VALL-E under "flash" on one batch (kernel 4, 12 launches) against a CPU
     copy;
 12. infer: the port's infer CLI (``valle_tpu_torch.bin.infer.main``) from
     files it writes first (the full-width VALL-E at CUT_LAYERS = 2 + 2
     layers as a ``.pt``, the random codec as the converter's ``.npz``, a
     ``chars`` symbol table and a 3 s prompt wav at 16 kHz), on two texts,
     through ``--attn-impl flash``, under PyTorch's default TF32 flags:
     kernel 2's launches per text (CUT_LAYERS prefill + 7 x CUT_LAYERS NAR;
     kernel 1 none); the first launch of each of the
     run's kernel 2 shapes (batch 1, prefix and dense) against the plain
     attention on the same inputs; the first text's prefill and 8 decode
     steps, fed its own codes, against a CPU copy of the model, and its NAR
     codes against the CPU copy's NAR passes; the prompt's codes from the
     card's codec against a CPU copy's; and the two wavs, with the CLI's wall
     time and the codec's encode time;
 12r. infer_reference_pt (path r): the same infer CLI run from a
     reference-layout ``.pt`` (extra keys, tied NAR heads overwritten), its
     codes equal to phase 12's;
 13. serve: the port's serve CLI (``valle_tpu_torch.bin.serve.main``; the
     model at CUT_LAYERS = 2 + 2 layers, as in phases 12, 14, 17s, 17u and
     18)
     on 24 requests (16 with the prompt wav and its text, 8 promptless; texts of
     20-160 characters in buckets 256 / 512) from the same files, in the
     serving defaults (bf16, int8 KV cache), ``--attn-impl flash``, batch
     16, greedy, once per weight mode (``--quantize-weights none / w8 /
     w8a8``): wall time, audio-s/s and launches per run (kernel 2 on every
     prefill and NAR pass, kernel 1 none: the CLI's decode reads are plain,
     as JAX's); the first kernel 2 launch of each shape against the plain
     attention with a bit-equal rerun; every int8 product shape of the w8a8
     run (decode, prefill, NAR, the 1,025-output head) bit-equal to its plain
     integer sums; JAX's one-layer bars (0.01 W8, 0.02 W8A8) for each
     quantized weight of the first AR layer and the head on the card; the
     w8 / w8a8 first full batch's prefill logits against the unquantized
     run's (0.03 / 0.035: the JAX package's own whole-model readings exceed
     the one-layer bars, ``scripts/quant_logit_error.py``); and per mode the
     device time by kernel family of a profiled prefill, 16 decode steps and
     7 NAR passes of that batch;
 14. continuous: ``serve_continuous`` (32 requests, batch 8, chunk 128,
     admission width 8, ``ragged_decode``) with the same model in bf16 with
     an int8 KV cache, greedy, EOS forbidden: launches (kernel 1 on every
     decode step), AR slot occupancy and audio-s/s, beside ``generate`` on
     the same requests in batches of 8; kernel 1 at a decode step with
     mixed live lengths and finished slots against its plain version, with
     a bit-equal rerun; every kernel 2 shape likewise; lengths equal to
     generate's, codebook-1 codes equal up to the first near-tie (a top-two
     gap of at most 4 bf16 ulps in generate's logits);
 15. train_cli: the port's training CLI (``valle_tpu_torch.bin.train.main``)
     in process on a synthetic corpus it writes (64 utterances of 4-6 s of
     random codes, 8 for dev, texts of 40-100 ``chars`` symbols): the
     full-width VALL-E through stage 1 (1 epoch) and stage 2 (1 more epoch)
     in one exp dir (``--attn-impl fused --dropout 0.1``, ScaledAdam, Eden,
     averaging, validation, step checkpoints with keep-last-k 1, the OOM
     scan, accumulation 2): the native loader path, 12 x A launches of
     kernels 2 and 3 per step, kernel 2 only in validation, the scan's
     launches apart, no non-finite step, the ``ar_*`` weights bit-equal
     across the stage switch, the first kernel 2 and 3 launch of each shape
     against the plain attention with bit-equal reruns, a step resumed from
     stage 2's mid-epoch checkpoint bit-equal to the uninterrupted one, a
     hand-fed step at that batch's shape, and the final ``epoch-2.pt``
     through the infer CLI (``--use-averaged-model``) to a finite wav; the
     loop's seconds per step beside the bare step's, the loader's and the
     copy's host seconds, a profiled step's device idle share, the saves'
     seconds and bytes, peak memory and the logged MFU;
     tts_train_cli: the full-width TTS baseline through the same CLI for 2
     steps on random mels with SpecAugment (24 / 24 / 12 / 12 launches of
     kernels 2 / 3 / 4 / 4-backward per step); stage 2 runs with
     ``--visualize true`` where matplotlib is installed (``"matplotlib"`` on
     the line says which) and must write min(4, B) PNGs of the first dev
     batch per validation, else none;
 16. tokenize_cli: the port's tokenize CLI
     (``valle_tpu_torch.bin.tokenize_dataset.main``) on the card: 64 + 8
     seeded wavs of 4-6 s (half at 16 kHz, resampled) through the
     full-width random EnCodec in batches of 16, then 8 wavs of 8-10 s in
     Fbank mode, and the stats CLI: audio-s/s; one batch's codes against a
     CPU copy of the codec (at least 99.5% of the frames equal, and every
     differing frame at a near-tie of its RVQ search, ``CODE_TIE_RTOL``);
 17. train_cli_bf16: the train CLI in bf16 with ``--remat dots_nobatch`` on
     that corpus: the full-width VALL-E through stage 1 (with the OOM scan)
     and stage 2: 24 x A / 12 x A launches of kernels 2 / 3 per step
     (kernel 2 again in the recompute); every captured kernel 2 / 3 launch
     (bf16, prefix and dense, dropout 0.1) against its plain version with a
     bit-equal rerun; f32 parameters, optimizer state, average and
     checkpoint; finite losses; one micro-batch's bf16 loss and gradients
     against a bf16 CPU copy (the ReLU-gate method at ``BF16_CHECK``); the
     averaged ``epoch-2.pt`` through the infer CLI in bf16 to a finite wav;
     tts_train_cli_bf16: the TTS baseline on the Fbank corpus under
     ``--remat full``, 2 steps, 48 / 24 / 24 / 12 launches of kernels 2 / 3
     / 4 / 4-backward per step, each kernel captured and held;
     tts_scaling_train_cli (path p): ``--model-name Transformer
     --scaling-xformers true`` through the train CLI on that corpus, f32, 2
     steps at 24 / 24 / 12 / 12 launches;
 17s. ddp_train (path s): phase 9's step (at CUT_LAYERS = 2 + 2 layers, as
     phases 12, 13, 14, 17u and 18) through the parallel layer in a
     group of one over NCCL, bit-equal to the same step without a group
     (loss, gradients, weights, step generator), with the gradient
     reduction's bytes and ms; then the deterministic step at B=8 on one
     process, and two ranks sharing the card over gloo, each with 4 of its
     rows: the summed gradients within 1e-5 of it (2-norm over all; each
     tensor within 5e-5), the loss and the updated weights' checksum within
     1e-5, equal on both ranks; 2 x 2 x CUT_LAYERS launches of kernels 2
     and 3 each per rank and step; then a step with dropout 0.1 whose first
     kernel 2 and 3 launch per shape on rank 1 is held against the plain
     version with a bit-equal rerun; rank 1's dropout keep rate within 4 sigma of 0.9 and
     its bits other than rank 0's; the reductions' ms and peak GiB per rank;
 17t. ddp_train_cli (path t): the train CLI as two processes
     (``--num-processes 2 --dist-backend gloo``) on path i's corpus and
     flags, stage 0, 1 epoch: one log (rank 0's), one set of ``.pt`` files,
     the OOM scan per rank, equal finite losses on both ranks, 48 / 48
     launches per step, the averaged ``epoch-1.pt`` through the infer CLI
     to a finite wav;
 17u. tp_serve (path u; the model at CUT_LAYERS layers): the serve CLI on
     8 prompted requests in one
     bucket, bf16, int8 KV, greedy, on one rank and then at
     ``--tensor-parallel 2 --quantize-weights w8a8`` and at
     ``--data-parallel 2`` (ranks sharing the card over gloo): manifests and
     codes equal up to the first near-tie of the one-rank run's logits; two
     ranks at T=2 (8 heads each): the W8A8 prefill logits of the CLI's batch
     bit-equal to the one-rank CLI's, and bf16 ``generate(...,
     ragged_decode=True)`` on 8 requests with the first kernel 1 and kernel
     2 launch per shape held against the plain versions, codes equal to one
     rank's up to the first near-tie; launches per rank;
 18. remat_ab: phase 9's step (at CUT_LAYERS = 2 + 2 layers) in f32, and in
     bf16 under remat none, full and
     dots_nobatch: the bf16 loss, gradients and step generator bit-equal
     across the policies, launches (kernel 2 doubled under remat, kernel 3
     not), peak memory of the accumulation group (lower under remat) and of
     the step, step seconds, and the ATen ops that dots_nobatch saved;
 19. a ``kernels`` summary line (each kernel's launches on every path), then
     the last line ``{"ok": true, "device": {...}}``.

Kernel 2 and 4 cases carry their time over SDPA's and, in f32, the bound
with the products as 3xTF32 on the tensor cores; backward cases also the
names of SDPA's backward kernels (``torch.profiler``).  Kernel times are the
median of 5 windows of back-to-back calls (CUDA events), with the fastest
and slowest window as the spread, and beside them the device time per call
from ``torch.profiler``, which leaves out the host's launch overhead.  Exits
non-zero without CUDA, and where the port's package is not beside it.  Needs
one card, no network.  Paths s-u start rank processes of this script
(``run_rank_processes``) and the serve CLI's own; every one is waited for,
and a failed one fails the phase.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
KERNELS = ["ragged_decode", "prefix_attention", "prefix_attention_bwd"]  # kernel 4 is in 2 / 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense; f32 on the CUDA cores without TF32, and f32-accurate products as
# 3xTF32 (three TF32 products at 495 TFLOP/s each)
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
                  "tf32x3": 495e12 / 3}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# depth (AR and NAR layers) of paths e-f (infer, serve), g-h (continuous), m
# (remat_ab), r (infer_reference_pt), s (ddp_train) and u (tp_serve): cut
# from 12 so that the script keeps inside its time limit beside paths v-x;
# full width, and each compares within its own runs
CUT_LAYERS = 2
LOGIT_ATOL = 1e-3
# path v's bf16 logits against the f32 CPU copy's, over their largest
# magnitude: bf16 rounds every product's inputs and outputs (2^-9 relative)
# through 12 layers; the bar is about the serve phases' W8 bar (0.03)
BF16_LOGIT_RTOL = 0.03
# the eval visualizer's PNGs need matplotlib, which the card's machine may lack
HAVE_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
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
    return named_device_ms(profiled_ops(fn, iters)[2], kernel_names)


def named_device_ms(events, kernel_names):
    """:func:`device_ms` from a profile's ``key_averages()``."""
    per_launch = [e.self_device_time_total / e.count for e in events
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


_ATTN_KERNEL = re.compile(r"(attn_bwd_dq(?:_split|_wide|_cluster)?_kernel|"
                          r"attn_bwd_dkv(?:_split|_wide|_cluster)?_kernel|"
                          r"flash_bias_bwd_dq(?:_split|_wide|_cluster)?_kernel|"
                          r"flash_bias_bwd_dkv(?:_split|_wide|_cluster)?_kernel|attn_bwd_delta_kernel|"
                          r"prefix_attention(?:_split|_wide|_cluster)?_kernel|"
                          r"flash_bias_fwd(?:_split|_wide|_cluster)?_kernel)"
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
                            r"Lb([01])E"
                            r"|ragged_decode_combine_kernelILi(\d+)E"
                            r"|ragged_decode_strided_kernelI(a|f|13__nv_bfloat16)Li(\d+)ELb([01])E"
                            r"|(ragged_decode_combine_strided_kernel)"
                            r"|ragged_decode_scores_kernelI(a|f|13__nv_bfloat16)E")
_KV_NAMES = {"a": "int8", "f": "float32"}


def ragged_label(mangled: str):
    """``ragged_decode_split_kernel<int8, 4, 1>`` (cache type, lanes per
    head, chunks per lane; ``, slots`` for the instantiation that stages
    heads that are not whole 16-byte chunks into slots),
    ``ragged_decode_combine_kernel<256>`` (threads),
    ``ragged_decode_strided_kernel<int8, 1>`` (cache type, chunks per
    thread; ``, scored`` for the instantiation that sums V slices of heads
    scored by ``ragged_decode_scores_kernel<int8>``),
    ``ragged_decode_combine_strided_kernel`` or the scores kernel for a
    mangled kernel 1 name, or None for another kernel."""
    m = _RAGGED_KERNEL.search(mangled)
    if m is None:
        return None
    if m.group(5) is not None:
        return f"ragged_decode_combine_kernel<{m.group(5)}>"
    if m.group(6) is not None:
        kv = _KV_NAMES.get(m.group(6), "bfloat16")
        scored = ", scored" if m.group(8) == "1" else ""
        return f"ragged_decode_strided_kernel<{kv}, {m.group(7)}{scored}>"
    if m.group(9) is not None:
        return m.group(9)
    if m.group(10) is not None:
        return f"ragged_decode_scores_kernel<{_KV_NAMES.get(m.group(10), 'bfloat16')}>"
    kv = _KV_NAMES.get(m.group(1), "bfloat16")
    slots = ", slots" if m.group(4) == "1" else ""
    return f"ragged_decode_split_kernel<{kv}, {m.group(2)}, {m.group(3)}{slots}>"


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
                if op in line and re.search(rf"\b{op}", line):
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


RAGGED_NAMES = ["ragged_decode_split_kernel", "ragged_decode_combine_kernel",
                "ragged_decode_strided_kernel", "ragged_decode_combine_strided_kernel",
                "ragged_decode_scores_kernel"]
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
        # path v's layer: d = 1024 at 4 heads of Dh 256
        ("generate B=8 dh 256", 8, 768, 4, 256, GENERATE_LENS, ("int8",)),
    ]


def ragged_inputs(dev, rng, b, c, h, dh, lens, cache):
    """(args of ragged_decode_attention, dequantized k and v in q's dtype)
    on the card: f32 q, K and V from ``rng`` (a numpy RandomState, or a
    torch Generator on the card, which makes them there), 10% bias holes;
    int8 caches quantized per (token, head), others cast."""
    import torch

    from valle_tpu_torch.nn.attention import quantize_kv

    if isinstance(rng, torch.Generator):
        qf, kf, vf = (torch.randn(shape, generator=rng, device=dev)
                      for shape in ((b, 1, h, dh), (b, c, h, dh), (b, c, h, dh)))
        holes = torch.rand((b, c), generator=rng, device=dev) < 0.1
        bias = torch.where(holes, -1e9, 0.0)
    else:
        qf = torch.from_numpy(rng.randn(b, 1, h, dh).astype(np.float32)).to(dev)
        kf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
        vf = torch.from_numpy(rng.randn(b, c, h, dh).astype(np.float32)).to(dev)
        bias = torch.from_numpy(np.where(rng.rand(b, c) < 0.1, -1e9, 0.0).astype(np.float32))
        bias = bias.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    if cache == "int8":
        k, ks = quantize_kv(kf)
        v, vs = quantize_kv(vf)
        return (qf, k, v, lengths, bias, ks, vs), (k.float() * ks[..., None],
                                                   v.float() * vs[..., None])
    dt = getattr(torch, cache)
    q, k, v = qf.to(dt), kf.to(dt), vf.to(dt)
    return (q, k, v, lengths, bias, None, None), (k, v)


def ragged_library_ms(args, kv_lib, lens, **timing) -> float:
    """Kernel 1's yardstick: ms of one SDPA call on the same (dequantized)
    data and mask (``ragged_inputs``' args and dequantized k and v), over
    the slots of length > 0 (a length-0 slot has no finite column for
    SDPA); ``timing``: ``cuda_time``'s options."""
    import torch
    from torch.nn import functional as F

    q, lengths, bias = args[0], args[3], args[4]
    k_lib, v_lib = kv_lib
    col = torch.arange(bias.shape[1], device=q.device)[None, :]
    mask = torch.where(col < lengths[:, None].long(), bias, float("-inf"))
    live_slots = torch.tensor([i for i, n in enumerate(lens) if n > 0], device=q.device)
    mask = mask[live_slots][:, None, None, :].to(q.dtype)
    ql, kl, vl = (t[live_slots].transpose(1, 2).contiguous()
                  for t in (q, k_lib.to(q.dtype), v_lib.to(q.dtype)))
    return cuda_time(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
                     **timing)["ms"]


def check_ragged_decode(dev):
    import torch

    from valle_tpu_torch.ops.ragged_decode import (
        _cached_plan, ragged_decode_attention, ragged_decode_attention_reference)

    rng = torch.Generator(device=dev).manual_seed(SEED)  # inputs made on the card
    results = []
    for name, b, c, h, dh, lens, caches in ragged_cases():
        for cache in caches:
            args, kv_lib = ragged_inputs(dev, rng, b, c, h, dh, lens, cache)
            q, k = args[0], args[1]
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
            library_ms = ragged_library_ms(args, kv_lib, lens)
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
            del args, kv_lib
    emit({"phase": "kernel1_ragged_decode", "device_ms_is": "split + combine kernels per call",
          "cases": results})
    return {r["case"]: r for r in results}


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
# kernels 2-4: the whole-row instantiations (48, 72 and 96 zero-padded), the
# wide kernels of Dh 256 (144 and 192 padded to it), then above it the
# cluster forward and backward (384, 512 and 1024 in clusters of 3, 4 and 8
# blocks), and past the clusters' reach at 1152 the split kernels (9 chunks)
HEAD_DIMS = (16, 32, 48, 72, 96, 128, 144, 192, 256, 384, 512, 1024, 1152)


def launched_kernels(fn, calls: int = 3) -> set:
    """The names of the CUDA kernels that ``fn()`` launches, from
    ``torch.profiler`` over ``calls`` calls after a warm-up (the profiler can
    miss a call's first launches: with one call it reported a forward's
    backward kernels without the forward's)."""
    return profiled_ops(fn, calls)[0]


def profiled_ops(fn, calls: int = 3, tries: int = 6):
    """(CUDA kernel names, CPU op names, the profile's ``key_averages()``)
    of ``calls`` calls of ``fn()``, from ``torch.profiler`` after a warm-up
    call.  Now and then a profile records no kernel at all (every ``fn``
    here launches some), and three profiles in a row have come back empty:
    such a profile is taken again, up to ``tries`` times, each after a
    pause a little longer than the last and over twice the calls, and each
    retry is reported on stderr."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            print(f"profiled_ops: empty profile, retry {attempt}", file=sys.stderr, flush=True)
            time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls * (2 if attempt else 1)):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = {e.key for e in events if e.device_type == DeviceType.CUDA}
        if kernels:
            break
    return kernels, {e.key for e in events if e.device_type == DeviceType.CPU}, events


def check_head_dims(dev, fwd_res, bwd_res):
    """Kernels 2, 3 and 4, forward and backward, at the head dims the
    training shapes do not reach (``HEAD_DIMS``: 16, 32, 128, the wide
    kernels' 256, above it 384, 512, 1024 and 1152, and 48, 72, 96, 144 and
    192, which the wrappers zero-pad to 64, 128, 128, 256 and 256; the scale is
    not a power of two but at 16, 64, 256 and 1024), in f32 and bf16:
    kernels 2 / 3 in prefix mode at rate 0.1 and in dense mode at rate 0,
    kernel 4 with a causal + padding bias, each against its plain version
    with a bit-equal rerun.  Past 128 the kernels that each case launches
    are read from the profiler, per direction, on the routes of
    ``forward_plan`` and ``backward_plan``: wide at 256 (144, 192, 256),
    cluster from 384 to 1024 with no split kernel in either direction, split
    at 1152.  Each cluster kernel that a case launches, forward or backward
    pass, reports its registers, spills, HMMA, shared memory, resident
    blocks and ``cudaOccupancyMaxActiveClusters`` at its cluster size
    (``cluster_forward_resources``, ``cluster_pass_resources``; ``fwd_res``
    and ``bwd_res``: the build phase's).  Returns the cases and the cluster
    forward kernels' resources."""
    import torch

    from valle_tpu_torch.ops import flash_attention as fl
    from valle_tpu_torch.ops import fused_attention as fa

    rng = np.random.RandomState(SEED + 8)
    b, h, t, prefix_s = HEAD_DIM_CASE
    key_bias = np.where(np.arange(t)[None, :] >= rng.randint(3 * t // 4, t + 1, b)[:, None],
                        -1e9, 0.0).astype(np.float32)
    kb = torch.from_numpy(key_bias).to(dev)
    dec = torch.from_numpy(_decoder_bias(rng, b, t, 3 * t // 4)).to(dev)
    results, cluster_kernels, cluster_forward = [], {}, {}
    for dh in HEAD_DIMS:
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
                route = {}
                if dh > 128:
                    fplan, plan = fa.forward_plan(dh, dt), fa.backward_plan(dh, dt)
                    names = launched_kernels(lambda: (fwd(), call()))
                    kernel4 = mode == "kernel4 decoder bias"
                    prefix = "flash_bias_bwd" if kernel4 else "attn_bwd"
                    fwd_name = "flash_bias_fwd" if kernel4 else "prefix_attention"
                    want_names = [f"{fwd_name}_{fplan.route}_kernel"] + [
                        f"{prefix}_{p}_{plan.route}_kernel" for p in ("dq", "dkv")]
                    for name in want_names:
                        assert any(name in n for n in names), \
                            f"{case} launched no {name}: {sorted(names)}"
                    split = sorted(n for n in names if "_split_kernel" in n)
                    split_fwd = [n for n in split if "_bwd_" not in n]
                    assert fplan.route == "split" or not split_fwd, \
                        f"{case} launched split forward kernels: {split_fwd}"
                    assert plan.route == "split" or len(split_fwd) == len(split), \
                        f"{case} launched split backward kernels: {split}"
                    route = {"tiles": {"forward": fplan.route, "backward": plan.route},
                             "kernels_seen": want_names}
                    if fplan.route == "cluster":
                        route["cluster"] = {"forward": fplan.cluster,
                                            "forward_key_tile": fplan.key_tile}
                        drop = ", drop" if rate > 0 else ""
                        label = f"{fwd_name}_cluster_kernel<{dtype}{drop}>"
                        key = f"{label} x {fplan.cluster}"
                        if key not in cluster_forward:
                            cluster_forward[key] = cluster_forward_resources(
                                fwd_res, label, dtype, kernel4, rate > 0, fplan)
                    if plan.route == "cluster":
                        route.setdefault("cluster", {}).update(
                            dq=plan.cluster, dkv=plan.dkv_cluster)
                        drop = ", drop" if rate > 0 else ""
                        for p, nc in (("dq", plan.cluster), ("dkv", plan.dkv_cluster)):
                            label = f"{prefix}_{p}_cluster_kernel<{dtype}{drop}>"
                            key = f"{label} x {nc}"
                            if key not in cluster_kernels:
                                cluster_kernels[key] = cluster_pass_resources(
                                    bwd_res, label, dtype, kernel4, rate > 0, p == "dkv",
                                    plan.padded_dh)
                results.append({"case": case, "b": b, "h": h, "t": t, "dh": dh,
                                "forward_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
                                "max_abs_err": max(errs), "tol": TOL[dtype],
                                "bit_equal_rerun": True, **route})
    emit({"phase": "kernel2_3_4_head_dims",
          "err_is": "forward: max |kernel - plain|; backward (max_abs_err): max |kernel - plain| "
                    "/ max |plain|, worst of dq, dk, dv", "cases": results,
          "cluster_forward_kernels": cluster_forward, "cluster_kernels": cluster_kernels})
    return results, cluster_forward


DH256_H, DH256_DH = 4, 256  # heads and head dim of paths v-x (d = 1024, nhead 4)
DH256_MEL_STEPS = 20  # path x's greedy mel steps, all held against the CPU copy


def _measure(case, call, want, rel, kernel_names, plain, library, n_bytes, n_ops, dtype,
             kernels) -> dict:
    """One kernel call at a timed shape: ``call()``'s tensors against
    ``want`` (max |kernel - plain|, over max |plain| where ``rel``) within
    TOL with a bit-equal rerun; event ms, device ms (``kernel_names``), the
    plain version's and the library's ms, the bound, and the registers,
    spills and HMMA of ``kernels``."""
    import torch

    got, again = call(), call()
    torch.cuda.synchronize()
    errs = [float((g.float() - w.float()).abs().max()) / (
        float(w.float().abs().max()) if rel else 1.0) for g, w in zip(got, want)]
    assert all(torch.isfinite(g).all() for g in got), case
    assert all(torch.equal(g, a) for g, a in zip(got, again)), f"{case} is not bit-reproducible"
    assert max(errs) <= TOL[dtype], f"{case} disagrees with its plain version: {errs}"
    del got, again
    timing = cuda_time(call, iters=10)
    timing["device_ms"] = device_ms(call, kernel_names, iters=5)
    plain_ms = cuda_time(plain, iters=1, windows=3)["ms"]
    library_ms = cuda_time(library, iters=10)["ms"]
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"case": case, "dtype": dtype, "max_abs_err": max(errs), "max_abs_errs": errs,
            "err_is": "max |kernel - plain|" + (" / max |plain|" if rel else ""),
            "tol": TOL[dtype], "bit_equal_rerun": True, **timing, "plain_ms": plain_ms,
            "library_ms": library_ms, "ms_over_library": timing["ms"] / library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            **_tf32x3_bound(dtype, n_bytes, n_ops), "kernels": kernels,
            "tflops": n_ops / timing["ms"] / 1e9}


WIDE_MIN_WARPS = 8  # resident warps per SM that each wide kernel and pass must reach


def wide_pass_resources(res, label: str, dtype: str, bias: bool, drop: bool,
                        dkv=None) -> dict:
    """The build phase's registers, spills and HMMA of one wide kernel at Dh
    256 with, from the runtime, its registers, local bytes, dynamic shared
    memory, threads and resident blocks and warps per SM: a backward pass of
    kernels 3 and 4 (``dkv``: the dK/dV pass, else dQ;
    ``prefix_attention_bwd_wide_info``) or, with ``dkv`` None, the forward of
    kernel 2 or 4 (``prefix_attention_wide_info``)."""
    import ctypes

    from valle_tpu_torch.ops import cuda_build

    if dkv is None:
        fn = cuda_build.load("prefix_attention").prefix_attention_wide_info
        flags = (int(bias), int(drop))
    else:
        fn = cuda_build.load("prefix_attention_bwd").prefix_attention_bwd_wide_info
        flags = (int(bias), int(drop), int(dkv))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * (1 + len(flags)) + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 5)()
    err = fn(0 if dtype == "float32" else 1, *flags, info)
    assert err == 0, f"{label}: occupancy query failed: cudaError {err}"
    regs, local, smem, threads, blocks = info
    res = {**res[label], "runtime_registers": regs, "local_bytes": local,
           "dynamic_smem_bytes": smem, "threads": threads, "blocks_per_sm": blocks,
           "warps_per_sm": blocks * threads // 32}
    assert res["spill_bytes"] == 0 and local == 0, f"{label} spills: {res}"
    assert res["hmma"] > 0, f"{label} runs no tensor-core MMA: {res}"
    assert res["warps_per_sm"] >= WIDE_MIN_WARPS, f"{label}: too few resident warps: {res}"
    return res


def cluster_pass_resources(res, label: str, dtype: str, bias: bool, drop: bool, dkv: bool,
                           dh: int) -> dict:
    """The build phase's registers, spills and HMMA of one cluster pass
    kernel of kernels 3 and 4 (Dh above 256) with, from the runtime
    (``prefix_attention_bwd_cluster_info``), its registers, local bytes,
    dynamic shared memory, threads, resident blocks and warps per SM, and
    the clusters of the size that head dim ``dh`` launches that can be
    resident at once (``cudaOccupancyMaxActiveClusters``): no spill, and at
    least one."""
    import ctypes

    from valle_tpu_torch.ops import cuda_build

    fn = cuda_build.load("prefix_attention_bwd").prefix_attention_bwd_cluster_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 7)()
    err = fn(0 if dtype == "float32" else 1, int(bias), int(drop), int(dkv), dh, info)
    assert err == 0, f"{label}: occupancy query failed: cudaError {err}"
    regs, local, smem, threads, blocks, clusters, nc = info
    res = {**res[label], "cluster": nc, "runtime_registers": regs, "local_bytes": local,
           "dynamic_smem_bytes": smem, "threads": threads, "blocks_per_sm": blocks,
           "warps_per_sm": blocks * threads // 32, "max_active_clusters": clusters}
    assert res["spill_bytes"] == 0 and local == 0, f"{label} spills: {res}"
    assert res["hmma"] > 0, f"{label} runs no tensor-core MMA: {res}"
    assert clusters > 0, f"{label}: no cluster of {nc} blocks fits the card: {res}"
    return res


def cluster_forward_resources(res, label: str, dtype: str, bias: bool, drop: bool,
                              plan) -> dict:
    """The build phase's registers, spills and HMMA of one cluster forward
    kernel of kernels 2 and 4 (Dh 257-1024) with, from the runtime
    (``prefix_attention_cluster_info``), its registers, local bytes, dynamic
    shared memory, threads, resident blocks and warps per SM, the clusters
    of the size that ``plan`` (``forward_plan``) launches that can be
    resident at once, and the keys of a streamed tile: no spill, at least
    one cluster, and the plan's cluster size and key tile."""
    import ctypes

    from valle_tpu_torch.ops import cuda_build

    fn = cuda_build.load("prefix_attention").prefix_attention_cluster_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    info = (ctypes.c_int * 8)()
    err = fn(0 if dtype == "float32" else 1, int(bias), int(drop), plan.padded_dh, info)
    assert err == 0, f"{label}: occupancy query failed: cudaError {err}"
    regs, local, smem, threads, blocks, clusters, nc, kn = info
    res = {**res[label], "cluster": nc, "key_tile": kn, "runtime_registers": regs,
           "local_bytes": local, "dynamic_smem_bytes": smem, "threads": threads,
           "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
           "max_active_clusters": clusters}
    assert res["spill_bytes"] == 0 and local == 0, f"{label} spills: {res}"
    assert res["hmma"] > 0, f"{label} runs no tensor-core MMA: {res}"
    assert clusters > 0, f"{label}: no cluster of {nc} blocks fits the card: {res}"
    assert (nc, kn) == (plan.cluster, plan.key_tile), f"{label}: forward_plan is {plan}: {res}"
    return res


def _measure_forward(case, call, want, kernel_names, plain, library, n_bytes, n_ops, dtype,
                     kernels) -> dict:
    """:func:`_measure` of a forward that returns (out, lse): the output
    within TOL of its plain version and the f32 LSE within TOL["float32"] of
    the plain version's, each reported."""
    res = _measure(case, call, want, False, kernel_names, plain, library, n_bytes, n_ops, dtype,
                   kernels)
    out_err, lse_err = res["max_abs_errs"]
    assert lse_err <= TOL["float32"], f"{case}: LSE disagrees with the plain version: {lse_err}"
    return {**res, "out_max_abs_err": out_err, "lse_max_abs_err": lse_err,
            "lse_tol": TOL["float32"]}


def check_dh256(dev, fwd_res, bwd_res) -> dict:
    """Kernels 2, 3 and 4 at 4 heads of Dh 256 (paths v-x), all in the wide
    kernels (the forward's ``*_wide_kernel`` and the backward's wide passes),
    on the training shapes of phases 5-7: kernel 2's forward and kernel 3 on
    dense self-attention at T=880 (B=4, rate 0.1; the FLOPs of 16 heads of
    Dh 64), kernel 2 in dense cross-attention (the 752 audio rows against
    the 128 text keys, rate 0.1), kernel 4's forward and backward on the TTS
    decoder's causal + padding bias (B=4, T=938) and its forward at the TTS
    inference shape (B=8, T=201, a (1, 1, T, T) causal bias broadcast over
    batch and heads), in f32 and bf16, each against its plain version with a
    bit-equal rerun (the forward's LSE at the f32 bar) and timed against it
    and SDPA (forward, or its backward) on the same dense mask; ``fwd_res`` /
    ``bwd_res``: the build phase's registers, spills and HMMA per kernel, to
    which each wide kernel adds its shared memory and resident warps
    (``wide_pass_resources``: at least ``WIDE_MIN_WARPS``, no spill)."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.ops import flash_attention as fl
    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.masks import AttnMaskSpec

    rng = np.random.RandomState(SEED + 14)
    h, dh = DH256_H, DH256_DH
    t = TRAIN_S + TRAIN_T
    kb = torch.from_numpy(_train_key_bias(rng, TRAIN_S, TRAIN_T)).to(dev)
    dec = torch.from_numpy(_decoder_bias(rng, TTS_B, TTS_T, int(0.8 * TTS_T))).to(dev)
    n_inf = INF_STEPS + 1
    inf_bias = torch.from_numpy(_inference_bias(n_inf, INF_STEPS // 2)).to(dev)
    results = {}

    def sdpa_grad(q, k, v, dout, mask, rate):
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, dropout_p=rate)
        return lambda: torch.autograd.grad(ol, (ql, kl, vl), dout.transpose(1, 2),
                                           retain_graph=True)

    def fwd_bytes(q, k, bias):
        """q, k, v and out once each, the f32 bias and the f32 LSE."""
        return ((2 * q.numel() + 2 * k.numel()) * q.element_size() + bias.numel() * 4
                + q.shape[0] * q.shape[1] * q.shape[2] * 4)

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        drop = ", drop"
        k2_kernels = {f"prefix_attention_wide_kernel<{dtype}{drop}>": wide_pass_resources(
            fwd_res, f"prefix_attention_wide_kernel<{dtype}{drop}>", dtype, False, True)}
        q, k, v, dout = (torch.from_numpy(rng.randn(TRAIN_B, t, h, dh).astype(np.float32))
                         .to(dev, dt) for _ in range(4))
        seed = int(rng.randint(0, 2**62))
        args = (q, k, v, kb, None, DROPOUT, seed)
        mask = AttnMaskSpec(kb, None).dense(t).to(dt)
        ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
        results[f"kernel2 dense T={t} {dtype}"] = _measure_forward(
            f"kernel 2 dense self T={t} H={h} Dh={dh} rate {DROPOUT} {dtype}",
            lambda: fa._forward(*args, with_lse=True), fa.attention_forward_reference(*args),
            ["prefix_attention_wide_kernel"], lambda: fa.attention_forward_reference(*args),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, dropout_p=DROPOUT),
            fwd_bytes(q, k, kb), 4.0 * TRAIN_B * h * dh * t * t, dtype, k2_kernels)
        # dense cross-attention: the audio rows against the text keys
        qc = q[:, :TRAIN_T].contiguous()
        kc, vc = (x[:, :TRAIN_S].contiguous() for x in (k, v))
        kbc = kb[:, :TRAIN_S].contiguous()
        cargs = (qc, kc, vc, kbc, None, DROPOUT, seed)
        cmask = kbc[:, None, None, :].to(dt)
        qcl, kcl, vcl = (x.transpose(1, 2) for x in (qc, kc, vc))
        results[f"kernel2 cross {dtype}"] = _measure_forward(
            f"kernel 2 dense cross Tq={TRAIN_T} Tk={TRAIN_S} H={h} Dh={dh} rate {DROPOUT} "
            f"{dtype}",
            lambda: fa._forward(*cargs, with_lse=True), fa.attention_forward_reference(*cargs),
            ["prefix_attention_wide_kernel"], lambda: fa.attention_forward_reference(*cargs),
            lambda: F.scaled_dot_product_attention(qcl, kcl, vcl, attn_mask=cmask,
                                                   dropout_p=DROPOUT),
            fwd_bytes(qc, kc, kbc), 4.0 * TRAIN_B * h * dh * TRAIN_T * TRAIN_S, dtype,
            k2_kernels)
        del qc, kc, vc, kbc, cmask, qcl, kcl, vcl
        out, lse = fa._forward(*args, with_lse=True)
        kw = dict(prefix_s=None, dropout_rate=DROPOUT, dropout_seed=seed)
        k3_call = lambda: fa.fused_prefix_attention_backward(  # noqa: E731
            q, k, v, kb, out, dout, lse, **kw)
        results[f"kernel3 dense T={t} {dtype}"] = _measure(
            f"kernel 3 dense self T={t} H={h} Dh={dh} rate {DROPOUT} {dtype}", k3_call,
            fa.attention_backward_reference(q, k, v, kb, out, dout, lse, None, DROPOUT, seed),
            True, ["attn_bwd_"], lambda: fa.attention_backward_reference(
                q, k, v, kb, out, dout, lse, None, DROPOUT, seed),
            sdpa_grad(q, k, v, dout, mask, DROPOUT),
            (q.numel() * 8 * q.element_size() + kb.numel() * 4 + TRAIN_B * h * t * 8),
            10.0 * TRAIN_B * h * dh * t * t, dtype,
            {label: wide_pass_resources(bwd_res, label, dtype, False, True, dkv)
             for label, dkv in ((f"attn_bwd_dq_wide_kernel<{dtype}{drop}>", False),
                                (f"attn_bwd_dkv_wide_kernel<{dtype}{drop}>", True))})
        results[f"kernel3 dense T={t} {dtype}"]["device_ms_by_pass"] = {
            name: device_ms(k3_call, [name], iters=5)
            for name in ("attn_bwd_delta", "attn_bwd_dq_wide", "attn_bwd_dkv_wide")}
        del q, k, v, dout, out, lse, mask, ql, kl, vl
        k4_kernels = {f"flash_bias_fwd_wide_kernel<{dtype}>": wide_pass_resources(
            fwd_res, f"flash_bias_fwd_wide_kernel<{dtype}>", dtype, True, False)}
        # the TTS inference shape: one (1, 1, T, T) bias for every batch row and head
        q, k, v = (torch.from_numpy(rng.randn(INF_B, n_inf, h, dh).astype(np.float32))
                   .to(dev, dt) for _ in range(3))
        mask = inf_bias.to(dt)
        ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
        results[f"kernel4 inference {dtype}"] = _measure_forward(
            f"kernel 4 TTS inference B={INF_B} T={n_inf} H={h} Dh={dh} (1,1,T,T) bias {dtype}",
            lambda: fl._forward(q, k, v, inf_bias, with_lse=True),
            fl.flash_attention_forward_reference(q, k, v, inf_bias), ["flash_bias_fwd_wide_kernel"],
            lambda: fl.flash_attention_forward_reference(q, k, v, inf_bias),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
            fwd_bytes(q, k, inf_bias), 4.0 * INF_B * h * dh * n_inf * n_inf, dtype, k4_kernels)
        del q, k, v, mask, ql, kl, vl
        q, k, v, dout = (torch.from_numpy(rng.randn(TTS_B, TTS_T, h, dh).astype(np.float32))
                         .to(dev, dt) for _ in range(4))
        mask = dec.to(dt)
        ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
        results[f"kernel4 decoder {dtype}"] = _measure_forward(
            f"kernel 4 TTS decoder B={TTS_B} T={TTS_T} H={h} Dh={dh} {dtype}",
            lambda: fl._forward(q, k, v, dec, with_lse=True),
            fl.flash_attention_forward_reference(q, k, v, dec), ["flash_bias_fwd_wide_kernel"],
            lambda: fl.flash_attention_forward_reference(q, k, v, dec),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask),
            fwd_bytes(q, k, dec), 4.0 * TTS_B * h * dh * TTS_T * TTS_T, dtype, k4_kernels)
        out, lse = fl._forward(q, k, v, dec, with_lse=True)
        k4_call = lambda: fl.flash_attention_biased_backward(  # noqa: E731
            q, k, v, dec, out, dout, lse)[:3]
        results[f"kernel4 decoder backward {dtype}"] = _measure(
            f"kernel 4 backward TTS decoder B={TTS_B} T={TTS_T} H={h} Dh={dh} {dtype}", k4_call,
            fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse)[:3], True,
            ["flash_bias_bwd_", "attn_bwd_delta"],
            lambda: fl.flash_attention_backward_reference(q, k, v, dec, out, dout, lse),
            sdpa_grad(q, k, v, dout, mask, 0.0),
            q.numel() * 8 * q.element_size() + dec.numel() * 4 + TTS_B * h * TTS_T * 8,
            10.0 * TTS_B * h * dh * TTS_T * TTS_T, dtype,
            {label: wide_pass_resources(bwd_res, label, dtype, True, False, dkv)
             for label, dkv in ((f"flash_bias_bwd_dq_wide_kernel<{dtype}>", False),
                                (f"flash_bias_bwd_dkv_wide_kernel<{dtype}>", True))})
        results[f"kernel4 decoder backward {dtype}"]["device_ms_by_pass"] = {
            name: device_ms(k4_call, [name], iters=5)
            for name in ("attn_bwd_delta", "flash_bias_bwd_dq_wide", "flash_bias_bwd_dkv_wide")}
        del q, k, v, dout, out, lse, mask, ql, kl, vl
    emit({"phase": "kernels_2_3_4_dh256", "cases": list(results.values())})
    return results


# kernel 1 at head dims and head counts beyond phase 3's: (name, b, c, h, dh)
# at rows of about 1,024 elements (Dh 8, 40, 50 and 72 are not whole 16-byte
# chunks in int8, 50 in bf16 either: the kernel stages them into slots of
# whole chunks, 50 in int8 two bytes a copy; 320 and 512 take 2-4 chunks per
# lane), and rows of many head groups: 64 heads of Dh 64 in f32 (32 groups,
# two slices) beside Dh 8's 128 heads (in int8 slots of 16: 4 groups of 32)
# and 1,024 heads (32 groups, two slices of unpadded heads);
# past 1024 the strided layout (1025 in int8 and bf16 a byte / two bytes a
# copy), and past the chunks a strided thread holds in every cache type
# (Dh 16388: int8 4, bf16 8 bytes a copy, f32 bulk copies) the scores
# kernel and V slices, at a smaller B and C
RAGGED_HEAD_DIM_LENS = [0, 512, 259, 150, 1, 388, 32, 450]  # B=8, C=512
ALL3 = ("int8", "float32", "bfloat16")
# (name, b, c, h, dh, lengths, caches, scored)
RAGGED_HEAD_DIM_CASES = [(f"dh {dh}", 8, 512, h, dh, RAGGED_HEAD_DIM_LENS, ALL3, False)
                         for dh, h in ((8, 128), (40, 25), (50, 20), (72, 14), (144, 7),
                                       (192, 5), (320, 3), (512, 2), (1025, 1), (1100, 1),
                                       (2048, 2))]
RAGGED_HEAD_DIM_CASES += [
    ("dh 16388", 4, 256, 1, 16388, [0, 256, 131, 7], ALL3, True),
    ("64 heads of dh 64", 8, 512, 64, 64, RAGGED_HEAD_DIM_LENS, ("float32",), False),
    # 32 head groups of Dh 8 in 16-byte slots: two slices
    ("1024 heads of dh 8", 8, 512, 1024, 8, RAGGED_HEAD_DIM_LENS, ("int8",), False)]
# the redesigned strided kernel (its chunks per thread and the V-slice flag
# as template arguments), as the profiler names it demangled or mangled
_STRIDED_KERNEL = re.compile(r"ragged_decode_strided_kernel"
                             r"(?:<[^<>]*, \d+, (?:true|false)>"
                             r"|I(?:a|f|13__nv_bfloat16)Li\d+ELb[01]E)")


def check_ragged_head_dims(dev):
    """Kernel 1 (split and combine) at the head dims and head counts phase 3
    does not reach (``RAGGED_HEAD_DIM_CASES``), each against its plain
    version with a bit-equal rerun and exact zeros for finished slots, with
    the plan, the event ms and the bound.  From one profile (taken again
    only where it misses one of them): each call launches kernel 1's two
    kernels (past Dh 1024 the redesigned strided kernel and its combine,
    and the scores kernel where the case says so) and nothing else, no pad
    or copy of the cache where the head is not whole 16-byte chunks either.
    Past 1024 and where the head is not whole chunks, the call's event ms
    beside its plain version's and SDPA's; past 1024 its device ms too
    (the unpadded heads' device ms: ``scripts/ragged_ab.py``).  (Path v's
    Dh 256 at the generate shape is a case of phase 3.)"""
    import torch

    from valle_tpu_torch.ops.ragged_decode import (
        _cached_plan, padded_head_dim, ragged_decode_attention, ragged_decode_attention_reference)

    rng = torch.Generator(device=dev).manual_seed(SEED + 13)  # inputs made on the card
    results = []
    for name, b, c, h, dh, lens, caches, scored in RAGGED_HEAD_DIM_CASES:
        for cache in caches:
            args, kv_lib = ragged_inputs(dev, rng, b, c, h, dh, lens, cache)
            tol = TOL["bfloat16" if cache == "bfloat16" else "float32"]
            got = ragged_decode_attention(*args)
            again = ragged_decode_attention(*args)
            want = ragged_decode_attention_reference(*args)
            torch.cuda.synchronize()
            case = f"{name} x {h} heads {cache} cache"
            err = float((got - want).abs().max())
            assert got.shape == want.shape and torch.isfinite(got).all(), case
            assert torch.equal(got, again), f"kernel 1 ({case}) is not bit-reproducible"
            dead = [i for i, n in enumerate(lens) if n == 0]
            assert all(float(got[i].abs().max()) == 0.0 for i in dead), \
                "a length-0 slot must give exact zeros"
            assert err <= tol, f"kernel 1 ({case}) disagrees with its plain version: {err}"
            call = lambda: ragged_decode_attention(*args)  # noqa: E731
            # a profile that misses one of kernel 1's kernels is taken again
            want = ((_STRIDED_KERNEL, re.compile("ragged_decode_combine_strided_kernel"))
                    if dh > 1024 else (re.compile("ragged_decode_split_kernel"),
                                       re.compile(r"ragged_decode_combine_kernel\b")))
            if scored:
                want += (re.compile("ragged_decode_scores_kernel"),)
            for _ in range(3):  # past 1024 the same profile gives the device ms
                kernels, cpu_ops, events = profiled_ops(call, 20 if dh > 1024 else 3)
                if all(any(w.search(k) for k in kernels) for w in want):
                    break
            assert all(any(w.search(k) for k in kernels) for w in want), \
                f"{case}: no profile showed kernel 1's kernels {want}: {sorted(kernels)}"
            strays = sorted(k for k in kernels if not any(n in k for n in RAGGED_NAMES))
            assert not strays, f"kernel 1 ({case}) launched other kernels: {strays}"
            copies = sorted(o for o in cpu_ops if o.startswith("aten::")
                            and any(w in o for w in ("pad", "copy", "cat")))
            assert not copies, f"kernel 1 ({case}) copies the cache: {copies}"
            elem = args[1].element_size()
            dhp = padded_head_dim(dh, elem)
            live = int(sum(min(max(n, 0), c) for n in lens))
            n_bytes = (live * h * dh * 2 * elem + (live * h * 8 if cache == "int8" else 0)
                       + live * 4 + b * 4 + b * h * dh * (args[0].element_size() + 4))
            bound_ms, bound_by = bound(n_bytes, 4.0 * live * h * dh, cache)
            res = {"case": case, "b": b, "c": c, "h": h, "dh": dh, "slot_dh": dhp,
                   "plan": _cached_plan(b, c, h, dh, elem, torch.cuda.current_device())._asdict(),
                   "max_abs_err": err, "tol": tol, "bit_equal_rerun": True,
                   "kernels_seen": sorted(kernels),
                   "ms": cuda_time(call, iters=10, windows=3)["ms"], "bound_ms": bound_ms,
                   "bound_by": bound_by}
            if dh > 1024:
                res["device_ms"] = named_device_ms(events, RAGGED_NAMES)
            if dh > 1024 or dhp != dh:  # the plain version's and SDPA's event ms
                res["plain_ms"] = cuda_time(lambda: ragged_decode_attention_reference(*args),
                                            iters=10, windows=3)["ms"]
                res["library_ms"] = ragged_library_ms(args, kv_lib, lens, iters=10, windows=3)
            results.append(res)
            del args, kv_lib
    emit({"phase": "kernel1_head_dims", "cases": results})


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


def main_path(dev, nhead: int = 16, beside=None):
    """Phase 8 (path a) at the default 16 heads, with the codec; path v
    (``generate_dh256``) at ``nhead=4`` (Dh 256) without it, its timings
    beside path a's (``beside``, path a's phase line), then in bf16
    (``bf16_generate``)."""
    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.sample import _nar_refine, _prefill_kv, generate

    cfg = ModelConfig(attn_impl="flash", kv_cache_dtype="int8", nhead=nhead)  # full width
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

    del cpu_model
    bf16 = None
    if beside is not None:  # path v: the same weights in bf16, the serving dtype
        bf16 = bf16_generate(model, x, x_lens_t, prompts, prompt_lens_t, kw, want, forced,
                             cpu_logits)
    frames = int(lengths.sum())
    line = {"phase": "main_path" if beside is None else "generate_dh256",
            "model": f"VALL-E default ModelConfig (d=1024, {nhead} heads, Dh "
                     f"{cfg.decoder_dim // nhead}, 12+12 layers, Q=8), attn_impl=flash, "
                     "kv_cache int8, ragged_decode, f32",
            "batch": b, "text_lens": x_lens.tolist(), "prompt_lens": prompt_lens.tolist(),
            "stop_lens": stop_lens.tolist(), "decode_steps": steps, "launches": launches,
            "generate_s": total_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms_per_step,
            "nar_ms_per_pass": nar_ms / (cfg.num_quantizers - 1),
            "frames_per_s": frames / total_s, "audio_s_per_s": frames / 75.0 / total_s,
            "peak_mem_gib": peak_gib, "logit_max_abs_err_vs_cpu": logit_err,
            "logit_atol": LOGIT_ATOL}
    if beside is None:
        line["codec"] = decode_codes(codes, frames, total_s)
    else:
        line["beside_16_heads"] = {k: beside[k] for k in (
            "generate_s", "prefill_ms", "decode_ms_per_step", "nar_ms_per_pass", "peak_mem_gib")}
        line["bfloat16"] = bf16
    emit(line)
    return launches, line


def bf16_generate(model, x, x_lens, prompts, prompt_lens, kw, want, forced, cpu_logits) -> dict:
    """Path v in bf16 (int8 KV, ``ragged_decode``): ``model``'s weights cast
    for bf16 compute, ``generate`` on the same requests with its launches
    (``want``, as in f32) and timings, and its teacher-forced prefill and
    decode logits (fed the f32 run's tokens ``forced``) against the f32 CPU
    copy's ``cpu_logits``, relative to their largest magnitude, within
    ``BF16_LOGIT_RTOL``."""
    import torch

    from valle_tpu_torch.models import get_model
    from valle_tpu_torch.sample import _nar_refine, _prefill_kv, generate

    cfg = model.cfg.replace(dtype="bfloat16")
    bf_model = get_model(cfg, device=x.device, state_dict=model.state_dict())
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    generate(bf_model, x, x_lens, prompts, prompt_lens, generator=gen, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = generate(bf_model, x, x_lens, prompts, prompt_lens, generator=gen, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    assert launches == want, f"bf16 launch counts {launches}, expected {want}"
    codes, lengths = out["codes"], out["lengths"]
    assert int(codes.min()) >= 0 and int(codes.max()) < cfg.num_audio_tokens

    def prefill():
        with torch.inference_mode():
            _prefill_kv(bf_model, x, x_lens, prompts, prompt_lens)

    def nar():
        with torch.inference_mode():
            _nar_refine(bf_model, x, x_lens, prompts, prompt_lens, codes[..., 0], lengths)

    prefill_ms = cuda_time(prefill, iters=3, windows=3, warmup=1)["ms"]
    nar_ms = cuda_time(nar, iters=1, windows=3, warmup=1)["ms"]
    steps = want["ragged_decode"] // cfg.num_layers
    logits = teacher_forced_logits(bf_model, x, x_lens, prompts, prompt_lens, forced, True)
    assert torch.isfinite(logits).all()
    rel = float((logits - cpu_logits).abs().max() / cpu_logits.abs().max())
    del bf_model
    torch.cuda.empty_cache()
    assert rel <= BF16_LOGIT_RTOL, f"bf16 logits off the f32 CPU copy's by {rel} of their max"
    return {"generate_s": total_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": (total_s * 1e3 - prefill_ms - nar_ms) / steps,
            "nar_ms_per_pass": nar_ms / (cfg.num_quantizers - 1), "launches": launches,
            "logit_rel_err_vs_f32_cpu": rel, "logit_rtol": BF16_LOGIT_RTOL}


CODEC_WAV_RTOL = 1e-4  # f32 wav on the card against the CPU copy, over max |wav|
BF16_WAV_RTOL = 0.05  # bf16 decode against f32 (tests/test_encodec_parity.py)
INT16_LSB = 2
CODE_MATCH = 0.995  # prompt codes equal to the CPU copy's (test_encodec_parity.py)


def decode_codes(codes, frames: int, generate_s: float) -> dict:
    """Phase 8's codes (B, T, Q) to waveforms with the full-width codec of
    seeded random weights: f32 against a CPU copy, int16 output and bf16
    against f32.  Returns the codec's numbers for the phase line."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from valle_tpu_torch.codec import Encodec, random_codec_params

    params = random_codec_params(seed=SEED)
    codec, codec_bf16 = Encodec(params), Encodec(params, decode_dtype="bfloat16")
    b, t, _ = codes.shape
    f32 = cuda_time(lambda: codec.decode(codes), iters=1, windows=3, warmup=1)
    bf16 = cuda_time(lambda: codec_bf16.decode(codes, out_int16=True), iters=1, windows=3,
                     warmup=1)
    wav = codec.decode(codes)
    assert tuple(wav.shape) == (b, 1, t * codec.cfg.hop_length), tuple(wav.shape)
    assert torch.isfinite(wav).all()
    with FlopCounterMode(display=False) as counter:  # the convs; the LSTM by hand below
        wav_cpu = Encodec(params, device="cpu").decode(codes.cpu())
    hidden = codec.cfg.num_filters * 2 ** len(codec.cfg.upsampling_ratios)
    lstm_flop = codec.cfg.num_lstm_layers * b * t * 2 * 4 * hidden * 2 * hidden
    flop = counter.get_total_flops() + lstm_flop
    scale = float(wav_cpu.abs().max())
    cpu_err = float((wav.cpu() - wav_cpu).abs().max()) / scale
    assert cpu_err <= CODEC_WAV_RTOL, f"card wav differs from the CPU copy by {cpu_err}"

    def host_int16(w):
        return torch.round(w.clamp(-1.0, 1.0) * 32767.0).to(torch.int32)

    i16 = codec.decode(codes, out_int16=True)
    assert i16.dtype == torch.int16
    i16_lsb = int((i16.int() - host_int16(wav)).abs().max())
    wav_bf16 = codec_bf16.decode(codes)
    bf16_err = float((wav_bf16 - wav).abs().max()) / float(wav.abs().max())
    bf16_i16 = codec_bf16.decode(codes, out_int16=True)
    bf16_lsb = int((bf16_i16.int() - host_int16(wav_bf16)).abs().max())
    assert bf16_err < BF16_WAV_RTOL, f"bf16 wav differs from f32 by {bf16_err}"
    assert max(i16_lsb, bf16_lsb) <= INT16_LSB, (i16_lsb, bf16_lsb)
    audio_s = b * t / codec.cfg.frame_rate
    bound_ms, bound_by = bound(0, flop, "float32")
    return {"decode_frames": [b, t], "f32_ms": f32["ms"], "f32_ms_spread": [f32["ms_min"],
            f32["ms_max"]], "bf16_int16_ms": bf16["ms"],
            "gflop_per_audio_s": flop / 1e9 / audio_s, "lstm_gflop_per_audio_s":
            lstm_flop / 1e9 / audio_s, "f32_bound_ms": bound_ms, "bound_by": bound_by,
            "f32_audio_s_per_s": audio_s / (f32["ms"] / 1e3),
            "bf16_int16_audio_s_per_s": audio_s / (bf16["ms"] / 1e3),
            "text_to_wav_audio_s_per_s": frames / 75.0 / (generate_s + f32["ms"] / 1e3),
            "f32_top_kernels": top_device_kernels(lambda: codec.decode(codes), 4, iters=1),
            "bf16_int16_top_kernels": top_device_kernels(
                lambda: codec_bf16.decode(codes, out_int16=True), 4, iters=1),
            "wav_max_err_vs_cpu": cpu_err, "wav_rtol": CODEC_WAV_RTOL,
            "bf16_max_err_vs_f32": bf16_err, "bf16_rtol": BF16_WAV_RTOL,
            "int16_lsb": [i16_lsb, bf16_lsb]}


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
F32_CHECK = {"loss_rtol": LOSS_RTOL, "flip_share": FLIP_SHARE, "flip_atol": FLIP_ATOL,
             "grad_rtol": GRAD_RTOL, "grad_norm_rtol": GRAD_NORM_RTOL}
# bf16 on the card against a bf16 CPU copy: both round the products' outputs
# to bf16 at the same points, but cuBLAS and the kernels sum in other orders
# than the CPU, and one bf16 ulp is 2^-8 of a value, so a gate flips where
# |h| is within a few ulps of 0.  On an H100 (the bf16 train CLI's first
# micro-batch, 2 rows, after its two stages) the readings were: loss 4.8e-5,
# 5.6e-4 of 110 M gates flipped at |h| <= 4.9e-3, gradients 7.4e-3 (largest
# element) / 2.3e-3 (2-norm); the bars are 4-20x those
CHECK_ROWS = 2  # rows of the bf16 CLI's first micro-batch in its gradient check
BF16_CHECK = {"loss_rtol": 1e-3, "flip_share": 2e-3, "flip_atol": 2e-2, "grad_rtol": 5e-2,
              "grad_norm_rtol": 2e-2}


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


def profile_breakdown(fn, extra_families=()) -> dict:
    """One call of ``fn()`` under ``torch.profiler``: wall seconds, device
    busy seconds, the device time by kernel family and the top kernels.
    ``extra_families``: (name, name substrings) pairs matched before the
    standard families."""
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
    families = dict(extra_families)
    families |= {"kernel1 (ragged_decode)": tuple(RAGGED_NAMES),
                 "kernel2 (prefix_attention)": ("prefix_attention_kernel",
                                                "prefix_attention_wide_kernel",
                                                "prefix_attention_cluster_kernel",
                                                "prefix_attention_split_kernel"),
                 "kernel3 (prefix_attention_bwd)": ("attn_bwd_",),
                 "kernel4 (flash_attention)": ("flash_bias_fwd",),
                 "kernel4 (flash_attention_bwd)": ("flash_bias_bwd_",),
                 "matmul (cuBLAS / CUTLASS)": ("gemm", "Gemm", "cutlass", "xmma", "sm90_",
                                               "nvjet")}
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
    the feed-forward block of each ReLU layer (linear1 -> linear2) and the
    two ReLUs of the Transformer TTS mel prenet (dropout is off in eval
    mode).  The scaling_xformers layout has none: its DoubleSwish is
    smooth."""
    from valle_tpu_torch.nn.layers import TransformerLayer

    for name, mod in model.named_modules():
        if isinstance(mod, TransformerLayer) and mod.activation == "relu":
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


def _eps_term_hooks(model, terms: dict) -> list:
    """Hooks on every ``BasicNorm`` of ``model`` (the scaling layout's
    balanced basic norms) that add, per norm, the sum over the elements of
    its output of |dloss/dout * dout/deps| into ``terms[<name>.eps]``: the
    magnitude of the terms whose sum is that epsilon's gradient.  Returns
    the hook handles."""
    from valle_tpu_torch.nn.layers import BasicNorm

    handles = []
    for name, mod in model.named_modules():
        if not isinstance(mod, BasicNorm):
            continue

        def after(m, args, out, key=f"{name}.eps"):
            x = args[0].detach().float()
            e = m.eps.detach().float().exp()
            coef = 0.5 * e * ((x * x).mean(-1, keepdim=True) + e) ** -1.5

            def on_grad(g):
                terms[key] = terms.get(key, 0.0) + float((g.float() * x * coef).abs().sum())

            out.register_hook(on_grad)

        handles.append(mod.register_forward_hook(after))
    return handles


def set_dropout_rates(model, rates=None) -> dict:
    """Set every dropout rate of ``model`` (attention, layer, embedding and
    prenet dropout) to 0, or back to ``rates``; returns the rates it found,
    by module."""
    from valle_tpu_torch.nn.dropout import Dropout

    found = {}
    for mod in model.modules():
        attr = "rate" if isinstance(mod, Dropout) else "dropout"
        if isinstance(getattr(mod, attr, None), float):
            found[mod] = getattr(mod, attr)
            setattr(mod, attr, 0.0 if rates is None else rates[mod])
    return found


def _micro_grads(model, batch, gates: dict, flips: dict, forward_kw: dict,
                 train_mode: bool = False, eps_terms=None):
    """Loss and per-parameter gradients of micro-batch 0 at dropout 0, with
    the ReLU gates recorded into or taken from ``gates``: in eval mode, or
    in train mode with every dropout rate set to 0 for the call (the
    scaling layout's balancers then act in the backward).  ``eps_terms``:
    a dict that ``_eps_term_hooks`` fills."""
    model.train(train_mode)
    rates = set_dropout_rates(model) if train_mode else None
    model.zero_grad(set_to_none=True)
    handles = _relu_gate_hooks(model, gates, flips)
    if eps_terms is not None:
        handles += _eps_term_hooks(model, eps_terms)
    try:
        out = model(*(batch[k][0] for k in ("text_tokens", "text_tokens_lens", "audio_features",
                                            "audio_features_lens")),
                    train_stage=0, **forward_kw)
        out["loss"].backward()
    finally:
        for handle in handles:
            handle.remove()
        if rates is not None:
            set_dropout_rates(model, rates)
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
                   tols=None, train_mode: bool = False, **forward_kw) -> dict:
    """One micro-batch's loss and gradients at dropout 0 on the card against
    a CPU copy of the model (plain versions; the training build, so f32
    parameters under any compute dtype) that follows the card's ReLU gates;
    fails past ``tols`` (``F32_CHECK``: LOSS_RTOL, FLIP_SHARE, FLIP_ATOL,
    GRAD_RTOL and GRAD_NORM_RTOL).  ``train_mode``: both copies in train
    mode with every dropout rate at 0 (``_micro_grads``).  The learnable
    epsilon of a balanced basic norm is a scalar whose gradient sums the
    contributions of every element of the norm's output, which cancel (the
    line reports how far: ``eps_conditioning_min_max``), so its error is
    taken over that sum of magnitudes (``_eps_term_hooks``, on the CPU
    copy), the bound of a sum's rounding error; its error over |g| is
    reported beside, unchecked."""
    from valle_tpu_torch.models import get_model

    tols = tols or F32_CHECK
    t0 = time.perf_counter()
    gates, flips = {}, {}
    loss_gpu, grads_gpu = _micro_grads(model, batch, gates, flips, forward_kw, train_mode)
    cpu_model = get_model(model.cfg, device="cpu", training=True)
    cpu_model.load_state_dict(model.state_dict())
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    eps_terms = {}
    loss_cpu, grads_cpu = _micro_grads(cpu_model, cpu_batch, gates, flips, forward_kw,
                                       train_mode, eps_terms)
    del cpu_model
    grad_err, grad_norm_err = _grad_errors(grads_gpu, grads_cpu)
    eps_raw = {n: grad_err[n] for n in eps_terms}
    eps_conditioning = {n: eps_terms[n] / max(float(grads_cpu[n].abs()), 1e-30)
                        for n in eps_terms}
    for n, scale in eps_terms.items():
        grad_err[n] = grad_norm_err[n] = float((grads_gpu[n] - grads_cpu[n]).abs()) / max(
            scale, 1e-30)
    del grads_gpu, grads_cpu
    worst = sorted(grad_err, key=grad_err.get, reverse=True)[:5]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    flip_h = max((f["max_abs_h"] for f in flips.values()), default=0.0)
    n_gates = sum(g.numel() for g in gates.values())
    n_flips = sum(f["gates"] for f in flips.values())
    check = {"phase": phase, "weights": weights, "mode": "train" if train_mode else "eval",
             "dropout0_loss_gpu": loss_gpu, "dropout0_loss_cpu": loss_cpu,
             "dropout0_loss_rel_err": loss_err, "loss_rtol": tols["loss_rtol"],
             "relu_gates": n_gates, "flipped_gates": n_flips, "flip_share": tols["flip_share"],
             "flipped_gates_by_layer": {n: f["gates"] for n, f in flips.items() if f["gates"]},
             "flipped_max_abs_h": flip_h, "flip_atol": tols["flip_atol"],
             "worst_grads": {n: grad_err[n] for n in worst},
             "max_grad_rel_err": grad_err[worst[0]],
             "max_grad_norm_rel_err": max(grad_norm_err.values()),
             "median_grad_rel_err": float(np.median(list(grad_err.values()))),
             "grad_rtol": tols["grad_rtol"], "grad_norm_rtol": tols["grad_norm_rtol"],
             "n_grads": len(grad_err), "seconds": time.perf_counter() - t0}
    if eps_terms:
        check |= {"eps_err_over_term_sum_max": max(grad_err[n] for n in eps_terms),
                  "eps_err_over_abs_grad_max": max(eps_raw.values()),
                  "eps_conditioning_min_max": [min(eps_conditioning.values()),
                                               max(eps_conditioning.values())]}
    emit(check)
    assert loss_err <= tols["loss_rtol"], (loss_gpu, loss_cpu)
    assert n_flips <= tols["flip_share"] * n_gates, f"{n_flips} of {n_gates} ReLU gates flipped"
    assert flip_h <= tols["flip_atol"], f"a ReLU gate flipped at |h| = {flip_h}"
    assert grad_err[worst[0]] <= tols["grad_rtol"], (worst[0], grad_err[worst[0]])
    assert max(grad_norm_err.values()) <= tols["grad_norm_rtol"], max(grad_norm_err.values())
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
    return launches[0], med


def train_dh256_path(dev, beside_step_s: float) -> dict:
    """Path w: phase 9's step (its batch: B=4, S=128, T=752, A=2; fused,
    dropout 0.1, ScaledAdam, Eden) at 4 heads (Dh 256: the wide kernels of
    kernels 2 and 3), in f32 and in bf16 (the training build): launches per
    step, a bit-equal repeated step, the step's seconds beside phase 9's
    (``beside_step_s``, 16 heads, f32) and, in f32, the loss and gradients
    at dropout 0 of micro-batch 0 against a CPU copy (``gradient_check``).
    Returns the f32 step's launches."""
    import copy
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    batch = _train_batch(ModelConfig(), np.random.RandomState(SEED + 5), dev)
    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    runs, check = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(attn_impl="fused", nhead=4, dtype=dtype)
        torch.manual_seed(SEED)
        model = get_model(cfg, training=True)
        if dtype == "float32":
            check = gradient_check(model, batch, "initial", phase="train_dh256_gradient_check",
                                   nar_stage=cfg.num_quantizers // 2)
        state = init_train_state(model, make_opt, train_stage=0)
        step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
        step_s, launches, losses, peak_gib = _timed_steps(
            step, state, batch, torch.Generator().manual_seed(SEED), TRAIN_STEPS)
        per_step = TRAIN_A * (cfg.num_layers + cfg.nar_num_layers)
        want = {"ragged_decode": 0, "prefix_attention": per_step,
                "prefix_attention_bwd": per_step, "flash_attention": 0, "flash_attention_bwd": 0}
        assert all(c == want for c in launches), \
            f"launch counts {launches}, expected {want} per step"
        twin = copy.deepcopy(state)
        _, m1 = step(state, batch, torch.Generator().manual_seed(SEED + 1), 0)
        _, m2 = step(twin, batch, torch.Generator().manual_seed(SEED + 1), 0)
        repeat_equal = float(m1["loss"]) == float(m2["loss"]) and all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(), twin.model.parameters()))
        assert repeat_equal, (dtype, float(m1["loss"]), float(m2["loss"]))
        med = float(np.median(step_s))
        runs[dtype] = {"losses": losses, "step_s": step_s, "step_s_median": med,
                       "frames_per_s": TRAIN_A * TRAIN_B * TRAIN_T / med,
                       "peak_mem_gib": peak_gib, "launches_per_step": launches[0],
                       "repeat_bit_equal": repeat_equal}
        del twin, state, model, step
        torch.cuda.empty_cache()
    emit({"phase": "train_dh256", "model": "VALL-E ModelConfig(nhead=4) (d=1024, 4 heads, Dh "
          "256, 12+12 layers, Q=8), attn_impl=fused, dropout 0.1, train_stage 0, training build",
          "accumulation": TRAIN_A, "batch": TRAIN_B, "text_tokens": TRAIN_S, "frames": TRAIN_T,
          "runs": runs, "beside_16_heads_f32_step_s": beside_step_s,
          "f32_over_16_heads": runs["float32"]["step_s_median"] / beside_step_s,
          "dropout0_max_grad_rel_err": check["max_grad_rel_err"],
          "dropout0_flipped_gates": check["flipped_gates"]})
    return runs["float32"]["launches_per_step"]


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


def tts_train_path(dev, nhead: int = 16, beside_step_s=None):
    """Full-width Transformer TTS baseline training steps through kernels 2,
    3 and 4, with launch counts per step, a bit-equal repeated step, and the
    loss and gradients in eval mode held against a CPU copy: phase 10 at the
    default 16 heads, path x (``tts_dh256_train``) at ``nhead=4`` (Dh 256,
    the wide kernels) with its step beside phase 10's (``beside_step_s``) and
    the same gradient check."""
    import copy
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    # the default widths (d=1024, 16 heads, 12 + 12 layers, FFN 4096, 100 mel
    # bins), f32; attention dropout 0 keeps the decoder self-attention on
    # kernel 4, while the prenet (0.5) and positional (0.1) dropouts stay on
    cfg = ModelConfig(model_name="Transformer", attn_impl="flash", dropout=0.0, nhead=nhead)
    torch.manual_seed(SEED)
    model = get_model(cfg)
    batch = _tts_batch(cfg, np.random.RandomState(SEED + 7), dev)
    check = gradient_check(model, batch, "initial", phase="tts_gradient_check"
                           if beside_step_s is None else "tts_dh256_gradient_check")

    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    state = init_train_state(model, make_opt, train_stage=0)
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(SEED)

    step_s, launches, losses, peak_gib = _timed_steps(step, state, batch, gen, TTS_STEPS)
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
    beside = {} if beside_step_s is None else {"beside_16_heads_step_s": beside_step_s,
                                               "over_16_heads": med / beside_step_s}
    emit({"phase": "tts_train" if beside_step_s is None else "tts_dh256_train",
          "model": f"Transformer TTS ModelConfig(nhead={nhead}) (d=1024, {nhead} heads, Dh "
          f"{cfg.decoder_dim // nhead}, 12 encoder + 12 decoder layers, FFN 4096, 100 mel "
          "bins), attn_impl=flash, attention dropout 0, prenet dropout 0.5, positional dropout "
          "0.1, f32", **beside,
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
    return launches[0], med


SCALING_BF16_STEPS = 3


def _timed_steps(step, state, batch, gen, n: int):
    """A warm-up step, then ``n`` timed steps: (seconds, launches, losses)
    per step and the peak GiB of the timed steps."""
    import torch

    step(state, batch, gen, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, launches, losses = [], [], []
    for _ in range(n):
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, 0)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    return step_s, launches, losses, torch.cuda.max_memory_allocated() / 2**30


def tts_scaling_train_path(dev, plain_step_s: float):
    """The Transformer TTS baseline's scaling_xformers variant at full width
    (balanced DoubleSwish, identity / balanced basic norms), train mode with
    its balancers active: f32 steps with launch counts and a bit-equal
    repeated step, one micro-batch's train-mode loss and gradients (every
    dropout at 0 on both copies) against a CPU copy, then bf16 steps under
    ``remat full``; step seconds beside path c's in this call."""
    import copy
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    # attention dropout 0 keeps the decoder self-attention on kernel 4 (the
    # plain math takes attention with dropout under "flash"); the positional
    # dropouts (0.1) stay on
    cfg = ModelConfig(model_name="Transformer", attn_impl="flash", dropout=0.0,
                      scaling_xformers=True)
    torch.manual_seed(SEED)
    model = get_model(cfg, training=True)
    batch = _tts_batch(cfg, np.random.RandomState(SEED + 7), dev)
    check = gradient_check(model, batch, "initial", phase="tts_scaling_gradient_check",
                           train_mode=True)

    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
    state = init_train_state(model, make_opt, train_stage=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(SEED)
    step_s, launches, losses, peak_gib = _timed_steps(step, state, batch, gen, TTS_STEPS)
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
    torch.cuda.empty_cache()

    cfg16 = cfg.replace(dtype="bfloat16", remat="full")
    torch.manual_seed(SEED)
    state16 = init_train_state(get_model(cfg16, training=True), make_opt, train_stage=0)
    step16_s, launches16, losses16, peak16 = _timed_steps(
        step, state16, batch, torch.Generator().manual_seed(SEED), SCALING_BF16_STEPS)
    want16 = dict(want, prefix_attention=4 * n, flash_attention=2 * n)  # remat: forward twice
    assert all(c == want16 for c in launches16), \
        f"bf16 remat launch counts {launches16}, expected {want16} per step"
    del state16
    torch.cuda.empty_cache()

    med, med16 = float(np.median(step_s)), float(np.median(step16_s))
    frames = TTS_B * TTS_T
    emit({"phase": "tts_scaling_train", "model": "Transformer TTS default ModelConfig with "
          "scaling_xformers (balanced DoubleSwish, identity / balanced basic norms, out "
          "projections at 0.01, one-layer prenet), attn_impl=flash, attention dropout 0, "
          "positional dropout 0.1, train mode (balancers active)",
          "params": n_params, "batch": TTS_B, "text_tokens": TTS_S, "frames": TTS_T,
          "optimizer": "ScaledAdam lr 0.05 clip 2.0 betas (0.9, 0.95), Eden warmup 200",
          "f32": {"losses": losses, "step_s": step_s, "step_s_median": med,
                  "frames_per_s": frames / med, "peak_mem_gib": peak_gib,
                  "launches_per_step": launches[0], "profiled_step": breakdown,
                  "repeat_bit_equal": repeat_equal},
          "bf16_remat_full": {"losses": losses16, "step_s": step16_s, "step_s_median": med16,
                              "frames_per_s": frames / med16, "peak_mem_gib": peak16,
                              "launches_per_step": launches16[0]},
          "path_c_step_s_median": plain_step_s, "f32_over_path_c": med / plain_step_s,
          "train_mode_loss_rel_err": check["dropout0_loss_rel_err"],
          "train_mode_max_grad_rel_err": check["max_grad_rel_err"],
          "train_mode_max_grad_norm_rel_err": check["max_grad_norm_rel_err"]})
    return {"tts_scaling_train_step": launches[0], "tts_scaling_train_bf16": launches16[0]}


def tts_inference_path(dev, scaling: bool = False, nhead: int = 16, steps: int = INF_STEPS,
                       check_steps: int = CHECK_STEPS, phase=None):
    """The Transformer TTS baseline's greedy mel loop at full width on 8
    requests for ``steps`` steps (INF_STEPS), with launch counts and the
    first ``check_steps`` (CHECK_STEPS) mels held against a CPU copy;
    ``scaling``: its scaling_xformers variant; ``nhead``: 4 in path x."""
    import torch

    from valle_tpu_torch.models import ModelConfig, get_model

    cfg = ModelConfig(model_name="Transformer", attn_impl="flash", scaling_xformers=scaling,
                      nhead=nhead)
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
    out = model.inference(x, x_lens_t, max_steps=steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = cfg.num_layers
    want = {"ragged_decode": 0, "prefix_attention": n + n * steps, "prefix_attention_bwd": 0,
            "flash_attention": n * steps, "flash_attention_bwd": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"
    mel, lengths = out["mel"], out["lengths"]
    assert tuple(mel.shape) == (INF_B, steps, cfg.num_mel_bins), tuple(mel.shape)
    assert torch.isfinite(mel).all()
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= steps

    # the first steps against a CPU copy: step i reads frames <= i only, so a
    # shorter loop gives the same first frames
    cpu_model = get_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu = cpu_model.inference(x.cpu(), x_lens_t.cpu(), max_steps=check_steps)
    del cpu_model
    mel_err = float((mel[:, :check_steps].cpu() - cpu["mel"]).abs().max())
    assert mel_err <= LOGIT_ATOL, f"GPU mels differ from the CPU copy by {mel_err}"
    assert lengths.cpu().clamp(max=check_steps).tolist() == cpu["lengths"].tolist(), (
        lengths.tolist(), cpu["lengths"].tolist())
    emit({"phase": phase or ("tts_scaling_inference" if scaling else "tts_inference"),
          "model": f"Transformer TTS ModelConfig(nhead={nhead})" + (
              " with scaling_xformers" if scaling else "")
          + ", attn_impl=flash, f32, greedy, full recompute per step", "batch": INF_B,
          "text_lens": x_lens.tolist(), "max_steps": steps, "launches": launches,
          "lengths": lengths.tolist(), "call_s": total_s, "ms_per_step": total_s * 1e3 / steps,
          "frames_per_s": INF_B * steps / total_s, "peak_mem_gib": peak_gib,
          "mel_max_abs_err_vs_cpu": mel_err, "checked_steps": check_steps,
          "mel_atol": LOGIT_ATOL})
    return launches


# ---------------------------------------------------------------- phase 12

INFER_PROMPT_TEXT = "the prompt is read in this voice"
INFER_TEXTS = ["to get up and running quickly just follow the steps below",
               "a second request in the same voice"]
INFER_MAX_NEW = 384
# paths e and r: the infer CLI's flags beside its files (the model at CUT_LAYERS)
INFER_FLAGS = ["--num-decoder-layers", str(CUT_LAYERS), "--text-extractor", "chars",
               "--text-prompts", INFER_PROMPT_TEXT, "--text", "|".join(INFER_TEXTS),
               "--attn-impl", "flash", "--kv-cache-dtype", "int8", "--top-k", "1",
               "--max-new-tokens", str(INFER_MAX_NEW), "--seed", str(SEED)]
PROMPT_S, PROMPT_SR = 3, 16000


def _prompt_wav(path) -> None:
    """3 s at 16 kHz, so that the CLI resamples it to 24 kHz: two tones and
    seeded noise, as 16-bit PCM."""
    from valle_tpu_torch.data import write_wav

    rng = np.random.RandomState(SEED + 9)
    t = np.arange(PROMPT_S * PROMPT_SR) / PROMPT_SR
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
    write_wav(str(path), (wav + 0.05 * rng.randn(t.size)).astype(np.float32), PROMPT_SR)


def capture_first_calls(module, name: str, key_of):
    """Wrap ``module.<name>`` so that it keeps, per ``key_of(args, kwargs)``,
    the first call's arguments and output (tensors cloned); a call whose key
    is None is not kept.  The wrapper calls the real function once per call
    and leaves the launch counts alone.  Returns (captured: key -> (args,
    kwargs, out), restore)."""
    import torch

    fn = getattr(module, name)
    captured = {}

    def keep(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        return tuple(keep(x) for x in t) if isinstance(t, tuple) else t

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        key = key_of(args, kwargs)
        if key is not None and key not in captured:
            captured[key] = ([keep(a) for a in args], {k: keep(v) for k, v in kwargs.items()},
                             keep(out))
        return out

    # the wrapper shares the function's attributes: a launch counted through
    # the module's name while it is patched lands on the function
    wrapper.__dict__ = fn.__dict__
    setattr(module, name, wrapper)
    return captured, lambda: setattr(module, name, fn)


def capture_kernel2(when=lambda: True):
    """The first kernel 2 launch of each (mode, B, Tq, Tk) of a run, among
    the launches made while ``when()`` holds."""
    from valle_tpu_torch.ops import attention_impl

    return capture_first_calls(
        attention_impl, "fused_prefix_attention",
        lambda a, kw: (kw.get("prefix_s"), a[0].shape[0], a[0].shape[1], a[1].shape[1])
        if when() else None)


def check_kernel2_captures(captured, run: str) -> list:
    """Each captured kernel 2 launch against the plain attention on its
    inputs (with the launch's dropout bits), and a rerun of the kernel on
    them, which must be bit-equal."""
    import torch

    from valle_tpu_torch.ops.fused_attention import (
        attention_forward_reference, fused_prefix_attention)

    cases = []
    for (prefix_s, b, tq, tk), (args, kw, out) in sorted(
            captured.items(), key=lambda kv: (kv[0][0] is None, kv[0][1:])):
        q = args[0]
        dtype = str(q.dtype).removeprefix("torch.")
        with torch.no_grad():
            want = attention_forward_reference(*args[:4], prefix_s, kw.get("dropout_rate", 0.0),
                                               kw.get("dropout_seed"))[0]
            rerun = torch.equal(fused_prefix_attention(*args, **kw), out)
        err = float((out.float() - want.float()).abs().max())
        mode = "dense" if prefix_s is None else f"prefix s={prefix_s}"
        assert torch.isfinite(out).all() and err <= TOL[dtype], \
            f"kernel 2 in the {run} run ({mode}, B={b}, Tq={tq}, Tk={tk}) is off: {err}"
        assert rerun, f"kernel 2 in the {run} run ({mode}, B={b}, Tq={tq}): rerun differs"
        cases.append({"mode": mode, "b": b, "tq": tq, "tk": tk, "dtype": dtype,
                      "rate": kw.get("dropout_rate", 0.0), "max_abs_err": err,
                      "tol": TOL[dtype], "rerun_bit_equal": rerun})
    return cases


def _capture_infer_calls():
    """Wrap the attention's call of kernel 2 and the CLI's call of
    ``generate`` so that they keep what the CLI's run gave them: per kernel 2
    shape the first launch's inputs and output, and per text generate's
    inputs and codes.  Returns (captured, calls, restore)."""
    from valle_tpu_torch.bin import infer

    captured, restore_kernel = capture_kernel2()
    gen, calls = infer.generate, []

    def record(model, x, x_lens, prompt_codes, **kw):
        out = gen(model, x, x_lens, prompt_codes, **kw)
        calls.append({"x": x, "x_lens": x_lens, "prompts": prompt_codes,
                      "nar_text": kw["nar_text"], "nar_text_lens": kw["nar_text_lens"], **out})
        return out

    def restore():
        restore_kernel()
        infer.generate = gen

    infer.generate = record
    return captured, calls, restore


def check_infer_against_cpu(dev, cfg, model_pt, captured, calls):
    """What the CLI's run computed on the card against plain versions: every
    kernel 2 shape of the run (batch 1, the prefill's prefix mode and the
    NAR's dense mode at each text's lengths) against the plain attention on
    the captured inputs; the first text's prefill and first decode steps,
    fed its own codes, against a CPU copy of the model; and its NAR codes
    against the CPU copy's NAR passes on the card's codebook-1 tokens."""
    import torch

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.models import get_model
    from valle_tpu_torch.sample import _nar_refine

    cases = check_kernel2_captures(captured, "infer")
    assert {c["mode"] == "dense" for c in cases} == {True, False}, cases

    sd = infer.load_model_params(model_pt, cfg, "valle")
    gpu_model = get_model(cfg, device=dev, state_dict=sd)
    cpu_model = get_model(cfg, device="cpu", state_dict=sd)
    c = calls[0]
    prompt_lens = torch.full((1,), c["prompts"].shape[1], dtype=torch.long)
    forced = c["codes"][:, :8, 0]
    gpu_logits = teacher_forced_logits(gpu_model, c["x"], c["x_lens"], c["prompts"],
                                       prompt_lens.to(c["x"].device), forced, False)
    cpu_logits = teacher_forced_logits(cpu_model, c["x"].cpu(), c["x_lens"].cpu(),
                                       c["prompts"].cpu(), prompt_lens, forced.cpu(), False)
    logit_err = float((gpu_logits - cpu_logits).abs().max())
    assert torch.isfinite(gpu_logits).all()
    assert logit_err <= LOGIT_ATOL, f"infer logits differ from the CPU copy by {logit_err}"
    codes, lengths = c["codes"].cpu(), c["lengths"].cpu()
    with torch.inference_mode():
        cpu_codes = _nar_refine(cpu_model, c["nar_text"].cpu(), c["nar_text_lens"].cpu(),
                                c["prompts"].cpu(), prompt_lens, codes[..., 0], lengths)
    n = int(lengths[0])
    nar_match = float((codes[0, :n, 1:] == cpu_codes[0, :n, 1:]).float().mean())
    assert nar_match >= CODE_MATCH, f"NAR codes match the CPU copy's in {nar_match}"
    return {"kernel2_cases": cases, "logit_max_abs_err_vs_cpu": logit_err,
            "logit_atol": LOGIT_ATOL, "logit_steps": 1 + forced.shape[1],
            "nar_code_match_vs_cpu": nar_match, "nar_code_match_min": CODE_MATCH}


SYMBOLS = "abcdefghijklmnopqrstuvwxyz"  # the chars frontend's symbols ("_" is a space)


def write_serving_files(tmp) -> dict:
    """The files a user hands the CLIs, written once for the infer, serve and
    continuous phases: the full-width VALL-E (seeded random weights, f32) at
    CUT_LAYERS layers as a ``.pt``, the random codec as the converter's
    ``.npz``, a 3 s prompt wav at 16 kHz and a ``chars`` symbol table."""
    import torch

    from valle_tpu_torch.codec import random_codec_params, save_codec_npz
    from valle_tpu_torch.models import ModelConfig, get_model

    torch.manual_seed(SEED)
    torch.save({"model": get_model(ModelConfig(num_layers=CUT_LAYERS)).state_dict()},
               tmp / "model_cut.pt")
    save_codec_npz(tmp / "codec.npz", random_codec_params(seed=SEED))
    _prompt_wav(tmp / "prompt.wav")
    (tmp / "tokens.k2symbols").write_text(
        "".join(f"{c} {i + 1}\n" for i, c in enumerate(list(SYMBOLS) + ["_"])))
    torch.cuda.empty_cache()
    return {name: tmp / name for name in ("model_cut.pt", "codec.npz", "prompt.wav",
                                          "tokens.k2symbols")} | {"dir": tmp}


def infer_path(dev, files):
    """The port's infer CLI, text and a 16 kHz prompt wav to two wavs through
    the full-width VALL-E (a ``.pt`` of seeded random weights) and codec (the
    converter's ``.npz`` layout), under PyTorch's default TF32 flags as a
    user's process has them: kernel 2's launches per text, the run's kernel
    2 launches, logits and NAR codes against plain versions, the prompt codes
    against a CPU copy of the codec, and the wavs' lengths."""
    import torch

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved_tf32 = [f.allow_tf32 for f in flags]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        return _infer_path(dev, files)
    finally:
        for f, allow in zip(flags, saved_tf32):
            f.allow_tf32 = allow


def _infer_path(dev, files):
    import torch
    from scipy.io import wavfile

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.codec import load_codec
    from valle_tpu_torch.data import convert_audio, read_wav
    from valle_tpu_torch.models import ModelConfig

    cfg = ModelConfig(num_layers=CUT_LAYERS)  # the default VALL-E's width
    tmp = files["dir"]
    argv = ["--checkpoint", str(tmp / "model_cut.pt"), "--codec-checkpoint",
            str(tmp / "codec.npz"), "--text-tokens", str(tmp / "tokens.k2symbols"),
            "--audio-prompts", str(tmp / "prompt.wav"), "--output-dir",
            str(tmp / "out")] + INFER_FLAGS
    captured, calls, restore = _capture_infer_calls()
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        infer.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        restore()

    per_text = cfg.num_layers + (cfg.num_quantizers - 1) * cfg.nar_num_layers
    want = {"ragged_decode": 0, "prefix_attention": per_text * len(INFER_TEXTS),
            "prefix_attention_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"
    assert len(calls) == len(INFER_TEXTS), len(calls)
    frames = []
    for n, call in enumerate(calls):
        codes = np.load(tmp / "out" / f"{n}_codes.npy")
        sr, wav = wavfile.read(tmp / "out" / f"{n}.wav")
        assert codes.ndim == 2 and codes.shape[1] == cfg.num_quantizers, codes.shape
        assert 0 <= codes.min() and codes.max() < cfg.num_audio_tokens
        assert (codes == call["codes"][0, :codes.shape[0]].cpu().numpy()).all()
        assert sr == 24000 and wav.dtype == np.int16 and wav.ndim == 1
        assert wav.shape[0] == 320 * codes.shape[0], (wav.shape, codes.shape)
        assert np.isfinite(wav.astype(np.float32)).all()
        frames.append(int(codes.shape[0]))

    args = infer.get_parser().parse_args(argv)
    checks = check_infer_against_cpu(dev, infer.config_from_args(args), str(tmp / "model_cut.pt"),
                                     captured, calls)
    # the prompt's codes from the card's codec against a CPU copy's
    card = load_codec(tmp / "codec.npz")
    prompt = infer.encode_prompt_wavs(args, card, cfg.num_quantizers)
    prompt_cpu = infer.encode_prompt_wavs(args, load_codec(tmp / "codec.npz", device="cpu"),
                                          cfg.num_quantizers)
    assert prompt.shape == prompt_cpu.shape == (1, PROMPT_S * 75, cfg.num_quantizers)
    assert (prompt == calls[0]["prompts"].cpu().numpy()).all()
    match = float((prompt == prompt_cpu).mean())
    assert match >= CODE_MATCH, f"prompt codes match the CPU copy's in {match}"
    wav, sr = read_wav(str(tmp / "prompt.wav"))
    wav = torch.from_numpy(convert_audio(wav, sr, 24000, 1)[None]).to(dev)
    encode = cuda_time(lambda: card.encode(wav), iters=1, windows=3, warmup=1)
    emit({"phase": "infer", "cli": "python -m valle_tpu_torch.bin.infer", "flags": INFER_FLAGS,
          "model": f"VALL-E ModelConfig(num_layers={CUT_LAYERS}) (d=1024, 16 heads, "
                   f"{CUT_LAYERS}+{CUT_LAYERS} layers), seeded random weights (.pt)",
          "codec": "EncodecConfig(), seeded random weights (.npz)", "texts": INFER_TEXTS,
          "tf32_flags": "PyTorch defaults (matmul off, cuDNN on; the codec turns it off)",
          "launches": launches, "frames": frames, "cli_wall_s": wall_s,
          "audio_s_per_s": sum(frames) / 75.0 / wall_s,
          "encode_ms_per_prompt_s": encode["ms"] / PROMPT_S,
          "encode_ms_spread": [encode["ms_min"], encode["ms_max"]],
          "prompt_code_match_vs_cpu": match, "prompt_code_match_min": CODE_MATCH, **checks})
    return launches


# ---------------------------------------------------------------- phase 13


SERVE_MODES = ("none", "w8", "w8a8")
SERVE_BATCH = 16
SERVE_BUCKETS = (256, 512)
SERVE_WORDS = ("the", "voice", "reads", "a", "short", "line", "of", "text", "in", "quiet",
               "rooms", "where", "light", "falls", "over", "old", "maps", "and", "every",
               "request", "waits", "its", "turn")
# JAX's bars for one Dense layer against its float output (tests/test_quantize.py)
QUANT_LAYER_RTOL = {"w8": 0.01, "w8a8": 0.02}
QUANT_LAYERS = ("ar_decoder.layers.0.self_attn.in_proj_weight",
                "ar_decoder.layers.0.self_attn.out_proj.weight",
                "ar_decoder.layers.0.linear1.weight", "ar_decoder.layers.0.linear2.weight",
                "ar_predict_layer.weight")
# the whole model's prefill logits against the unquantized run's: the JAX
# package's own full-width readings exceed the one-layer bars (W8 0.0217,
# W8A8 0.0211 in bf16; 0.0147 / 0.0206 in f32: scripts/quant_logit_error.py),
# so these bars are about 1.5x those
QUANT_LOGIT_RTOL = {"w8": 0.03, "w8a8": 0.035}
WINDOW_STEPS = 16  # decode steps in the profiled window of each weight mode


def _text_of(rng, n: int) -> str:
    """A text of exactly ``n`` characters of the symbol table's words."""
    words = []
    while len(" ".join(words)) < n:
        words.append(SERVE_WORDS[rng.randint(len(SERVE_WORDS))])
    return " ".join(words)[:n].strip().ljust(n, "a")


def _serve_requests(path, wav) -> list:
    """24 requests: 16 with the prompt wav and its text, 8 promptless; texts
    of 20-160 characters, the promptless ones of 20-30 in the 256 bucket."""
    rng = np.random.RandomState(SEED + 11)
    rows = []
    for i in range(24):
        prompted, short = i < 16, 16 <= i < 20
        text = _text_of(rng, rng.randint(20, 31) if short else rng.randint(20, 161))
        rows.append(f"r{i:02d}\t{text}\t{wav if prompted else '-'}\t"
                    f"{INFER_PROMPT_TEXT if prompted else '-'}")
    path.write_text("\n".join(rows) + "\n")
    return rows


INT8_FAMILY = ("int8 products (torch._int_mm)", ("gemm_s8", "s8s8", "imma", "int8", "Int8"))


def check_quantized_layers(sd, dev) -> dict:
    """JAX's one-layer bars on the card: each quantized weight of the first
    AR layer and the head (the full-width weights of the ``.pt``), W8 and
    W8A8 through ``qdense.linear`` in f32 on 64 rows of N(0, 1)
    activations, against the float product."""
    import torch

    from valle_tpu_torch.nn import qdense

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name in QUANT_LAYERS:
        w = sd[name].to(dev).float()
        x = torch.randn(64, w.shape[1], generator=g, device=dev)
        exact = x @ w.t()
        w8, scale = qdense._quantize_kernel(w)
        for mode, bar in QUANT_LAYER_RTOL.items():
            approx = qdense.linear(x, w8, None, scale, act_quant=mode == "w8a8")
            rel = float((approx - exact).abs().max() / exact.abs().max())
            assert rel < bar, f"{name} {mode}: {rel} off the float layer (bar {bar})"
            out[f"{name} {mode}"] = rel
    return out


def quant_product_ms(sd, dev, rows: int) -> dict:
    """Device ms per call (CUDA events) of each quantized weight's product at
    ``rows`` rows of bf16 activations: the bf16 product, W8's dequantised
    copy alone and its whole product, the int8 product (``torch._int_mm``)
    alone and W8A8's whole product; and their sums over the weights of one
    decode step (12 layers x 4 products + the head) or one NAR pass
    (12 x 4)."""
    import torch
    from torch.nn import functional as F

    from valle_tpu_torch.nn import qdense

    g = torch.Generator(device=dev).manual_seed(SEED)
    per = {}
    for name in QUANT_LAYERS:
        w = sd[name].to(dev)
        wb, (w8, scale) = w.bfloat16(), qdense._quantize_kernel(w)
        x = torch.randn(rows, w.shape[1], generator=g, device=dev).bfloat16()
        x8 = torch.randint(-127, 128, (rows, w.shape[1]), generator=g, device=dev,
                           dtype=torch.int8)
        fns = {"bf16": lambda: F.linear(x, wb), "w8_dequant_copy": lambda: w8.to(x.dtype),
               "w8": lambda: qdense.linear(x, w8, None, scale),
               "int8_product": lambda: qdense.int8_matmul(x8, w8),
               "w8a8": lambda: qdense.linear(x, w8, None, scale, act_quant=True)}
        per[name.split(".")[-2]] = {k: cuda_time(fn, iters=20, windows=3)["ms"]
                                    for k, fn in fns.items()}
    layer = [per[k] for k in ("self_attn", "out_proj", "linear1", "linear2")]
    sums = {k: 12 * sum(p[k] for p in layer) for k in layer[0]}
    head = per["ar_predict_layer"]
    return {"rows": rows, "per_weight": per, "per_nar_pass": sums,
            "per_decode_step": {k: v + head[k] for k, v in sums.items()}}


def _window_breakdown(model, batch) -> dict:
    """Device time by kernel family (``torch.profiler``) of a prefill, 16
    decode steps and the 7 NAR passes over the full bucket, on the first serve
    batch's inputs: where a weight mode's time goes."""
    import torch

    from valle_tpu_torch.sample import _decode_bias, _make_cache, _nar_refine, _prefill_kv

    x, x_lens, prompts, plens, bucket = batch
    b = x.shape[0]
    families = (INT8_FAMILY,)

    def prefill():
        with torch.inference_mode():
            return _prefill_kv(model, x, x_lens, prompts, plens)

    logits, (k, v), mem, key_pad, mem_bias, tpre = prefill()

    def decode():
        with torch.inference_mode():
            cache = _make_cache("int8", k, v, tpre + WINDOW_STEPS)
            tok = torch.zeros((b, 1), dtype=torch.long, device=x.device)
            for t in range(WINDOW_STEPS):
                model.ar_decode_step(tok, (plens + t)[:, None], cache, tpre + t,
                                     _decode_bias(~key_pad, tpre + WINDOW_STEPS, t))

    tokens = torch.zeros((b, bucket), dtype=torch.long, device=x.device)
    full = torch.full((b,), bucket, dtype=torch.long, device=x.device)

    def nar():
        with torch.inference_mode():
            _nar_refine(model, x, x_lens, prompts, plens, tokens, full)

    out = {}
    for name, fn in (("prefill", prefill), ("decode_16_steps", decode), ("nar_7_passes", nar)):
        fn()  # warm-up
        out[name] = profile_breakdown(fn, families)
    return out


def serve_path(dev, files):
    """The port's serve CLI (``valle_tpu_torch.bin.serve.main``) on 24
    requests in the serving defaults (bf16, int8 KV cache), ``--attn-impl
    flash``, batch 16, buckets 256 / 512, greedy, once per weight mode
    (``--quantize-weights none / w8 / w8a8``): wall time, audio-s/s and
    launches per run; the first kernel 2 launch of each shape against the
    plain attention with a bit-equal rerun; every int8 product shape of the
    w8a8 run bit-equal to its plain integer sums; the w8 / w8a8 runs' first
    prefill logits against the unquantized run's at JAX's relative bars; and
    per mode the device time by kernel family of a profiled window."""
    import torch

    from valle_tpu_torch import sample
    from valle_tpu_torch.bin import infer, serve
    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.nn import qdense

    tmp = files["dir"]
    rows = _serve_requests(tmp / "requests.tsv", files["prompt.wav"])
    runs, paths, first_logits, batch = {}, {}, {}, None
    # the CLI's settings, at CUT_LAYERS layers (seeded random weights)
    cfg = ModelConfig(dtype="bfloat16", kv_cache_dtype="int8", attn_impl="flash",
                      num_layers=CUT_LAYERS)
    model_pt = files["model_cut.pt"]
    for mode in SERVE_MODES:
        out_dir = tmp / f"serve_{mode}"
        argv = ["--requests", str(tmp / "requests.tsv"), "--checkpoint", str(model_pt),
                "--num-decoder-layers", str(CUT_LAYERS),
                "--codec-checkpoint", str(files["codec.npz"]), "--text-tokens",
                str(files["tokens.k2symbols"]), "--text-extractor", "chars", "--batch-size",
                str(SERVE_BATCH), "--length-buckets", ",".join(map(str, SERVE_BUCKETS)),
                "--attn-impl", "flash", "--top-k", "1", "--quantize-weights", mode,
                "--seed", str(SEED), "--output-dir", str(out_dir)]
        int8_matmul = qdense.int8_matmul
        kernel2, restore_k2 = capture_kernel2()
        int8_calls, restore_mm = capture_first_calls(
            qdense, "int8_matmul", lambda a, kw: (*a[0].shape, a[1].shape[0]))
        prefills, restore_pre = capture_first_calls(sample, "_prefill_kv",
                                                    lambda a, kw: a[1].shape[0])
        try:
            torch.cuda.synchronize()
            reset_launches()
            int8_matmul.launches = 0
            t0 = time.perf_counter()
            serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            int8_launches = int8_matmul.launches
        finally:
            restore_k2(), restore_mm(), restore_pre()
        manifest = [json.loads(line) for line in
                    (out_dir / "manifest.jsonl").read_text().splitlines()]
        assert sorted(m["id"] for m in manifest) == sorted(r.split("\t")[0] for r in rows)
        jobs = sum(-(-sum(m["bucket"] == bk for m in manifest) // SERVE_BATCH)
                   for bk in SERVE_BUCKETS)
        per_job = cfg.num_layers + (cfg.num_quantizers - 1) * cfg.nar_num_layers
        want = {"ragged_decode": 0, "prefix_attention": per_job * jobs,
                "prefix_attention_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0}
        assert launches == want, f"serve {mode}: launch counts {launches}, expected {want}"
        assert (int8_launches > 0) == (mode == "w8a8"), (mode, int8_launches)
        for m in manifest:
            codes = np.load(out_dir / f"{m['id']}_codes.npy")
            assert codes.shape == (m["frames"], cfg.num_quantizers)
            assert 0 <= m["frames"] <= m["bucket"]
            assert codes.size == 0 or (0 <= codes.min() and codes.max() < 1024)
            assert (out_dir / f"{m['id']}.wav").exists() == (m["frames"] > 0)
        kernel2_cases = check_kernel2_captures(kernel2, f"serve {mode}")
        assert {c["mode"] == "dense" for c in kernel2_cases} == {True, False}, kernel2_cases
        int8_cases = []
        for (m_rows, k_in, n_out), (args, _, out) in sorted(int8_calls.items()):
            exact = torch.equal(out, qdense.int_mm_reference(args[0], args[1].t()))
            assert exact, f"int8 product ({m_rows} x {k_in} -> {n_out}) differs from its sums"
            int8_cases.append([m_rows, k_in, n_out])
        if mode == "w8a8":
            assert {c[0] <= SERVE_BATCH for c in int8_cases} == {True, False}, int8_cases
            assert any(c[2] == 1025 for c in int8_cases), int8_cases
        args, _, out = prefills[SERVE_BATCH]  # the first full batch (bucket 512)
        first_logits[mode] = out[0].float()
        batch = (*args[1:5], SERVE_BUCKETS[-1])  # its inputs, for the profiled windows
        del prefills, int8_calls, kernel2, args, out
        frames = sum(m["frames"] for m in manifest)
        runs[mode] = {"wall_s": wall, "frames": frames, "audio_s": frames / 75.0,
                      "audio_s_per_s": frames / 75.0 / wall, "jobs": jobs,
                      "launches": launches, "int8_product_calls": int8_launches,
                      "kernel2_cases": kernel2_cases, "int8_product_shapes_bit_equal": int8_cases}
        paths[f"serve_{mode}"] = launches

    ref, off = first_logits["none"], []
    for mode, rtol in QUANT_LOGIT_RTOL.items():
        rel = float((first_logits[mode] - ref).abs().max() / ref.abs().max())
        runs[mode]["prefill_logit_rel_err_vs_none"] = rel
        runs[mode]["prefill_logit_rtol"] = rtol
        if rel > rtol:
            off.append(f"serve {mode}: prefill logits {rel} off the unquantized run's")

    sd = infer.load_model_params(str(model_pt), cfg, "valle")
    layer_errors = check_quantized_layers(sd, dev)
    x = batch[0]
    products = {"decode": quant_product_ms(sd, dev, x.shape[0]),
                "nar": quant_product_ms(sd, dev, x.shape[0] * (x.shape[1] + batch[2].shape[1]
                                                             + SERVE_BUCKETS[-1]))}
    for mode in SERVE_MODES:
        model = get_model(cfg.replace(act_quant=mode == "w8a8"), device=dev, state_dict=sd,
                          quantize=mode != "none")
        runs[mode]["window"] = _window_breakdown(model, batch)
        del model
        torch.cuda.empty_cache()
    emit({"phase": "serve", "cli": "python -m valle_tpu_torch.bin.serve",
          "model": f"VALL-E ModelConfig(num_layers={CUT_LAYERS}) (d=1024, 16 heads, "
                   f"{CUT_LAYERS}+{CUT_LAYERS} layers), seeded random weights (.pt), bf16, int8 KV",
          "requests": len(rows), "batch_size": SERVE_BATCH, "buckets": SERVE_BUCKETS,
          "window": f"prefill, {WINDOW_STEPS} decode steps, 7 NAR passes of the first batch",
          "layer_rel_err_vs_float": layer_errors, "layer_rtol": QUANT_LAYER_RTOL,
          "quantized_products_ms": products, "runs": runs})
    assert not off, off  # after the phase's line, which carries every reading
    return paths


# ---------------------------------------------------------------- phase 14


CONT_REQUESTS = 32
CONT_SCHED = dict(batch_size=8, chunk=128, admit_width=8, cap_steps=2048, nar_bucket=384,
                  ragged_decode=True, top_k=1, forbid_eos=True)
NEAR_TIE_ULPS = 4  # a top-two logit gap of at most 4 bf16 ulps of the top logit


def _bf16_ulp(x: float) -> float:
    return float(np.ldexp(1.0, np.frexp(abs(x))[1] - 8))


def continuous_path(dev, files):
    """``serve_continuous`` on 32 requests (the full-width VALL-E in bf16 with
    an int8 KV cache, ``ragged_decode``), then ``generate`` on the same
    requests in batches of 8: launches (kernel 1 on every decode step),
    slot occupancy and audio-s/s of both; kernel 1 on the first decode step
    with mixed live lengths and finished slots against its plain version,
    with a bit-equal rerun; every kernel 2 shape likewise; lengths equal to
    generate's, codebook-1 codes equal up to the first near-tie (whose
    top-two gap in generate's logits is printed) and every codebook equal
    for the requests without one."""
    import torch

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.nn import attention
    from valle_tpu_torch.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)
    from valle_tpu_torch.sample import generate
    from valle_tpu_torch.sample.continuous import serve_continuous

    cfg = ModelConfig(dtype="bfloat16", attn_impl="flash", kv_cache_dtype="int8",
                      num_layers=CUT_LAYERS)
    model = get_model(cfg, device=dev,
                      state_dict=infer.load_model_params(str(files["model_cut.pt"]), cfg,
                                                         "valle"))
    rng = np.random.RandomState(SEED + 13)
    r, s, p, q = CONT_REQUESTS, 64, 225, cfg.num_quantizers
    req = {"x": rng.randint(1, cfg.num_text_tokens, (r, s)), "x_lens": rng.randint(40, s + 1, r),
           "prompts": rng.randint(0, cfg.num_audio_tokens, (r, p, q)),
           "prompt_lens": rng.randint(150, p + 1, r), "stop_lens": rng.randint(64, 385, r)}
    counts = {"prefill": 0, "decode": 0}
    gaps = []
    real = {"prefill": model.ar_prefill, "decode": model.ar_decode_step}

    def counted(name, record):
        def fn(*args, **kw):
            counts[name] += 1
            out = real[name](*args, **kw)
            if record:  # the top-two gap of the logits that pick the next token
                top = out[0].float().topk(2, dim=-1).values
                gaps.append(torch.stack([top[:, 0], top[:, 0] - top[:, 1]], 1))
            return out
        return fn

    k2, restore_k2 = capture_kernel2()
    model.ar_prefill, model.ar_decode_step = counted("prefill", False), counted("decode", False)
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = serve_continuous(model, req, generator=torch.Generator(device=dev).manual_seed(SEED),
                               **CONT_SCHED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        restore_k2()
    steps, prefills = counts["decode"], counts["prefill"]
    n_layers = cfg.num_layers
    nar_batches = -(-r // CONT_SCHED["batch_size"])
    want = {"ragged_decode": n_layers * steps,
            "prefix_attention": n_layers * prefills + 7 * cfg.nar_num_layers * nar_batches,
            "prefix_attention_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0}
    assert launches == want, f"continuous: launch counts {launches}, expected {want}"
    lengths = [o["length"] for o in out]
    assert lengths == req["stop_lens"].tolist(), (lengths, req["stop_lens"].tolist())
    frames = sum(lengths)
    kernel2_cases = check_kernel2_captures(k2, "continuous")
    del k2

    # kernel 1 at the first decode step with live slots of different lengths
    # and finished ones (after a refill), in a rerun on the first 16 requests
    # (the capture reads the lengths on the host at every launch)
    def mixed(a, kw):
        lens = a[3]
        live = lens[lens > 0]
        return bool((lens == 0).any()) and live.numel() > 1 and bool((live != live[0]).any())

    k1, restore_k1 = capture_first_calls(attention, "ragged_decode_attention", mixed)
    try:
        serve_continuous(model, {k: v[:16] for k, v in req.items()}, **CONT_SCHED)
    finally:
        restore_k1()
    assert True in k1, "no decode step had mixed lengths and finished slots"
    args, kw, got = k1.pop(True)
    del k1
    want_k1 = ragged_decode_attention_reference(*args)
    k1_err = float((got - want_k1).abs().max())
    k1_rerun = torch.equal(ragged_decode_attention(*args, **kw), got)
    assert k1_err <= TOL["float32"] and k1_rerun, (k1_err, k1_rerun)
    k1_lens = args[3].tolist()
    del args, got, want_k1

    # generate on the same requests in batches of 8, recording the logits' gaps
    counts.update(prefill=0, decode=0)
    model.ar_prefill, model.ar_decode_step = counted("prefill", True), counted("decode", True)
    b = CONT_SCHED["batch_size"]
    gen_codes, gen_gaps = [], []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for g0 in range(0, r, b):
        gaps.clear()
        take = lambda k: torch.from_numpy(req[k][g0: g0 + b]).to(dev)  # noqa: E731
        res = generate(model, take("x"), take("x_lens"), take("prompts"), take("prompt_lens"),
                       generator=torch.Generator(device=dev).manual_seed(SEED),
                       stop_lens=take("stop_lens"), max_new_tokens=CONT_SCHED["nar_bucket"],
                       top_k=1, forbid_eos=True, ragged_decode=True)
        gen_codes.append(res["codes"].cpu().numpy())
        gen_gaps.append(torch.stack(gaps, 1).cpu().numpy())  # (b, steps + 1, 2)
        assert res["lengths"].cpu().tolist() == req["stop_lens"][g0: g0 + b].tolist()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches()
    del model.ar_prefill, model.ar_decode_step  # the wrappers; the methods again
    gen_steps = counts["decode"]
    assert gen_launches["ragged_decode"] == n_layers * gen_steps, gen_launches
    assert gen_launches["prefix_attention"] == (n_layers + 7 * cfg.nar_num_layers) * nar_batches

    equal, ties = 0, []
    for i, o in enumerate(out):
        g, row = divmod(i, b)
        mine, theirs = o["codes"][:, 0], gen_codes[g][row, :o["length"], 0]
        diff = np.flatnonzero(mine != theirs)
        if diff.size == 0:
            assert (o["codes"] == gen_codes[g][row, :o["length"]]).all(), f"request {i}: NAR codes"
            equal += 1
            continue
        j = int(diff[0])
        top, gap = (float(v) for v in gen_gaps[g][row, j])
        limit = NEAR_TIE_ULPS * _bf16_ulp(top)
        ties.append({"request": i, "step": j, "top_logit": top, "gap": gap, "limit": limit})
    emit({"phase": "continuous", "model": "VALL-E default ModelConfig, seeded random weights "
          "(.pt), bf16, int8 KV, attn_impl=flash", "requests": r, "schedule": CONT_SCHED,
          "stop_lens": req["stop_lens"].tolist(), "decode_steps": steps, "prefills": prefills,
          "launches": launches, "ar_slot_occupancy": frames / (b * steps), "wall_s": wall,
          "audio_s_per_s": frames / 75.0 / wall,
          "kernel1_step": {"lengths": k1_lens, "max_abs_err": k1_err, "tol": TOL["float32"],
                           "rerun_bit_equal": k1_rerun},
          "kernel2_cases": kernel2_cases,
          "generate": {"batches": nar_batches, "decode_steps": gen_steps,
                       "launches": gen_launches, "ar_slot_occupancy": frames / (b * gen_steps),
                       "wall_s": gen_wall, "audio_s_per_s": frames / 75.0 / gen_wall},
          "requests_with_equal_codes": equal, "first_near_ties": ties,
          "near_tie": f"top-two gap <= {NEAR_TIE_ULPS} bf16 ulps of the top logit"})
    off = [t for t in ties if t["gap"] > t["limit"]]
    assert not off, f"codes differ from generate's without a near-tie: {off}"
    return launches, gen_launches


# ---------------------------------------------------------------- phase 15
# The training CLI: full-width VALL-E through the two-stage recipe on a
# synthetic corpus (4-6 s utterances, 75 frames/s x 8 codebooks; texts of
# 40-100 chars symbols), then the Transformer TTS baseline on random mels.

CLI_UTTS, CLI_DEV_UTTS, CLI_DUR = 64, 8, (4.0, 6.0)
CLI_FLAGS = ["--attn-impl", "fused", "--dropout", "0.1", "--optimizer-name", "ScaledAdam",
             "--scheduler-name", "Eden", "--average-period", "2", "--valid-interval", "4",
             "--save-every-n", "4", "--keep-last-k", "1", "--oom-check", "true",
             "--max-duration", "20", "--num-buckets", "2", "--accumulate-grad-steps", "2",
             "--batch-quant", "1", "--log-interval", "1", "--tensorboard", "false",
             "--seed", str(SEED)]
TTS_CLI_UTTS, TTS_CLI_DUR = 8, (8.0, 10.0)  # 750-938 mel frames at 93.75 frames/s
HAND_FED_STEPS = 5


class _StopRun(BaseException):
    """Ends a CLI run from inside its step (not an Exception: the CLI's
    crash handler lets it through)."""


def write_cli_corpus(root, symbols, *, splits, dur, fmt, frame_rate, dim, seed) -> Path:
    """Manifests and shards of random codes (``fmt`` "vsh") or random mels
    ("vsf") for each (split, count), and the ``chars`` symbol table."""
    import shutil

    from valle_tpu_torch.data import CodeShardWriter, Manifest

    rng = np.random.RandomState(seed)
    chars = list(SYMBOLS) + ["_"]
    for split, n in splits:
        records = []
        with CodeShardWriter(root, prefix=f"{split}_codes", fmt=fmt, num_quantizers=dim) as w:
            for i in range(n):
                d = float(rng.uniform(*dur))
                t = int(round(d * frame_rate))
                feats = (rng.randn(t, dim).astype(np.float32) if fmt == "vsf"
                         else rng.randint(0, 1024, (t, dim)))
                utt = f"{i % 4}_{100 + i % 4}_{i:06d}_000000"
                shard, key = w.write(utt, feats)
                tokens = [chars[j] for j in rng.randint(0, len(chars), rng.randint(40, 101))]
                rec = {"id": utt, "text": "".join(tokens), "tokens": tokens, "duration": d,
                       "shard": shard, "key": key}
                if fmt == "vsf":
                    rec["feature_dim"] = dim
                records.append(rec)
        Manifest.save(iter(records), root / f"manifest_{split}.jsonl.gz")
    shutil.copy(symbols, root / "unique_text_tokens.k2symbols")
    return root


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def capture_kernel3(when=lambda: True):
    """The first kernel 3 launch of each (mode, B, Tq, Tk) of a run, among
    the launches made while ``when()`` holds."""
    from valle_tpu_torch.ops import fused_attention

    return capture_first_calls(
        fused_attention, "fused_prefix_attention_backward",
        lambda a, kw: (kw.get("prefix_s"), a[0].shape[0], a[0].shape[1], a[1].shape[1])
        if when() else None)


def check_kernel3_captures(captured, run: str) -> list:
    """Each captured kernel 3 launch against the plain backward on its inputs
    (the launch's dropout bits), and a bit-equal rerun."""
    import torch

    from valle_tpu_torch.ops import fused_attention as fa

    cases = []
    for (prefix_s, b, tq, tk), (args, kw, out) in sorted(
            captured.items(), key=lambda kv: (kv[0][0] is None, kv[0][1:])):
        dtype = str(args[0].dtype).removeprefix("torch.")
        want = fa.attention_backward_reference(*args[:7], prefix_s, kw.get("dropout_rate", 0.0),
                                               kw.get("dropout_seed"))
        err = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(out, want))
        rerun = all(torch.equal(g, a) for g, a in zip(fa.fused_prefix_attention_backward(
            *args, **kw), out))
        mode = "dense" if prefix_s is None else f"prefix s={prefix_s}"
        assert all(torch.isfinite(g).all() for g in out) and err <= TOL[dtype], \
            f"kernel 3 in the {run} run ({mode}, B={b}, Tq={tq}, Tk={tk}) is off: {err}"
        assert rerun, f"kernel 3 in the {run} run ({mode}, B={b}, Tq={tq}): rerun differs"
        cases.append({"mode": mode, "b": b, "tq": tq, "tk": tk, "dtype": dtype,
                      "rate": kw.get("dropout_rate", 0.0), "max_rel_err": err,
                      "tol": TOL[dtype], "rerun_bit_equal": rerun})
    return cases


def capture_kernel4(when=lambda: True):
    """The first kernel 4 forward and backward launch of each (B, Tq, Tk,
    bias shape) of a run, among the launches made while ``when()`` holds:
    the forward through the autograd function's ``_forward`` (with the
    LSE), the backward through ``flash_attention_biased_backward``.
    Returns (forward captures, backward captures, restore)."""
    from valle_tpu_torch.ops import flash_attention as fl

    def key(a, kw):
        return (a[0].shape[0], a[0].shape[1], a[1].shape[1], tuple(a[3].shape)) if when() else None

    fwd, restore_fwd = capture_first_calls(fl, "_forward", key)
    bwd, restore_bwd = capture_first_calls(fl, "flash_attention_biased_backward", key)

    def restore():
        restore_fwd()
        restore_bwd()

    return fwd, bwd, restore


def check_kernel4_captures(fwd, bwd, run: str) -> list:
    """Each captured kernel 4 forward (output and LSE) and backward (dq, dk,
    dv and d(bias) where taken) against the plain version on its inputs, and
    a bit-equal rerun of the kernel on them."""
    import torch

    from valle_tpu_torch.ops import flash_attention as fl

    cases = []
    for (b, tq, tk, bias_shape), (args, kw, (out, lse)) in sorted(fwd.items()):
        dtype = str(args[0].dtype).removeprefix("torch.")
        with torch.no_grad():
            want, want_lse = fl.flash_attention_forward_reference(*args[:4])
            again, again_lse = fl._forward(*args, **kw)
        err = float((out.float() - want.float()).abs().max())
        # a call under no_grad takes no LSE
        lse_err = 0.0 if lse is None else float((lse - want_lse).abs().max())
        rerun = torch.equal(again, out) and (lse is None or torch.equal(again_lse, lse))
        where = f"kernel 4 forward in the {run} run (B={b}, Tq={tq}, Tk={tk}, bias {bias_shape})"
        assert torch.isfinite(out).all() and err <= TOL[dtype] and lse_err <= TOL["float32"], \
            f"{where} is off: {err}, LSE {lse_err}"
        assert rerun, f"{where}: rerun differs"
        cases.append({"pass": "forward", "b": b, "tq": tq, "tk": tk, "bias_shape": list(bias_shape),
                      "dtype": dtype, "max_abs_err": err, "lse_max_abs_err": lse_err,
                      "tol": TOL[dtype], "rerun_bit_equal": rerun})
    for (b, tq, tk, bias_shape), (args, kw, out) in sorted(bwd.items()):
        dtype = str(args[0].dtype).removeprefix("torch.")
        bias_grad = kw.get("bias_grad", False)
        want = fl.flash_attention_backward_reference(*args[:7], bias_grad)
        again = fl.flash_attention_biased_backward(*args, **kw)
        got, again, want = ([g for g in x if g is not None] for x in (out, again, want))
        err = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(got, want))
        rerun = all(torch.equal(g, a) for g, a in zip(got, again))
        where = f"kernel 4 backward in the {run} run (B={b}, Tq={tq}, Tk={tk}, bias {bias_shape})"
        assert all(torch.isfinite(g).all() for g in got) and err <= TOL[dtype], \
            f"{where} is off: {err}"
        assert rerun, f"{where}: rerun differs"
        cases.append({"pass": "backward", "b": b, "tq": tq, "tk": tk,
                      "bias_shape": list(bias_shape), "bias_grad": bias_grad, "dtype": dtype,
                      "max_rel_err": err, "tol": TOL[dtype], "rerun_bit_equal": rerun})
    return cases


def _cli_numbers(summary: dict) -> dict:
    """Medians of a CLI run's steps: the loop's seconds per step (the wait
    for the loader, the copy and the step), its parts, and the logged MFU."""
    steps = summary["steps"]
    med = lambda key: float(np.median([s[key] for s in steps]))  # noqa: E731
    mfu = [s["mfu"] for s in steps if s.get("mfu") is not None]
    return {"steps": len(steps), "shapes_ABST": sorted({tuple(s["shape"]) for s in steps}),
            "losses": [s["loss"] / s["frames"] for s in steps],
            "cli_step_s_median": float(np.median([s["data_s"] + s["copy_s"] + s["step_s"]
                                                  for s in steps])),
            "step_s_median": med("step_s"), "loader_wait_s_median": med("data_s"),
            "copy_s_median": med("copy_s"), "loader_wait_s_max": max(s["data_s"] for s in steps),
            "mfu_median": float(np.median(mfu)) if mfu else None,
            "saves": summary["saves"], "validations": summary["validations"],
            "oom_scan": summary["oom_scan"], "peak_mem_gib": summary["peak_mem_bytes"] / 2**30,
            "loader_path": summary["loader_path"], "resumed_from": summary["resumed_from"]}


def train_cli_path(dev, files, hand_fed_step_s):
    """The port's training CLI (``valle_tpu_torch.bin.train.main``) in
    process: the full-width VALL-E through stage 1 (1 epoch) and stage 2 (1
    more epoch) in one exp dir, a step resumed from stage 2's mid-epoch
    checkpoint, the final averaged weights through the infer CLI to a wav,
    then the full-width TTS baseline with SpecAugment for 2 steps."""
    import os
    import shutil

    import torch

    from valle_tpu_torch.bin import infer as infer_cli
    from valle_tpu_torch.bin import train as train_cli
    from valle_tpu_torch.train.checkpoint import CheckpointManager

    root = files["dir"] / "train_cli"
    corpus = write_cli_corpus(root / "data", files["tokens.k2symbols"],
                              splits=(("train", CLI_UTTS), ("dev", CLI_DEV_UTTS)), dur=CLI_DUR,
                              fmt="vsh", frame_rate=75.0, dim=8, seed=SEED + 11)
    exp = root / "exp"
    steps, validations, scans, saves_kept = [], [], [], {}
    watch = {"keep_step": None, "snapshot": None, "profile": None, "stage": None}

    make_step, run_validation = train_cli.make_train_step, train_cli.run_validation
    scan = train_cli.scan_batch_shapes_for_oom

    def counted_make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            before = read_launches()
            if watch["profile"] == state.step:  # one profiled step of stage 2
                out = []
                watch["breakdown"] = profile_breakdown(
                    lambda: out.append(step(state, batch, rng, epoch)))
                state, metrics = out[0]
            else:
                state, metrics = step(state, batch, rng, epoch)
            steps.append({"stage": kw["train_stage"], "step": state.step,
                          "micro_batches": batch["text_tokens"].shape[0],
                          "launches": _delta(read_launches(), before)})
            if watch["keep_step"] is not None and state.step == watch["keep_step"] + 1:
                watch["snapshot"] = (float(metrics["loss"]), {
                    k: v.detach().clone() for k, v in state.model.state_dict().items()})
            return state, metrics

        return run

    def counted_validation(eval_fn, state, loader, dev_, *args, **kw):
        n = sum(1 for _ in loader)
        first_rows = len(next(iter(loader))["utt_id"][0])
        before = read_launches()
        out = run_validation(eval_fn, state, loader, dev_, *args, **kw)
        validations.append({"batches": n, "first_batch_rows": first_rows,
                            "launches": _delta(read_launches(), before)})
        return out

    def counted_scan(*a, **kw):
        before = read_launches()
        out = scan(*a, **kw)
        scans.append({"shapes": len(out), "launches": _delta(read_launches(), before)})
        return out

    class KeepingManager(CheckpointManager):
        """Keeps a hard link of the checkpoint the resume check restores,
        which keep-last-k would prune."""

        def save_step(self, step, state, meta):
            super().save_step(step, state, meta)
            if step == watch["keep_step"]:
                keep = root / "kept"
                keep.mkdir()
                os.link(self.path(f"checkpoint-{step}"), keep / f"checkpoint-{step}.pt")
                shutil.copy(self.dir / f"checkpoint-{step}.meta.json", keep)
                saves_kept["name"] = f"checkpoint-{step}"

    train_cli.make_train_step = counted_make_train_step
    train_cli.run_validation = counted_validation
    train_cli.scan_batch_shapes_for_oom = counted_scan
    train_cli.CheckpointManager = KeepingManager
    captured2, restore2 = capture_kernel2()
    captured3, restore3 = capture_kernel3()
    kept: dict = {}
    restore_copy = first_to_device_arrays(train_cli, kept)
    argv = ["--manifest-dir", str(corpus), "--exp-dir", str(exp), *CLI_FLAGS]
    try:
        reset_launches()
        t0 = time.perf_counter()
        first = train_cli.main(argv + ["--train-stage", "1", "--num-epochs", "1"])
        stage1_s = time.perf_counter() - t0
        n1 = first["state"].step
        stage1_ar = {k: v.detach().clone() for k, v in first["state"].model.state_dict().items()
                     if k.startswith("ar_")}
        first_numbers = _cli_numbers(first)
        del first["state"]
        torch.cuda.empty_cache()
        switch_from = CheckpointManager(exp / "checkpoints").latest()
        # the resume check restores stage 2's first step checkpoint
        watch["keep_step"] = (n1 // 4 + 1) * 4
        watch["profile"] = n1 + 1
        t0 = time.perf_counter()
        second = train_cli.main(argv + ["--train-stage", "2", "--num-epochs", "2",
                                        "--visualize", str(HAVE_MATPLOTLIB).lower()])
        stage2_s = time.perf_counter() - t0
        counts = read_launches()
    finally:
        restore2()
        restore3()
        restore_copy()
        train_cli.make_train_step, train_cli.run_validation = make_step, run_validation
        train_cli.scan_batch_shapes_for_oom = scan
        train_cli.CheckpointManager = CheckpointManager
    n2 = second["state"].step
    second_numbers = _cli_numbers(second)
    per_step = [{k: r[k] for k in ("step", "epoch", "shape", "step_s", "data_s", "copy_s")}
                for r in first["steps"] + second["steps"]]
    # the profiled step carries the profiler's overhead: it is left out below
    stage2_steps = [r for r in second["steps"] if r["step"] != watch["profile"] + 1]
    assert first_numbers["loader_path"] == second_numbers["loader_path"] == "native", \
        "the VALL-E run did not take the native loader path"
    losses = first_numbers["losses"] + second_numbers["losses"]
    assert all(np.isfinite(losses)), losses
    for rec in steps:
        want = 12 * rec["micro_batches"]
        assert rec["launches"] == {"ragged_decode": 0, "prefix_attention": want,
                                   "prefix_attention_bwd": want, "flash_attention": 0,
                                   "flash_attention_bwd": 0}, rec
    for rec in validations:
        assert rec["launches"]["prefix_attention"] == 12 * rec["batches"], rec
        assert sum(rec["launches"].values()) == rec["launches"]["prefix_attention"], rec
    assert switch_from == "epoch-1" and second_numbers["resumed_from"] == "epoch-1"
    final = second["state"].model.state_dict()
    ar_equal = all(torch.equal(final[k], v) for k, v in stage1_ar.items())
    assert ar_equal, "the stage switch changed an ar_* weight"
    nar_trained = {id(p) for g in second["state"].optimizer.param_groups for p in g["params"]}
    assert all(n.startswith("nar_") for n, p in second["state"].model.named_parameters()
               if id(p) in nar_trained)
    keep_step = watch["keep_step"]
    assert saves_kept.get("name") == f"checkpoint-{keep_step}" and n2 > keep_step, \
        (saves_kept, n2, keep_step)
    want_loss, want_weights = watch["snapshot"]
    del second, stage1_ar, final
    torch.cuda.empty_cache()
    # --visualize on stage 2: min(4, B) PNGs of the first dev batch per validation
    eval_dirs = sorted(os.listdir(exp / "eval")) if (exp / "eval").exists() else []
    pngs = {d: len(os.listdir(exp / "eval" / d)) for d in eval_dirs}
    if HAVE_MATPLOTLIB:
        want_png = min(4, validations[-1]["first_batch_rows"])
        assert "epoch-2" in pngs and set(pngs.values()) == {want_png}, (pngs, want_png)
    else:
        assert not pngs, pngs

    k2_cases = check_kernel2_captures(captured2, "train CLI")
    k3_cases = check_kernel3_captures(captured3, "train CLI")
    del captured2, captured3
    copies = copy_ms(kept["arrays"], dev)

    # resume on the card: restore the kept mid-epoch checkpoint and take the
    # next step, then time hand-fed steps on that batch
    resume = {}
    (root / "resume").mkdir()
    shutil.move(str(root / "kept"), str(root / "resume" / "checkpoints"))

    def resumed_make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            state, metrics = step(state, batch, rng, epoch)
            got = state.model.state_dict()
            resume.update(step=state.step, loss=float(metrics["loss"]), want_loss=want_loss,
                          weights_bit_equal=all(torch.equal(got[k], v)
                                                for k, v in want_weights.items()))
            times = []
            for n in range(HAND_FED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, batch, torch.Generator().manual_seed(n), epoch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            resume["hand_fed_step_s"] = times
            resume["shape_ABST"] = list(batch["text_tokens"].shape) + [
                batch["audio_features"].shape[2]]
            raise _StopRun

        return run

    train_cli.make_train_step = resumed_make_train_step
    try:
        train_cli.main(["--manifest-dir", str(corpus), "--exp-dir", str(root / "resume"),
                        *CLI_FLAGS, "--train-stage", "2", "--num-epochs", "2",
                        "--oom-check", "false"])
    except _StopRun:
        pass
    finally:
        train_cli.make_train_step = make_step
    del want_weights
    torch.cuda.empty_cache()
    assert resume["step"] == keep_step + 1, resume
    assert resume["loss"] == resume["want_loss"] and resume["weights_bit_equal"], \
        f"the step resumed from checkpoint-{keep_step} differs: {resume}"

    # train -> infer: the final averaged weights through the infer CLI,
    # sampling (its default): a model fit to random codes rates EOS (one per
    # utterance) above any one code, so greedy decoding may stop at once
    out_dir = root / "infer"
    before = read_launches()
    t0 = time.perf_counter()
    infer_cli.main(["--checkpoint", str(exp / "checkpoints" / "epoch-2.pt"),
                    "--use-averaged-model", "true", "--codec-checkpoint", str(files["codec.npz"]),
                    "--text-tokens", str(files["tokens.k2symbols"]), "--text-extractor",
                    "chars", "--attn-impl", "flash", "--seed", str(SEED), "--max-new-tokens", "150",
                    "--text-prompts", INFER_PROMPT_TEXT, "--audio-prompts",
                    str(files["prompt.wav"]), "--text", INFER_TEXTS[0],
                    "--output-dir", str(out_dir)])
    infer_s = time.perf_counter() - t0
    infer_launches = _delta(read_launches(), before)
    from valle_tpu_torch.data import read_wav

    wav, sr = read_wav(str(out_dir / "0.wav"))
    assert wav.size > 0 and np.isfinite(wav).all(), "the trained model's wav is not finite"

    shutil.rmtree(exp)
    emit({"phase": "train_cli", "model": "VALL-E default ModelConfig (367.4 M parameters), "
          "f32, through valle_tpu_torch.bin.train.main", "flags": CLI_FLAGS,
          "corpus": {"train": CLI_UTTS, "dev": CLI_DEV_UTTS, "seconds": CLI_DUR,
                     "text_symbols": [40, 100]},
          "stage1": first_numbers, "stage2": second_numbers,
          "stage_seconds": [stage1_s, stage2_s], "steps": [n1, n2 - n1],
          "launches_per_step": steps, "validation_launches": validations,
          "oom_scan_launches": scans, "profiled_stage2_step": watch.get("breakdown"),
          "hand_fed_step_s_phase9": hand_fed_step_s,
          "hand_fed_step_s_median": float(np.median(resume["hand_fed_step_s"])),
          "hand_fed_shape_ABST": resume["shape_ABST"],
          "cli_steps": per_step, "profiled_step": watch["profile"] + 1,
          "cli_at_hand_fed_shape": {key: float(np.median(
              [sum(r[k] for k in parts) for r in stage2_steps
               if r["shape"] == resume["shape_ABST"]])) for key, parts in (
              ("loop_s_median", ("data_s", "copy_s", "step_s")), ("step_s_median", ("step_s",)))},
          "switch_from": switch_from, "ar_weights_bit_equal_across_switch": ar_equal,
          "visualize": {"matplotlib": HAVE_MATPLOTLIB, "pngs_by_tag": pngs},
          "resume": {k: v for k, v in resume.items() if k != "hand_fed_step_s"},
          "kernel2_captures": k2_cases, "kernel3_captures": k3_cases, "batch_copy_ms": copies,
          "infer": {"seconds": infer_s, "launches": infer_launches, "wav_samples": int(wav.size),
                    "sample_rate": sr}})
    tts = tts_train_cli_path(dev, files, root)
    shutil.rmtree(root)
    return {"train_cli": counts, "tts_train_cli": tts}


def copy_ms(arrays: dict, dev, n: int = 10) -> dict:
    """Host ms to put one CLI batch on the card and have it there (the call,
    then a sync), first call and median of the next ``n - 1``, three ways:
    the CLI's ``to_device`` (page-locked buffers kept per shape), a fresh
    ``pin_memory()`` per array and call, and a plain ``.to(dev)`` from
    pageable memory."""
    import torch

    from valle_tpu_torch.bin import train as train_cli

    ways = {
        "staged_pinned": lambda: train_cli.to_device(arrays, dev),
        "pin_per_call": lambda: {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            dev, non_blocking=True) for k, v in arrays.items()},
        "pageable": lambda: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                             for k, v in arrays.items()},
    }
    out = {"bytes": int(sum(np.asarray(v).nbytes for v in arrays.values()))}
    for name, fn in ways.items():
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"first_ms": times[0], "median_ms": float(np.median(times[1:]))}
    return out


def first_to_device_arrays(train_cli, kept: dict):
    """Wrap ``train_cli.to_device`` so that ``kept["arrays"]`` holds the
    first batch it is given (numpy); returns the restore."""
    fn = train_cli.to_device

    def wrapper(arrays, dev):
        kept.setdefault("arrays", {k: np.array(v) for k, v in arrays.items()})
        return fn(arrays, dev)

    train_cli.to_device = wrapper
    return lambda: setattr(train_cli, "to_device", fn)


def tts_train_cli_path(dev, files, root) -> dict:
    """The full-width TTS baseline through the training CLI: 2 steps on a
    float-mel manifest with SpecAugment, kernels 2, 3 and 4 forward and
    backward on each step; the first launch of each kernel at each shape of
    the training steps (past the OOM scan) is held against its plain version
    with a bit-equal rerun."""
    import torch

    from valle_tpu_torch.bin import train as train_cli

    corpus = write_cli_corpus(root / "mels", files["tokens.k2symbols"],
                              splits=(("train", TTS_CLI_UTTS),), dur=TTS_CLI_DUR, fmt="vsf",
                              frame_rate=24000 / 256, dim=100, seed=SEED + 12)
    steps = []
    training = {"on": False}  # past the OOM scan: the launches the captures keep
    make_step = train_cli.make_train_step

    def counted(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            before = read_launches()
            training["on"] = True
            state, metrics = step(state, batch, rng, epoch)
            training["on"] = False
            steps.append(_delta(read_launches(), before))
            return state, metrics

        return run

    on = lambda: training["on"]  # noqa: E731
    kept: dict = {}
    train_cli.make_train_step = counted
    captured2, restore2 = capture_kernel2(on)
    captured3, restore3 = capture_kernel3(on)
    fwd4, bwd4, restore4 = capture_kernel4(on)
    restore_copy = first_to_device_arrays(train_cli, kept)
    try:
        reset_launches()
        out = train_cli.main(["--manifest-dir", str(corpus), "--exp-dir", str(root / "tts_exp"),
                              "--model-name", "Transformer", "--attn-impl", "flash",
                              "--dropout", "0", "--enable-spec-aug", "true", "--num-epochs", "1",
                              "--max-duration", "40", "--num-buckets", "1", "--batch-quant", "1",
                              "--valid-interval", "1000", "--save-every-n", "0",
                              "--log-interval", "1", "--tensorboard", "false",
                              "--seed", str(SEED)])
        counts = read_launches()
    finally:
        restore2()
        restore3()
        restore4()
        restore_copy()
        train_cli.make_train_step = make_step
    numbers = _cli_numbers(out)
    del out
    torch.cuda.empty_cache()
    assert numbers["steps"] == 2 and all(np.isfinite(numbers["losses"])), numbers
    want = {"ragged_decode": 0, "prefix_attention": 24, "prefix_attention_bwd": 24,
            "flash_attention": 12, "flash_attention_bwd": 12}
    assert all(s == want for s in steps), f"launches per step {steps}, expected {want}"
    k2_cases = check_kernel2_captures(captured2, "TTS train CLI")
    k3_cases = check_kernel3_captures(captured3, "TTS train CLI")
    k4_cases = check_kernel4_captures(fwd4, bwd4, "TTS train CLI")
    assert k2_cases and k3_cases and {c["pass"] for c in k4_cases} == {"forward", "backward"}, \
        "a kernel of the TTS train CLI's steps was not captured"
    del captured2, captured3, fwd4, bwd4
    torch.cuda.empty_cache()
    copies = copy_ms(kept["arrays"], dev)
    emit({"phase": "tts_train_cli", "model": "Transformer TTS default widths (353.7 M "
          "parameters), f32, attn_impl flash, attention dropout 0, SpecAugment",
          "corpus": {"train": TTS_CLI_UTTS, "seconds": TTS_CLI_DUR, "mel_bins": 100},
          **numbers, "launches_per_step": steps, "kernel2_captures": k2_cases,
          "kernel3_captures": k3_cases, "kernel4_captures": k4_cases,
          "batch_copy_ms": copies})
    return counts


# --------------------------------------------------- phases 16, 17 and 18

TOK_UTTS, TOK_DEV_UTTS, TOK_DUR, TOK_BATCH = 64, 8, (4.0, 6.0), 16
TOK_FBANK_UTTS, TOK_FBANK_DUR = 8, (8.0, 10.0)
# a code of the card's encode may differ from the CPU copy's only where the
# CPU's RVQ search had its two smallest distances within this share of the
# residual's squared norm (the distances are r^2 - 2 r.e + e^2 in f32, and
# the latents of two convolution and LSTM stacks differ in their last bits)
CODE_TIE_RTOL = 1e-3
BF16_CLI_FLAGS = ["--dtype", "bfloat16", "--remat", "dots_nobatch", "--attn-impl", "fused",
                  "--dropout", "0.1", "--optimizer-name", "ScaledAdam", "--scheduler-name",
                  "Eden", "--average-period", "2", "--valid-interval", "1000",
                  "--save-every-n", "0", "--max-duration", "20", "--num-buckets", "2",
                  "--accumulate-grad-steps", "2", "--batch-quant", "1", "--log-interval", "1",
                  "--tensorboard", "false", "--seed", str(SEED)]
REMAT_STEPS = 5


def _write_wav_tsv(root, name: str, n: int, dur, seed: int) -> Path:
    """``n`` seeded wavs of ``dur`` seconds, half at 16 kHz (so that the CLI
    resamples them) and half at 24 kHz: a vibrato tone with an envelope and
    noise; and their TSV (utt_id, wav path, a text of the symbol table's
    words).  Ids are LibriTTS-like (speaker_book_utt_seg)."""
    from valle_tpu_torch.data import write_wav

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        sr = (16000, 24000)[i % 2]
        t = np.arange(int(rng.uniform(*dur) * sr)) / sr
        f0 = rng.uniform(90, 250)
        phase = 2 * np.pi * f0 * t + 3.0 * np.sin(2 * np.pi * 5.0 * t)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t) ** 2
        wav = 0.3 * env * (np.sin(phase) + 0.3 * np.sin(3 * phase)) + 0.02 * rng.randn(t.size)
        path = root / f"{name}_{i:03d}.wav"
        write_wav(str(path), wav.astype(np.float32), sr)
        rows.append(f"{i % 4}_{100 + i % 4}_{i:06d}_000000\t{path}\t"
                    f"{_text_of(rng, rng.randint(40, 101))}")
    tsv = root / f"{name}.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return tsv


def rvq_flips(codebooks, latents, codes):
    """The CPU's RVQ search on its ``latents`` beside the card's ``codes``:
    at the first quantizer where a frame's card code differs, the gap
    between the CPU's two smallest distances there over |r|^2 of that
    frame's residual.  Returns one record per differing frame."""
    import torch

    residual = latents.transpose(1, 2).double()
    cb_all = codebooks.double()
    done = torch.zeros(codes.shape[:2], dtype=torch.bool)
    flips = []
    for q in range(codes.shape[-1]):
        cb = cb_all[q]
        r2 = (residual**2).sum(-1, keepdim=True)
        d2 = r2 - 2 * residual @ cb.t() + (cb**2).sum(-1)[None, None, :]
        idx = torch.argmin(d2, dim=-1)
        new = (codes[..., q] != idx) & ~done
        if new.any():
            top2 = d2.topk(2, dim=-1, largest=False).values
            for b, t in new.nonzero().tolist():
                flips.append({"b": b, "t": t, "q": q,
                              "gap_rel": float((top2[b, t, 1] - top2[b, t, 0]) / r2[b, t, 0])})
        done |= new
        residual = residual - cb[codes[..., q].long()]  # follow the card's path
    return flips


def tokenize_cli_path(dev, files, root) -> dict:
    """The port's tokenize CLI on the card: 64 + 8 seeded wavs of 4-6 s
    (half at 16 kHz) through the full-width random EnCodec in batches of 16,
    then 8 wavs of 8-10 s in Fbank mode, and the stats CLI; one batch's
    codes against a CPU copy of the codec, with the RVQ top-two gap of every
    frame whose code differs.  Returns the launch counts (no attention
    kernel runs) and the two corpus directories."""
    import contextlib
    import io

    import torch

    from valle_tpu_torch.bin import stats as stats_cli
    from valle_tpu_torch.bin import tokenize_dataset as tok_cli
    from valle_tpu_torch.codec import load_codec
    from valle_tpu_torch.codec.encodec_model import encode_latents, full_f32
    from valle_tpu_torch.data import convert_audio, read_wav

    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    tsvs = {"train": _write_wav_tsv(wavs, "train", TOK_UTTS, TOK_DUR, SEED + 21),
            "dev": _write_wav_tsv(wavs, "dev", TOK_DEV_UTTS, TOK_DUR, SEED + 22),
            "fbank": _write_wav_tsv(wavs, "fbank", TOK_FBANK_UTTS, TOK_FBANK_DUR, SEED + 23)}
    codes_dir, mels_dir = root / "codes", root / "mels"
    reset_launches()
    runs = {}
    for split in ("train", "dev"):
        t0 = time.perf_counter()
        out = tok_cli.main(["--tsv", str(tsvs[split]), "--output-dir", str(codes_dir),
                            "--split", split, "--codec-checkpoint", str(files["codec.npz"]),
                            "--text-extractor", "chars", "--batch-frames", str(TOK_BATCH)])
        runs[split] = out | {"cli_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fbank = tok_cli.main(["--tsv", str(tsvs["fbank"]), "--output-dir", str(mels_dir),
                          "--split", "train", "--audio-extractor", "Fbank",
                          "--text-extractor", "chars"])
    fbank["cli_s"] = time.perf_counter() - t0
    counts = read_launches()
    stats_out = {}
    for name, d in (("codes", codes_dir), ("mels", mels_dir)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats_cli.main(["--manifest-dir", str(d)])
        stats_out[name] = buf.getvalue()
    assert "Cuts count: 64" in stats_out["codes"] and "Cuts count: 8" in stats_out["mels"]

    # the first training batch again, on the card and on a CPU copy
    rows = [line.split("\t") for line in tsvs["train"].read_text().splitlines()[:TOK_BATCH]]
    batch_wavs = []
    for _, path, _ in rows:
        wav, sr = read_wav(path)
        batch_wavs.append(convert_audio(wav, sr, 24000, 1)[0])
    batch = np.zeros((len(rows), 1, max(w.shape[-1] for w in batch_wavs)), np.float32)
    for k, w in enumerate(batch_wavs):
        batch[k, 0, : w.shape[-1]] = w
    card = load_codec(files["codec.npz"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes_card = card.encode(batch)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    with torch.inference_mode(), full_f32():
        lat_card = encode_latents(card.params, torch.from_numpy(batch).to(dev), card.cfg).cpu()
    codes_card = codes_card.cpu()
    del card
    torch.cuda.empty_cache()
    cpu = load_codec(files["codec.npz"], device="cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        lat_cpu = encode_latents(cpu.params, torch.from_numpy(batch), cpu.cfg)
    cpu_s = time.perf_counter() - t0
    codes_cpu = cpu.encode(batch)
    # frames past each wav's end are cut by the CLI: compare the kept ones
    keep = torch.zeros(codes_card.shape[:2], dtype=torch.bool)
    for k, w in enumerate(batch_wavs):
        keep[k, : int(np.ceil(w.shape[-1] / 320))] = True
    equal = (codes_card == codes_cpu).all(-1)
    share = float(equal[keep].float().mean())
    flips = [f for f in rvq_flips(cpu.params["quantizer"], lat_cpu, codes_card)
             if keep[f["b"], f["t"]]]
    lat_err = float((lat_card - lat_cpu).abs().max() / lat_cpu.abs().max())
    audio_s = runs["train"]["audio_seconds"]
    emit({"phase": "tokenize_cli", "codec": "EnCodec 24 kHz default widths, seeded random "
          "weights (.npz), f32 without TF32", "batch_frames": TOK_BATCH,
          "wavs": {"train": TOK_UTTS, "dev": TOK_DEV_UTTS, "seconds": TOK_DUR,
                   "sample_rates": [16000, 24000]},
          "encodec": {split: r for split, r in runs.items()},
          "audio_s_per_s_encode": audio_s / runs["train"]["encode_seconds"],
          "audio_s_per_s_cli": audio_s / runs["train"]["cli_s"],
          "fbank": fbank | {"wavs": TOK_FBANK_UTTS, "seconds": TOK_FBANK_DUR},
          "batch_encode_s": batch_s, "batch_audio_s": float(sum(w.shape[-1] for w in batch_wavs)
                                                             / 24000),
          "cpu_encoder_s": cpu_s, "latents_max_rel_err": lat_err,
          "batch_frames_equal_share": share, "code_match": CODE_MATCH,
          "frames_differing": len(flips), "flips": flips[:20], "code_tie_rtol": CODE_TIE_RTOL,
          "stats": stats_out, "launches": counts})
    assert share >= CODE_MATCH, f"only {share} of one batch's frames equal the CPU copy's"
    off = [f for f in flips if f["gap_rel"] > CODE_TIE_RTOL]
    assert not off, f"codes differ from the CPU copy's without a near-tie: {off}"
    return counts, codes_dir, mels_dir


def _f32_state(state) -> dict:
    """The dtypes of every parameter, optimizer state tensor and averaged
    weight of a training state."""
    import torch

    opt = {v.dtype for s in state.optimizer.state.values() for v in s.values()
           if isinstance(v, torch.Tensor) and v.is_floating_point()}
    return {"params": sorted({str(p.dtype) for p in state.model.parameters()}),
            "optimizer": sorted(str(d) for d in opt),
            "model_avg": sorted({str(v.dtype) for v in (state.model_avg or {}).values()})}


def train_cli_bf16_path(dev, files, codes_dir, mels_dir) -> dict:
    """The port's training CLI in bf16 with remat on the tokenize CLI's
    corpora: the full-width VALL-E through stage 1 (1 epoch, with the OOM
    scan) and stage 2 (1 more epoch) under ``--dtype bfloat16 --remat
    dots_nobatch``, then the final averaged weights through the infer CLI
    in bf16 to a wav; the TTS baseline on the Fbank corpus under ``--remat
    full`` for 2 steps.  Checks the launches per step, the captured kernel
    launches against their plain versions, f32 parameters and optimizer
    state, finite losses, and one micro-batch's bf16 loss and gradients
    against a bf16 CPU copy."""
    import torch

    from valle_tpu_torch.bin import infer as infer_cli
    from valle_tpu_torch.bin import train as train_cli
    from valle_tpu_torch.data import read_wav
    from valle_tpu_torch.train.state import partition_params

    exp = codes_dir.parent / "exp_bf16"
    steps = []
    training = {"on": False}
    make_step = train_cli.make_train_step

    def counted(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            if "micro" not in kept:  # the first training batch's first micro-batch
                kept["micro"] = {k: batch[k][:1, :CHECK_ROWS].clone() for k in (
                    "text_tokens", "text_tokens_lens", "audio_features", "audio_features_lens")}
            before = read_launches()
            training["on"] = True
            state, metrics = step(state, batch, rng, epoch)
            training["on"] = False
            steps.append({"stage": kw["train_stage"], "micro_batches":
                          batch["text_tokens"].shape[0],
                          "launches": _delta(read_launches(), before)})
            return state, metrics

        return run

    on = lambda: training["on"]  # noqa: E731
    kept: dict = {}
    train_cli.make_train_step = counted
    captured2, restore2 = capture_kernel2(on)
    captured3, restore3 = capture_kernel3(on)
    argv = ["--manifest-dir", str(codes_dir), "--exp-dir", str(exp), *BF16_CLI_FLAGS]
    try:
        reset_launches()
        t0 = time.perf_counter()
        first = train_cli.main(argv + ["--train-stage", "1", "--num-epochs", "1",
                                       "--oom-check", "true"])
        stage1_s = time.perf_counter() - t0
        first_numbers, first_dtypes = _cli_numbers(first), _f32_state(first["state"])
        del first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        second = train_cli.main(argv + ["--train-stage", "2", "--num-epochs", "2",
                                        "--oom-check", "false"])
        stage2_s = time.perf_counter() - t0
        counts = read_launches()
    finally:
        restore2()
        restore3()
        train_cli.make_train_step = make_step
    second_numbers, second_dtypes = _cli_numbers(second), _f32_state(second["state"])
    losses = first_numbers["losses"] + second_numbers["losses"]
    assert all(np.isfinite(losses)), losses
    for d in (first_dtypes, second_dtypes):
        assert d == {"params": ["torch.float32"], "optimizer": ["torch.float32"],
                     "model_avg": ["torch.float32"]}, d
    for rec in steps:  # remat: kernel 2 in the forward and again in the recompute
        want = 12 * rec["micro_batches"]
        assert rec["launches"] == {"ragged_decode": 0, "prefix_attention": 2 * want,
                                   "prefix_attention_bwd": want, "flash_attention": 0,
                                   "flash_attention_bwd": 0}, rec
    saved = torch.load(exp / "checkpoints" / "epoch-2.pt", map_location="cpu",
                       weights_only=False)
    ckpt_dtypes = sorted({str(v.dtype) for part in ("model", "model_avg")
                          for v in saved[part].values() if v.is_floating_point()})
    assert ckpt_dtypes == ["torch.float32"], ckpt_dtypes
    del saved
    k2_cases = check_kernel2_captures(captured2, "bf16 train CLI")
    k3_cases = check_kernel3_captures(captured3, "bf16 train CLI")
    assert {c["dtype"] for c in k2_cases + k3_cases} == {"bfloat16"}
    assert any(c["mode"].startswith("prefix") for c in k2_cases), "no prefix-mode launch"
    del captured2, captured3

    # the first training batch's first micro-batch (CHECK_ROWS rows) at
    # dropout 0 in bf16 against a bf16 CPU copy, at the trained weights, with
    # every parameter taking a gradient as in a fresh model
    model = second["state"].model
    for p in partition_params(model, 0)[0].values():
        p.requires_grad_(True)
    micro = kept["micro"]
    del second
    torch.cuda.empty_cache()
    check = gradient_check(model, micro, "after the bf16 CLI's two stages",
                           phase="train_bf16_gradient_check", tols=BF16_CHECK,
                           nar_stage=model.cfg.num_quantizers // 2)
    del model
    torch.cuda.empty_cache()

    out_dir = exp.parent / "infer_bf16"
    t0 = time.perf_counter()
    infer_cli.main(["--checkpoint", str(exp / "checkpoints" / "epoch-2.pt"),
                    "--use-averaged-model", "true", "--dtype", "bfloat16",
                    "--codec-checkpoint", str(files["codec.npz"]),
                    "--text-tokens", str(codes_dir / "unique_text_tokens.k2symbols"),
                    "--text-extractor", "chars", "--attn-impl", "flash", "--seed", str(SEED),
                    "--max-new-tokens", "150", "--text-prompts", "the voice reads a line",
                    "--audio-prompts", str(files["prompt.wav"]), "--text",
                    "every request waits its turn", "--output-dir", str(out_dir)])
    infer_s = time.perf_counter() - t0
    wav, sr = read_wav(str(out_dir / "0.wav"))
    assert wav.size > 0 and np.isfinite(wav).all(), "the bf16-trained model's wav is not finite"
    emit({"phase": "train_cli_bf16", "model": "VALL-E default ModelConfig (367.4 M "
          "parameters), bf16 compute over f32 parameters, remat dots_nobatch, through "
          "valle_tpu_torch.bin.train.main on the tokenize CLI's corpus",
          "flags": BF16_CLI_FLAGS, "stage1": first_numbers, "stage2": second_numbers,
          "stage_seconds": [stage1_s, stage2_s], "launches_per_step": steps,
          "state_dtypes": [first_dtypes, second_dtypes], "checkpoint_dtypes": ckpt_dtypes,
          "kernel2_captures": k2_cases, "kernel3_captures": k3_cases,
          "gradient_check_rows": CHECK_ROWS, "gradient_check": {
              k: check[k] for k in ("dropout0_loss_rel_err", "flipped_gates",
                                    "max_grad_rel_err", "max_grad_norm_rel_err",
                                    "median_grad_rel_err", "seconds")},
          "infer": {"seconds": infer_s, "wav_samples": int(wav.size), "sample_rate": sr}})
    tts = tts_train_cli_bf16_path(dev, mels_dir)
    return {"train_cli_bf16": counts, "tts_train_cli_bf16": tts}


def tts_train_cli_bf16_path(dev, mels_dir) -> dict:
    """The full-width TTS baseline through the training CLI on the tokenize
    CLI's Fbank corpus, ``--dtype bfloat16 --remat full``, 2 steps; kernels
    2, 3 and 4 (forward and backward) captured past the OOM scan and held
    against their plain versions."""
    import torch

    from valle_tpu_torch.bin import train as train_cli

    steps = []
    training = {"on": False}
    make_step = train_cli.make_train_step

    def counted(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            before = read_launches()
            training["on"] = True
            state, metrics = step(state, batch, rng, epoch)
            training["on"] = False
            steps.append(_delta(read_launches(), before))
            return state, metrics

        return run

    on = lambda: training["on"]  # noqa: E731
    train_cli.make_train_step = counted
    captured2, restore2 = capture_kernel2(on)
    captured3, restore3 = capture_kernel3(on)
    fwd4, bwd4, restore4 = capture_kernel4(on)
    try:
        reset_launches()
        out = train_cli.main(["--manifest-dir", str(mels_dir), "--exp-dir",
                              str(mels_dir.parent / "tts_exp_bf16"), "--model-name",
                              "Transformer", "--dtype", "bfloat16", "--remat", "full",
                              "--attn-impl", "flash", "--dropout", "0", "--num-epochs", "1",
                              "--max-duration", "40", "--num-buckets", "1", "--batch-quant", "1",
                              "--valid-interval", "1000", "--save-every-n", "0",
                              "--log-interval", "1", "--tensorboard", "false",
                              "--seed", str(SEED)])
        counts = read_launches()
    finally:
        restore2()
        restore3()
        restore4()
        train_cli.make_train_step = make_step
    numbers, dtypes = _cli_numbers(out), _f32_state(out["state"])
    del out
    torch.cuda.empty_cache()
    assert numbers["steps"] == 2 and all(np.isfinite(numbers["losses"])), numbers
    assert dtypes["params"] == dtypes["optimizer"] == ["torch.float32"], dtypes
    want = {"ragged_decode": 0, "prefix_attention": 48, "prefix_attention_bwd": 24,
            "flash_attention": 24, "flash_attention_bwd": 12}
    assert all(s == want for s in steps), f"launches per step {steps}, expected {want}"
    k2_cases = check_kernel2_captures(captured2, "bf16 TTS train CLI")
    k3_cases = check_kernel3_captures(captured3, "bf16 TTS train CLI")
    k4_cases = check_kernel4_captures(fwd4, bwd4, "bf16 TTS train CLI")
    assert k2_cases and k3_cases and {c["pass"] for c in k4_cases} == {"forward", "backward"}, \
        "a kernel of the bf16 TTS train CLI's steps was not captured"
    assert {c["dtype"] for c in k2_cases + k3_cases + k4_cases} == {"bfloat16"}
    emit({"phase": "tts_train_cli_bf16", "model": "Transformer TTS default widths (353.7 M "
          "parameters), bf16 over f32 parameters, remat full, attn_impl flash, attention "
          "dropout 0, on the tokenize CLI's Fbank corpus",
          "corpus": {"train": TOK_FBANK_UTTS, "seconds": TOK_FBANK_DUR}, **numbers,
          "state_dtypes": dtypes, "launches_per_step": steps, "kernel2_captures": k2_cases,
          "kernel3_captures": k3_cases, "kernel4_captures": k4_cases})
    return counts


def remat_ab_path(dev) -> dict:
    """One full-width VALL-E training step at phase 9's shape and batch
    (dropout 0.1, one fixed step generator) in f32 without remat and in bf16
    under each remat policy: the accumulation group's loss, gradients and
    generator state against bf16 without remat, the peak memory, kernel 2 / 3
    launches, and the seconds of the whole step (median of REMAT_STEPS)."""
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.nn import layers
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import (accumulate_gradients, init_train_state,
                                            make_train_step)

    batch = _train_batch(ModelConfig(), np.random.RandomState(SEED + 5), dev)
    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    policy = layers.dots_nobatch_policy
    runs, base = {}, None
    for dtype, remat in (("float32", "none"), ("bfloat16", "none"), ("bfloat16", "full"),
                         ("bfloat16", "dots_nobatch")):
        cfg = ModelConfig(attn_impl="fused", dtype=dtype, remat=remat, num_layers=CUT_LAYERS)
        torch.manual_seed(SEED)
        model = get_model(cfg, training=True)
        state = init_train_state(model, make_opt, train_stage=0)
        saved_ops: dict = {}

        def observed(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision.name == "MUST_SAVE":
                saved_ops[str(op)] = saved_ops.get(str(op), 0) + 1
            return decision

        layers.dots_nobatch_policy = observed
        try:
            gen = torch.Generator().manual_seed(SEED + 7)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            metrics = accumulate_gradients(model, batch, 0, gen)
            torch.cuda.synchronize()
            launches = read_launches()
            grad_peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            layers.dots_nobatch_policy = policy
        run = {"dtype": dtype, "remat": remat, "loss": float(metrics["loss"]),
               "launches": launches, "accumulation_peak_gib": grad_peak,
               "policy_saved_ops": saved_ops}
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        if (dtype, remat) == ("bfloat16", "none"):
            base = (metrics["loss"], grads, gen.get_state())
        elif dtype == "bfloat16":
            run["loss_max_abs_diff"] = float((metrics["loss"] - base[0]).abs())
            run["grad_max_abs_diff"] = max(float((g - base[1][n]).abs().max())
                                           for n, g in grads.items())
            run["generator_state_equal"] = bool(torch.equal(gen.get_state(), base[2]))
            del grads
        state.optimizer.zero_grad(set_to_none=True)
        step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
        step(state, batch, torch.Generator().manual_seed(SEED), 0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for n in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, torch.Generator().manual_seed(SEED + n), 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        run |= {"step_s": times, "step_s_median": float(np.median(times)),
                "step_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        runs[f"{dtype} {remat}"] = run
        del state, model, step
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    per_group = TRAIN_A * 2 * CUT_LAYERS
    for name, run in runs.items():
        twice = run["remat"] != "none"
        assert run["launches"]["prefix_attention"] == per_group * (2 if twice else 1), run
        assert run["launches"]["prefix_attention_bwd"] == per_group, run
        if twice:
            assert run["loss_max_abs_diff"] == 0.0 and run["grad_max_abs_diff"] == 0.0, run
            assert run["generator_state_equal"], run
            assert (run["accumulation_peak_gib"]
                    < runs["bfloat16 none"]["accumulation_peak_gib"]), run
    assert runs["bfloat16 dots_nobatch"]["policy_saved_ops"], "the policy saved nothing"
    f32, bf16 = runs["float32 none"]["step_s_median"], runs["bfloat16 none"]["step_s_median"]
    emit({"phase": "remat_ab", "model": f"VALL-E ModelConfig(num_layers={CUT_LAYERS}) (d=1024, "
          f"16 heads, {CUT_LAYERS}+{CUT_LAYERS} layers), attn_impl fused, dropout 0.1, "
          "train_stage 0, phase 9's batch", "accumulation": TRAIN_A, "batch": TRAIN_B,
          "text_tokens": TRAIN_S, "frames": TRAIN_T, "runs": runs,
          "bf16_over_f32_step_speedup": f32 / bf16,
          "frames_per_s": {k: TRAIN_A * TRAIN_B * TRAIN_T / r["step_s_median"]
                           for k, r in runs.items()}})
    return {f"remat_ab_{name.replace(' ', '_')}": run["launches"] for name, run in runs.items()}


# ------------------------------------------- phases 19-21 (paths p, q and r)


def tts_scaling_cli_path(dev, mels_dir) -> dict:
    """``--model-name Transformer --scaling-xformers true`` through the
    training CLI on the tokenize CLI's Fbank corpus, f32, 2 steps: the flag's
    route from the command line, with kernels 2, 3 and 4 forward and
    backward on each step."""
    import torch

    from valle_tpu_torch.bin import train as train_cli

    steps = []
    make_step = train_cli.make_train_step

    def counted(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            before = read_launches()
            state, metrics = step(state, batch, rng, epoch)
            steps.append(_delta(read_launches(), before))
            return state, metrics

        return run

    train_cli.make_train_step = counted
    try:
        reset_launches()
        out = train_cli.main(["--manifest-dir", str(mels_dir), "--exp-dir",
                              str(mels_dir.parent / "tts_exp_scaling"), "--model-name",
                              "Transformer", "--scaling-xformers", "true", "--attn-impl", "flash",
                              "--dropout", "0", "--num-epochs", "1", "--max-duration", "40",
                              "--num-buckets", "1", "--batch-quant", "1", "--valid-interval",
                              "1000", "--save-every-n", "0", "--log-interval", "1",
                              "--tensorboard", "false", "--seed", str(SEED)])
        counts = read_launches()
    finally:
        train_cli.make_train_step = make_step
    model = out["state"].model
    assert model.cfg.scaling_xformers and hasattr(model, "decoder_prenet_fc")
    assert model.encoder.layers[0].activation == "balanced_double_swish"
    numbers = _cli_numbers(out)
    del out, model
    torch.cuda.empty_cache()
    assert numbers["steps"] == 2 and all(np.isfinite(numbers["losses"])), numbers
    want = {"ragged_decode": 0, "prefix_attention": 24, "prefix_attention_bwd": 24,
            "flash_attention": 12, "flash_attention_bwd": 12}
    assert all(s == want for s in steps), f"launches per step {steps}, expected {want}"
    emit({"phase": "tts_scaling_train_cli", "flags": "--model-name Transformer "
          "--scaling-xformers true --attn-impl flash --dropout 0", "model": "Transformer TTS "
          "default widths, scaling_xformers, f32, on the tokenize CLI's Fbank corpus",
          **numbers, "launches_per_step": steps})
    return counts


VIS_ATOL = 1e-3  # hidden states of order 1 (the final balanced basic / layer norm)


def visualize_path(dev):
    """``VALLE.visualize_forward`` of the full-width VALL-E under "flash" on
    one batch on the card (its merged dense bias through kernel 4), held
    against a CPU copy."""
    import torch

    from valle_tpu_torch.models import ModelConfig, get_model

    cfg = ModelConfig(attn_impl="flash")
    torch.manual_seed(SEED)
    model = get_model(cfg)
    batch = _train_batch(cfg, np.random.RandomState(SEED + 13), dev)
    args = [batch[k][0] for k in ("text_tokens", "text_tokens_lens", "audio_features",
                                  "audio_features_lens")]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    enc, dec = model.visualize_forward(*args)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_launches()
    want = {"ragged_decode": 0, "prefix_attention": 0, "prefix_attention_bwd": 0,
            "flash_attention": cfg.num_layers, "flash_attention_bwd": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"
    cpu_model = get_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    del model
    enc_cpu, dec_cpu = cpu_model.visualize_forward(*(a.cpu() for a in args))
    del cpu_model
    b, s = args[0].shape
    assert tuple(enc.shape) == (b, s, cfg.decoder_dim), tuple(enc.shape)
    assert tuple(dec.shape) == (b, args[2].shape[1], cfg.decoder_dim), tuple(dec.shape)
    assert torch.isfinite(dec).all()
    enc_err = float((enc.cpu() - enc_cpu).abs().max())
    dec_err = float((dec.cpu() - dec_cpu).abs().max())
    assert enc_err <= VIS_ATOL and dec_err <= VIS_ATOL, (enc_err, dec_err)
    emit({"phase": "visualize", "model": "VALL-E default ModelConfig, attn_impl=flash, f32",
          "batch": [b, s, int(args[2].shape[1])], "launches": launches, "call_s": call_s,
          "enc_max_abs_err_vs_cpu": enc_err, "dec_max_abs_err_vs_cpu": dec_err,
          "atol": VIS_ATOL, "dec_max_abs": float(dec_cpu.abs().max()),
          "matplotlib": HAVE_MATPLOTLIB})
    return launches


# keys of a reference checkpoint that the JAX conversion skips
REFERENCE_EXTRA = ("ar_decoder.layers.0.self_attn.extra_buffer", "criterion.weight")


def reference_pt_path(dev, files):
    """Path e's infer CLI once more, from a reference-layout ``.pt``: the
    port's state dict plus keys that JAX's ``convert_state_dict`` skips
    (extra keys, and tied NAR heads overwritten with other values); its codes
    must equal the plain ``.pt``'s run."""
    import torch

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.models import ModelConfig

    cfg = ModelConfig(num_layers=CUT_LAYERS)
    tmp = files["dir"]
    sd = dict(torch.load(tmp / "model_cut.pt", map_location="cpu")["model"])
    gen = torch.Generator().manual_seed(SEED)
    for key in REFERENCE_EXTRA:
        sd[key] = torch.randn(7, generator=gen)
    tied = [f"nar_predict_layers.{j}.weight" for j in range(cfg.num_quantizers - 2)]
    for key in tied:
        sd[key] = torch.randn(sd[key].shape, generator=gen)
    torch.save({"model": sd, "epoch": 1}, tmp / "reference.pt")
    del sd
    argv = ["--checkpoint", str(tmp / "reference.pt"), "--codec-checkpoint",
            str(tmp / "codec.npz"), "--text-tokens", str(tmp / "tokens.k2symbols"),
            "--audio-prompts", str(tmp / "prompt.wav"), "--output-dir",
            str(tmp / "out_reference")] + INFER_FLAGS
    tf32 = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in tf32]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:  # path e's flags
        reset_launches()
        t0 = time.perf_counter()
        infer.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        for f, allow in zip(tf32, saved):
            f.allow_tf32 = allow
    equal = []
    for n in range(len(INFER_TEXTS)):
        got = np.load(tmp / "out_reference" / f"{n}_codes.npy")
        want = np.load(tmp / "out" / f"{n}_codes.npy")
        equal.append(got.shape == want.shape and bool((got == want).all()))
    assert all(equal), f"the reference .pt's codes differ from the plain .pt's: {equal}"
    emit({"phase": "infer_reference_pt", "extra_keys": list(REFERENCE_EXTRA),
          "overwritten_tied_heads": tied, "codes_equal_plain_pt": equal, "cli_wall_s": wall_s,
          "launches": launches})
    return launches


# --------------------------------------------------------- paths s, t and u
# The parallel layer (valle_tpu_torch/parallel) on the card.  The machine
# has one card, and NCCL refuses two ranks on one device, so: a group of one
# over NCCL, and two (or more) ranks sharing the card over gloo, which
# stages CUDA tensors through the host: those runs check correctness, and
# their times are not the speed of a multi-card run.

RANK_TIMEOUT_S = 600
DDP_B = 8  # the reference step's batch; each of the two ranks takes half
DDP_GRAD_RTOL = 1e-5  # 2-norm of all the gradients' error over theirs
DDP_LOSS_RTOL = DDP_CHECKSUM_RTOL = 1e-5
TP_REQUESTS, TP_MAX_NEW = 8, 32  # the serve CLI's runs take one bucket of TP_MAX_NEW


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


_RUNS = []  # every start_rank_processes run, stopped when the script ends


def start_rank_processes(job: str, world: int, args=(), *, backend="gloo",
                         group=True) -> dict:
    """Start ``job(*args)`` (a function of this script) in ``world``
    processes, as the ranks of a group over ``backend`` on the card
    (``group=False``: the job makes its own, from the address it is given),
    each in a session of its own, so that stopping it stops what it spawned.
    ``wait_rank_processes`` takes the handle this returns."""
    import os

    from valle_tpu_torch.parallel import dist

    out = Path(tempfile.mkdtemp(prefix="ranks-", dir=Path(__file__).resolve().parent / "build"))
    address = f"127.0.0.1:{dist.free_port()}"
    procs, logs = [], []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w+")
        logs.append(log)
        argv = [sys.executable, "-c", "import chip_smoke; chip_smoke._rank_main()", job,
                str(rank), str(world), address, backend, str(int(group)), str(out),
                *map(str, args)]
        procs.append(subprocess.Popen(argv, cwd=Path(__file__).resolve().parent,
                                      env=dict(os.environ), stdout=log,
                                      stderr=subprocess.STDOUT, start_new_session=True))
    run = {"job": job, "out": out, "procs": procs, "logs": logs}
    _RUNS.append(run)
    return run


def stop_rank_processes(run: dict) -> None:
    """Kill every process of ``run`` that still runs, with what it spawned."""
    import os
    import signal

    for p in run["procs"]:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def wait_rank_processes(run: dict, timeout=RANK_TIMEOUT_S) -> list:
    """Each rank's result (the JSON its job returns) of ``run``.  When a
    process fails, or ``timeout`` seconds from now pass, every process
    still running is killed and the phase fails with the processes'
    output."""
    procs, logs, world = run["procs"], run["logs"], len(run["procs"])
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        stop_rank_processes(run)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, f"{run['job']}: ranks {failed} failed:\n" + "\n".join(
        f"--- rank {r} (exit {procs[r].returncode})\n{texts[r][-4000:]}" for r in range(world))
    return [json.loads((run["out"] / f"rank{r}.json").read_text()) for r in range(world)]


def run_rank_processes(job: str, world: int, args=(), *, backend="gloo", group=True,
                       timeout=RANK_TIMEOUT_S) -> list:
    """``start_rank_processes`` and ``wait_rank_processes`` in one."""
    return wait_rank_processes(start_rank_processes(job, world, args, backend=backend,
                                                    group=group), timeout)


def _rank_main() -> None:
    """A rank process of ``run_rank_processes``."""
    import torch

    from valle_tpu_torch.ops import cuda_build
    from valle_tpu_torch.parallel import dist

    job, rank, world, address, backend, group, out, *args = sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build(KERNELS)  # built by the parent: loads only
    if group == "1":
        dist.initialize(address, int(world), int(rank), device="cuda", backend=backend,
                        timeout_s=RANK_TIMEOUT_S)
    try:
        res = globals()[job](int(rank), int(world), address, Path(out), *args)
    finally:
        dist.shutdown()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


class GradCapture:
    """Keeps the gradients that a train state's optimizer gets at its next
    step (summed over the ranks; before ScaledAdam's own clipping)."""

    def __init__(self, state):
        self.grads = {}
        names = {id(p): n for n, p in state.model.named_parameters()}
        real = state.optimizer.step

        def step(*a, **kw):
            if not self.grads:
                self.grads = {names[id(p)]: p.grad.detach().clone()
                              for g in state.optimizer.param_groups for p in g["params"]}
            return real(*a, **kw)

        state.optimizer.step = step


def _grad_rel_errors(got: dict, want: dict) -> dict:
    """Per tensor the 2-norm of the error over the tensor's, and over all."""
    import torch

    assert got.keys() == want.keys()
    per = {n: float((got[n] - want[n]).norm() / want[n].norm().clamp(min=1e-30)) for n in want}
    total = float(torch.stack([(got[n] - want[n]).double().norm() for n in want]).norm()
                  / torch.stack([want[n].double().norm() for n in want]).norm())
    worst = sorted(per, key=per.get, reverse=True)[:3]
    return {"all": total, "worst": {n: per[n] for n in worst}}


def timed_reductions():
    """Wrap ``train.step.reduce_gradients_`` so that it records, per call,
    the bytes reduced and its milliseconds (synchronised on both sides).
    Returns (records, restore)."""
    import torch

    from valle_tpu_torch.train import step as step_mod

    real, records = step_mod.reduce_gradients_, []

    def timed(params, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = real(params, group)
        torch.cuda.synchronize()
        records.append({"bytes": n, "ms": (time.perf_counter() - t0) * 1e3})
        return n

    step_mod.reduce_gradients_ = timed
    return records, lambda: setattr(step_mod, "reduce_gradients_", real)


def _ddp_setup(dev, deterministic: bool = True):
    """Phase 9's model (seeded init) at CUT_LAYERS layers, optimizer and
    schedule."""
    import functools

    import torch

    from valle_tpu_torch.models import ModelConfig, get_model
    from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
    from valle_tpu_torch.train.step import init_train_state

    cfg = ModelConfig(attn_impl="fused", num_layers=CUT_LAYERS)
    torch.manual_seed(SEED)
    model = get_model(cfg, device=dev)
    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95))
    return cfg, model, make_opt, get_lr_fn("eden", 0.05, warmup_steps=200)


def _ddp_batch(cfg, dev, rows=slice(None)):
    """Phase 9's batch layout at B=8 (rows ``rows`` of it)."""
    import torch

    rng = np.random.RandomState(SEED + 17)
    a, b, s, t = TRAIN_A, DDP_B, TRAIN_S, TRAIN_T
    x_lens = rng.randint(3 * s // 4, s + 1, (a, b))
    y_lens = rng.randint(int(0.8 * t), t + 1, (a, b))
    x_lens[:, 0], y_lens[:, 0] = s, t
    arrays = {"text_tokens": rng.randint(1, cfg.num_text_tokens, (a, b, s)),
              "text_tokens_lens": x_lens,
              "audio_features": rng.randint(0, cfg.num_audio_tokens, (a, b, t, cfg.num_quantizers)),
              "audio_features_lens": y_lens}
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, rows])).to(dev)
            for k, v in arrays.items()}


def ddp_train_path(dev, tmp: Path):
    """Path s.  (1) Phase 9's step (f32, dropout 0.1, B=4, A=2) through the
    parallel layer in a group of one over NCCL, against the same step
    without a group: bit-equal loss, gradients, weights and step generator.
    (2) The deterministic B=8 step on one process, then two ranks sharing
    the card over gloo, each with half of the batch, held against it
    (``ddp_train_job``)."""
    import copy

    import torch

    from valle_tpu_torch.parallel import dist
    from valle_tpu_torch.parallel.mesh import Mesh
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg, model, make_opt, lr_fn = _ddp_setup(dev)
    batch = _train_batch(cfg, np.random.RandomState(SEED + 5), dev)  # phase 9's
    plain = init_train_state(model, make_opt, train_stage=0)
    grouped = copy.deepcopy(plain)
    per_step = TRAIN_A * (cfg.num_layers + cfg.nar_num_layers)
    world1 = {}
    dist.initialize(f"127.0.0.1:{dist.free_port()}", 1, 0, device="cuda", force=True)
    records, restore = timed_reductions()
    try:
        backend = torch.distributed.get_backend()
        for name, state, mesh in (("plain", plain, None), ("group_of_one", grouped, Mesh())):
            grads = GradCapture(state)
            step = make_train_step(lr_fn, train_stage=0, mesh=mesh)
            gen = torch.Generator().manual_seed(SEED)
            reset_launches()
            t0 = time.perf_counter()
            _, metrics = step(state, batch, gen, 0)
            torch.cuda.synchronize()
            world1[name] = {"loss": float(metrics["loss"]), "grads": grads.grads,
                            "gen": gen.get_state(), "launches": read_launches(),
                            "step_s": time.perf_counter() - t0}
    finally:
        restore()
        dist.shutdown()
    a, b = world1["plain"], world1["group_of_one"]
    grads_equal = all(torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"])
    weights_equal = all(torch.equal(x, y) for x, y in zip(plain.model.state_dict().values(),
                                                          grouped.model.state_dict().values()))
    gen_equal = torch.equal(a["gen"], b["gen"])
    want = {"ragged_decode": 0, "prefix_attention": per_step, "prefix_attention_bwd": per_step,
            "flash_attention": 0, "flash_attention_bwd": 0}
    assert a["launches"] == b["launches"] == want, (a["launches"], b["launches"], want)
    assert backend == "nccl", backend
    assert a["loss"] == b["loss"] and grads_equal and weights_equal and gen_equal, \
        ("a group of one differs from the single-process step", a["loss"], b["loss"],
         grads_equal, weights_equal, gen_equal)
    world1_line = {"backend": backend, "loss": a["loss"], "bit_equal": True,
                   "launches_per_step": b["launches"], "step_s": [a["step_s"], b["step_s"]],
                   "reduction": records[-1]}  # the group's (the plain step reduces nothing)
    del plain, grouped, model, world1, a, b
    torch.cuda.empty_cache()

    # the reference: one process, the whole B=8 batch, deterministic
    cfg, model, make_opt, lr_fn = _ddp_setup(dev)
    state = init_train_state(model, make_opt, train_stage=0)
    grads = GradCapture(state)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = make_train_step(lr_fn, train_stage=0, deterministic=True)(
        state, _ddp_batch(cfg, dev), torch.Generator().manual_seed(SEED + 2), 0)
    torch.cuda.synchronize()
    ref = {"loss": float(metrics["loss"]), "grads": {n: g.cpu() for n, g in grads.grads.items()},
           "checksum": sum(float(p.detach().abs().sum()) for p in state.model.parameters())}
    ref_line = {"loss": ref["loss"], "checksum": ref["checksum"],
                "step_s": time.perf_counter() - t0,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    ref_path = tmp / "ddp_reference.pt"
    torch.save(ref, ref_path)
    del state, model, grads, ref, metrics
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_rank_processes("ddp_train_job", 2, [ref_path])
    ranks_s = time.perf_counter() - t0
    ref_path.unlink()
    r0, r1 = ranks
    assert r0["loss"] == r1["loss"] and r0["checksum"] == r1["checksum"], (r0, r1)
    loss_err = abs(r0["loss"] - ref_line["loss"]) / abs(ref_line["loss"])
    checksum_err = abs(r0["checksum"] - ref_line["checksum"]) / ref_line["checksum"]
    emit({"phase": "ddp_train", "model": f"VALL-E ModelConfig(num_layers={CUT_LAYERS}) (d=1024, "
          f"16 heads, {CUT_LAYERS}+{CUT_LAYERS} layers), attn_impl=fused, f32, train_stage 0, "
          "ScaledAdam + Eden", "group_of_one": world1_line,
          "reference_b8": ref_line, "ranks": ranks, "ranks_wall_s": ranks_s,
          "loss_rel_err": loss_err, "checksum_rel_err": checksum_err,
          "bars": {"grads_all": DDP_GRAD_RTOL, "grads_each": GRAD_RTOL, "loss": DDP_LOSS_RTOL,
                   "checksum": DDP_CHECKSUM_RTOL},
          "note": "two ranks share one card over gloo, which stages through the host: "
                  "their times are not a multi-card run's",
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": _smi()})
    assert loss_err <= DDP_LOSS_RTOL and checksum_err <= DDP_CHECKSUM_RTOL, (loss_err,
                                                                             checksum_err)
    for r in ranks:
        assert r["grad_err"]["all"] <= DDP_GRAD_RTOL, r["grad_err"]
        assert max(r["grad_err"]["worst"].values()) <= GRAD_RTOL, r["grad_err"]
    counts = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    return {"ddp_train_group_of_one": world1_line["launches_per_step"], "ddp_train": counts}


def ddp_train_job(rank: int, world: int, address: str, out: Path, ref_path: str) -> dict:
    """A rank of path s: its half of the B=8 batch, a deterministic step
    held against the reference's gradients, then a step in train mode
    (dropout 0.1) whose first kernel 2 and 3 launch per shape is held
    against the plain version on rank 1, with rank 1's dropout bits."""
    import torch

    from valle_tpu_torch.ops import fused_attention as fa
    from valle_tpu_torch.ops.philox import SEED_RANGE, draw_seed, dropout_keep_mask, fold_rank
    from valle_tpu_torch.parallel.mesh import Mesh, replicate_
    from valle_tpu_torch.train.step import init_train_state, make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh()
    cfg, model, make_opt, lr_fn = _ddp_setup(dev)
    replicate_(model, mesh)
    state = init_train_state(model, make_opt, train_stage=0)
    half = slice(rank * DDP_B // world, (rank + 1) * DDP_B // world)
    batch = _ddp_batch(cfg, dev, half)
    grads = GradCapture(state)
    records, restore = timed_reductions()
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_launches()
        t0 = time.perf_counter()
        _, metrics = make_train_step(lr_fn, train_stage=0, deterministic=True, mesh=mesh)(
            state, batch, torch.Generator().manual_seed(SEED + 2), 0)
        torch.cuda.synchronize()
        step_s = [time.perf_counter() - t0]
        launches = read_launches()
        ref = torch.load(ref_path, map_location=dev)
        grad_err = _grad_rel_errors(grads.grads, ref["grads"])
        del ref, grads
        checksum = sum(float(p.detach().abs().sum()) for p in state.model.parameters())
        loss = float(metrics["loss"])
        peak = torch.cuda.max_memory_allocated() / 2**30

        on_rank1 = lambda: rank == 1  # noqa: E731
        k2, restore2 = capture_kernel2(on_rank1)
        k3, restore3 = capture_kernel3(on_rank1)
        try:
            reset_launches()
            t0 = time.perf_counter()
            make_train_step(lr_fn, train_stage=0, mesh=mesh)(
                state, batch, torch.Generator().manual_seed(SEED + 3), 0)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            dropout_launches = read_launches()
        finally:
            restore2()
            restore3()
    finally:
        restore()
    res = {"rank": rank, "rows": [half.start, half.stop], "loss": loss, "checksum": checksum,
           "grad_err": grad_err, "launches": launches, "dropout_step_launches": dropout_launches,
           "step_s": step_s, "reductions": records, "peak_mem_gib": peak}
    per_step = TRAIN_A * (cfg.num_layers + cfg.nar_num_layers)
    for counts in (launches, dropout_launches):
        assert counts["prefix_attention"] == counts["prefix_attention_bwd"] == per_step, counts
    if rank == 1:
        res["kernel2_captures"] = check_kernel2_captures(k2, "ddp rank 1")
        res["kernel3_captures"] = check_kernel3_captures(k3, "ddp rank 1")
        assert all(c["rate"] > 0 for c in res["kernel2_captures"]), res["kernel2_captures"]
        # rank 1's dropout bits: the folded seed of a generator state, and
        # rank 0's from the same state
        raw = int(torch.randint(0, SEED_RANGE, (), generator=torch.Generator().manual_seed(
            SEED + 4)))
        seeds = [fold_rank(raw, r) for r in (0, 1)]
        assert draw_seed(torch.Generator().manual_seed(SEED + 4)) == seeds[1]
        b, h, t = TRAIN_B, cfg.nhead, TRAIN_S + TRAIN_T
        masks = [dropout_keep_mask(s, b, h, t, t, DROPOUT, device=dev) for s in seeds]
        q, k, v = (torch.randn(b, t, h, cfg.decoder_dim // h, device=dev) for _ in range(3))
        kb = torch.zeros(b, t, device=dev)
        got = fa._forward(q, k, v, kb, TRAIN_S, DROPOUT, seeds[1], False)[0]
        want = fa.attention_forward_reference(q, k, v, kb, TRAIN_S, DROPOUT, seeds[1])[0]
        err = float((got - want).abs().max())
        keep = float(masks[1].float().mean())
        sigma = float(np.sqrt(DROPOUT * (1 - DROPOUT) / masks[1].numel()))
        differ = float((masks[0] != masks[1]).float().mean())
        res["dropout"] = {"seeds": seeds, "keep_rate": keep, "sigma": sigma,
                          "bits_differing_from_rank0": differ, "kernel2_max_abs_err": err}
        assert abs(keep - (1 - DROPOUT)) <= 4 * sigma, res["dropout"]
        assert seeds[0] != seeds[1] and differ > 0.1, res["dropout"]
        assert err <= TOL["float32"], res["dropout"]
    return res


def ddp_train_cli_path(dev, files) -> dict:
    """Path t: the train CLI as two processes (``--num-processes 2
    --dist-backend gloo``, the ranks sharing the card) on path i's corpus,
    stage 0 for one epoch with path i's flags (OOM scan, validation, step
    checkpoints, averaging): one log, one set of ``.pt`` files, finite
    losses, equal on both ranks, then the averaged ``epoch-1.pt`` through
    the infer CLI to a finite wav."""
    import shutil

    from valle_tpu_torch.bin import infer as infer_cli
    from valle_tpu_torch.data import read_wav

    t_phase = time.perf_counter()
    root = files["dir"] / "ddp_cli"
    corpus = write_cli_corpus(root / "data", files["tokens.k2symbols"],
                              splits=(("train", CLI_UTTS), ("dev", CLI_DEV_UTTS)), dur=CLI_DUR,
                              fmt="vsh", frame_rate=75.0, dim=8, seed=SEED + 11)
    exp = root / "exp"
    argv = ["--manifest-dir", corpus, "--exp-dir", exp, *CLI_FLAGS, "--train-stage", "0",
            "--num-epochs", "1"]
    t0 = time.perf_counter()
    ranks = run_rank_processes("train_cli_job", 2, argv, group=False)
    cli_s = time.perf_counter() - t0
    log = (exp / "log.txt").read_text()
    names = sorted(p.name for p in (exp / "checkpoints").iterdir() if p.suffix == ".pt")
    r0, r1 = ranks
    assert "distributed: process 0/2" in log and "epoch 1 done" in log, log[-2000:]
    assert "process 1/2" not in log, "rank 1 wrote to the log"
    assert "epoch-1.pt" in names and sum(n.startswith("checkpoint-") for n in names) <= 1, names
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) >= 2, (r0, r1)
    assert all(np.isfinite(r0["losses"])), r0["losses"]
    per_step = TRAIN_A * 24
    for r in ranks:
        assert all(s["prefix_attention"] == s["prefix_attention_bwd"] == per_step
                   for s in r["launches_per_step"]), r["launches_per_step"]

    out_dir = root / "infer"
    before = read_launches()
    infer_cli.main(["--checkpoint", str(exp / "checkpoints" / "epoch-1.pt"),
                    "--use-averaged-model", "true", "--codec-checkpoint", str(files["codec.npz"]),
                    "--text-tokens", str(files["tokens.k2symbols"]), "--text-extractor",
                    "chars", "--attn-impl", "flash", "--seed", str(SEED), "--max-new-tokens", "150",
                    "--text-prompts", INFER_PROMPT_TEXT, "--audio-prompts",
                    str(files["prompt.wav"]), "--text", INFER_TEXTS[0],
                    "--output-dir", str(out_dir)])
    infer_launches = _delta(read_launches(), before)
    wav, sr = read_wav(str(out_dir / "0.wav"))
    assert wav.size > 0 and np.isfinite(wav).all(), "the trained model's wav is not finite"
    shutil.rmtree(root)
    emit({"phase": "ddp_train_cli", "cli": "python -m valle_tpu_torch.bin.train --num-processes 2 "
          "--dist-backend gloo (two ranks sharing the card)", "flags": CLI_FLAGS,
          "checkpoints": names, "ranks": ranks, "cli_wall_s": cli_s,
          "infer": {"launches": infer_launches, "wav_samples": int(wav.size), "sample_rate": sr},
          "note": "gloo stages the all-reduces through the host: times are not a multi-card "
                  "run's", "seconds": time.perf_counter() - t_phase, "nvidia_smi": _smi()})
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def train_cli_job(rank: int, world: int, address: str, out: Path, *argv) -> dict:
    """A rank of path t: ``valle_tpu_torch.bin.train.main`` with this rank's
    process flags, counting kernel launches per step."""
    from valle_tpu_torch.bin import train as train_cli

    make_step = train_cli.make_train_step
    per_step = []

    def counted(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch, rng, epoch):
            before = read_launches()
            out_ = step(state, batch, rng, epoch)
            per_step.append(_delta(read_launches(), before))
            return out_

        return run

    train_cli.make_train_step = counted
    reset_launches()
    summary = train_cli.main([*argv, "--num-processes", str(world), "--process-id", str(rank),
                              "--coordinator-address", address, "--dist-backend", "gloo"])
    return {"rank": rank, "losses": [s["loss"] for s in summary["steps"]],
            "shapes": [s["shape"] for s in summary["steps"]],
            "step_s": [s["step_s"] for s in summary["steps"]],
            "oom_scan_shapes": len(summary["oom_scan"]), "saves": summary["saves"],
            "validations": summary["validations"], "launches": read_launches(),
            "launches_per_step": per_step, "peak_mem_gib": summary["peak_mem_bytes"] / 2**30}


# path u: tensor- and data-parallel serving

def _tp_requests(cfg):
    """8 requests at generate's shapes: text 40-64 tokens, prompts of
    150-225 frames."""
    import torch

    rng = np.random.RandomState(SEED + 19)
    r, s, p, q = TP_REQUESTS, 64, 225, cfg.num_quantizers
    arrays = {"x": rng.randint(1, cfg.num_text_tokens, (r, s)),
              "x_lens": rng.randint(40, s + 1, r),
              "prompt_codes": rng.randint(0, cfg.num_audio_tokens, (r, p, q)),
              "prompt_lens": rng.randint(150, p + 1, r)}
    return {k: torch.from_numpy(v).long() for k, v in arrays.items()}


def record_gaps(model):
    """Forward hooks on the prediction heads that keep, per call, the top
    logit and the gap to the second (AR: one call per token, prefill first;
    NAR: one call per stage).  Returns (ar, nar, remove)."""
    import torch

    ar, nar = [], []

    def top2(out):
        top = out.float().topk(2, dim=-1).values
        return torch.stack([top[..., 0], top[..., 0] - top[..., 1]], -1).cpu()

    handles = [model.ar_predict_layer.register_forward_hook(lambda m, i, o: ar.append(top2(o)))]
    handles += [layer.register_forward_hook(lambda m, i, o: nar.append(top2(o)))
                for layer in model.nar_predict_layers]
    return ar, nar, lambda: [h.remove() for h in handles]


def first_differences(ref_codes, got_codes, ar_gaps, nar_gaps) -> dict:
    """Per row, where ``got_codes`` first leaves ``ref_codes`` (codebook 1
    first, then each NAR codebook where codebook 1 agrees), with the
    reference's top-two gap there; rows equal throughout count as equal.
    ``ar_gaps`` (B, steps, 2); ``nar_gaps`` per stage (B, T, 2)."""
    equal, ties = 0, []
    for row, (want, got) in enumerate(zip(ref_codes, got_codes)):
        diff = np.flatnonzero(want[:, 0] != got[:, 0])
        if diff.size:
            j = int(diff[0])
            top, gap = (float(v) for v in ar_gaps[row, j])
            ties.append({"row": row, "codebook": 1, "step": j, "top_logit": top, "gap": gap,
                         "limit": NEAR_TIE_ULPS * _bf16_ulp(top)})
            continue
        for stage in range(1, want.shape[1]):
            diff = np.flatnonzero(want[:, stage] != got[:, stage])
            if diff.size:
                j = int(diff[0])
                top, gap = (float(v) for v in nar_gaps[stage - 1][row, j])
                ties.append({"row": row, "codebook": stage + 1, "step": j, "top_logit": top,
                             "gap": gap, "limit": NEAR_TIE_ULPS * _bf16_ulp(top)})
                break
        else:
            equal += 1
    return {"rows_equal": equal, "first_near_ties": ties,
            "off": [t for t in ties if t["gap"] > t["limit"]]}


def _tp_config(w8a8: bool):
    from valle_tpu_torch.models import ModelConfig

    return ModelConfig(dtype="bfloat16", attn_impl="flash", kv_cache_dtype="int8",
                       act_quant=w8a8, num_layers=CUT_LAYERS)


def tp_generate_job(rank: int, world: int, address: str, out: Path, model_pt: str,
                    batch_pt: str) -> dict:
    """A rank of path u's T=2 mesh: the W8A8 prefill logits of the serve
    CLI's first batch (``batch_pt``, which the parent writes once its
    one-rank run has it) on its heads, then bf16 ``generate(...,
    ragged_decode=True)`` with an int8 KV cache on 8 requests, the first
    kernel 1 and kernel 2 launch of each shape held against the plain
    versions."""
    import torch

    from valle_tpu_torch.bin import infer
    from valle_tpu_torch.models import get_model
    from valle_tpu_torch.nn import attention
    from valle_tpu_torch.ops.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)
    from valle_tpu_torch.parallel.mesh import Mesh, shard_parameters_
    from valle_tpu_torch.sample import _prefill_kv, generate

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(1, world)
    sd = infer.load_model_params(model_pt, _tp_config(False), "valle")
    model = shard_parameters_(get_model(_tp_config(True), device=dev, state_dict=sd,
                                        quantize=True), mesh)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not Path(batch_pt).exists():
        assert time.monotonic() < deadline, f"{batch_pt} did not come"
        time.sleep(0.1)
    with torch.inference_mode():
        batch = [t.to(dev) for t in torch.load(batch_pt)]
        logits = _prefill_kv(model, *batch)[0].float().cpu()
    del model, batch
    torch.cuda.empty_cache()

    cfg = _tp_config(False)
    model = shard_parameters_(get_model(cfg, device=dev, state_dict=sd), mesh)
    del sd
    heads = model.ar_decoder.layers[0].self_attn.local_heads
    k1, restore1 = capture_first_calls(attention, "ragged_decode_attention",
                                       lambda a, kw: tuple(a[0].shape))
    k2, restore2 = capture_kernel2()
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = generate(model, **{k: v.to(dev) for k, v in _tp_requests(cfg).items()}, top_k=1,
                       max_new_tokens=TP_MAX_NEW, forbid_eos=True, ragged_decode=True,
                       generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        restore1()
        restore2()
    k1_cases = []
    for shape, (args, kw, got) in sorted(k1.items()):
        err = float((got.float() - ragged_decode_attention_reference(*args).float()).abs().max())
        rerun = torch.equal(ragged_decode_attention(*args, **kw), got)
        assert err <= TOL["float32"] and rerun, (shape, err, rerun)
        k1_cases.append({"q_shape": list(shape), "cache": str(args[1].dtype),
                         "max_abs_err": err, "rerun_bit_equal": rerun})
    k2_cases = check_kernel2_captures(k2, f"tp rank {rank}")
    assert k1 and all(s[2] == heads for s in k1), list(k1)
    torch.save({"logits": logits, "codes": res["codes"].cpu(), "lengths": res["lengths"].cpu()},
               out / f"tp_rank{rank}.pt")
    return {"rank": rank, "local_heads": heads, "launches": launches, "generate_wall_s": wall,
            "kernel1_cases": k1_cases, "kernel2_cases": k2_cases,
            "saved": str(out / f"tp_rank{rank}.pt")}


def _serve_tsv(path, wav) -> None:
    """8 requests with the prompt wav and its text, texts of 20-40
    characters (a bucket of ``TP_MAX_NEW`` takes them all)."""
    rng = np.random.RandomState(SEED + 23)
    path.write_text("".join(f"p{i}\t{_text_of(rng, rng.randint(20, 41))}\t{wav}\t"
                            f"{INFER_PROMPT_TEXT}\n" for i in range(TP_REQUESTS)))


def _serve_outputs(out_dir) -> tuple:
    manifest = [json.loads(line) for line in (out_dir / "manifest.jsonl").read_text().splitlines()]
    return manifest, [np.load(out_dir / f"{m['id']}_codes.npy") for m in manifest]


def _pad_codes(codes, width: int):
    out = np.zeros((len(codes), width, codes[0].shape[1]), np.int64)
    for i, c in enumerate(codes):
        out[i, :len(c)] = c
    return out


def serve_cli_job(rank: int, world: int, address: str, out: Path, *argv) -> dict:
    """A process of path u that runs ``valle_tpu_torch.bin.serve.main(argv)``
    (which starts the CLI's own ranks)."""
    from valle_tpu_torch.bin import serve

    t0 = time.perf_counter()
    serve.main(list(argv))
    return {"seconds": time.perf_counter() - t0}


def tp_serve_path(dev, files) -> dict:
    """Path u, against one rank on the same card: the serve CLI at
    ``--tensor-parallel 2 --quantize-weights w8a8`` and at
    ``--data-parallel 2`` (unquantized) on 8 prompted requests in one bucket
    (manifests and codes equal up to the first near-tie of the one-rank
    run's logits), and ``tp_generate_job`` on two ranks: the W8A8 prefill
    logits of the CLI's batch bit-equal to the one-rank CLI's, and bf16
    ``generate`` codes equal up to the first near-tie.  The ranks share the
    card over gloo; the two-rank CLI runs (each in a process of
    ``serve_cli_job``) and the ranks of ``tp_generate_job`` start first and
    run beside the one-rank runs."""
    import torch

    from valle_tpu_torch import sample
    from valle_tpu_torch.bin import serve

    t_phase = time.perf_counter()
    tmp = files["dir"]
    tsv = tmp / "tp_requests.tsv"
    _serve_tsv(tsv, files["prompt.wav"])
    base = ["--requests", str(tsv), "--checkpoint", str(files["model_cut.pt"]),
            "--num-decoder-layers", str(CUT_LAYERS), "--codec-checkpoint",
            str(files["codec.npz"]), "--text-tokens", str(files["tokens.k2symbols"]),
            "--text-extractor", "chars", "--batch-size", str(TP_REQUESTS), "--length-buckets",
            str(TP_MAX_NEW), "--attn-impl", "flash", "--top-k", "1", "--seed", str(SEED)]
    runs = {"tp": (["--quantize-weights", "w8a8"], "--tensor-parallel"),
            "dp": ([], "--data-parallel")}
    two_rank_runs = {name: start_rank_processes(
        "serve_cli_job", 1, base + extra + [flag, "2", "--dist-backend", "gloo", "--output-dir",
                                            tmp / f"{name}_two"], group=False)
        for name, (extra, flag) in runs.items()}
    batch_pt = tmp / "tp_batch.pt"
    t_ranks = time.perf_counter()
    tp_ranks = start_rank_processes("tp_generate_job", 2, [files["model_cut.pt"], batch_pt])
    real_generate = serve.generate
    one_rank = {}
    for name, (extra, _) in runs.items():  # one rank, recording its logits' top-two gaps
        gaps, kept = [], {}

        def recording(model_, *a, **kw):
            ar_, nar_, remove_ = record_gaps(model_)
            try:
                return real_generate(model_, *a, **kw)
            finally:
                remove_()
                gaps.append((torch.stack(ar_, 1).numpy(), [n.numpy() for n in nar_]))
                kept["model"] = model_

        prefills, restore_pre = capture_first_calls(sample, "_prefill_kv",
                                                    lambda a, kw: a[1].shape[0])
        serve.generate = recording
        try:
            t0 = time.perf_counter()
            serve.main(base + extra + ["--output-dir", str(tmp / f"{name}_one")])
            one_s = time.perf_counter() - t0
        finally:
            serve.generate = real_generate
            restore_pre()
        assert len(gaps) == 1 and len(prefills) == 1, "expected one batch"
        args, _, out = prefills.popitem()[1]
        one_rank[name] = {"s": one_s, "gaps": gaps[0], "batch": [t.cpu() for t in args[1:5]],
                          "logits": out[0].float().cpu(), "model": kept["model"]}
        del args, out, prefills
        if name == "tp":  # the batch the ranks wait for
            torch.save(one_rank["tp"]["batch"], batch_pt.with_suffix(".tmp"))
            batch_pt.with_suffix(".tmp").replace(batch_pt)

    # generate on one rank (the unquantized CLI run's model), then on two
    cfg = one_rank["dp"]["model"].cfg
    req = {k: v.to(dev) for k, v in _tp_requests(cfg).items()}
    ar, nar, remove = record_gaps(one_rank["dp"]["model"])
    try:
        reset_launches()
        want = sample.generate(one_rank["dp"].pop("model"), **req, top_k=1,
                               max_new_tokens=TP_MAX_NEW, forbid_eos=True, ragged_decode=True,
                               generator=torch.Generator(device=dev).manual_seed(SEED))
        one_rank_launches = read_launches()
    finally:
        remove()
    del one_rank["tp"]["model"], req
    torch.cuda.empty_cache()
    ranks = wait_rank_processes(tp_ranks)
    ranks_s = time.perf_counter() - t_ranks
    got = [torch.load(r["saved"]) for r in ranks]
    assert all(torch.equal(got[0][k], got[1][k]) for k in ("logits", "codes", "lengths")), \
        "the ranks of one model group differ"
    w8a8_equal = torch.equal(got[0]["logits"], one_rank["tp"]["logits"])
    w8a8_err = float((got[0]["logits"] - one_rank["tp"]["logits"]).abs().max())
    assert torch.equal(want["lengths"].cpu(), got[0]["lengths"])
    gen_cmp = first_differences(want["codes"].cpu().numpy(), got[0]["codes"].numpy(),
                                torch.stack(ar, 1).numpy(), [n.numpy() for n in nar])
    n_layers = cfg.num_layers
    for r in ranks:
        assert r["local_heads"] == cfg.nhead // 2, r
        assert r["launches"]["ragged_decode"] == n_layers * TP_MAX_NEW, r["launches"]
        assert r["launches"]["prefix_attention"] == n_layers + 7 * cfg.nar_num_layers, r

    # the serve CLI on two ranks
    cli = {}
    for name, (extra, flag) in runs.items():
        two_s = wait_rank_processes(two_rank_runs[name])[0]["seconds"]
        (m1, c1), (m2, c2) = (_serve_outputs(tmp / f"{name}_{k}") for k in ("one", "two"))
        assert [m["id"] for m in m1] == [m["id"] for m in m2]
        width = max(len(c) for c in c1 + c2)
        cmp = first_differences(_pad_codes(c1, width), _pad_codes(c2, width),
                                *one_rank[name]["gaps"])
        cli[name] = {"flags": extra + [flag, "2"], "one_rank_s": one_rank[name]["s"],
                     "two_ranks_s": two_s, "manifests_equal": m1 == m2,
                     "codes_equal": all(np.array_equal(a, b) for a, b in zip(c1, c2)), **cmp}
    emit({"phase": "tp_serve", "model": "VALL-E default ModelConfig, seeded random weights "
          "(.pt), bf16, int8 KV, attn_impl=flash", "requests": TP_REQUESTS,
          "max_new_tokens": TP_MAX_NEW, "ranks": ranks, "ranks_wall_s": ranks_s,
          "w8a8_prefill_bit_equal": w8a8_equal, "w8a8_prefill_max_abs_err": w8a8_err,
          "w8a8_batch": [list(t.shape) for t in one_rank["tp"]["batch"]],
          "generate_vs_one_rank": gen_cmp, "one_rank_launches": one_rank_launches,
          "serve_cli": cli,
          "near_tie": f"top-two gap <= {NEAR_TIE_ULPS} bf16 ulps of the top logit",
          "note": "ranks share one card over gloo, which stages through the host, and the "
                  "two-rank CLI runs run beside the rest: times are not a multi-card run's",
          "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": _smi()})
    assert w8a8_equal, f"W8A8 prefill logits at T=2 differ from T=1 by {w8a8_err}"
    off = gen_cmp["off"] + [t for c in cli.values() for t in c["off"]]
    assert not off, f"codes at T=2 / D=2 differ from one rank's without a near-tie: {off}"
    return {"tp_generate": {k: sum(r["launches"][k] for r in ranks)
                            for k in ranks[0]["launches"]}}


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
    smi = _smi()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    # The three sources build side by side, each followed by its SASS scan;
    # no kernel is timed until all three are in (nvcc would share the host
    # with the timed calls).
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(3)

    def build_and_scan(name, *label):
        seconds = cuda_build.build([name])[name]
        log = cuda_build.log_path(name)
        return seconds, kernel_resources(log.with_suffix(".so"), log, *label)

    jobs = {"ragged_decode": pool.submit(build_and_scan, "ragged_decode", ragged_label,
                                         (("i2f", "I2F"),)),
            "prefix_attention": pool.submit(build_and_scan, "prefix_attention"),
            "prefix_attention_bwd": pool.submit(build_and_scan, "prefix_attention_bwd")}
    built = {name: job.result() for name, job in jobs.items()}
    pool.shutdown()
    (_, k1_res), (_, fwd), (_, bwd) = (built[name] for name in KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {name: built[name][0] for name in KERNELS},
          "ptxas": {name: ptxas_summary(cuda_build.log_path(name)) for name in KERNELS},
          "kernel1_kernels": k1_res, "forward_kernels": fwd, "backward_kernels": bwd,
          "note": "seconds: until the last source was built and scanned, before any kernel "
                  "ran"})
    # kernel 1: seven / eight / nine lane layouts (int8 / bf16 / f32), each
    # for whole-chunk heads and for heads staged into slots, the combine
    # kernel in two sizes, the strided layout at three / four / three chunk
    # counts a thread and its combine, and for the widest heads the scores
    # kernel and the V-slice instantiation in each cache type
    assert len(k1_res) == 67, f"expected 67 kernel 1 kernels, found {sorted(k1_res)}"
    assert all(r["spill_bytes"] == 0 for r in k1_res.values()), "ptxas spills in kernel 1"
    assert all(r["i2f"] == 0 for n, r in k1_res.items() if "int8" in n), \
        "an int8-cache instantiation of kernel 1 converts with I2F"
    # kernel 2: f32 / bf16 x Dh 16 / 32 / 64 / 128 / wide / cluster / split x
    # dropout or not; kernel 4 without
    assert len(fwd) == 42, f"expected 42 forward kernels, found {sorted(fwd)}"
    assert all(r["hmma"] > 0 for r in fwd.values()), "a forward kernel runs no tensor-core MMA"
    assert all(r["spill_bytes"] == 0 for r in fwd.values()), "ptxas spills in the forward"
    # kernels 3 / 4: 60 of Dh 16-128 and split, 12 wide passes of Dh 256, 12
    # cluster passes above it
    passes = {n: r for n, r in bwd.items() if "delta" not in n}
    assert len(passes) == 84, f"expected 84 backward pass kernels, found {sorted(passes)}"
    assert all(r["hmma"] > 0 for r in passes.values()), "a backward pass runs no tensor-core MMA"
    assert all(r["spill_bytes"] == 0 for r in bwd.values()), "ptxas spills in the backward"
    k1 = check_ragged_decode(dev)
    check_ragged_head_dims(dev)
    check_prefix_attention(dev, fwd)
    k2d = check_dropout_forward(dev, fwd)
    k3 = check_backward(dev, bwd)
    k4 = check_flash_bias(dev, fwd, bwd)
    _, cluster_fwd = check_head_dims(dev, fwd, bwd)
    k234_dh256 = check_dh256(dev, fwd, bwd)
    paths = {}
    paths["generate"], generate_line = main_path(dev)
    paths["generate_dh256"], _ = main_path(dev, nhead=DH256_H, beside=generate_line)
    paths["train_step"], hand_fed_step_s = train_path(dev, k2d, k3)
    paths["train_dh256"] = train_dh256_path(dev, hand_fed_step_s)
    paths["tts_train_step"], tts_step_s = tts_train_path(dev)
    paths["tts_dh256_train"], _ = tts_train_path(dev, nhead=DH256_H, beside_step_s=tts_step_s)
    paths["tts_inference"] = tts_inference_path(dev)
    paths["tts_dh256_inference"] = tts_inference_path(
        dev, nhead=DH256_H, steps=DH256_MEL_STEPS, check_steps=DH256_MEL_STEPS,
        phase="tts_dh256_inference")
    paths.update(tts_scaling_train_path(dev, tts_step_s))
    paths["tts_scaling_inference"] = tts_inference_path(dev, scaling=True)
    paths["visualize"] = visualize_path(dev)
    with tempfile.TemporaryDirectory() as tmp:
        files = write_serving_files(Path(tmp))
        paths["infer"] = infer_path(dev, files)
        paths["infer_reference_pt"] = reference_pt_path(dev, files)
        paths.update(serve_path(dev, files))
        paths["continuous"], paths["continuous_generate"] = continuous_path(dev, files)
        paths.update(train_cli_path(dev, files, hand_fed_step_s))
        paths["tokenize_cli"], codes_dir, mels_dir = tokenize_cli_path(
            dev, files, files["dir"] / "data_cli")
        paths.update(train_cli_bf16_path(dev, files, codes_dir, mels_dir))
        paths["tts_scaling_train_cli"] = tts_scaling_cli_path(dev, mels_dir)
        paths.update(ddp_train_path(dev, files["dir"]))
        paths["ddp_train_cli"] = ddp_train_cli_path(dev, files)
        paths.update(tp_serve_path(dev, files))
    paths.update(remat_ab_path(dev))

    def numbers(res):
        return {"case": res["case"], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "ms_spread": [res["ms_min"], res["ms_max"]], "device_ms": res["device_ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                **({"cuda_kernels": sorted(res["kernels"])} if "kernels" in res else {})}

    def entry(name, source, replaces, res, path, dh256, cluster=None):
        by_path = {p: counts[name] for p, counts in paths.items()}
        more = {} if cluster is None else {"cluster_kernels": {
            k: {f: r[f] for f in ("registers", "spill_bytes", "hmma", "cluster", "key_tile",
                                  "dynamic_smem_bytes", "max_active_clusters")}
            for k, r in cluster_fwd.items() if k.startswith(cluster)}}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": by_path[path], "launches_by_path": by_path, **numbers(res),
                "dh256": [numbers(r) for r in dh256], **more}

    t = TRAIN_S + TRAIN_T
    emit({"kernels": [
        entry("ragged_decode", "valle_tpu_torch/csrc/ragged_decode.cu",
              "valle_tpu/ops/ragged_decode.py:56", k1["phase3 int8 cache"], "generate",
              [k1["generate B=8 dh 256 int8 cache"]]),
        entry("prefix_attention", "valle_tpu_torch/csrc/prefix_attention.cu",
              "valle_tpu/ops/fused_attention.py:110", k2d["dense_self"], "train_step",
              [k234_dh256[f"kernel2 {c} {d}"] for c in (f"dense T={t}", "cross")
               for d in ("float32", "bfloat16")], "prefix_attention_cluster_kernel"),
        entry("prefix_attention_bwd", "valle_tpu_torch/csrc/prefix_attention_bwd.cu",
              "valle_tpu/ops/fused_attention.py:139", k3["dense_self float32 rate 0.1"],
              "train_step",
              [k234_dh256[f"kernel3 dense T={t} {d}"] for d in ("float32", "bfloat16")]),
        entry("flash_attention", "valle_tpu_torch/csrc/prefix_attention.cu",
              "valle_tpu/ops/flash_attention.py:46", k4["decoder float32"]["forward"],
              "tts_train_step",
              [k234_dh256[f"kernel4 {c} {d}"] for c in ("decoder", "inference")
               for d in ("float32", "bfloat16")], "flash_bias_fwd_cluster_kernel"),
        entry("flash_attention_bwd", "valle_tpu_torch/csrc/prefix_attention_bwd.cu",
              "valle_tpu/ops/flash_attention.py:46", k4["decoder float32"]["backward"],
              "tts_train_step",
              [k234_dh256[f"kernel4 decoder backward {d}"] for d in ("float32", "bfloat16")]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:  # a failed phase leaves no rank process behind
        for started in _RUNS:
            stop_rank_processes(started)
    sys.exit(code)
