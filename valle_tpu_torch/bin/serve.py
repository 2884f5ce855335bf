"""Batch serving CLI: length-bucketed zero-shot TTS at full batch, the twin
of ``valle_tpu/bin/serve.py``.

  - requests are routed to length buckets by ``nar_len * frames_per_phoneme``,
    each served by ``generate`` with its own ``max_new_tokens``;
  - every batch is padded to a power of two (at least 8) up to
    ``--batch-size``, and text and prompt lengths to multiples of 32, as in
    JAX (where that bounds the number of compiled programs);
  - prompt wavs are encoded by the codec in batches grouped by their length
    once truncated to the prompt cap;
  - the codec decodes each generation batch in ``--decode-batch`` chunks with
    the int16 conversion on the device, and the host copies and wav writes of
    batch i run after batch i+1 is dispatched;
  - ``--quantize-weights w8|w8a8`` quantizes the decoder weights to int8 on
    the host, from the f32 checkpoint, before they go to the card.

Serving defaults: ``--dtype bfloat16 --kv-cache-dtype int8``.  The decode
reads of ``generate`` are plain math (no ``ragged_decode``), as the JAX CLI
runs them; ``--attn-impl flash`` takes the prefill and the NAR passes to
kernel 2.

``--data-parallel D --tensor-parallel T`` serves on D x T ranks, which the
CLI starts itself (one process each, rank r on ``cuda:{r % device_count}``,
``parallel/mesh.py``), as the JAX CLI serves on a D x T mesh: every batch is
padded to a multiple of D rows and data shard d generates rows ``[d b / D,
(d + 1) b / D)``; the T ranks of a shard split the decoder layers' heads and
FFN features and sample alike (one seed per shard); the first rank gathers
the codes, decodes and writes.  Greedy codes equal the one-rank run's.

Input: a TSV of requests ``id<TAB>text[<TAB>prompt_wav<TAB>prompt_text]``
(prompt columns optional, ``-`` for none: promptless generation).  Output:
``<id>.wav`` and ``<id>_codes.npy`` per request and a ``manifest.jsonl``.

Run: python -m valle_tpu_torch.bin.serve --requests reqs.tsv --checkpoint model.pt
     --text-tokens tokens.k2symbols --codec-checkpoint codec.npz --attn-impl flash
     (--device cpu runs the kernels' plain versions on the CPU)
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from valle_tpu_torch import macros
from valle_tpu_torch.bin.infer import load_model_params
from valle_tpu_torch.codec import load_codec
from valle_tpu_torch.data import convert_audio, get_text_token_collater, read_wav, write_wav
from valle_tpu_torch.data.text_tokenizer import TextTokenizer, tokenize_text
from valle_tpu_torch.models import add_model_arguments, config_from_args, get_model
from valle_tpu_torch.parallel import dist
from valle_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_batch, shard_parameters_
from valle_tpu_torch.sample import generate
from valle_tpu_torch.utils import resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=str, required=True,
                   help="TSV: id<TAB>text[<TAB>prompt_wav<TAB>prompt_text]")
    add_model_arguments(p)
    p.set_defaults(dtype="bfloat16", kv_cache_dtype="int8")  # the serving defaults
    p.add_argument("--text-tokens", type=str, required=True)
    p.add_argument("--text-extractor", type=str, default="espeak")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--codec-checkpoint", type=str, default="",
                   help=".npz converted EnCodec weights; omit to emit codes only")
    p.add_argument("--codec-dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="decode-direction compute dtype (encoding is always float32)")
    p.add_argument("--output-dir", type=Path, default=Path("serve_out"))
    p.add_argument("--batch-size", type=int, default=256,
                   help="max sequences per batch; partial batches pad to powers of two")
    p.add_argument("--decode-batch", type=int, default=128, help="codec-decode chunk size")
    p.add_argument("--encode-batch", type=int, default=64, help="prompt-encode chunk size")
    p.add_argument("--length-buckets", type=str, default="256,512",
                   help="comma-separated max_new_tokens per bucket")
    p.add_argument("--frames-per-phoneme", type=float, default=8.0,
                   help="audio-frame estimate per phoneme for bucket routing")
    p.add_argument("--prompt-cap-frames", type=int, default=225,
                   help="prompt region size (3 s at 75 Hz)")
    p.add_argument("--quantize-weights", type=str, default="none",
                   choices=("none", "w8", "w8a8"))
    p.add_argument("--data-parallel", type=int, default=1,
                   help="ranks (one process per card) that split each batch's rows")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="ranks that split the decoder layers' heads and FFN features "
                   "(Megatron); --data-parallel x --tensor-parallel processes in all")
    p.add_argument("--dist-backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="collectives between the ranks (default: nccl on cuda, gloo on cpu; "
                   "gloo on cuda stages through the host, for ranks that share a card)")
    p.add_argument("--top-k", type=int, default=-100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without CUDA) | cpu")
    return p


def read_requests(path: str):
    rows = []
    for lineno, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            raise ValueError(f"{path}:{lineno}: expected id<TAB>text"
                             f"[<TAB>prompt_wav<TAB>prompt_text], got {line!r}")
        rid, text = parts[0], parts[1]
        wav = parts[2] if len(parts) > 2 and parts[2] != "-" else ""
        ptext = parts[3] if len(parts) > 3 and parts[3] != "-" else ""
        rows.append({"id": rid, "text": text, "wav": wav, "ptext": ptext})
    return rows


def _pad_to(arr, n, fill=0):
    out = np.full((n,), fill, arr.dtype if hasattr(arr, "dtype") else np.int32)
    out[: len(arr)] = arr
    return out


def _quantize_batch(n: int, full: int) -> int:
    """Smallest power of two >= n (at least 8), capped at ``full``."""
    b = 8
    while b < n and b < full:
        b *= 2
    return min(b, full)


def encode_prompts(requests, codec, pcap: int, encode_batch: int):
    """Encode the prompt wavs in batches grouped by their length once
    truncated to the prompt cap (``pcap`` frames x hop samples), so every
    prompt of at least the cap lands in one group.  Truncating before the
    encode equals encoding then truncating for every frame but the last
    (the encoder is causal)."""
    cap_samples = pcap * codec.cfg.hop_length
    wavs = {}
    for i, r in enumerate(requests):
        if not r["wav"]:
            continue
        wav, sr = read_wav(r["wav"])
        wav = convert_audio(wav, sr, codec.sample_rate, codec.channels)
        wavs[i] = np.asarray(wav)[..., :cap_samples]
    groups = defaultdict(list)
    for i, w in wavs.items():
        groups[w.shape[-1]].append(i)
    for _length, idxs in sorted(groups.items()):
        for j0 in range(0, len(idxs), encode_batch):
            chunk = idxs[j0: j0 + encode_batch]
            codes = codec.encode(np.stack([wavs[i] for i in chunk])).cpu().numpy()  # (n, T', Q)
            for j, i in enumerate(chunk):
                requests[i]["prompt"] = codes[j, :pcap]


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    world = args.data_parallel * args.tensor_parallel
    if world == 1:
        serve(args)
        return
    if args.device == "cuda":
        resolve_device(None)  # raises without CUDA before any rank starts
    if args.batch_size % args.data_parallel:
        raise ValueError("--batch-size must divide by --data-parallel")
    # one process per rank, on this host; a failed rank fails the run
    torch.multiprocessing.spawn(_serve_rank, args=(world, f"127.0.0.1:{dist.free_port()}", args),
                                nprocs=world, join=True)


def _serve_rank(rank: int, world: int, address: str, args) -> None:
    dist.initialize(address, world, rank, device=args.device, backend=args.dist_backend)
    try:
        serve(args)
    finally:
        dist.shutdown()


def serve(args) -> None:
    """Serve the requests of ``args`` as this process's rank of the
    ``--data-parallel`` x ``--tensor-parallel`` mesh (one rank without a
    process group): its rows of each batch on its heads; the first rank
    gathers the codes, decodes and writes."""
    mesh = Mesh(args.data_parallel, args.tensor_parallel)
    logging.basicConfig(level=logging.INFO if mesh.is_primary else logging.WARNING, force=True,
                        format="%(asctime)s %(levelname)s %(message)s")
    dev = dist.local_device(args.device)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    buckets = sorted(int(b) for b in args.length_buckets.split(","))

    cfg = config_from_args(args)
    if args.quantize_weights == "w8a8":
        cfg = cfg.replace(act_quant=True)
    variant = "vallf" if cfg.model_name.lower() in ("vall-f", "vallf") else "valle"
    # quantized on the host from the f32 weights, then cast and moved
    model = get_model(cfg, device=dev, quantize=args.quantize_weights != "none",
                      state_dict=load_model_params(args.checkpoint, cfg, variant))
    shard_parameters_(model, mesh)
    logging.info("model loaded%s",
                 " + quantized" if args.quantize_weights != "none" else "")
    tokenizer = TextTokenizer(backend=args.text_extractor)
    collater = get_text_token_collater(args.text_tokens)
    codec = (load_codec(args.codec_checkpoint, decode_dtype=args.codec_dtype, device=dev)
             if args.codec_checkpoint else None)
    frame_rate = codec.cfg.frame_rate if codec is not None else macros.AUDIO_FRAME_RATE
    hop = codec.cfg.hop_length if codec is not None else 320

    # host preprocessing: tokenize and encode the prompts
    requests = read_requests(args.requests)
    pcap = args.prompt_cap_frames
    if any(r["wav"] for r in requests):
        if codec is None:
            raise ValueError("--codec-checkpoint required for prompts")
        encode_prompts(requests, codec, pcap, args.encode_batch)
    for r in requests:
        full = f"{r['ptext']} {r['text']}".strip()
        toks, lens = collater([tokenize_text(tokenizer, full)])
        r["x"], r["x_len"] = np.asarray(toks[0]), int(lens[0])
        if cfg.prefix_mode in (2, 4) and r["ptext"]:
            _, el = collater([tokenize_text(tokenizer, r["ptext"].strip())])
            el = int(el[0])
            # SOS + synthesis text + EOS
            r["nar_x"] = np.concatenate([r["x"][:1], r["x"][el - 1:]])
            r["nar_len"] = r["x_len"] - (el - 2)
        else:
            r["nar_x"], r["nar_len"] = r["x"], r["x_len"]
        if "prompt" not in r:
            r["prompt"] = np.zeros((0, cfg.num_quantizers), np.int32)
        est = int(r["nar_len"] * args.frames_per_phoneme)  # bucket by estimated length
        r["bucket"] = next((b for b in buckets if est <= b), buckets[-1])
    logging.info("host preprocessing done (%d requests)", len(requests))

    # bucketed batched generation; the ranks of one data shard sample alike
    generator = torch.Generator(device=dev).manual_seed(args.seed + mesh.data_index)
    manifest = []
    wall0 = time.perf_counter()
    jobs = []
    for bucket in buckets:
        group = [r for r in requests if r["bucket"] == bucket]
        if group:
            logging.info(f"bucket max_new={bucket}: {len(group)} requests")
        for i in range(0, len(group), args.batch_size):
            jobs.append((group[i: i + args.batch_size], bucket))

    def dispatch(chunk, bucket):
        """Pad one batch, move it to the device and queue generate and the
        chunked decode; no host sync but generate's own per-step reads."""
        n = len(chunk)
        b = _quantize_batch(n, args.batch_size)
        b = -(-b // mesh.data) * mesh.data  # rows split over the data shards
        rnd = lambda v: max(32, -(-v // 32) * 32)  # noqa: E731
        s = rnd(max(r["x_len"] for r in chunk))
        sn = rnd(max(r["nar_len"] for r in chunk))
        pmax = max((len(r["prompt"]) for r in chunk), default=0)
        p = rnd(pmax) if pmax else 0
        pad = lambda k, w: np.stack(  # noqa: E731
            [_pad_to(np.asarray(r[k])[:w], w) for r in chunk]
            + [np.zeros((w,), np.int32)] * (b - n))
        x, nar_x = pad("x", s), pad("nar_x", sn)
        x_lens = _pad_to(np.asarray([r["x_len"] for r in chunk]), b, 1)
        nar_lens = _pad_to(np.asarray([r["nar_len"] for r in chunk]), b, 1)
        prompts = np.zeros((b, p, cfg.num_quantizers), np.int64)
        plens = np.ones((b,), np.int64)
        for j, r in enumerate(chunk):
            prompts[j, : len(r["prompt"])] = r["prompt"]
            plens[j] = len(r["prompt"])
        put = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()  # noqa: E731
        rows = {"x": put(x), "x_lens": put(x_lens), "prompt_codes": put(prompts),
                "prompt_lens": put(plens), "nar_text": put(nar_x), "nar_text_lens": put(nar_lens)}
        out = generate(model, **shard_batch(rows, mesh), generator=generator,
                       top_k=args.top_k, temperature=args.temperature, max_new_tokens=bucket)
        out = {k: gather_rows(v, mesh) for k, v in out.items()}
        wavs = None
        if codec is not None and mesh.is_primary:
            # the decoder is causal, so trimming the padded output to L * hop
            # samples per request equals an unpadded decode
            wavs = [codec.decode(out["codes"][j: j + args.decode_batch], out_int16=True)
                    for j in range(0, n, args.decode_batch)]
        return {"chunk": chunk, "bucket": bucket, "out": out, "wavs": wavs,
                "t0": time.perf_counter()}

    writers = ThreadPoolExecutor(max_workers=8)

    def finish(job):
        """Fetch and write one dispatched job (while the next job's device
        work runs)."""
        chunk, bucket = job["chunk"], job["bucket"]
        n = len(chunk)
        codes = job["out"]["codes"][:n].cpu().numpy()
        lengths = job["out"]["lengths"][:n].cpu().numpy()
        wavs = (np.concatenate([w.cpu().numpy() for w in job["wavs"]])[:n]
                if job["wavs"] is not None else None)
        dt = time.perf_counter() - job["t0"]
        logging.info(f"  batch of {n} (max_new={bucket}): {dt:.2f}s device+fetch "
                     f"({lengths.sum() / frame_rate / dt:.1f} audio-s/s)")
        futures = []
        for j, (r, c, length) in enumerate(zip(chunk, codes, lengths)):
            length = int(length)
            np.save(args.output_dir / f"{r['id']}_codes.npy", c[:length].astype(np.int32))
            manifest.append({"id": r["id"], "frames": length, "seconds": length / frame_rate,
                             "bucket": bucket})
            if wavs is not None and length > 0:
                futures.append(writers.submit(
                    write_wav, str(args.output_dir / f"{r['id']}.wav"),
                    wavs[j][..., : length * hop], codec.sample_rate))
        for f in futures:
            f.result()

    try:
        pending = None
        for chunk, bucket in jobs:
            t_d = time.perf_counter()
            job = dispatch(chunk, bucket)
            logging.info("  dispatched batch of %d (max_new=%d) in %.2fs host",
                         len(chunk), bucket, time.perf_counter() - t_d)
            if pending is not None and mesh.is_primary:
                finish(pending)  # overlaps the job just dispatched
            pending = job
        if pending is not None and mesh.is_primary:
            finish(pending)
    finally:
        writers.shutdown()
    if not mesh.is_primary:
        return

    total_s = sum(m["seconds"] for m in manifest)
    wall = time.perf_counter() - wall0
    with open(args.output_dir / "manifest.jsonl", "w") as f:
        for m in manifest:
            f.write(json.dumps(m) + "\n")
    logging.info(f"served {len(manifest)} requests, {total_s:.1f} audio-s in {wall:.1f}s "
                 f"({total_s / max(wall, 1e-9):.1f} audio-s/s wav-out incl. host pre/post)")


if __name__ == "__main__":
    main()
