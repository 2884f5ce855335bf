"""Offline dataset tokenization: wavs and transcripts -> phoneme tokens,
EnCodec codes (or BigVGAN log-mel features) and the symbol table.  The twin
of ``valle_tpu/bin/tokenize_dataset.py``, with every flag of its parser and
the same defaults, plus ``--device``; it writes the same manifests, shards
and symbol table.

The input is a TSV of ``utt_id\\twav_path\\ttext`` lines.  Encodec mode
encodes batches of ``--batch-frames`` wavs, zero-padded to the longest, on
the card with the port's codec (``valle_tpu_torch.codec``; its
convolutions, LSTM and RVQ search are PyTorch ops, as they are XLA ops in the
JAX package) and cuts each utterance's codes to ``ceil(n / 320)`` frames.
Fbank mode writes float16 features into VSF1 shards, computed on the host
in numpy.  Both write ``manifest_{split}.jsonl.gz`` and extend
``unique_text_tokens.k2symbols`` across splits, so ids already in earlier
manifests keep their values.

Run: python -m valle_tpu_torch.bin.tokenize_dataset --tsv train.tsv \
        --output-dir data/tokenized --split train --codec-checkpoint codec.npz
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from pathlib import Path

import numpy as np

from valle_tpu_torch import macros
from valle_tpu_torch.data import CodeShardWriter, Manifest, SymbolTable, convert_audio, read_wav
from valle_tpu_torch.data.text_tokenizer import TextTokenizer, tokenize_text
from valle_tpu_torch.utils import resolve_device


def _load_or_new_symbols(out_dir: Path) -> SymbolTable:
    """The symbol table of earlier splits, extended by this one (ids already
    in earlier manifests stay), or a new one."""
    path = out_dir / "unique_text_tokens.k2symbols"
    if path.exists():
        return SymbolTable.from_file(path)
    return SymbolTable()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", type=Path, required=True,
                   help="utt_id\\twav_path\\ttext per line")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--codec-checkpoint", type=str, default="",
                   help="required for --audio-extractor Encodec")
    p.add_argument("--audio-extractor", type=str, default="Encodec",
                   choices=["Encodec", "Fbank"],
                   help="Encodec codes (VALL-E) or BigVGAN fbank features "
                   "(Transformer baseline)")
    p.add_argument("--text-extractor", type=str, default="espeak")
    p.add_argument("--batch-frames", type=int, default=64,
                   help="wavs encoded per batch on the card (zero-padded to the longest)")
    p.add_argument("--shard-format", type=str, default="vsh", choices=["vsh", "h5"],
                   help="vsh = packed shards for the native C++ loader")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without CUDA) | cpu")
    return p


def _record(utt_id, text, tokens, duration, shard, key) -> dict:
    return {"id": utt_id, "text": text, "tokens": tokens, "duration": duration,
            "shard": shard, "key": key}


def _fbank_main(args, rows, tokenizer) -> dict:
    """Fbank mode: BigVGAN log-mel features into float16 (VSF1) shards for
    the Transformer TTS baseline."""
    from valle_tpu_torch.data.fbank import get_fbank_extractor

    extractor = get_fbank_extractor()
    symbols = _load_or_new_symbols(args.output_dir)
    records = []
    audio_s = 0.0
    with CodeShardWriter(args.output_dir, prefix=f"fbank_{args.split}", fmt="vsf",
                         num_quantizers=macros.NUM_MEL_BINS) as w:
        for i, (utt_id, wav_path, text) in enumerate(rows):
            wav, sr = read_wav(wav_path)
            wav = convert_audio(wav, sr, macros.SAMPLE_RATE, 1)
            feats = extractor.extract(wav[0], macros.SAMPLE_RATE)  # (T, 100)
            shard, key = w.write(utt_id, feats.astype(np.float16))
            tokens = tokenize_text(tokenizer, text)
            for s in tokens:
                symbols.add(s)
            rec = _record(utt_id, text, tokens, wav.shape[-1] / macros.SAMPLE_RATE, shard, key)
            rec["feature_dim"] = macros.NUM_MEL_BINS
            records.append(rec)
            audio_s += rec["duration"]
            if i % 200 == 0:
                logging.info(f"{i + 1}/{len(rows)}")
    Manifest.save(iter(records), args.output_dir / f"manifest_{args.split}.jsonl.gz")
    symbols.to_file(args.output_dir / "unique_text_tokens.k2symbols")
    logging.info(f"wrote fbank manifest + symbols to {args.output_dir}")
    return {"utterances": len(records), "audio_seconds": audio_s}


def main(argv=None) -> dict:
    """Tokenize as the flags say; returns the utterance count, the seconds
    of audio and, in Encodec mode, the seconds spent encoding (host reads
    and padding included) and the batches encoded."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    args.output_dir.mkdir(parents=True, exist_ok=True)

    tokenizer = TextTokenizer(backend=args.text_extractor)
    rows = []
    for line in args.tsv.read_text().strip().split("\n"):
        utt_id, wav_path, text = line.split("\t", 2)
        rows.append((utt_id, wav_path, text))
    logging.info(f"{len(rows)} utterances")

    if args.audio_extractor == "Fbank":
        return _fbank_main(args, rows, tokenizer)

    from valle_tpu_torch.codec import load_codec

    if not args.codec_checkpoint:
        raise ValueError("--codec-checkpoint is required for --audio-extractor Encodec")
    codec = load_codec(args.codec_checkpoint, device=dev)

    symbols = _load_or_new_symbols(args.output_dir)
    records = []
    audio_s = 0.0
    t0 = time.perf_counter()
    n_batches = 0
    with CodeShardWriter(args.output_dir, prefix=f"codes_{args.split}",
                         fmt=args.shard_format) as w:
        for i in range(0, len(rows), args.batch_frames):
            chunk = rows[i: i + args.batch_frames]
            wavs = []
            for _, wav_path, _ in chunk:
                wav, sr = read_wav(wav_path)
                wavs.append(convert_audio(wav, sr, codec.sample_rate, codec.channels)[0])
            batch = np.zeros((len(chunk), 1, max(x.shape[-1] for x in wavs)), np.float32)
            for k, x in enumerate(wavs):
                batch[k, 0, : x.shape[-1]] = x
            codes = codec.encode(batch).cpu().numpy()  # (B, T', Q)
            n_batches += 1
            for k, (utt_id, _, text) in enumerate(chunk):
                n_frames = math.ceil(wavs[k].shape[-1] / macros.AUDIO_HOP)
                shard, key = w.write(utt_id, codes[k, :n_frames])
                tokens = tokenize_text(tokenizer, text)
                for s in tokens:
                    symbols.add(s)
                duration = wavs[k].shape[-1] / codec.sample_rate
                records.append(_record(utt_id, text, tokens, duration, shard, key))
                audio_s += duration
            if (i // args.batch_frames) % 50 == 0:
                logging.info(f"{i + len(chunk)}/{len(rows)}")
    encode_s = time.perf_counter() - t0

    Manifest.save(iter(records), args.output_dir / f"manifest_{args.split}.jsonl.gz")
    symbols.to_file(args.output_dir / "unique_text_tokens.k2symbols")
    logging.info(f"wrote manifest + symbols to {args.output_dir} ({audio_s:.1f} s of audio "
                 f"in {encode_s:.2f} s)")
    return {"utterances": len(records), "audio_seconds": audio_s, "encode_seconds": encode_s,
            "batches": n_batches}


if __name__ == "__main__":
    main()
