"""Zero-shot TTS inference CLI: the twin of ``valle_tpu/bin/infer.py``.

Text (and the prompt's text) through the text frontend, the prompt wavs
through the codec's encoder, ``sample.generate`` (or ``sample.continual``),
and the codes through the codec's decoder to wavs, on the card unless
``--device cpu`` is given.  For each text it writes ``{n}_codes.npy`` and,
with a codec, ``{n}.wav`` to ``--output-dir`` (``continual_codes.npy`` /
``continual.wav`` under ``--continual``).

Checkpoints (``--checkpoint``):
  - a reference ``.pt`` (``{"model": state_dict}``, and ``"model_avg"``
    under ``--use-averaged-model``): the port's parameter names are the
    reference's, and ``utils/convert_reference.py`` selects the keys the
    model takes, as the JAX conversion does (extra keys and the tied NAR
    heads of the file are skipped);
  - an ``.npz`` of flattened flax params, through ``utils/bridge.py``.
An Orbax directory needs JAX's checkpoint stack and is refused.
``--quantize-weights w8|w8a8`` quantizes the decoder weights to int8 on the
host, from the f32 checkpoint, then moves the int8 weights and their f32
scales to the card (``nn/qdense.py``; ``w8a8`` also quantizes activations).
``--codec-checkpoint`` is the ``.npz`` that ``python -m
valle_tpu_torch.bin.convert_codec`` writes from the public EnCodec weights.
A ``.pt`` of f32 weights (the train CLI's, in f32 or bf16) is cast to
``--dtype`` as it loads.

Run: python -m valle_tpu_torch.bin.infer --text "..." --text-prompts "..."
     --audio-prompts p.wav --checkpoint model.pt --codec-checkpoint codec.npz
     --text-extractor chars --attn-impl flash
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from valle_tpu_torch.codec import load_codec
from valle_tpu_torch.data import convert_audio, get_text_token_collater, read_wav, write_wav
from valle_tpu_torch.data.text_tokenizer import TextTokenizer, tokenize_text
from valle_tpu_torch.models import add_model_arguments, config_from_args, get_model, str2bool
from valle_tpu_torch.sample import continual, generate
from valle_tpu_torch.utils import resolve_device, unflatten_tree
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax
from valle_tpu_torch.utils.convert_reference import select_state_dict


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--text-prompts", type=str, default="",
                        help="Text prompts separated by |.")
    parser.add_argument("--audio-prompts", type=str, default="",
                        help="Audio prompt wavs separated by |.")
    parser.add_argument("--text", type=str,
                        default="To get up and running quickly just follow the steps below.",
                        help="Text to be synthesized; | separates multiple.")
    add_model_arguments(parser)
    parser.add_argument("--text-tokens", type=str,
                        default="data/tokenized/unique_text_tokens.k2symbols")
    parser.add_argument("--text-extractor", type=str, default="espeak",
                        help="espeak | pypinyin | pypinyin_initials_finals | chars")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--codec-checkpoint", type=str, default="",
                        help=".npz of converted EnCodec weights")
    parser.add_argument("--output-dir", type=Path, default=Path("infer/demo"))
    parser.add_argument("--top-k", type=int, default=-100)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=1024)
    parser.add_argument("--continual", type=str2bool, default=False)
    parser.add_argument("--use-averaged-model", type=str2bool, default=False,
                        help="load the running model average saved beside the raw "
                        "weights (\"model_avg\" of a .pt) instead of the raw weights")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quantize-weights", type=str, default="none",
                        choices=("none", "w8", "w8a8"),
                        help="int8 decoder weights (W8), optionally with per-row "
                        "int8 activations (W8A8); see valle_tpu_torch/nn/qdense.py")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (raises without CUDA) | cpu")
    return parser


def load_model_params(path: str, cfg, variant: str, use_averaged: bool = False) -> dict:
    """The model weights of ``path`` as the port's state dict (CPU tensors);
    a ``.pt`` through the reference key selection
    (``utils/convert_reference.py``)."""
    p = Path(path)
    if p.suffix == ".npz":
        if use_averaged:
            raise ValueError(".npz checkpoints carry no averaged model")
        with np.load(p, allow_pickle=False) as f:
            params = unflatten_tree({k: f[k] for k in f.files})
        sd = numpy_state_dict_from_jax(params, cfg, variant)
        return {k: torch.from_numpy(v) for k, v in sd.items()}
    if p.suffix == ".pt":
        sd = torch.load(p, map_location="cpu", weights_only=False)
        if use_averaged:
            sd = sd.get("model_avg")
            if sd is None:
                raise ValueError(f"{path} has no model_avg (trained without averaging)")
        elif "model" in sd:
            sd = sd["model"]
        return select_state_dict({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)},
                                 cfg, variant)
    raise ValueError(
        f"{path}: not an .npz or .pt checkpoint. An Orbax checkpoint directory needs JAX's "
        "checkpoint stack, which the port does not import; export its params as an .npz of "
        "flattened flax params (keys 'a/b/c') or a .pt state dict")


def encode_prompt_wavs(args, codec, num_quantizers: int) -> np.ndarray:
    """(1, P, Q) codes of the prompt wavs, concatenated along time; a
    zero-length prompt without ``--audio-prompts``."""
    if not args.audio_prompts:
        # promptless generation: the model conditions on the text alone
        return np.zeros((1, 0, num_quantizers), np.int64)
    if codec is None:
        raise ValueError("--codec-checkpoint required with audio prompts")
    segs = []
    for audio_file in args.audio_prompts.split("|"):
        wav, sr = read_wav(audio_file)
        wav = convert_audio(wav, sr, codec.sample_rate, codec.channels)
        segs.append(codec.encode(wav[None])[0].cpu().numpy())  # (T', Q)
    return np.concatenate(segs, axis=0)[None]


def _write(args, codec, codes: np.ndarray, name: str) -> None:
    if codec is not None:
        wav = codec.decode(codes[None])[0].cpu().numpy()
        path = args.output_dir / f"{name}.wav"
        write_wav(str(path), wav, codec.sample_rate)
        logging.info(f"wrote {path}")
    np.save(args.output_dir / f"{name}_codes.npy", codes.astype(np.int32))


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    dev = resolve_device(None if args.device == "cuda" else args.device)
    args.output_dir.mkdir(parents=True, exist_ok=True)

    cfg = config_from_args(args)
    if args.quantize_weights == "w8a8":
        cfg = cfg.replace(act_quant=True)
    variant = "vallf" if cfg.model_name.lower() in ("vall-f", "vallf") else "valle"
    # quantized on the host from the f32 weights, then cast and moved
    model = get_model(cfg, device=dev, quantize=args.quantize_weights != "none",
                      state_dict=load_model_params(args.checkpoint, cfg, variant,
                                                   use_averaged=args.use_averaged_model))

    text_tokenizer = TextTokenizer(backend=args.text_extractor)
    collater = get_text_token_collater(args.text_tokens)
    codec = load_codec(args.codec_checkpoint, device=dev) if args.codec_checkpoint else None

    text_prompts = " ".join(args.text_prompts.split("|"))
    prompt_codes = torch.from_numpy(encode_prompt_wavs(args, codec, cfg.num_quantizers)).to(dev)

    def tokens_of(text):
        tokens, lens = collater([tokenize_text(text_tokenizer, text)])
        return torch.from_numpy(tokens).to(dev), torch.from_numpy(lens).long().to(dev)

    if args.continual:
        # keep codebook 1 of the prompt codes and regenerate codebooks 2..Q past
        # the first min(T/2, 3 s); only the prompt text conditions the NAR passes
        if not args.audio_prompts:
            raise ValueError("--continual requires --audio-prompts")
        if args.text.strip() != "":
            raise ValueError("--continual requires empty --text")
        x, x_lens = tokens_of(text_prompts)
        out = continual(model, x, x_lens, prompt_codes)
        length = int(out["lengths"][0])
        codes = out["codes"][0, :length].cpu().numpy()  # (T', Q)
        logging.info(f"continual: {length} frames ({length / 75:.2f}s)")
        _write(args, codec, codes, "continual")
        return

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    for n, text in enumerate(args.text.split("|")):
        logging.info(f"synthesize text: {text}")
        x, x_lens = tokens_of(f"{text_prompts} {text}".strip())
        nar_text, nar_text_lens = x, x_lens
        if cfg.prefix_mode in (2, 4) and text_prompts:
            _, enroll_lens = tokens_of(text_prompts.strip())
            el = int(enroll_lens[0])
            # SOS + synthesis text + EOS
            nar_text = torch.cat([x[:, :1], x[:, el - 1:]], 1)
            nar_text_lens = x_lens - (el - 2)
        out = generate(model, x, x_lens, prompt_codes, generator=generator, top_k=args.top_k,
                       temperature=args.temperature, max_new_tokens=args.max_new_tokens,
                       nar_text=nar_text, nar_text_lens=nar_text_lens)
        length = int(out["lengths"][0])
        codes = out["codes"][0, :length].cpu().numpy()  # (T', Q)
        logging.info(f"generated {length} frames ({length / 75:.2f}s)")
        _write(args, codec, codes, str(n))


if __name__ == "__main__":
    main()
