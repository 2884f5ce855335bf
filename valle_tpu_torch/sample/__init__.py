"""Batched zero-shot generation: the twin of ``valle_tpu/sample/__init__.py``.

  - The AR loop samples codebook-1 tokens with top-k / top-p / temperature
    until the triple stop condition (argmax EOS | sampled EOS | length > 16x
    the text length, or a per-request ``stop_lens`` cap), discarding the
    stopping sample.
  - Seven NAR passes then refine codebooks 2..8 greedily, accumulating the
    embeddings of the earlier stages' samples.

As in the JAX package, prompts are right-aligned in a fixed prompt region so
every sequence's next-token column is the same across the batch, and the KV
cache grows in 128-step segments.  JAX runs the loop as a ``lax.while_loop``;
here it is a Python loop over steps (a CUDA graph of the step is later work),
and a ``torch.Generator`` takes the place of the JAX key.  ``continual``
keeps codebook 1 of given codes and regenerates the others with the NAR
passes; ``nar_refine`` runs the NAR passes over given codebook-1 tokens
(the continuous-batching scheduler's drain, ``sample/continuous.py``).

Under tensor parallelism (a model sliced by
``parallel.mesh.shard_parameters_``) every rank of a model group runs the
loop on the same rows with its heads: the layers' reductions leave equal
logits on all of them, so generators seeded alike sample the same tokens,
``finished`` agrees, and the ranks take part in the same collectives until
the loop ends.  The KV cache holds the local heads (its shape comes from
the prefill's K/V).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from valle_tpu_torch.nn.attention import quantize_kv
from valle_tpu_torch.ops import masks as mask_ops
from valle_tpu_torch.ops.sampling import topk_sampling

CHUNK = 128  # KV-cache growth step, in decode steps


def _right_align(tokens: torch.Tensor, lens: torch.Tensor, cap: int, bos_id=None):
    """(B, P) tokens with per-sequence lens -> (B, cap (+1 with BOS)) right-aligned.

    Returns (aligned_tokens, positions, valid): positions are the per-sequence
    audio positions (BOS at 0, code i at i + has_bos) and valid marks the real
    (non-filler) slots.
    """
    b, p = tokens.shape
    has_bos = int(bos_id is not None)
    cap_total = cap + has_bos
    slot = torch.arange(cap_total, device=tokens.device)[None, :]
    shift = cap_total - lens.long()[:, None] - has_bos  # first real slot
    rel = slot - shift - has_bos  # index into tokens; -1 = BOS slot
    if p > 0:
        vals = tokens.gather(1, rel.clamp(0, p - 1))
    else:
        vals = torch.zeros((b, cap_total), dtype=tokens.dtype, device=tokens.device)
    if has_bos:
        vals = torch.where(rel == -1, torch.full_like(vals, bos_id), vals)
        valid = rel >= -1
    else:
        valid = rel >= 0
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    positions = (rel + has_bos).clamp(min=0)
    return vals, positions, valid


def _prefill_kv(model, x, x_lens, prompt_codes, prompt_lens):
    """AR prefill over [text ; right-aligned prompt].

    The mask goes in as an ``AttnMaskSpec``: the key-padding row plus
    ``prefix_s = S`` (VALL-E) or ``0`` (VALL-F), not a merged dense bias.
    Returns (last_logits, (k, v) each (L, B, Tpre, H, Dh), memory-or-None,
    key_pad_pre (B, Tpre), mem_bias, tpre)."""
    cfg = model.cfg
    s = x.shape[1]
    p = prompt_codes.shape[1]
    x_mask = mask_ops.make_pad_mask(x_lens, s)
    mem_bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])
    ar_tokens, ar_positions, ar_valid = _right_align(
        prompt_codes[..., 0].long(), prompt_lens, p,
        bos_id=cfg.bos_id if cfg.prepend_bos else None,
    )
    if model.variant == "vallf":
        # VALL-F caches only the audio side; text is cross-attention memory
        key_pad_pre = ~ar_valid
        prefix_s = 0
    else:
        key_pad_pre = torch.cat([x_mask, ~ar_valid], 1)
        prefix_s = s
    spec = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(key_pad_pre), prefix_s=prefix_s)
    last_logits, kv, memory = model.ar_prefill(x, ar_tokens, ar_positions, spec, mem_bias)
    return last_logits, kv, memory, key_pad_pre, mem_bias, key_pad_pre.shape[1]


def _make_cache(kv_cache_dtype: str, k_pre: torch.Tensor, v_pre: torch.Tensor, width: int):
    """Stacked decode cache of ``width`` columns holding the prefill K/V:
    (kc, vc) in the model dtype, or (kc, vc, ks, vs) int8 with f32 scales."""
    n_layers, b, tpre, h, dh = k_pre.shape
    if kv_cache_dtype == "int8":
        cache = (
            k_pre.new_zeros((n_layers, b, width, h, dh), dtype=torch.int8),
            k_pre.new_zeros((n_layers, b, width, h, dh), dtype=torch.int8),
            k_pre.new_zeros((n_layers, b, width, h), dtype=torch.float32),
            k_pre.new_zeros((n_layers, b, width, h), dtype=torch.float32),
        )
        k8, ks0 = quantize_kv(k_pre)
        v8, vs0 = quantize_kv(v_pre)
        for buf, val in zip(cache, (k8, v8, ks0, vs0)):
            buf[:, :, :tpre] = val
        return cache
    cache = (k_pre.new_zeros((n_layers, b, width, h, dh)),
             v_pre.new_zeros((n_layers, b, width, h, dh)))
    cache[0][:, :, :tpre] = k_pre
    cache[1][:, :, :tpre] = v_pre
    return cache


def _grow_cache(cache, grow: int):
    """Append ``grow`` zero columns to every buffer of the cache (axis 2)."""
    out = []
    for c in cache:
        pad = c.new_zeros(c.shape[:2] + (grow,) + c.shape[3:])
        out.append(torch.cat([c, pad], 2))
    return tuple(out)


def _decode_bias(pre_valid: torch.Tensor, width: int, t: int) -> torch.Tensor:
    """(B, 1, 1, width) additive bias of decode step t: the valid prefill
    columns plus the generated columns [tpre, tpre + t]."""
    b, tpre = pre_valid.shape
    slot = torch.arange(width, device=pre_valid.device)[None, :]
    valid = torch.cat([pre_valid, pre_valid.new_zeros((b, width - tpre))], 1)
    valid = valid | ((slot >= tpre) & (slot <= tpre + t))
    return mask_ops.mask_to_bias(~valid[:, None, None, :])


@torch.inference_mode()
def generate(
    model,
    x: torch.Tensor,
    x_lens: torch.Tensor,
    prompt_codes: torch.Tensor,
    prompt_lens: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    top_k: int = -100,
    top_p: float = 1.0,
    temperature: float = 1.0,
    max_new_tokens: int = 1024,
    forbid_eos: bool = False,
    stop_lens: Optional[torch.Tensor] = None,
    nar_text: Optional[torch.Tensor] = None,
    nar_text_lens: Optional[torch.Tensor] = None,
    ragged_decode: bool = False,
) -> Dict[str, torch.Tensor]:
    """Batched zero-shot TTS generation on the model's device.

    Args:
      x: (B, S) phoneme ids; x_lens: (B,) lengths.
      prompt_codes: (B, P, Q) EnCodec codes of the acoustic prompt.
      prompt_lens: (B,) valid prompt lengths (default: full P).
      generator: the random stream of the sampler (on the model's device).
      stop_lens: optional (B,) per-sequence caps: sequence i is finished
        once it has stop_lens[i] tokens even if EOS never fires.
      nar_text / nar_text_lens: text for the NAR passes when it differs
        from ``x`` (prefix modes 2/4).
      ragged_decode: route each decode step's cache read through kernel 1:
        finished slots read nothing, live slots read [0, tpre + t + 1).

    Returns {"codes": (B, max_new, Q) int64, "lengths": (B,) int64}.
    """
    cfg = model.cfg
    dev = next(model.parameters()).device
    as_dev = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    x, x_lens, prompt_codes = as_dev(x), as_dev(x_lens), as_dev(prompt_codes)
    prompt_lens, stop_lens = as_dev(prompt_lens), as_dev(stop_lens)
    b, p = x.shape[0], prompt_codes.shape[1]
    eos = cfg.eos_id
    bos = int(cfg.prepend_bos)
    if prompt_lens is None:
        prompt_lens = torch.full((b,), p, dtype=torch.long, device=dev)
    if nar_text is None:
        nar_text, nar_text_lens = x, x_lens
    else:
        nar_text, nar_text_lens = as_dev(nar_text), as_dev(nar_text_lens)

    last_logits, (k_pre, v_pre), memory, key_pad_pre, mem_bias, tpre = _prefill_kv(
        model, x, x_lens, prompt_codes, prompt_lens)
    chunk = min(CHUNK, max_new_tokens)
    cache = _make_cache(cfg.kv_cache_dtype, k_pre, v_pre, tpre + chunk)
    del k_pre, v_pre
    pre_valid = ~key_pad_pre

    logits = last_logits
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    gen_len = torch.full((b,), max_new_tokens, dtype=torch.long, device=dev)
    t = 0
    while t < max_new_tokens and not bool(finished.all()):
        width = cache[0].shape[2]
        if width < tpre + t + 1:  # grow by the next segment
            cache = _grow_cache(cache, min(chunk, max_new_tokens - (width - tpre)))
            width = cache[0].shape[2]
        if forbid_eos:
            # benchmark / min-length mode: EOS can never be sampled or win
            logits = logits.clone()
            logits[:, eos] = -1e9
        samples = topk_sampling(logits, top_k=top_k, top_p=top_p,
                                temperature=temperature, generator=generator)
        argmax_eos = torch.argmax(logits, dim=-1) == eos
        too_long = (t + bos) > x_lens * 16
        if stop_lens is not None:
            too_long = too_long | (t >= stop_lens)
        stop_now = argmax_eos | (samples == eos) | too_long
        gen_len = torch.where(stop_now & ~finished, t, gen_len)
        finished = finished | stop_now
        tok = torch.where(finished, eos, samples)
        tokens[:, t] = tok

        positions = (prompt_lens + bos + t)[:, None]
        bias = _decode_bias(pre_valid, width, t)
        kv_lengths = None
        if ragged_decode:
            # finished slots read nothing (their output is forced to EOS and
            # discarded); live slots read [0, tpre + t] inclusive
            kv_lengths = torch.where(finished, 0, tpre + t + 1).to(torch.int32)
        logits, cache = model.ar_decode_step(
            tok[:, None], positions, cache, tpre + t, bias, memory, mem_bias,
            kv_lengths=kv_lengths,
        )
        t += 1

    gen_valid = torch.arange(max_new_tokens, device=dev)[None, :] < gen_len[:, None]
    tokens = torch.where(gen_valid, tokens, torch.zeros_like(tokens))
    if cfg.num_quantizers == 1:
        return {"codes": tokens[..., None], "lengths": gen_len}
    codes = _nar_refine(model, nar_text, nar_text_lens, prompt_codes, prompt_lens,
                        tokens, gen_len)
    return {"codes": codes, "lengths": gen_len}


@torch.inference_mode()
def nar_refine(model, nar_text, nar_text_lens, prompt_codes, prompt_lens, tokens, gen_len):
    """NAR refinement of the AR codebook-1 ``tokens`` (B, T_gen) with
    ``gen_len`` (B,) valid tokens into (B, T_gen, Q) codes, on the model's
    device (the JAX package's jitted ``nar_refine``)."""
    dev = next(model.parameters()).device
    return _nar_refine(model, *(torch.as_tensor(a, device=dev).long() for a in (
        nar_text, nar_text_lens, prompt_codes, prompt_lens, tokens, gen_len)))


def _nar_refine(model, nar_text, nar_text_lens, prompt_codes, prompt_lens, tokens, gen_len):
    """NAR refinement of the AR codebook-1 ``tokens`` (B, T_gen) into
    (B, T_gen, Q) codes: Q-1 passes, each under a key-padding-only mask."""
    cfg = model.cfg
    q = cfg.num_quantizers
    p = prompt_codes.shape[1]
    dev = tokens.device
    max_new_tokens = tokens.shape[1]
    gen_valid = torch.arange(max_new_tokens, device=dev)[None, :] < gen_len[:, None]

    sn = nar_text.shape[1]
    nar_x_mask = mask_ops.make_pad_mask(nar_text_lens, sn)
    x_emb = model.nar_text_encode(nar_text)
    pr_tokens, pr_positions, pr_valid = _right_align(
        prompt_codes[..., 0].long(), prompt_lens, p)
    gen_positions = prompt_lens.long()[:, None] + torch.arange(max_new_tokens, device=dev)[None, :]
    positions = torch.cat([pr_positions, gen_positions], 1)
    y_pad = torch.cat([~pr_valid, ~gen_valid], 1)
    nar_mem_bias = mask_ops.mask_to_bias(nar_x_mask[:, None, None, :])
    if model.variant == "vallf":
        bias = mask_ops.mask_to_bias(y_pad[:, None, None, :])
        gen_start = p
    else:
        key_pad = torch.cat([nar_x_mask, y_pad], 1)
        bias = mask_ops.mask_to_bias(key_pad[:, None, None, :])
        gen_start = sn + p

    y_emb = model.nar_embed0(torch.cat([pr_tokens, tokens], 1))

    def prompt_rest(j):
        pc, _, _ = _right_align(prompt_codes[..., j + 1].long(), prompt_lens, p)
        return model.nar_embed_rest(j, pc) * pr_valid[..., None]

    if cfg.prefix_mode != 0:
        # fold all prompt codebooks in up front
        for j in range(q - 1):
            y_emb[:, :p] += prompt_rest(j)

    codes = [tokens]
    for i in range(q - 1):
        samples = model.nar_forward_stage(i, y_emb, positions, x_emb, bias, gen_start,
                                          nar_mem_bias)
        samples = torch.where(gen_valid, samples, torch.zeros_like(samples))
        codes.append(samples)
        if i < q - 2:
            if cfg.prefix_mode == 0:
                y_emb[:, :p] += prompt_rest(i)
            y_emb[:, p:] += model.nar_embed_rest(i, samples) * gen_valid[..., None]
    return torch.stack(codes, -1)


@torch.inference_mode()
def continual(model, x: torch.Tensor, x_lens: torch.Tensor, y: torch.Tensor,
              y_lens: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Continual task: keep codebook 1 of the codes ``y`` (B, T, Q), take
    each row's first ``min(y_lens // 2, 225)`` frames (3 s) as its acoustic
    prompt and regenerate codebooks 2..Q of the rest with the NAR passes
    (greedy).

    The prefix is taken per row from its true length, not from the padded
    width.  Each returned row is shifted left so that its regenerated
    region starts at index 0: ``lengths = y_lens - prefix``.

    Returns {"codes": (B, T, Q) int64, "lengths": (B,) int64}.
    """
    cfg = model.cfg
    dev = next(model.parameters()).device
    x, x_lens, y = (torch.as_tensor(a, device=dev) for a in (x, x_lens, y))
    b, t, q = y.shape
    y = y.long()
    if y_lens is None:
        y_lens = torch.full((b,), t, dtype=torch.long, device=dev)
    y_lens = torch.as_tensor(y_lens, device=dev).long()
    plen = torch.clamp(y_lens // 2, max=3 * 75)  # (B,)

    s = x.shape[1]
    x_mask = mask_ops.make_pad_mask(x_lens, s)
    x_emb = model.nar_text_encode(x)
    y0 = y[..., 0]
    y_emb = model.nar_embed0(y0)
    y_mask = mask_ops.make_pad_mask(y_lens, t)
    nar_mem_bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])
    if model.variant == "vallf":
        bias = mask_ops.mask_to_bias(y_mask[:, None, None, :])
        gen_start = 0
    else:
        key_pad = torch.cat([x_mask, y_mask], 1)
        bias = mask_ops.mask_to_bias(key_pad[:, None, None, :])
        gen_start = s

    steps = torch.arange(t, device=dev)[None, :]
    positions = steps.expand(b, t)
    prefix_sel = (steps < plen[:, None])[..., None]

    def add_prompt(i):
        return model.nar_embed_rest(i, y[:, :, i + 1]) * prefix_sel

    if cfg.prefix_mode != 0:
        for j in range(q - 1):
            y_emb = y_emb + add_prompt(j)

    lengths = torch.clamp(y_lens - plen, min=0)
    # per-row left shift: output index j <- input position plen_b + j
    shift_idx = torch.clamp(steps + plen[:, None], max=t - 1)
    out_valid = steps < lengths[:, None]

    def out_row(vals):  # (B, t) predictions at audio positions -> shifted
        return torch.where(out_valid, vals.gather(1, shift_idx), torch.zeros_like(vals))

    codes = [out_row(y0)]
    gen_sel = (steps >= plen[:, None])[..., None]
    for i in range(q - 1):
        samples = model.nar_forward_stage(i, y_emb, positions, x_emb, bias, gen_start,
                                          nar_mem_bias)
        codes.append(out_row(samples))
        if i < q - 2:
            if cfg.prefix_mode == 0:
                y_emb = y_emb + add_prompt(i)
            y_emb = y_emb + model.nar_embed_rest(i, samples) * gen_sel
    return {"codes": torch.stack(codes, -1), "lengths": lengths}
