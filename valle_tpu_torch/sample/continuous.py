"""Continuous batching: slot-refill AR decoding over a persistent KV cache,
the twin of ``valle_tpu/sample/continuous.py``.

The bucket scheduler (``bin/serve.py``, ``generate``) serves fixed batches,
each gated by its longest sequence.  This one keeps the batch full: the AR
loop runs in ``chunk``-step segments, and at each segment boundary the host
harvests the finished slots and re-prefills them with queued requests.  The
same scheduler as JAX's:

  - a fixed cache capacity of ``tpre + max_stop + 1`` columns, where
    ``tpre`` is the [text ; right-aligned prompt] region of every sequence;
  - per-slot cache columns: slot b writes its generated K/V at column
    ``tpre + min(own_t, cap_own)``, with ``own_t`` its own step count, so a
    refilled slot's region restarts at the prefix (the (B,) ``cache_index``
    of ``nn/attention.py``);
  - with ``ragged_decode``, kernel 1 reads columns [0, tpre + own_c] of a
    live slot and nothing of a finished one (``kv_lengths`` 0);
  - admission in groups of ``admit_width``: a group's padding rows are
    prefilled with the group and dropped at the scatter (slot index ``b``),
    so every admission prefill has one shape;
  - admission while ``t_now + stop < cap_steps`` (a slot admitted at
    ``t_now`` with stop s is marked finished by the step at ``t_now + s``),
    and a restart with a fresh state when that budget blocks a queued
    request;
  - NAR refinement of the harvested requests in full batches of
    ``batch_size`` at the ``nar_bucket`` length (``sample.nar_refine``).

A segment is a Python loop of ``ar_decode_step`` that reads ``finished``
on the host every step, as ``generate`` does; JAX runs it as a
``lax.while_loop``.  A ``torch.Generator`` takes the place of the JAX key.
VALL-E only, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from valle_tpu_torch.nn.attention import quantize_kv
from valle_tpu_torch.ops import masks as mask_ops
from valle_tpu_torch.ops.sampling import topk_sampling
from valle_tpu_torch.sample import _prefill_kv, nar_refine

GEN_LEN_UNSET = np.iinfo(np.int32).max // 2  # gen_len of a slot that has not stopped


def _quantize_cache(kv) -> Tuple[torch.Tensor, ...]:
    k8, ks = quantize_kv(kv[0])
    v8, vs = quantize_kv(kv[1])
    return k8, v8, ks, vs


def _prefill_parts(model, x, x_lens, prompts, plens):
    """Prefill of an admission group: (last logits, cache parts (int8 with
    scales, or k and v in the model dtype), pre_valid (B, tpre))."""
    logits, kv, _mem, key_pad_pre, _mb, _tpre = _prefill_kv(model, x, x_lens, prompts, plens)
    parts = _quantize_cache(kv) if model.cfg.kv_cache_dtype == "int8" else tuple(kv)
    return logits, parts, ~key_pad_pre


@dataclass
class _State:
    """The running batch: the stacked cache (L, B, C, ...), each slot's next
    logits, its tokens at global steps, and per-slot scalars (B,)."""

    cache: Tuple[torch.Tensor, ...]
    logits: torch.Tensor
    tokens: torch.Tensor  # (B, cap_steps), written at the global step t
    t: int  # global step
    finished: torch.Tensor
    gen_len: torch.Tensor
    start_t: torch.Tensor  # the global step a slot's request started at
    pre_valid: torch.Tensor  # (B, tpre)
    x_lens: torch.Tensor
    prompt_lens: torch.Tensor
    stop_lens: torch.Tensor


def _admit(model, state: _State, slots: np.ndarray, x, x_lens, prompts, plens, stop_lens):
    """Scatter a prefilled admission group into ``slots`` of the running
    state, in place; rows whose slot index is out of range (the batch size)
    are padding and are dropped."""
    logits, parts, pre_valid_new = _prefill_parts(model, x, x_lens, prompts, plens)
    b, tpre = state.pre_valid.shape
    if pre_valid_new.shape[1] != tpre:
        raise ValueError(f"admission prefill of {pre_valid_new.shape[1]} columns into a "
                         f"state of {tpre}")
    dev = state.logits.device
    rows = torch.as_tensor(np.flatnonzero(slots < b), device=dev)
    sl = torch.as_tensor(slots[slots < b], dtype=torch.long, device=dev)
    for c, p in zip(state.cache, parts):
        c[:, sl, :tpre] = p[:, rows].to(c.dtype)
    state.logits[sl] = logits[rows]
    state.finished[sl] = False
    state.gen_len[sl] = GEN_LEN_UNSET
    state.start_t[sl] = state.t
    state.pre_valid[sl] = pre_valid_new[rows]
    for name, v in (("x_lens", x_lens), ("prompt_lens", plens), ("stop_lens", stop_lens)):
        getattr(state, name)[sl] = v[rows].to(getattr(state, name).dtype)


def _segment(model, state: _State, seg_end: int, *, tpre: int, top_k: int, top_p: float,
             temperature: float, generator, forbid_eos: bool = False,
             ragged_decode: bool = False) -> None:
    """Run the AR loop to global step ``seg_end`` (or until every slot is
    finished), updating ``state`` in place."""
    cfg = model.cfg
    eos = cfg.eos_id
    bos = int(cfg.prepend_bos)
    b = state.logits.shape[0]
    c_cap = state.cache[0].shape[2]
    cap_own = c_cap - tpre - 1
    dev = state.logits.device
    slot_idx = torch.arange(c_cap, device=dev)[None, :]
    key_valid = torch.cat(
        [state.pre_valid, state.pre_valid.new_zeros((b, c_cap - tpre))], 1)
    while state.t < seg_end and not bool(state.finished.all()):
        logits = state.logits
        if forbid_eos:
            logits = logits.clone()
            logits[:, eos] = -1e9
        samples = topk_sampling(logits, top_k=top_k, top_p=top_p, temperature=temperature,
                                generator=generator)
        argmax_eos = torch.argmax(logits, dim=-1) == eos
        own_t = state.t - state.start_t  # per-slot generated count
        too_long = ((own_t + bos) > state.x_lens * 16) | (own_t >= state.stop_lens)
        stop_now = argmax_eos | (samples == eos) | too_long
        state.gen_len = torch.where(stop_now & ~state.finished, own_t, state.gen_len)
        state.finished = state.finished | stop_now
        tok = torch.where(state.finished, eos, samples)
        state.tokens[:, state.t] = tok

        # slot b's generated K/V live at [tpre, tpre + own_t] whenever it was
        # admitted; a finished slot clamps at the last column (its output is
        # discarded)
        own_c = torch.clamp(own_t, max=cap_own)
        positions = (state.prompt_lens + bos + own_c)[:, None]
        step_valid = key_valid | ((slot_idx >= tpre) & (slot_idx <= tpre + own_c[:, None]))
        bias = mask_ops.mask_to_bias(~step_valid[:, None, None, :])
        kv_lengths = None
        if ragged_decode:
            kv_lengths = torch.where(state.finished, 0, tpre + own_c + 1).to(torch.int32)
        state.logits, _ = model.ar_decode_step(
            tok[:, None], positions, state.cache, tpre + own_c, bias, kv_lengths=kv_lengths)
        state.t += 1


@torch.inference_mode()
def serve_continuous(
    model,
    requests: Dict[str, np.ndarray],
    *,
    batch_size: int,
    generator: Optional[torch.Generator] = None,
    cap_steps: int = 2048,
    chunk: int = 128,
    admit_width: int = 32,
    top_k: int = -100,
    top_p: float = 1.0,
    temperature: float = 1.0,
    forbid_eos: bool = False,
    nar_bucket: int = 512,
    ragged_decode: bool = False,
) -> List[Dict[str, np.ndarray]]:
    """Serve ``requests`` (any R >= 1) with slot refill, on the model's device.

    requests: {"x": (R, S), "x_lens": (R,), "prompts": (R, P, Q),
    "prompt_lens": (R,), "stop_lens": (R,)} host arrays (``stop_lens``
    caps each request's length).  generator: the sampler's random stream
    (on the model's device).
    Returns one {"codes": (len, Q), "length": int} per request, in order.
    """
    if model.variant != "valle":
        raise ValueError("the continuous scheduler serves VALL-E only")
    dev = next(model.parameters()).device
    r_total = requests["x"].shape[0]
    b = batch_size
    max_stop = int(np.max(requests["stop_lens"]))
    if max_stop >= cap_steps:
        raise ValueError(f"cap_steps={cap_steps} cannot finish a stop_lens={max_stop} request")

    def take(k, idx):
        return torch.as_tensor(np.asarray(requests[k])[idx], device=dev).long()

    def fresh_state(ridx_real: np.ndarray):
        """A full state over ``ridx_real``, padded to ``b`` rows whose
        stop_lens=1: they finish at the first step and become free slots,
        never registered in slot_req."""
        n = len(ridx_real)
        ridx = np.zeros((b,), np.int64)
        ridx[:n] = ridx_real
        stop = take("stop_lens", ridx)
        stop[n:] = 1
        logits, parts, pre_valid = _prefill_parts(
            model, take("x", ridx), take("x_lens", ridx), take("prompts", ridx),
            take("prompt_lens", ridx))
        tpre = pre_valid.shape[1]
        # fixed capacity: every slot's generated region is [tpre, tpre + own_len]
        c_cap = tpre + max_stop + 1
        cache = []
        for p in parts:
            c = p.new_zeros((p.shape[0], b, c_cap) + p.shape[3:])
            c[:, :, :tpre] = p
            cache.append(c)
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        state = _State(
            cache=tuple(cache), logits=logits,
            tokens=torch.zeros((b, cap_steps), dtype=torch.long, device=dev), t=0,
            finished=torch.zeros((b,), dtype=torch.bool, device=dev),
            gen_len=torch.full((b,), GEN_LEN_UNSET, dtype=torch.long, device=dev),
            start_t=zeros, pre_valid=pre_valid, x_lens=take("x_lens", ridx),
            prompt_lens=take("prompt_lens", ridx), stop_lens=stop)
        return state, tpre, {i: int(ridx_real[i]) for i in range(n)}

    state, tpre, slot_req = fresh_state(np.arange(min(b, r_total)))
    next_req = len(slot_req)
    harvested: Dict[int, Dict] = {}
    seg_kwargs = dict(tpre=tpre, top_k=top_k, top_p=top_p, temperature=temperature,
                      generator=generator, forbid_eos=forbid_eos, ragged_decode=ragged_decode)

    seg_end = chunk
    while True:
        _segment(model, state, seg_end, **seg_kwargs)
        t_now = state.t
        finished = state.finished.cpu().numpy()
        gen_len = state.gen_len.cpu().numpy()
        start_t = state.start_t.cpu().numpy()
        tokens_host = None
        for s_i in list(slot_req):
            if finished[s_i]:
                if tokens_host is None:
                    tokens_host = state.tokens.cpu().numpy()
                length, st = int(gen_len[s_i]), int(start_t[s_i])
                harvested[slot_req.pop(s_i)] = {
                    "tokens": tokens_host[s_i, st: st + length].copy(), "length": length}
        # every slot not serving a live request (just harvested, or a padding
        # row of a partial fresh state) is admissible; admit while there is
        # a queue, a free slot and room to finish (the last step runs at
        # cap_steps - 1, hence the strict <)
        free_slots = [i for i in range(b) if i not in slot_req]
        admissions = []
        while (free_slots and next_req < r_total
               and t_now + int(requests["stop_lens"][next_req]) < cap_steps):
            s_i = free_slots.pop()
            admissions.append((s_i, next_req))
            slot_req[s_i] = next_req
            next_req += 1
        for a0 in range(0, len(admissions), admit_width):
            grp = admissions[a0: a0 + admit_width]
            slots = np.full((admit_width,), b, np.int64)  # b = a dropped padding row
            ridx = np.zeros((admit_width,), np.int64)
            for j, (s_i, r_i) in enumerate(grp):
                slots[j], ridx[j] = s_i, r_i
            _admit(model, state, slots, take("x", ridx), take("x_lens", ridx),
                   take("prompts", ridx), take("prompt_lens", ridx), take("stop_lens", ridx))
        if not slot_req:
            if next_req >= r_total:
                break  # every slot drained and nothing left to admit
            # the step budget blocked admission while requests were queued:
            # restart with a fresh state (global step 0) over the rest
            nxt = np.arange(next_req, min(next_req + b, r_total))
            state, tpre, slot_req = fresh_state(nxt)
            next_req = int(nxt[-1]) + 1
            seg_end = 0
        if seg_end >= cap_steps:
            raise RuntimeError(f"cap_steps={cap_steps} exhausted with {len(slot_req)} slots live")
        seg_end += min(chunk, cap_steps - seg_end)

    # NAR refinement in full drain batches
    results: List[Optional[Dict]] = [None] * r_total
    order = sorted(harvested)
    for g0 in range(0, len(order), b):
        grp = order[g0: g0 + b]
        tok = np.zeros((b, nar_bucket), np.int64)
        lens = np.zeros((b,), np.int64)
        ridx = np.zeros((b,), np.int64)
        for j, r_i in enumerate(grp):
            h = harvested[r_i]
            n = min(h["length"], nar_bucket)
            tok[j, :n] = h["tokens"][:n]
            lens[j], ridx[j] = n, r_i
        codes = nar_refine(model, take("x", ridx), take("x_lens", ridx), take("prompts", ridx),
                           take("prompt_lens", ridx), tok, lens).cpu().numpy()
        for j, r_i in enumerate(grp):
            results[r_i] = {"codes": codes[j, :lens[j]], "length": int(lens[j])}
    if any(r is None for r in results):
        raise RuntimeError("the scheduler dropped a request")
    return results
