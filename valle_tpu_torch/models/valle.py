"""VALL-E / VALL-F neural codec language models: the twin of
``valle_tpu/models/valle.py``.

  - ``VALLE``: decoder-only prefix-LM over the concatenated [text ; audio].
  - ``VALLF``: text as cross-attention memory, decoder over audio only.
  - The AR stage predicts codebook 1 plus EOS; NAR stages 2..Q refine the
    other codebooks with stage-conditioned adaptive layer norm.

Parameter names are the reference PyTorch model's, so the port loads a
reference ``state_dict`` as it is and a JAX parameter tree through
``utils/bridge.py``.  The NAR codebook tables stay Q separate embeddings
(``nar_audio_embeddings.{j}``), and with ``share_embedding`` the prediction
layer j shares its weight with table j+2, as in the reference.  As in the
JAX model, the compute dtype (``cfg.compute_dtype``) is that of the
projections, attention and logits, each module casting at its call; the
embeddings, positional embeddings and norms compute in f32, so in bf16 the
residual stream stays f32.  ``models.get_model`` keeps every parameter f32
for training and casts the rest once for inference.

Dropout is at the JAX model's rates (attention and layer dropout at
``cfg.dropout``, the AR positions and the NAR audio position at 0.1, the NAR
text position at 0, the prenets at 0.5 / 0.25) and active in train mode only.
The random draws of training (NAR stage, prefix length of mode 1, prompt
starts of mode 2) are taken from the forward's ``rng`` CPU generator unless
given explicitly.  Under data parallelism (``batch_group``, set for a
training step by ``parallel.mesh.global_batch``) the NAR stage and the
prefix length of mode 1 are the group's first rank's draws, and the
longest length (the AR loss's EOS positions), the shortest one and the
frame and row totals (the prefix of modes 1 and 2 and its rescale) are the
whole batch's, as in the JAX step over its global batch (the step pads the
ranks' parts to the group's widths); the prompt starts of mode 2 stay per
row, and the prompts of mode 4 are each rank's loader's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from valle_tpu_torch.models.config import ModelConfig
from valle_tpu_torch.nn.dropout import Dropout
from valle_tpu_torch.nn.embedding import SinePositionalEmbedding, TokenEmbedding
from valle_tpu_torch.nn.layers import TransformerStack
from valle_tpu_torch.nn.qdense import Dense
from valle_tpu_torch.ops import masks as mask_ops
from valle_tpu_torch.parallel import dist


def _cross_entropy_sum(logits, targets, valid):
    """Summed CE over valid positions; logits (..., V), targets (...,) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return (nll * valid.to(nll.dtype)).sum()


def _top10_hits(logits, targets):
    """Per-position bool: target within the top-10 logits.  Targets out of
    the vocabulary (EOS at padding) are clamped; callers mask them."""
    idx = targets.long().clamp(max=logits.shape[-1] - 1)
    tgt_logit = logits.gather(-1, idx[..., None])
    return (logits > tgt_logit).sum(dim=-1) < 10


class _Transpose(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


class _Prenet(nn.Sequential):
    """``nn.Sequential`` whose dropout modules draw from the forward's rng.
    Its layers cast to the compute dtype at their call."""

    def forward(self, x, rng=None):
        for mod in self:
            x = mod(x, rng) if isinstance(mod, Dropout) else mod(x)
        return x


class _Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that casts its input, weight and bias to ``dtype`` at
    the call, as flax's ``nn.Conv(dtype=...)`` does (None: no cast)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` that normalises in f32 and returns ``dtype``, as
    flax's ``nn.BatchNorm(dtype=...)`` does (None: no cast)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.compute_dtype)


class ConvPrenet(_Prenet):
    """Text conv prenet: 3x(conv5 + BN + ReLU + dropout 0.5) + linear, as the
    reference's ``nn.Sequential`` (so its keys are ``1``, ``2``, ``5``, ``6``,
    ``9``, ``10`` and ``14``)."""

    def __init__(self, d_model: int, dtype: Optional[torch.dtype] = None):
        mods = [_Transpose()]
        for _ in range(3):
            mods += [_Conv1d(d_model, d_model, kernel_size=5, padding=2, dtype=dtype),
                     _BatchNorm1d(d_model, dtype=dtype), nn.ReLU(), Dropout(0.5)]
        mods += [_Transpose(), Dense(d_model, d_model, dtype=dtype)]
        super().__init__(*mods)


class MLPPrenet(_Prenet):
    """Audio prenet: d->256->256->d with ReLU + dropout 0.25 (keys ``0``,
    ``3``, ``6``)."""

    def __init__(self, d_model: int, hidden: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__(
            Dense(d_model, hidden, dtype=dtype), nn.ReLU(), Dropout(0.25),
            Dense(hidden, hidden, dtype=dtype), nn.ReLU(), Dropout(0.25),
            Dense(hidden, d_model, dtype=dtype),
        )


class VALLE(nn.Module):
    """Decoder-only VALL-E (``variant='vallf'`` gives the cross-attention
    VALL-F layout)."""

    variant = "valle"
    batch_group = None  # the data group over which the batch is split

    @staticmethod
    def metric_names(train_stage: int):
        """Keys of the forward() output dict at this train stage (the train
        step's metric accumulator)."""
        return {
            0: ["loss", "ar_loss", "nar_loss", "ArTop10Accuracy", "NarTop10Accuracy", "frames"],
            1: ["loss", "ar_loss", "ArTop10Accuracy", "frames"],
            2: ["loss", "nar_loss", "NarTop10Accuracy", "frames"],
        }[train_stage]

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, nd = cfg.decoder_dim, cfg.nar_decoder_dim
        v, q = cfg.num_audio_tokens, cfg.num_quantizers
        dt = cfg.compute_dtype
        cross = self.variant == "vallf"

        self.ar_text_embedding = TokenEmbedding(d, cfg.num_text_tokens)
        self.ar_audio_embedding = TokenEmbedding(d, v + 1 + int(cfg.prepend_bos))
        if cfg.add_prenet:
            self.ar_text_prenet = ConvPrenet(d, dtype=dt)
            self.ar_audio_prenet = MLPPrenet(d, dtype=dt)
        self.ar_text_position = SinePositionalEmbedding(d, dropout=0.1, alpha=True,
                                                        max_len=cfg.max_len)
        self.ar_audio_position = SinePositionalEmbedding(d, dropout=0.1, alpha=True,
                                                         max_len=cfg.max_len)
        self.ar_decoder = TransformerStack(
            cfg.num_layers, d, cfg.nhead, d * 4, norm_first=cfg.norm_first,
            adaptive_norm=False, cross_attention=cross, final_norm=cfg.norm_first,
            attn_impl=cfg.attn_impl, act_quant=cfg.act_quant, dropout=cfg.dropout, dtype=dt,
            remat=cfg.remat,
        )
        self.ar_predict_layer = Dense(d, v + 1, use_bias=False, act_quant=cfg.act_quant,
                                      dtype=dt)

        if q > 1:
            self.nar_text_embedding = TokenEmbedding(nd, cfg.num_text_tokens)
            # codebook-1 table has the extra EOS/pad row (vocab V+1)
            self.nar_audio_embeddings = nn.ModuleList(
                [TokenEmbedding(nd, v + 1)] + [TokenEmbedding(nd, v) for _ in range(q - 1)]
            )
            if cfg.add_prenet:
                self.nar_text_prenet = ConvPrenet(nd, dtype=dt)
                self.nar_audio_prenet = MLPPrenet(nd, dtype=dt)
            self.nar_text_position = SinePositionalEmbedding(nd, dropout=0.0, max_len=cfg.max_len)
            self.nar_audio_position = SinePositionalEmbedding(nd, dropout=0.1,
                                                              max_len=cfg.max_len)
            self.nar_decoder = TransformerStack(
                cfg.nar_num_layers, nd, cfg.nar_nhead, nd * 4, norm_first=cfg.norm_first,
                adaptive_norm=True, cross_attention=cross, final_norm=cfg.norm_first,
                attn_impl=cfg.attn_impl, act_quant=cfg.act_quant, dropout=cfg.dropout,
                dtype=dt, remat=cfg.remat,
            )
            self.nar_predict_layers = nn.ModuleList(
                Dense(nd, v, use_bias=False, dtype=dt) for _ in range(q - 1)
            )
            if cfg.share_embedding:
                # predict[j] ties to embedding table j+2 for j <= Q-3; only
                # the last keeps its own weight
                for j in range(q - 2):
                    self.nar_predict_layers[j].weight = self.nar_audio_embeddings[j + 2].weight
            self.nar_stage_embeddings = nn.ModuleList(
                TokenEmbedding(nd, 1) for _ in range(q - 1)
            )

    # ------------------------------------------------------------------ utils

    def _rest_gather(self, codes_rest: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Summed multi-codebook embedding of codebooks 2..Q.

        codes_rest: (B, T, Q-1) tokens; weights: multiplier broadcastable to
        (B, T, Q-1).  Returns (B, T, nd)."""
        w = torch.broadcast_to(weights, codes_rest.shape)
        out = None
        for j in range(codes_rest.shape[-1]):
            e = self.nar_audio_embeddings[j + 1](codes_rest[..., j])
            e = e * w[..., j, None].to(e.dtype)
            out = e if out is None else out + e
        return out

    def _ar_text(self, text, rng=None):
        x = self.ar_text_embedding(text, rng)
        if self.cfg.add_prenet:
            x = self.ar_text_prenet(x, rng)
        return self.ar_text_position(x, rng=rng)

    def _ar_audio(self, tokens, positions=None, offset=0, rng=None):
        e = self.ar_audio_embedding(tokens, rng)
        if self.cfg.add_prenet:
            e = self.ar_audio_prenet(e, rng)
        return self.ar_audio_position(e, positions=positions, offset=offset, rng=rng)

    def _nar_text(self, text, rng=None):
        x = self.nar_text_embedding(text, rng)
        if self.cfg.add_prenet:
            x = self.nar_text_prenet(x, rng)
        return self.nar_text_position(x, rng=rng)

    def _nar_audio_pos(self, y_emb, positions=None, rng=None):
        if self.cfg.add_prenet:
            y_emb = self.nar_audio_prenet(y_emb, rng)
        return self.nar_audio_position(y_emb, positions=positions, rng=rng)

    def _pad_y_eos(self, codes0, y_mask_int):
        """Returns (ar_in, ar_tgt, t_full)."""
        cfg = self.cfg
        b = codes0.shape[0]
        zeros = torch.zeros((b, 1), dtype=codes0.dtype, device=codes0.device)
        ones = torch.ones((b, 1), dtype=y_mask_int.dtype, device=codes0.device)
        t_full = torch.cat([codes0, zeros], 1) + cfg.eos_id * torch.cat([y_mask_int, ones], 1)
        if cfg.prepend_bos:
            bos = torch.full((b, 1), cfg.bos_id, dtype=codes0.dtype, device=codes0.device)
            return torch.cat([bos, t_full[:, :-1]], 1), t_full, t_full
        return t_full[:, :-1], t_full[:, 1:], t_full

    # ---------------------------------------------------------------- forward

    def forward(
        self,
        x: torch.Tensor,
        x_lens: torch.Tensor,
        y: torch.Tensor,
        y_lens: torch.Tensor,
        *,
        train_stage: int = 0,
        nar_stage: Optional[int] = None,
        prefix_len: Optional[int] = None,
        prompt_starts: Optional[torch.Tensor] = None,
        y_prompts_codes: Optional[torch.Tensor] = None,
        example_mask: Optional[torch.Tensor] = None,
        rng: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training / eval forward.  x (B,S) int, y (B,T,Q) int.

        train_stage: 0 = AR+NAR, 1 = AR only, 2 = NAR only.  The NAR stage,
        the prefix length of mode 1 and the prompt starts of mode 2 are drawn
        from ``rng`` (a CPU generator) unless given, as the JAX forward draws
        them from its 'stage' stream; ``rng`` also feeds dropout, which is
        active in train mode only.
        Returns a dict of summed losses and metric numerators.
        """
        cfg = self.cfg
        s, t = x.shape[1], y.shape[1]
        x_mask = mask_ops.make_pad_mask(x_lens, s)
        y_mask = mask_ops.make_pad_mask(y_lens, t)
        y_mask_int = y_mask.long()
        codes = y.long() * (1 - y_mask_int[..., None])
        ar_in, ar_tgt, t_full = self._pad_y_eos(codes[..., 0], y_mask_int)
        max_y = dist.all_reduce_(y_lens.max(), "max", self.batch_group)

        out: Dict[str, torch.Tensor] = {}
        total_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if train_stage in (0, 1):
            ar_loss, ar_metric = self._forward_ar(x, x_mask, ar_in, ar_tgt, y_mask, max_y,
                                                  y_lens, example_mask, rng)
            total_loss = total_loss + ar_loss
            out["ar_loss"] = ar_loss
            out.update(ar_metric)
        if cfg.num_quantizers > 1 and train_stage in (0, 2):
            if nar_stage is None:
                if rng is None:
                    raise ValueError("nar_stage must be given (1..Q-1), or an rng to draw it")
                nar_stage = dist.broadcast_int(
                    int(torch.randint(1, cfg.num_quantizers, (), generator=rng)), self.batch_group)
            nar_loss, nar_metric = self._forward_nar(
                x, x_mask, codes, t_full, y_mask, y_lens, int(nar_stage), prefix_len,
                prompt_starts, y_prompts_codes, example_mask, rng,
            )
            total_loss = total_loss + nar_loss
            out["nar_loss"] = nar_loss
            out.update(nar_metric)
        if train_stage == 0:
            total_loss = total_loss / 2.0
        out["loss"] = total_loss
        out["frames"] = y_lens.sum().float()
        return out

    def _forward_ar(self, x, x_mask, ar_in, ar_tgt, y_mask, max_y, y_lens, example_mask=None,
                    rng=None):
        cfg = self.cfg
        b, s = x.shape
        ty = ar_in.shape[1]
        x_emb = self._ar_text(x, rng)
        y_emb = self._ar_audio(ar_in, rng=rng)
        if cfg.prepend_bos:
            ar_y_mask = torch.cat([torch.zeros_like(y_mask[:, :1]), y_mask], 1)
        else:
            ar_y_mask = y_mask

        if self.variant == "valle":
            key_pad = torch.cat([x_mask, ar_y_mask], 1)
            bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(key_pad), prefix_s=s)
            dec, _, _ = self.ar_decoder(torch.cat([x_emb, y_emb], 1), attn_bias=bias, rng=rng)
            dec_y = dec[:, s:]
        else:  # vallf: causal self-attn over audio, cross-attn to text
            bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(ar_y_mask), prefix_s=0)
            mem_bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(x_mask))
            dec_y, _, _ = self.ar_decoder(y_emb, attn_bias=bias, memory=x_emb,
                                          memory_bias=mem_bias, rng=rng)

        logits = self.ar_predict_layer(dec_y)  # (B, Ty, V+1)
        pos = torch.arange(ty, device=x.device)[None, :]
        valid = pos <= max_y if cfg.prepend_bos else pos < max_y
        valid = valid.expand(ar_tgt.shape)
        if example_mask is not None:
            valid = valid & example_mask[:, None]
        loss = _cross_entropy_sum(logits, ar_tgt, valid)
        metric_valid = valid & (ar_tgt != cfg.eos_id)
        hits = _top10_hits(logits, ar_tgt) & metric_valid
        acc = hits.sum() / metric_valid.sum().clamp(min=1)
        return loss, {"ArTop10Accuracy": acc.float() * y_lens.sum().float()}

    def _forward_nar(self, x, x_mask, codes, t_full, y_mask, y_lens, nar_stage, prefix_len,
                     prompt_starts, y_prompts_codes, example_mask=None, rng=None):
        cfg = self.cfg
        b, s = x.shape
        dev = x.device
        if example_mask is not None:
            big = torch.iinfo(y_lens.dtype).max
            min_y_lens = int(torch.where(example_mask, y_lens, big).min())
            n_rows = example_mask.float().sum()
        else:
            min_y_lens = int(y_lens.min())
            n_rows = torch.tensor(float(b), device=dev)
        t = y_mask.shape[1]
        q = cfg.num_quantizers
        eos = cfg.eos_id
        mode = cfg.prefix_mode
        if mode in (1, 2):
            min_y_lens = -dist.reduce_ints([-min_y_lens], "max", self.batch_group)[0]

        y_nar_in = t_full[:, :-1]  # codebook-0 tokens with EOS at padding
        x_emb = self._nar_text(x, rng)
        stage_emb = self.nar_stage_embeddings[nar_stage - 1].weight  # (1, nd)
        codes_rest = codes[..., 1:]
        j_idx = torch.arange(1, q, device=dev)
        stage_w = (j_idx[None, None, :] < nar_stage).float()
        targets = codes[..., nar_stage] + eos * y_mask.long()
        rescale_prefix = 0.0
        emb0 = self.nar_audio_embeddings[0]
        positions = None
        prompt_emb = None
        seq_prompt_len = 0

        if mode == 0:
            y_emb = emb0(y_nar_in) + self._rest_gather(codes_rest, stage_w)
            tgt_ignore_extra = torch.zeros_like(y_mask)
        elif mode == 1:
            if prefix_len is None:
                if rng is None:
                    raise ValueError("prefix mode 1 needs prefix_len, or an rng to draw it")
                int_low = int(0.25 * min_y_lens)
                prefix_len = dist.broadcast_int(
                    int(torch.randint(int_low, max(int_low * 2, int_low + 1), (), generator=rng)),
                    self.batch_group)
                prefix_len = min(prefix_len, cfg.max_prefix_len)
            in_prefix = torch.arange(t, device=dev)[None, :] < prefix_len  # (1, T)
            w = (in_prefix[0][None, :, None] | (j_idx[None, None, :] < nar_stage)).float()
            y_emb = emb0(y_nar_in) + self._rest_gather(codes_rest, w)
            tgt_ignore_extra = in_prefix.expand(b, t)
            rescale_prefix = float(prefix_len)
        elif mode in (2, 4):
            if mode == 2:
                pcap = min(cfg.max_prefix_len, t)
                if prefix_len is None:
                    prefix_len = min(pcap, int(0.25 * min_y_lens))
                if prompt_starts is None:
                    if rng is None:
                        raise ValueError("prefix mode 2 needs prompt_starts, or an rng")
                    high = (y_lens.cpu() - prefix_len + 1).clamp(min=1)
                    prompt_starts = (torch.rand(b, generator=rng) * high).long().to(dev)
                seg_pos = prompt_starts[:, None] + torch.arange(pcap, device=dev)[None, :]
                seg_pos = seg_pos.clamp(0, t - 1).long()
                prompt_codes = codes.gather(1, seg_pos[..., None].expand(b, pcap, q))
                prompt_valid = torch.arange(pcap, device=dev)[None, :] < prefix_len
                pos_t = torch.arange(t, device=dev)[None, :]
                tgt_ignore_extra = (pos_t >= prompt_starts[:, None]) & (
                    pos_t < prompt_starts[:, None] + prefix_len)
                rescale_prefix = float(prefix_len)
            else:  # mode 4: prompts supplied, equal length across the batch
                if y_prompts_codes is None:
                    raise ValueError("prefix mode 4 needs y_prompts_codes")
                pcap = y_prompts_codes.shape[1]
                prompt_codes = y_prompts_codes.long()
                prefix_len = pcap
                prompt_valid = torch.ones((1, pcap), dtype=torch.bool, device=dev)
                tgt_ignore_extra = torch.zeros_like(y_mask)
            all_w = torch.ones((1, 1, q - 1), device=dev)
            prompt_emb = emb0(prompt_codes[..., 0]) + self._rest_gather(
                prompt_codes[..., 1:], all_w)
            y_emb = emb0(y_nar_in) + self._rest_gather(codes_rest, stage_w)
            prompt_mask = (~prompt_valid).expand(b, pcap)
            seq_prompt_len = pcap
            positions = torch.cat([
                torch.arange(pcap, device=dev)[None, :].expand(b, pcap),
                prefix_len + torch.arange(t, device=dev)[None, :].expand(b, t),
            ], 1)
        else:
            raise ValueError(f"prefix_mode {mode}")

        if prompt_emb is not None:
            y_full = torch.cat([prompt_emb, y_emb], 1)
            y_pad = torch.cat([prompt_mask, y_mask], 1)
        else:
            y_full, y_pad = y_emb, y_mask
        y_pos = self._nar_audio_pos(y_full, positions=positions, rng=rng)

        if self.variant == "valle":
            key_pad = torch.cat([x_mask, y_pad], 1)
            bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(key_pad))
            dec, _, _ = self.nar_decoder(torch.cat([x_emb, y_pos], 1), stage_emb=stage_emb,
                                         attn_bias=bias, rng=rng)
            dec_y = dec[:, s + seq_prompt_len:]
        else:
            bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(y_pad))
            mem_bias = mask_ops.AttnMaskSpec(mask_ops.mask_to_bias(x_mask))
            dec, _, _ = self.nar_decoder(y_pos, stage_emb=stage_emb, attn_bias=bias,
                                         memory=x_emb, memory_bias=mem_bias, rng=rng)
            dec_y = dec[:, seq_prompt_len:]

        logits = self.nar_predict_layers[nar_stage - 1](dec_y)
        valid = ~((targets == eos) | tgt_ignore_extra)
        loss = _cross_entropy_sum(logits, torch.where(valid, targets, 0), valid)
        total_length = y_lens.sum().float()
        if rescale_prefix:  # else the factor is exactly 1
            totals = torch.stack([total_length, n_rows.to(total_length.device)])
            length, rows = dist.all_reduce_(totals, "sum", self.batch_group)
            loss = loss * (length / (length - rescale_prefix * rows))
        hits = _top10_hits(logits, targets) & valid
        acc = hits.sum() / valid.sum().clamp(min=1)
        return loss, {"NarTop10Accuracy": acc.float() * total_length}

    @torch.no_grad()
    def visualize_forward(self, x, x_lens, y, y_lens):
        """Deterministic hidden states for the eval visualizer
        (``models/visualizer.py``), in eval mode whatever the module's mode:
        the text embedding (B, S, D) and the AR decoder's output over the
        audio region (B, Ty, D), under the prefix-LM bias (VALL-E) or the
        causal bias with cross-attention to the text (VALL-F).  The bias is
        a merged dense (B, 1, T, T) tensor, which ``attn_impl="flash"``
        sends to kernel 4."""
        was_training = self.training
        self.eval()
        try:
            b, s = x.shape
            x_mask = mask_ops.make_pad_mask(x_lens, s)
            y_mask = mask_ops.make_pad_mask(y_lens, y.shape[1])
            y_mask_int = y_mask.long()
            codes = y.long() * (1 - y_mask_int[..., None])
            ar_in, _, _ = self._pad_y_eos(codes[..., 0], y_mask_int)
            x_emb = self._ar_text(x)
            y_emb = self._ar_audio(ar_in)
            ty = ar_in.shape[1]
            ar_y_mask = (torch.cat([torch.zeros_like(y_mask[:, :1]), y_mask], 1)
                         if self.cfg.prepend_bos else y_mask)
            if self.variant == "valle":
                struct = mask_ops.prefix_lm_attn_mask(s, ty, device=x.device)
                key_pad = torch.cat([x_mask, ar_y_mask], 1)
                bias = mask_ops.mask_to_bias(mask_ops.merge_padding(struct, key_pad))
                dec = self.ar_decoder(torch.cat([x_emb, y_emb], 1), attn_bias=bias)[0]
                dec_y = dec[:, s:]
            else:
                struct = mask_ops.causal_mask(ty, device=x.device)
                bias = mask_ops.mask_to_bias(mask_ops.merge_padding(struct, ar_y_mask))
                mem_bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])
                dec_y = self.ar_decoder(y_emb, attn_bias=bias, memory=x_emb,
                                        memory_bias=mem_bias)[0]
        finally:
            self.train(was_training)
        return x_emb, dec_y

    # ---------------------------------------------------------------- decode
    # The parameter-touching pieces of the sampling loop; the loop itself,
    # its stop conditions and the cache layout live in valle_tpu_torch.sample.

    def ar_prefill(self, x, audio_tokens, audio_positions, bias, memory_bias=None):
        """Prefill pass; returns (last-position logits (B, V+1), stacked
        (k, v) each (L, B, Tpre, H, Dh), memory-or-None).

        VALL-E: full forward over [text ; audio prompt] under the prefix-LM
        mask.  VALL-F: causal self-attention over the audio prompt with
        cross-attention into the text memory."""
        x_emb = self._ar_text(x)
        y_emb = self._ar_audio(audio_tokens, positions=audio_positions)
        if self.variant == "valle":
            dec, _, kv = self.ar_decoder(torch.cat([x_emb, y_emb], 1), attn_bias=bias,
                                         return_kv=True)
            memory = None
        else:
            dec, _, kv = self.ar_decoder(y_emb, attn_bias=bias, memory=x_emb,
                                         memory_bias=memory_bias, return_kv=True)
            memory = x_emb
        return self.ar_predict_layer(dec[:, -1]), kv, memory

    def ar_decode_step(self, tok, positions, kv_cache, cache_index, bias, memory=None,
                       memory_bias=None, kv_lengths=None):
        """One decode step: tok (B, 1) -> (logits (B, V+1), updated cache).

        ``kv_lengths`` (B,) int32 routes the cache read through kernel 1
        (per-slot length-clipped reads; finished slots with length 0 read
        nothing)."""
        emb = self._ar_audio(tok, positions=positions)
        dec, new_cache, _ = self.ar_decoder(
            emb, kv_cache, attn_bias=bias, memory=memory, memory_bias=memory_bias,
            cache_index=cache_index, kv_lengths=kv_lengths,
        )
        return self.ar_predict_layer(dec[:, 0]), new_cache

    def nar_text_encode(self, x):
        return self._nar_text(x)

    def nar_embed0(self, tokens):
        return self.nar_audio_embeddings[0](tokens)

    def nar_embed_rest(self, j: int, tokens):
        """Embedding through table j+1 (codebook j+2)."""
        return self.nar_audio_embeddings[j + 1](tokens)

    def nar_forward_stage(self, i: int, y_emb, positions, x_emb, bias, gen_start: int,
                          memory_bias=None):
        """One NAR refinement pass for stage index i (0..Q-2); returns the
        greedy samples over the generated region."""
        stage_emb = self.nar_stage_embeddings[i].weight
        y_pos = self._nar_audio_pos(y_emb, positions=positions)
        if self.variant == "valle":
            dec, _, _ = self.nar_decoder(torch.cat([x_emb, y_pos], 1), stage_emb=stage_emb,
                                         attn_bias=bias)
        else:
            dec, _, _ = self.nar_decoder(y_pos, stage_emb=stage_emb, attn_bias=bias,
                                         memory=x_emb, memory_bias=memory_bias)
        logits = self.nar_predict_layers[i](dec[:, gen_start:])
        return torch.argmax(logits, dim=-1)


class VALLF(VALLE):
    variant = "vallf"
