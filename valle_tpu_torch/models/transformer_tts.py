"""Encoder-decoder Transformer TTS baseline (text -> mel): the twin of
``valle_tpu/models/transformer_tts.py``.

A phoneme encoder, a mel decoder with causal self-attention and
cross-attention to the encoder, mel MSE plus stop-token BCE with positive
weight 100, and a greedy autoregressive mel loop that recomputes the whole
decoder at every step.  Under ``attn_impl="flash"`` the encoder
self-attention and the cross-attention (key padding only) run on kernels 2
and 3, and the decoder self-attention, whose causal-plus-padding bias is a
dense (B, 1, T, T) tensor, on kernel 4 (``ops/flash_attention.py``).

The ``scaling_xformers`` variant builds both stacks in the scaling
layout (``nn/layers.py``): ``balanced_double_swish`` feed-forward blocks,
identity norms before attention, balanced basic norms before the
feed-forward blocks and as the final norms, and the initial weights of the
self-attention output projections and ``linear2`` scaled by 0.01; its mel
prenet is one ``decoder_prenet_fc`` ``Dense(num_mel_bins, d)`` without
dropout.  Its balancers act in train mode only.

Parameter names follow the JAX module's attribute names; the prenet is one
``nn.Sequential`` (``decoder_prenet.0``, ``.3``, ``.6``).  Dropout is active
in train mode only and draws from the forward's CPU generator ``rng``: the
attention and layer dropout at ``cfg.dropout``, both positional embeddings
at 0.1, the prenet at 0.5.  Both stacks take ``cfg.remat``.

Mixed precision is the JAX module's: the parameters are f32, the text
embedding and positional encodings compute in f32, the stacks get the
compute dtype (their norms compute in f32, so the encoder's residual stream
stays f32; the decoder's starts at the prenet's output in the compute
dtype, as JAX's does), and the prenet, ``predict_layer`` and ``stop_layer``
are ``Dense`` layers that cast to the compute dtype at their call, as
flax's ``nn.Dense(dtype=...)`` does.  The scaling variant's balanced basic
norms return f32 (JAX's promotion with their f32 epsilon), so its stacks'
feed-forward blocks and heads see f32 inputs and cast them.

The two losses are means over the batch's frames.  Under data parallelism
(``batch_group``, set for a training step by ``parallel.mesh.global_batch``)
their counts are the whole batch's, so the ranks' losses add up to the
global batch's, as in the JAX step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from valle_tpu_torch.models.config import ModelConfig
from valle_tpu_torch.models.valle import _Prenet
from valle_tpu_torch.nn.dropout import Dropout
from valle_tpu_torch.nn.embedding import SinePositionalEmbedding, TokenEmbedding
from valle_tpu_torch.nn.layers import TransformerStack
from valle_tpu_torch.nn.qdense import Dense
from valle_tpu_torch.ops import masks as mask_ops
from valle_tpu_torch.parallel import dist


class TransformerTTS(nn.Module):
    batch_group = None  # the data group over which the batch is split

    @staticmethod
    def metric_names(train_stage: int):
        del train_stage  # the baseline has no AR/NAR stages
        return ["loss", "mel_loss", "stop_loss", "frames"]

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_dim
        dt = cfg.compute_dtype
        sx = cfg.scaling_xformers
        stack_kw = dict(num_layers=cfg.num_layers, d_model=d, nhead=cfg.nhead,
                        dim_feedforward=d * 4, norm_first=cfg.norm_first,
                        final_norm=cfg.norm_first, attn_impl=cfg.attn_impl, dropout=cfg.dropout,
                        dtype=dt, remat=cfg.remat,
                        activation="balanced_double_swish" if sx else "relu",
                        norm_type="identity" if sx else "layer",
                        out_init_scale=0.01 if sx else 1.0)
        self.text_embedding = TokenEmbedding(d, cfg.num_text_tokens)
        self.text_position = SinePositionalEmbedding(d, dropout=0.1, alpha=True,
                                                     max_len=cfg.max_len)
        self.encoder = TransformerStack(**stack_kw)
        if sx:
            # one mel projection, no dropout
            self.decoder_prenet_fc = Dense(cfg.num_mel_bins, d, dtype=dt)
        else:
            # mel prenet with a 256-dim bottleneck
            self.decoder_prenet = _Prenet(
                Dense(cfg.num_mel_bins, 256, dtype=dt), nn.ReLU(), Dropout(0.5),
                Dense(256, 256, dtype=dt), nn.ReLU(), Dropout(0.5),
                Dense(256, d, dtype=dt),
            )
        self.decoder_position = SinePositionalEmbedding(d, dropout=0.1, alpha=True,
                                                        max_len=cfg.max_len)
        self.decoder = TransformerStack(cross_attention=True, **stack_kw)
        self.predict_layer = Dense(d, cfg.num_mel_bins, dtype=dt)
        self.stop_layer = Dense(d, 1, dtype=dt)

    def _prenet(self, mel: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.cfg.scaling_xformers:
            return self.decoder_prenet_fc(mel)
        return self.decoder_prenet(mel, rng)

    def encode(self, x, x_mask, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S) tokens and their (B, S) padding mask -> (B, S, D)."""
        h = self.text_position(self.text_embedding(x, rng), rng=rng)
        bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])
        return self.encoder(h, attn_bias=bias, rng=rng)[0]

    def forward(
        self,
        x: torch.Tensor,
        x_lens: torch.Tensor,
        y: torch.Tensor,
        y_lens: torch.Tensor,
        *,
        train_stage: int = 0,
        example_mask: Optional[torch.Tensor] = None,
        rng: Optional[torch.Generator] = None,
        **_: object,
    ) -> Dict[str, torch.Tensor]:
        """x (B,S) int tokens; y (B,T,M) float mels.  ``example_mask`` marks
        real rows (False = shape-padding dummy, excluded from the loss)."""
        if train_stage != 0:
            raise ValueError("the Transformer baseline trains at train_stage 0 only")
        cfg = self.cfg
        s, t = x.shape[1], y.shape[1]
        x_mask = mask_ops.make_pad_mask(x_lens, s)
        y_mask = mask_ops.make_pad_mask(y_lens, t)
        if example_mask is not None:
            y_mask = y_mask | ~example_mask[:, None]

        enc = self.encode(x, x_mask, rng)

        # teacher forcing: shift mel right with a zero frame
        y_in = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
        h = self.decoder_position(self._prenet(y_in, rng), rng=rng)
        struct = mask_ops.causal_mask(t, device=y.device)
        bias = mask_ops.mask_to_bias(mask_ops.merge_padding(struct, y_mask))
        mem_bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])
        dec = self.decoder(h, attn_bias=bias, memory=enc, memory_bias=mem_bias, rng=rng)[0]
        mel_pred = self.predict_layer(dec)
        stop_logit = self.stop_layer(dec)[..., 0]

        valid = (~y_mask).float()
        # stop target: 1 at the last valid frame and beyond
        pos = torch.arange(t, device=y.device)[None, :]
        stop_tgt = (pos >= (y_lens - 1)[:, None]).float()
        # BCE with positive weight 100; the log-sigmoids in the compute
        # dtype, the sum in f32, as the JAX module promotes them
        bce = -(100.0 * stop_tgt * F.logsigmoid(stop_logit).float()
                + (1 - stop_tgt) * F.logsigmoid(-stop_logit).float())
        loss_mask = pos < y_lens.clamp(min=1)[:, None]
        if example_mask is not None:
            loss_mask = loss_mask & example_mask[:, None]
        loss_mask = loss_mask.float()
        # the means' counts are the whole batch's under data parallelism
        counts = dist.all_reduce_(torch.stack([valid.sum(), loss_mask.sum()]), "sum",
                                  self.batch_group)
        mel_loss = (((mel_pred.float() - y.float()) ** 2) * valid[..., None]).sum() / (
            counts[0] * cfg.num_mel_bins).clamp(min=1.0)
        stop_loss = (bce * loss_mask).sum() / counts[1].clamp(min=1.0)
        return {
            "loss": mel_loss + stop_loss,
            "mel_loss": mel_loss,
            "stop_loss": stop_loss,
            "frames": y_lens.sum().float(),
        }

    @torch.no_grad()
    def inference(self, x: torch.Tensor, x_lens: torch.Tensor, *,
                  max_steps: int = 1000) -> Dict[str, torch.Tensor]:
        """Greedy autoregressive mel decoding, recomputing the decoder over
        all ``max_steps + 1`` frames at every step (no KV cache), as the JAX
        scan does.  Step i's bias lets row r see columns <= min(r, i); a row
        stops at the first step whose stop probability is above 0.5, and the
        loop still runs every step.  Returns ``mel`` (B, max_steps, M) and
        ``lengths`` (B,) int32 (``max_steps`` where no stop came)."""
        cfg = self.cfg
        b, s = x.shape
        dev = x.device
        x_mask = mask_ops.make_pad_mask(x_lens, s)
        enc = self.encode(x, x_mask)
        mem_bias = mask_ops.mask_to_bias(x_mask[:, None, None, :])

        n = max_steps + 1
        mels = torch.zeros((b, n, cfg.num_mel_bins), dtype=enc.dtype, device=dev)
        struct = mask_ops.causal_mask(n, device=dev)
        col = torch.arange(n, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        length = torch.full((b,), max_steps, dtype=torch.int32, device=dev)
        for i in range(max_steps):
            h = self.decoder_position(self._prenet(mels))
            bias = mask_ops.mask_to_bias((struct | (col > i)[None, :])[None, None])
            dec = self.decoder(h, attn_bias=bias, memory=enc, memory_bias=mem_bias)[0]
            mels[:, i + 1] = self.predict_layer(dec[:, i])
            stop = torch.sigmoid(self.stop_layer(dec[:, i])[..., 0]) > 0.5
            new_done = done | stop
            length = torch.where(~done & new_done, i + 1, length)
            done = new_done
        return {"mel": mels[:, 1:], "lengths": length}
