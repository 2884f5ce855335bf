"""EnCodec 24 kHz neural codec in PyTorch: the twin of
``valle_tpu/codec/encodec_model.py``.

SEANet encoder / decoder with a 2-layer LSTM bottleneck and a residual vector
quantizer: wav -> 8 x 1024-way codes at 75 Hz and back.  Plain functions over
a params tree of tensors laid out as PyTorch's ``conv1d`` wants, (B, C, T),
in the same order and with the same padding rules as the JAX functions:

  - a conv is ``{"w": (out, in, k), "b": (out,)}`` (the JAX tree holds
    ``(k, in, out)``);
  - a transposed conv is ``{"w": (in, out, k), "b": (out,)}``, the layout of
    ``torch.nn.ConvTranspose1d`` and of ``F.conv_transpose1d`` (the JAX tree
    holds ``(k, out, in)``, made from this layout by ``.transpose(2, 1, 0)``
    in ``valle_tpu/codec/convert.py``, and runs it through
    ``lax.conv_transpose(..., transpose_kernel=True)``);
  - an LSTM stack is a ``torch.nn.LSTM`` holding the JAX layers' ``wi`` /
    ``wh`` / ``bi`` / ``bh`` as ``weight_ih_l{n}`` / ``weight_hh_l{n}`` /
    ``bias_ih_l{n}`` / ``bias_hh_l{n}`` (torch's gate order i, f, g, o is the
    JAX code's); the JAX package runs it as a ``lax.scan``, here it is
    cuDNN's LSTM on the card;
  - the quantizer is the (NQ, V, D) codebook tensor.

No Pallas kernel lies in the codec: its convolutions, LSTM and gathers are
PyTorch ops here as they are XLA ops there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from valle_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    compress: int = 2
    num_lstm_layers: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 128
    num_quantizers: int = 32
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    trim_right_ratio: float = 1.0

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsampling_ratios))

    @property
    def frame_rate(self) -> int:
        return int(math.ceil(self.sampling_rate / self.hop_length))

    def num_q_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        bw_per_q = math.log2(self.codebook_size) * self.frame_rate
        if bandwidth is not None and bandwidth > 0.0:
            return int(max(1, math.floor(bandwidth * 1000 / bw_per_q)))
        return self.num_quantizers


# ----------------------------------------------------------------- primitives


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of (B, C, T).  Reflect padding of an input no longer
    than the pad first zero-pads it to ``max_pad + 1`` samples, reflects,
    then trims that zero tail (``F.pad`` refuses a reflect pad at or above
    the length)."""
    if mode != "reflect":
        return F.pad(x, (left, right))
    length = x.shape[-1]
    max_pad = max(left, right)
    extra = 0
    if length <= max_pad:
        extra = max_pad - length + 1
        x = F.pad(x, (0, extra))
    x = F.pad(x, (left, right), mode="reflect")
    if extra:
        x = x[..., : x.shape[-1] - extra]
    return x


def causal_conv1d(params: Mapping, x: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                  cfg: EncodecConfig) -> torch.Tensor:
    """x (B, Cin, T) -> (B, Cout, T'); params {w: (out, in, k), b: (out,)}.
    Left pad k_eff - stride, and on the right the extra samples that make
    the last frame whole (all on the left when causal, split otherwise)."""
    w, b = params["w"], params["b"]
    k = w.shape[-1]
    k_eff = (k - 1) * dilation + 1
    padding_total = k_eff - stride
    length = x.shape[-1]
    n_frames = math.ceil((length - k_eff + padding_total) / stride + 1) - 1
    ideal = n_frames * stride + k_eff - padding_total
    extra = ideal - length
    if cfg.use_causal_conv:
        x = _pad1d(x, padding_total, extra, cfg.pad_mode)
    else:
        pr = padding_total // 2
        x = _pad1d(x, padding_total - pr, pr + extra, cfg.pad_mode)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def causal_conv_transpose1d(params: Mapping, x: torch.Tensor, *, stride: int,
                            cfg: EncodecConfig) -> torch.Tensor:
    """Transposed conv with the causal right trim; params {w: (in, out, k), b}."""
    w, b = params["w"], params["b"]
    k = w.shape[-1]
    out = F.conv_transpose1d(x, w, b, stride=stride)
    padding_total = k - stride
    if cfg.use_causal_conv:
        pr = math.ceil(padding_total * cfg.trim_right_ratio)
    else:
        pr = padding_total // 2
    pl = padding_total - pr
    return out[..., pl: out.shape[-1] - pr]


def lstm_module(layers, device, dtype=torch.float32) -> torch.nn.LSTM:
    """A ``torch.nn.LSTM`` holding the JAX LSTM layers
    ``[{wi (4H, C), wh (4H, H), bi (4H,), bh (4H,)}, ...]`` (numpy or
    tensors), without drawing from the global random stream."""
    c, hidden = layers[0]["wi"].shape[1], layers[0]["wh"].shape[1]
    lstm = torch.nn.LSTM(c, hidden, num_layers=len(layers), batch_first=True,
                         device="meta", dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        for n, layer in enumerate(layers):
            for name, key in (("weight_ih", "wi"), ("weight_hh", "wh"),
                              ("bias_ih", "bi"), ("bias_hh", "bh")):
                getattr(lstm, f"{name}_l{n}").copy_(torch.as_tensor(np.asarray(layer[key])))
    lstm.requires_grad_(False)
    lstm.flatten_parameters()
    return lstm


def lstm_stack(lstm: torch.nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """The LSTM layers over (B, C, T), each feeding the next, with the
    residual added once after the last (EncodecLSTM)."""
    out, _ = lstm(x.transpose(1, 2))
    return out.transpose(1, 2) + x


def resnet_block(params: Mapping, x: torch.Tensor, *, dilations: Tuple[int, int],
                 cfg: EncodecConfig) -> torch.Tensor:
    """SEANet residual block: ELU-conv(k3, dil)-ELU-conv(k1) + conv shortcut."""
    h = F.elu(x)
    h = causal_conv1d(params["block_1"], h, dilation=dilations[0], cfg=cfg)
    h = F.elu(h)
    h = causal_conv1d(params["block_3"], h, dilation=dilations[1], cfg=cfg)
    sc = causal_conv1d(params["shortcut"], x, cfg=cfg)
    return sc + h


# ------------------------------------------------------------ encoder/decoder


def encode_latents(params: Mapping, wav: torch.Tensor, cfg: EncodecConfig) -> torch.Tensor:
    """wav (B, channels, T) -> latents (B, hidden_size, T')."""
    enc = params["encoder"]
    h = causal_conv1d(enc["layers_0"], wav, cfg=cfg)
    idx = 1
    for ratio in reversed(cfg.upsampling_ratios):
        for j in range(cfg.num_residual_layers):
            h = resnet_block(enc[f"layers_{idx}"], h,
                             dilations=(cfg.dilation_growth_rate**j, 1), cfg=cfg)
            idx += 1
        idx += 1  # ELU occupies a layer index
        h = F.elu(h)
        h = causal_conv1d(enc[f"layers_{idx}"], h, stride=ratio, cfg=cfg)
        idx += 1
    h = lstm_stack(enc[f"layers_{idx}"], h)
    idx += 2  # lstm + elu
    h = F.elu(h)
    return causal_conv1d(enc[f"layers_{idx}"], h, cfg=cfg)


def decode_latents(params: Mapping, latents: torch.Tensor, cfg: EncodecConfig) -> torch.Tensor:
    """latents (B, hidden_size, T') -> wav (B, channels, T)."""
    dec = params["decoder"]
    h = causal_conv1d(dec["layers_0"], latents, cfg=cfg)
    h = lstm_stack(dec["layers_1"], h)
    idx = 2
    for ratio in cfg.upsampling_ratios:
        idx += 1  # ELU
        h = F.elu(h)
        h = causal_conv_transpose1d(dec[f"layers_{idx}"], h, stride=ratio, cfg=cfg)
        idx += 1
        for j in range(cfg.num_residual_layers):
            h = resnet_block(dec[f"layers_{idx}"], h,
                             dilations=(cfg.dilation_growth_rate**j, 1), cfg=cfg)
            idx += 1
    h = F.elu(h)  # layer index idx is the ELU; the final conv is idx + 1
    return causal_conv1d(dec[f"layers_{idx + 1}"], h, cfg=cfg)


# ------------------------------------------------------------------ quantizer


def rvq_encode(codebooks: torch.Tensor, latents: torch.Tensor, num_q: int) -> torch.Tensor:
    """codebooks (NQ, V, D), latents (B, D, T) -> codes (B, T, num_q) int64.

    The distance is computed as the JAX package computes it,
    ``Σr² − 2·r·e + Σe²``, and its argmin takes the first index on a tie:
    another formula rounds differently and flips near-tied codes."""
    residual = latents.transpose(1, 2)  # (B, T, D)
    codes = []
    for q in range(num_q):
        cb = codebooks[q]
        dots = torch.matmul(residual, cb.t())
        d2 = (residual**2).sum(-1, keepdim=True) - 2 * dots + (cb**2).sum(-1)[None, None, :]
        idx = torch.argmin(d2, dim=-1)
        residual = residual - cb[idx]
        codes.append(idx)
    return torch.stack(codes, dim=-1)


def rvq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T, Q) -> latents (B, D, T): one gather from the flattened
    (Q·V, D) table and a sum over the quantizers."""
    q = codes.shape[-1]
    v, d = codebooks.shape[1], codebooks.shape[2]
    flat = codebooks[:q].reshape(q * v, d)
    idx = codes.long() + torch.arange(q, device=codes.device)[None, None, :] * v
    return flat[idx].sum(dim=2).transpose(1, 2)


# ------------------------------------------------------------------ weights


def _is_lstm(tree) -> bool:
    return isinstance(tree, (list, tuple)) and bool(tree) and isinstance(tree[0], Mapping) \
        and "wi" in tree[0]


def _torch_tree(tree, dev, dtype):
    """A JAX-layout codec subtree (numpy leaves) -> the port's layout on
    ``dev`` in ``dtype``: conv weights (k, in, out) -> (out, in, k),
    transposed-conv weights (k, out, in) -> (in, out, k), LSTM lists ->
    ``torch.nn.LSTM``."""
    if _is_lstm(tree):
        return lstm_module(tree, dev, dtype)
    if isinstance(tree, Mapping):
        if "w" in tree and "b" in tree and not isinstance(tree["w"], Mapping):
            w = torch.as_tensor(np.asarray(tree["w"]).transpose(2, 1, 0).copy())
            b = torch.as_tensor(np.asarray(tree["b"]))
            return {"w": w.to(dev, dtype), "b": b.to(dev, dtype)}
        return {k: _torch_tree(v, dev, dtype) for k, v in tree.items()}
    raise TypeError(f"unexpected codec leaf {type(tree)}")


def codec_params_to_torch(tree: Mapping, device=None, decode_dtype=torch.float32) -> Dict:
    """The JAX params tree of the codec (numpy leaves, the layout of
    ``valle_tpu/codec/convert.py``) -> the port's tree on ``device``: the
    encoder and the codebooks in f32, the decoder in ``decode_dtype``.  One
    transpose serves both conv kinds: (k, in, out) -> (out, in, k) and
    (k, out, in) -> (in, out, k)."""
    dev = resolve_device(device)
    return {
        "encoder": _torch_tree(tree["encoder"], dev, torch.float32),
        "decoder": _torch_tree(tree["decoder"], dev, decode_dtype),
        "quantizer": torch.as_tensor(np.asarray(tree["quantizer"], np.float32)).to(dev),
    }


def random_codec_params(cfg: EncodecConfig = EncodecConfig(), seed: int = 0) -> Dict:
    """Seeded random codec weights in the JAX layout (numpy): every conv and
    LSTM weight and bias N(0, 1/fan-in), the codebooks N(0, 1) (all-zero
    codebooks would tie every distance).  For tests and smoke runs only; the
    real weights come from ``python -m valle_tpu_torch.bin.convert_codec``."""
    rng = np.random.RandomState(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    def conv(cin, cout, k):
        return {"w": normal((k, cin, cout), cin * k), "b": normal((cout,), cin * k)}

    def conv_t(cin, cout, k):
        return {"w": normal((k, cout, cin), cin * k), "b": normal((cout,), cin * k)}

    def resblock(dim):
        hid = dim // cfg.compress
        return {"block_1": conv(dim, hid, cfg.residual_kernel_size),
                "block_3": conv(hid, dim, 1), "shortcut": conv(dim, dim, 1)}

    def lstm(dim):
        return [{"wi": normal((4 * dim, dim), dim), "wh": normal((4 * dim, dim), dim),
                 "bi": normal((4 * dim,), dim), "bh": normal((4 * dim,), dim)}
                for _ in range(cfg.num_lstm_layers)]

    enc: Dict = {}
    mult = 1
    enc["layers_0"] = conv(cfg.audio_channels, cfg.num_filters, cfg.kernel_size)
    idx = 1
    for ratio in reversed(cfg.upsampling_ratios):
        dim = mult * cfg.num_filters
        for _ in range(cfg.num_residual_layers):
            enc[f"layers_{idx}"] = resblock(dim)
            idx += 1
        idx += 1
        enc[f"layers_{idx}"] = conv(dim, 2 * dim, 2 * ratio)
        idx += 1
        mult *= 2
    top = mult * cfg.num_filters
    enc[f"layers_{idx}"] = lstm(top)
    idx += 2
    enc[f"layers_{idx}"] = conv(top, cfg.hidden_size, cfg.last_kernel_size)

    dec: Dict = {"layers_0": conv(cfg.hidden_size, top, cfg.kernel_size),
                 "layers_1": lstm(top)}
    idx = 2
    for ratio in cfg.upsampling_ratios:
        dim = mult * cfg.num_filters
        idx += 1
        dec[f"layers_{idx}"] = conv_t(dim, dim // 2, 2 * ratio)
        idx += 1
        for _ in range(cfg.num_residual_layers):
            dec[f"layers_{idx}"] = resblock(dim // 2)
            idx += 1
        mult //= 2
    dec[f"layers_{idx + 1}"] = conv(cfg.num_filters, cfg.audio_channels, cfg.last_kernel_size)
    quantizer = rng.standard_normal(
        (cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim)).astype(np.float32)
    return {"encoder": enc, "decoder": dec, "quantizer": quantizer}


# ------------------------------------------------------------------ public api


@contextlib.contextmanager
def full_f32():
    """cuDNN's convolutions and LSTM and cuBLAS's matmuls in full f32 inside,
    whatever the process's TF32 flags: PyTorch lets cuDNN round f32 inputs
    to TF32 by default, and one prompt code flipped by that rounding changes
    everything generated after it."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, allow in zip(flags, saved):
            f.allow_tf32 = allow


class Encodec:
    """EnCodec on the card (or on ``device``), from the JAX params tree:
    the twin of ``EncodecJax``.

    ``decode_dtype="bfloat16"`` runs the decode direction in bf16 (the
    decoder's weights cast once); encode always stays in f32, so codes do
    not depend on it.  Both directions run in full f32 (no TF32) whatever
    the process's flags."""

    def __init__(self, params: Mapping, cfg: Optional[EncodecConfig] = None,
                 decode_dtype: str = "float32", device=None):
        self.cfg = cfg or EncodecConfig()
        self.decode_dtype = getattr(torch, decode_dtype)
        self.params = codec_params_to_torch(params, device, self.decode_dtype)
        self.device = self.params["quantizer"].device

    @property
    def sample_rate(self) -> int:
        return self.cfg.sampling_rate

    @property
    def channels(self) -> int:
        return self.cfg.audio_channels

    @torch.inference_mode()
    def encode(self, wav, bandwidth: float = 6.0) -> torch.Tensor:
        """wav (B, channels, T) float -> codes (B, T', num_q) int64 on the
        codec's device (6 kbps = 8 codebooks)."""
        num_q = self.cfg.num_q_for_bandwidth(bandwidth)
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        with full_f32():
            latents = encode_latents(self.params, wav, self.cfg)
            return rvq_encode(self.params["quantizer"], latents, num_q)

    @torch.inference_mode()
    def decode(self, codes, *, out_int16: bool = False) -> torch.Tensor:
        """codes (B, T', Q) int -> wav (B, channels, T) f32 on the codec's
        device; ``out_int16=True`` returns round-half-even of
        ``clip(wav, -1, 1) · 32767`` as int16, computed on the device."""
        codes = torch.as_tensor(codes).to(self.device)
        latents = rvq_decode(self.params["quantizer"], codes).to(self.decode_dtype)
        with full_f32():
            wav = decode_latents(self.params, latents, self.cfg).float()
        if out_int16:
            return torch.round(wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return wav
