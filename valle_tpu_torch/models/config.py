"""Model configuration: the twin of ``valle_tpu/models/config.py``.

Same fields, defaults and validation; ``compute_dtype`` returns a torch dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from valle_tpu_torch import macros


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_name: str = "VALL-E"  # VALL-E | VALL-F | Transformer
    decoder_dim: int = 1024
    nhead: int = 16
    num_layers: int = 12
    norm_first: bool = True
    add_prenet: bool = False
    prefix_mode: int = 0  # 0,1,2,4
    share_embedding: bool = True
    nar_scale_factor: float = 1.0
    prepend_bos: bool = False
    num_quantizers: int = 8
    scaling_xformers: bool = False

    num_text_tokens: int = macros.NUM_TEXT_TOKENS
    num_audio_tokens: int = macros.NUM_AUDIO_TOKENS
    num_mel_bins: int = macros.NUM_MEL_BINS

    dropout: float = 0.1
    max_len: int = 4096  # positional-table capacity
    max_prefix_len: int = 225  # 3 s at 75 Hz

    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    attn_impl: str = "xla"  # xla | fused | flash | flash_kp
    # Decode KV-cache storage: "model" keeps K/V in the compute dtype,
    # "int8" stores symmetric per-(token, head) int8 values + f32 scales.
    kv_cache_dtype: str = "model"  # model | int8
    remat: str = "none"  # layer remat in training: none | full | dots_nobatch
    # with int8-quantized weights (nn.qdense.quantize_variables), also
    # quantize activations per row at run time: W8A8 (no effect on float weights)
    act_quant: bool = False

    def __post_init__(self):
        if isinstance(self.remat, bool):
            object.__setattr__(self, "remat", "full" if self.remat else "none")
        if self.remat not in ("none", "full", "dots_nobatch"):
            raise ValueError(
                f"remat must be 'none', 'full' or 'dots_nobatch' (or a bool), "
                f"got {self.remat!r}"
            )
        if self.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'model' or 'int8', got "
                f"{self.kv_cache_dtype!r}"
            )
        if self.attn_impl not in ("xla", "fused", "flash", "flash_kp"):
            raise ValueError(
                f"attn_impl must be 'xla', 'fused', 'flash' or 'flash_kp', "
                f"got {self.attn_impl!r}"
            )
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {self.dtype!r}"
            )

    @property
    def nar_decoder_dim(self) -> int:
        return int(self.decoder_dim * self.nar_scale_factor)

    @property
    def nar_nhead(self) -> int:
        return int(self.nhead * self.nar_scale_factor)

    @property
    def nar_num_layers(self) -> int:
        return int(self.num_layers * self.nar_scale_factor)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def eos_id(self) -> int:
        return self.num_audio_tokens

    @property
    def bos_id(self) -> int:
        return self.num_audio_tokens + 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
