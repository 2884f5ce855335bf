"""The data modules that zero-shot inference reads: wav I/O, the text
frontend and its symbol table.  Copies of the JAX package's modules of the
same names (``valle_tpu/data``), which the port may not import."""

from valle_tpu_torch.data.audio_io import convert_audio, read_wav, resample, write_wav
from valle_tpu_torch.data.collation import TextTokenCollater, get_text_token_collater
from valle_tpu_torch.data.symbol_table import SymbolTable
from valle_tpu_torch.data.text_tokenizer import TextTokenizer, tokenize_text

__all__ = ["convert_audio", "read_wav", "resample", "write_wav", "TextTokenCollater",
           "get_text_token_collater", "SymbolTable", "TextTokenizer", "tokenize_text"]
