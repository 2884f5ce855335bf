"""The data modules of the port, the twins of ``valle_tpu/data`` under the
same names: wav I/O, the text frontend and its symbol table, the shards and
manifests, the bucketing sampler, the loader with its prompts and
SpecAugment, the BigVGAN log-mel features (``fbank``), and the C++ loader's
binding (``native_loader``).  The port
keeps its own copies: it may not import the JAX package."""

from valle_tpu_torch.data.audio_io import convert_audio, read_wav, resample, write_wav
from valle_tpu_torch.data.bucketing import BucketSpec, DynamicBucketingSampler, SingleCutSampler
from valle_tpu_torch.data.collation import TextTokenCollater, get_text_token_collater
from valle_tpu_torch.data.dataset import Prefetcher, SpeechSynthesisDataset, TtsDataLoader
from valle_tpu_torch.data.fbank import BigVGANFbank, get_fbank_extractor, mel_distance
from valle_tpu_torch.data.input_strategies import NeighborPromptStrategy, PromptedFeatures
from valle_tpu_torch.data.shards import CodeShardWriter, Manifest
from valle_tpu_torch.data.symbol_table import SymbolTable
from valle_tpu_torch.data.text_tokenizer import TextTokenizer, tokenize_text
from valle_tpu_torch.data.transforms import SpecAugment
from valle_tpu_torch.data.vshard import VShardReader, VShardWriter

__all__ = ["convert_audio", "read_wav", "resample", "write_wav", "BucketSpec",
           "DynamicBucketingSampler", "SingleCutSampler", "TextTokenCollater",
           "get_text_token_collater", "Prefetcher", "SpeechSynthesisDataset", "TtsDataLoader",
           "BigVGANFbank", "get_fbank_extractor", "mel_distance",
           "NeighborPromptStrategy", "PromptedFeatures", "CodeShardWriter", "Manifest",
           "SymbolTable", "TextTokenizer", "tokenize_text", "SpecAugment", "VShardReader",
           "VShardWriter"]
