"""Phoneme-string collation to padded id arrays: the port's copy of
``valle_tpu/data/collation.py``.

Parity: the reference's valle/data/collation.py:10-122 — vocab built as
[<pad>, <bos>, <eos>] + sorted(symbols); sequences wrapped with BOS/EOS then
padded; lens include BOS/EOS.  Returns numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from valle_tpu_torch.data.symbol_table import SymbolTable


class TextTokenCollater:
    def __init__(
        self,
        text_tokens: List[str],
        add_eos: bool = True,
        add_bos: bool = True,
        pad_symbol: str = "<pad>",
        bos_symbol: str = "<bos>",
        eos_symbol: str = "<eos>",
    ):
        self.pad_symbol = pad_symbol
        self.add_eos = add_eos
        self.add_bos = add_bos
        self.bos_symbol = bos_symbol
        self.eos_symbol = eos_symbol

        # Vocab-order contract: pad=0, then bos/eos (when enabled), then the
        # corpus symbols in sorted order.  Checkpoints trained against a
        # given .k2symbols file depend on these exact ids.
        vocab: List[str] = [pad_symbol]
        if add_bos:
            vocab.append(bos_symbol)
        if add_eos:
            vocab.append(eos_symbol)
        vocab.extend(sorted(text_tokens))
        self.idx2token = vocab
        self.token2idx = {tok: i for i, tok in enumerate(vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.idx2token)

    def index(self, tokens_list: List[List[str]]) -> Tuple[np.ndarray, np.ndarray]:
        seqs, seq_lens = [], []
        for tokens in tokens_list:
            assert all(s in self.token2idx for s in tokens), [
                s for s in tokens if s not in self.token2idx
            ]
            seq = (
                ([self.bos_symbol] if self.add_bos else [])
                + list(tokens)
                + ([self.eos_symbol] if self.add_eos else [])
            )
            seqs.append(seq)
            seq_lens.append(len(seq))
        max_len = max(seq_lens)
        for seq, n in zip(seqs, seq_lens):
            seq.extend([self.pad_symbol] * (max_len - n))
        ids = np.array(
            [[self.token2idx[t] for t in seq] for seq in seqs], dtype=np.int64
        )
        return ids, np.array(seq_lens, dtype=np.int32)

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        tokens_seqs = [[p for p in text] for text in texts]
        max_len = len(max(tokens_seqs, key=len))
        seqs = [
            ([self.bos_symbol] if self.add_bos else [])
            + list(seq)
            + ([self.eos_symbol] if self.add_eos else [])
            + [self.pad_symbol] * (max_len - len(seq))
            for seq in tokens_seqs
        ]
        ids = np.array(
            [[self.token2idx[t] for t in seq] for seq in seqs], dtype=np.int64
        )
        lens = np.array(
            [len(seq) + int(self.add_eos) + int(self.add_bos) for seq in tokens_seqs],
            dtype=np.int32,
        )
        return ids, lens


def get_text_token_collater(text_tokens_file: str) -> TextTokenCollater:
    unique_tokens = SymbolTable.from_file(Path(text_tokens_file))
    return TextTokenCollater(unique_tokens.symbols, add_bos=True, add_eos=True)
