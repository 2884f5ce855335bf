"""k2-style symbol<->id table with file (de)serialization: the port's copy
of ``valle_tpu/data/symbol_table.py``.

Format contract (the reference's valle/utils/symbol_table.py:31-287, and
the k2 project's ``.k2symbols`` files): plain text, one ``<symbol> <id>`` pair
per line, with ``<eps>`` occupying id 0 unless the file says otherwise.  The
on-disk format must stay byte-compatible so tables written by the reference's
``bin/tokenizer.py`` load here unchanged; the implementation below is
otherwise independent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Generic, List, Optional, TypeVar, Union

Symbol = TypeVar("Symbol")


class SymbolTable(Generic[Symbol]):
    """Bidirectional symbol<->integer-id mapping.

    Construct empty (optionally seeding epsilon at id 0), or via
    :meth:`from_str` / :meth:`from_file` for the k2 text format.
    """

    def __init__(self, eps: Optional[Symbol] = "<eps>"):
        self._by_id: dict = {}
        self._by_sym: dict = {}
        self.eps = eps
        if eps is not None:
            self._by_id[0] = eps
            self._by_sym[eps] = 0

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_str(s: str) -> "SymbolTable":
        table = SymbolTable(eps=None)
        for lineno, line in enumerate(s.split("\n"), start=1):
            fields = line.split()
            if not fields:
                continue
            if len(fields) != 2:
                raise ValueError(
                    f"symbol-table line {lineno} is not '<symbol> <id>': "
                    f"{line!r}"
                )
            sym, idx = fields[0], int(fields[1])
            if sym in table._by_sym:
                raise RuntimeError(
                    f"symbol {sym!r} appears twice (line {lineno})"
                )
            if idx in table._by_id:
                raise RuntimeError(f"id {idx} appears twice (line {lineno})")
            table._by_id[idx] = sym
            table._by_sym[sym] = idx
        # files without an explicit id-0 line still get epsilon at 0 (the
        # k2/reference loader auto-seeds it)
        table.eps = table._by_id.setdefault(0, "<eps>")
        table._by_sym.setdefault(table.eps, 0)
        return table

    @staticmethod
    def from_file(filename: Union[str, Path]) -> "SymbolTable":
        text = Path(filename).read_text(encoding="utf-8")
        return SymbolTable.from_str(text.strip())

    # -- serialization ------------------------------------------------------

    def to_str(self) -> str:
        lines = [f"{sym} {idx}" for idx, sym in sorted(self._by_id.items())]
        return "\n".join(lines)

    def to_file(self, filename: Union[str, Path]) -> None:
        Path(filename).write_text(self.to_str() + "\n", encoding="utf-8")

    # -- mutation -----------------------------------------------------------

    def add(self, symbol: Symbol, index: Optional[int] = None) -> int:
        existing = self._by_sym.get(symbol)
        if existing is not None:
            return existing
        if index is None:
            index = max(self._by_id, default=-1) + 1
        elif index in self._by_id:
            raise ValueError(f"id {index} is occupied")
        self._by_id[index] = symbol
        self._by_sym[symbol] = index
        return index

    def merge(self, other: "SymbolTable") -> "SymbolTable":
        self._check_compatible(other)
        merged = SymbolTable(eps=None)
        merged.eps = self.eps
        for src in (self, other):
            for idx, sym in src._by_id.items():
                merged._by_id.setdefault(idx, sym)
            for sym, idx in src._by_sym.items():
                merged._by_sym.setdefault(sym, idx)
        return merged

    def _check_compatible(self, other: "SymbolTable") -> None:
        assert self.eps == other.eps, "mismatched epsilon"
        for idx in self._by_id.keys() & other._by_id.keys():
            assert self._by_id[idx] == other._by_id[idx], idx
        for sym in self._by_sym.keys() & other._by_sym.keys():
            assert self._by_sym[sym] == other._by_sym[sym], sym

    # -- lookup -------------------------------------------------------------

    def get(self, k: Union[int, Symbol]) -> Union[Symbol, int]:
        return self._by_id[k] if isinstance(k, int) else self._by_sym[k]

    @property
    def ids(self) -> List[int]:
        return sorted(self._by_id)

    @property
    def symbols(self) -> List[Symbol]:
        return sorted(self._by_sym)

    def __contains__(self, item) -> bool:
        return item in (self._by_id if isinstance(item, int) else self._by_sym)

    def __len__(self) -> int:
        return len(self._by_id)

    def __getitem__(self, item):
        return self.get(item)
