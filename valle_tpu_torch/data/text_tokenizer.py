"""Grapheme -> phoneme tokenization: the port's copy of
``valle_tpu/data/text_tokenizer.py``.

Parity: the reference's valle/data/tokenizer.py:40-209 —
``TextTokenizer`` wraps phonemizer/espeak (host-side C library, data-prep
only) with separators word="_", syllable="-", phone="|" and the ``to_list``
regex post-processing producing the k2symbols token stream; ``PypinyinBackend``
covers Chinese.  A pure-python ``chars`` backend is provided for environments
without espeak (tests, CI) — it emits per-character tokens with the same
separator contract.
"""

from __future__ import annotations

import re
from typing import Any, List, Pattern, Union

_DEFAULT_MARKS = ';:,.!?¡¿—…"«»“”'


class Separator:
    def __init__(self, word="_", syllable="-", phone="|"):
        self.word = word
        self.syllable = syllable
        self.phone = phone


class CharsBackend:
    """Fallback backend: characters as phonemes (deterministic, no deps)."""

    def phonemize(self, text: List[str], separator: Separator, strip=True, njobs=1):
        out = []
        for t in text:
            t = re.sub(" +", " ", t.strip())
            words = t.split(" ")
            out.append(
                separator.word.join(
                    separator.phone.join(list(w)) + separator.phone for w in words
                )
            )
        return out


class PypinyinBackend:
    """Chinese pinyin backend (ref tokenizer.py:40-113)."""

    def __init__(
        self,
        backend="initials_finals",
        punctuation_marks: Union[str, Pattern] = _DEFAULT_MARKS,
    ) -> None:
        self.backend = backend
        self.punctuation_marks = punctuation_marks

    def phonemize(
        self, text: List[str], separator: Separator, strip=True, njobs=1
    ) -> List[str]:
        from pypinyin import Style, pinyin
        from pypinyin.style._utils import get_finals, get_initials

        assert isinstance(text, list)
        phonemized = []
        for _text in text:
            _text = re.sub(" +", " ", _text.strip())
            _text = _text.replace(" ", separator.word)
            phones = []
            for _, py in enumerate(
                pinyin(_text, style=Style.TONE3, neutral_tone_with_five=True)
            ):
                if all(c in self.punctuation_marks for c in py[0]):
                    if len(phones):
                        assert phones[-1] == separator.syllable
                        phones.pop(-1)
                    phones.extend(list(py[0]))
                elif self.backend == "pypinyin":
                    phones.extend([py[0], separator.syllable])
                else:  # pypinyin_initials_finals
                    if py[0][-1].isalnum():
                        initial = get_initials(py[0], strict=False)
                        if py[0][-1].isdigit():
                            final = get_finals(py[0][:-1], strict=False) + py[0][-1]
                        else:
                            final = get_finals(py[0], strict=False)
                        phones.extend(
                            [initial, separator.phone, final, separator.syllable]
                        )
                    else:
                        raise ValueError(py)
            phonemized.append(
                "".join(phones).rstrip(f"{separator.word}{separator.syllable}")
            )
        return phonemized


class TextTokenizer:
    """Phonemize text into a list of symbol strings."""

    def __init__(
        self,
        language: str = "en-us",
        backend: str = "espeak",
        separator: Separator | None = None,
        preserve_punctuation: bool = True,
        punctuation_marks: Union[str, Pattern] = _DEFAULT_MARKS,
        with_stress: bool = False,
        tie: Union[bool, str] = False,
        language_switch: str = "keep-flags",
        words_mismatch: str = "ignore",
    ) -> None:
        self.separator = separator or Separator()
        if backend == "espeak":
            try:
                from phonemizer.backend import EspeakBackend

                self.backend: Any = EspeakBackend(
                    language,
                    punctuation_marks=punctuation_marks,
                    preserve_punctuation=preserve_punctuation,
                    with_stress=with_stress,
                    tie=tie,
                    language_switch=language_switch,
                    words_mismatch=words_mismatch,
                )
            except ImportError as e:
                raise ImportError(
                    "The espeak backend needs the `phonemizer` package and the "
                    "espeak-ng C library; install them or use backend='chars'."
                ) from e
        elif backend in ("pypinyin", "pypinyin_initials_finals"):
            self.backend = PypinyinBackend(
                backend=backend,
                punctuation_marks=punctuation_marks + self.separator.word,
            )
        elif backend == "chars":
            self.backend = CharsBackend()
        else:
            raise NotImplementedError(backend)

    def to_list(self, phonemized: str) -> List[str]:
        """Split a phonemized string into symbols (ref tokenizer.py:152-164)."""
        fields = []
        for word in phonemized.split(self.separator.word):
            pp = re.findall(r"\w+|[^\w\s]", word, re.UNICODE)
            fields.extend(
                [p for p in pp if p != self.separator.phone] + [self.separator.word]
            )
        assert len("".join(fields[:-1])) == len(phonemized) - phonemized.count(
            self.separator.phone
        )
        return fields[:-1]

    def __call__(self, text, strip=True) -> List[List[str]]:
        if isinstance(text, str):
            text = [text]
        phonemized = self.backend.phonemize(
            text, separator=self.separator, strip=strip, njobs=1
        )
        return [self.to_list(p) for p in phonemized]


def tokenize_text(tokenizer: TextTokenizer, text: str) -> List[str]:
    return tokenizer([text.strip()])[0]
