"""Tokenization for the serving path.

Two implementations behind one interface:

- ``ByteTokenizer`` — deterministic UTF-8 byte-level tokenizer with
  reserved specials (pad=0, bos=1, eos=2, bytes at 3..258). Needs no
  downloads (this image has zero egress), works with every model config
  whose vocab >= 259, and doubles as the token counter the reference keeps
  pluggable (` main.py:295-307`).
- ``HFTokenizer`` — wraps a locally available `transformers` tokenizer
  (TOKENIZER_PATH env) for real deployments with downloaded vocabularies.
"""

from __future__ import annotations

import abc
from typing import List, Optional


class Tokenizer(abc.ABC):
    pad_id: int
    bos_id: int
    eos_id: int

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...

    @abc.abstractmethod
    def decode(self, ids: List[int]) -> str: ...

    def count(self, text: str) -> int:
        """Token counter signature matching SwarmDB's pluggable counter."""
        return len(self.encode(text, add_bos=False))


class ByteTokenizer(Tokenizer):
    """UTF-8 bytes shifted by 3; ids 0/1/2 are pad/bos/eos."""

    pad_id, bos_id, eos_id = 0, 1, 2
    _OFFSET = 3

    def __init__(self, vocab_size: int = 512) -> None:
        if vocab_size < 256 + self._OFFSET:
            raise ValueError("ByteTokenizer needs vocab_size >= 259")
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(
            i - self._OFFSET for i in ids if self._OFFSET <= i < 256 + self._OFFSET
        )
        return data.decode("utf-8", "replace")


class HFTokenizer(Tokenizer):
    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        self.pad_id = self._tok.pad_token_id or 0
        self.bos_id = self._tok.bos_token_id or 1
        self.eos_id = self._tok.eos_token_id or 2

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def default_tokenizer(vocab_size: int, path: Optional[str] = None) -> Tokenizer:
    if path:
        return HFTokenizer(path)
    return ByteTokenizer(vocab_size)
