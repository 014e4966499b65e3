"""Text tokenization (host side; tokenization never touches the device).

A copy of `qwen3_tts_tpu/utils/tokenizer.py`.

Mirror of the reference wrapper (`src/utils/tokenizer.rs:8-36`): the same
`<model_dir>/tokenizer/tokenizer.json` consumed through the HF `tokenizers`
library, `encode(text, add_special_tokens=False)` / `decode`.

A deterministic byte-level fallback is provided for tests and environments
without a tokenizer.json; it maps UTF-8 bytes to ids [0, 256) and is NOT
compatible with real checkpoints.
"""

from __future__ import annotations

import os
from typing import List, Sequence


class Tokenizer:
    warning: str | None = None   # real tokenizer: nothing to surface

    def __init__(self, inner):
        self._inner = inner

    @classmethod
    def load(cls, model_dir: str) -> "Tokenizer":
        path = os.path.join(model_dir, "tokenizer", "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"tokenizer.json not found at {path}")
        from tokenizers import Tokenizer as HfTokenizer

        return cls(HfTokenizer.from_file(path))

    def encode(self, text: str) -> List[int]:
        return list(self._inner.encode(text, add_special_tokens=False).ids)

    def decode(self, ids: Sequence[int]) -> str:
        return self._inner.decode(list(ids), skip_special_tokens=False)


class ByteTokenizer:
    """Test fallback: UTF-8 bytes as ids. Same interface as Tokenizer."""

    warning = ("no tokenizer.json found: using the byte-level fallback "
               "tokenizer, which is NOT compatible with real checkpoints")

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def load_tokenizer(model_dir: str):
    """Tokenizer.json when present, byte fallback otherwise (`.warning` is a
    non-None string on the fallback so callers can surface it)."""
    try:
        return Tokenizer.load(model_dir)
    except (FileNotFoundError, ImportError):
        import warnings

        tok = ByteTokenizer()
        warnings.warn(tok.warning, stacklevel=2)
        return tok
