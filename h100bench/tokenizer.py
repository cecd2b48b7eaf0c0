"""The benchmark's tokenizer: whitespace words with fixed ids.

It keeps the call contract of the port's ``SimpleT5Tokenizer`` (``tok(text)
.input_ids`` appends ``</s>`` = 1, pad 0, unk 2), but a word's id is a hash
of the word, not the order in which words were first seen, so the port and
the reference give every prompt the same ids whatever ran first.
"""

from __future__ import annotations

import zlib


class WordTokenizer:
    class _Enc:
        def __init__(self, ids):
            self.input_ids = ids

    def __init__(self, vocab_size: int):
        if vocab_size < 8:
            raise ValueError("vocab_size must be at least 8")
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.unk_token_id = 2
        self.bos_token_id = None

    def word_id(self, word: str) -> int:
        return 3 + zlib.crc32(word.encode()) % (self.vocab_size - 3)

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = [self.word_id(w) for w in text.split()]
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return self._Enc(ids)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self(text, add_special_tokens).input_ids

