"""Tokenizer utilities of the port (a copy of
t2v_metrics_tpu/tokenization.py, under the same names).

  * the prompt is split on ``<image>``; each chunk is tokenized separately
    with special tokens (for T5 this appends ``</s>`` to *every* chunk, a
    quirk the pretrained CLIP-FlanT5 weights expect);
  * chunks are joined by IMAGE_TOKEN_INDEX (-200) markers.

The port never contacts the Hugging Face hub: ``load_hf_tokenizer`` reads a
local directory, or the local cache with ``local_files_only``.
"""

from __future__ import annotations

from .constants import IMAGE_TOKEN_INDEX


def splice_image_tokens_t5(prompt: str, tokenizer,
                           image_token_index: int = IMAGE_TOKEN_INDEX) -> list[int]:
    """T5 (no BOS) variant of image-token splicing."""
    chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]
    out: list[int] = []
    for i, chunk in enumerate(chunks):
        if i:
            out.append(image_token_index)
        out.extend(chunk)
    return out


def splice_image_tokens(prompt: str, tokenizer,
                        image_token_index: int = IMAGE_TOKEN_INDEX) -> list[int]:
    """Decoder-only (BOS-keeping) splicing, the reference LLaVA's
    ``tokenizer_image_token``: each chunk is tokenized with special tokens;
    a leading BOS is kept once, from the first chunk, and each ``<image>``
    is one ``image_token_index``."""
    chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]
    bos = getattr(tokenizer, "bos_token_id", None)
    offset = 1 if (chunks and chunks[0] and bos is not None and chunks[0][0] == bos) else 0
    out: list[int] = chunks[0][:offset]
    for i, chunk in enumerate(chunks):
        if i:
            out.append(image_token_index)
        out.extend(chunk[offset:])
    return out


def load_hf_tokenizer(path: str, **kwargs):
    """Load a fast tokenizer from a local directory or the local HF cache;
    never from the network. Needs ``transformers``, which the GPU machine
    lacks: there it raises ImportError saying so."""
    import os

    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer {path!r} needs the transformers package, "
            "which is not installed; pass a tokenizer object, or leave tokenizer "
            "out to use SimpleT5Tokenizer (scores then do not match pretrained "
            "weights)") from e

    if not os.path.isdir(path):
        kwargs.setdefault("local_files_only", True)
    return AutoTokenizer.from_pretrained(path, use_fast=True, **kwargs)


class SimpleT5Tokenizer:
    """Minimal whitespace tokenizer with the T5 special-token layout.

    Used by tests and random-weight runs where no pretrained vocabulary is
    available. The vocabulary is built on the fly; ids are stable within an
    instance. Mirrors the call contract of a HF tokenizer:
    ``tok(text).input_ids`` appends </s> (id 1), pad=0.
    """

    class _Enc:
        def __init__(self, ids):
            self.input_ids = ids

    def __init__(self, vocab_size: int = 32128):
        self.pad_token_id = 0
        self.eos_token_id = 1
        self.unk_token_id = 2
        self.bos_token_id = None
        self.vocab_size = vocab_size
        self._vocab: dict[str, int] = {"<pad>": 0, "</s>": 1, "<unk>": 2}

    def _id(self, word: str) -> int:
        if word not in self._vocab:
            if len(self._vocab) < self.vocab_size:
                self._vocab[word] = len(self._vocab)
            else:
                return self.unk_token_id
        return self._vocab[word]

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = [self._id(w) for w in text.split()]
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return self._Enc(ids)

    def encode(self, text: str, add_special_tokens: bool = True):
        return self(text, add_special_tokens=add_special_tokens).input_ids

    def decode(self, ids) -> str:
        rev = {v: k for k, v in self._vocab.items()}
        return " ".join(rev.get(int(i), "<unk>") for i in ids)
