"""Instruction tokenization (a copy of the JAX package's ``data/text.py``).

Reference format (data.py:905-919): ``<image>{instr}<|endofchunk|>{eos}``,
right padding to the longest in the batch, max_length 32.  The special
tokens <|endofchunk|>, <image> and <PAD> sit at the top of the vocabulary.

``HashTokenizer`` is the deterministic, dependency-free tokenizer the debug
paths use: words hash into the vocabulary range, the same text gives the
same ids in both packages.  ``HFTokenizer`` needs a transformers tokenizer,
which the port does not load yet.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic stand-in tokenizer with the Flamingo special tokens."""

    def __init__(self, vocab_size: int = 50432, max_length: int = 32):
        self.vocab_size = vocab_size
        self.max_length = max_length
        # ids at the top of the vocab, in resize_token_embeddings order:
        # <|endofchunk|>, <image>, <PAD>
        self.eoc_token_id = vocab_size - 3
        self.media_token_id = vocab_size - 2
        self.pad_token_id = vocab_size - 1
        self.eos_token_id = 0
        self._word_range = vocab_size - 4

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 1 + h % (self._word_range - 1)

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), right-padded to the longest (capped
        at max_length), layout ``<image> w1..wn <|endofchunk|> <eos>``."""
        seqs: List[List[int]] = []
        for t in texts:
            ids = [self.media_token_id]
            ids += [self._word_id(w) for w in t.strip().split()]
            ids += [self.eoc_token_id, self.eos_token_id]
            seqs.append(ids[: self.max_length])
        longest = max(min(max(len(s) for s in seqs), self.max_length), 1)
        input_ids = np.full((len(seqs), longest), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), longest), np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        return input_ids, mask


class HFTokenizer:
    """A transformers tokenizer with the Flamingo specials.  Not ported: the
    port depends on no tokenizer package."""

    def __init__(self, tokenizer_path: str, max_length: int = 32):
        raise NotImplementedError(
            f"HFTokenizer is not ported (asked for {tokenizer_path!r}); use "
            "HashTokenizer")


def fixed_length(ids: np.ndarray, mask: np.ndarray, length: int,
                 pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad or crop (B, S) ids and mask to ``length`` columns."""
    b, s = ids.shape
    if s >= length:
        return ids[:, :length], mask[:, :length]
    out_ids = np.full((b, length), pad_id, ids.dtype)
    out_mask = np.zeros((b, length), mask.dtype)
    out_ids[:, :s] = ids
    out_mask[:, :s] = mask
    return out_ids, out_mask


def window_text(input_ids: np.ndarray, attention_mask: np.ndarray, cfg):
    """(B, S) instructions -> the training forward's text rows at
    ``cfg.text_len``: one a frame, or one a window under 'vit_concat'
    (train_utils.py:240-251); padding ids are masked out."""
    ids, mask = np.asarray(input_ids), np.asarray(attention_mask)
    if cfg.fusion_mode != "vit_concat":
        w = cfg.window_size
        b, s = ids.shape
        ids = np.repeat(ids[:, None], w, axis=1).reshape(b * w, s)
        mask = np.repeat(mask[:, None], w, axis=1).reshape(b * w, s)
    return fixed_length(ids, mask, cfg.text_len, 0)
