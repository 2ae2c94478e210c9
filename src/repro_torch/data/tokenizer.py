"""Hashing tokenizer: string tweets -> term-id matrices (host-side, the
dictionary in front of the postings pools).

A copy of the reference package's ``data/tokenizer.py`` (hashlib and
numpy): the same text gives the same term ids in both packages.
"""
from __future__ import annotations

import hashlib
import re
from typing import Iterable, List

import numpy as np

_TOKEN_RE = re.compile(r"[#@]?\w+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def term_id(token: str, vocab_size: int) -> int:
    h = hashlib.blake2s(token.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % vocab_size


def encode_docs(texts: Iterable[str], vocab_size: int,
                max_len: int = 70) -> np.ndarray:
    rows = []
    for t in texts:
        ids = [term_id(tok, vocab_size) for tok in tokenize(t)][:max_len]
        rows.append(ids + [-1] * (max_len - len(ids)))
    return np.asarray(rows, np.int32)


def encode_query(text: str, vocab_size: int, max_terms: int = 8):
    ids = [term_id(tok, vocab_size) for tok in tokenize(text)][:max_terms]
    n = len(ids)
    return np.asarray(ids + [0] * (max_terms - n), np.uint32), n
