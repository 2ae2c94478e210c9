"""Posting encoding (paper §3.2): one uint32 = 24-bit docid | 8-bit position.

Tweets are <= 140 chars so 8 bits suffice for term position; a term
occurring k times in one tweet yields k postings.  Docids are assigned in
ascending ingest order within a segment (max 2**24 - 1 per segment; the
production segment holds 2**23 tweets).  Postings are int64 tensors
holding the uint32 value (torch has no uint32 shifts).
"""
from __future__ import annotations

DOC_BITS = 24
POS_BITS = 8
MAX_DOC = (1 << DOC_BITS) - 1
MAX_POS = (1 << POS_BITS) - 1


def pack(docid, pos):
    return ((docid << POS_BITS) | (pos & MAX_POS)) & 0xFFFFFFFF


def docid(posting):
    return posting >> POS_BITS


def position(posting):
    return posting & MAX_POS
