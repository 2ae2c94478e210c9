"""Descending-list merges shared by the batched query path.

Only the merges that ``core.qexec`` needs are ported so far; the
document-sharded engine itself is a later slice (ROADMAP.md, Queue 1
item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

INVALID = 0xFFFFFFFF


def merge_desc(flat_desc):
    """Vectorised merge of concatenated descending INVALID-padded lists
    along the last axis: one sort on a flipped key (``INVALID - 1 - x``
    for valid entries, INVALID fixed) yields valid docids descending at
    the front and all INVALID padding at the back.  Duplicates are
    preserved."""
    x = flat_desc
    key = torch.where(x == INVALID, x, INVALID - 1 - x)
    key = torch.sort(key, -1).values
    return torch.where(key == INVALID, key, INVALID - 1 - key)


def merge_desc_scored(flat_desc, flat_scores):
    """:func:`merge_desc` with a parallel int32 score array carried
    through one stable sort on the same key: returns ``(ids, scores)``
    with valid docids descending at the front and the INVALID lanes, in
    their original order, at the back."""
    x = flat_desc
    key = torch.where(x == INVALID, x, INVALID - 1 - x)
    order = torch.sort(key, dim=-1, stable=True).indices
    return torch.gather(x, -1, order), torch.gather(flat_scores, -1, order)


def topk_merge_desc(lists_desc, ns, k: Optional[int] = None):
    """Merge per-shard descending lists ``[S, W]`` (counts ``ns[S]``)
    into one descending list, optionally truncated to the newest ``k``.
    Returns ``(desc, n_total)``."""
    merged = merge_desc(lists_desc.reshape(-1))
    n = torch.as_tensor(ns).to(torch.int32).sum()
    if k is not None:
        merged = merged[:k]
        n = n.clamp(max=k)
    return merged, n
