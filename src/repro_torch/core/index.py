"""Active index segment: tweet ingest + dictionary (paper §3.2).

``ActiveSegment`` owns a :class:`~repro_torch.core.slicepool.PoolState`
plus the docid high-water mark; tweets arrive as (batch, max_len)
padded term-id matrices and are flattened into a (term, posting) stream
consumed by the batch-parallel bulk allocator (the per-posting scan
remains as the semantics oracle).  The dictionary is implicit: term ids
index the ``tail``/``freq`` tensors.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.core import postings as post
from repro_torch.core import slicepool
from repro_torch.core.pointers import PoolLayout


@dataclasses.dataclass
class ActiveSegment:
    """``bulk_ingest=True`` (default) uses the batch-parallel allocator
    (:func:`repro_torch.core.slicepool.make_bulk_ingest_fn`); ``False``
    keeps the per-posting scan — the bit-exactness oracle.  The state
    lives on ``device`` ("cuda" unless the caller asks for the CPU)."""
    layout: PoolLayout
    vocab_size: int
    max_docs: int = post.MAX_DOC
    state: slicepool.PoolState = None
    next_docid: int = 0
    bulk_ingest: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.state is None:
            self.state = slicepool.init_state(self.layout, self.vocab_size,
                                              self.device)
        if self.bulk_ingest:
            self._ingest = slicepool.make_bulk_ingest_fn(
                self.layout, self.vocab_size, str(self.state.heap.device))
        else:
            self._ingest = slicepool.make_ingest_fn(self.layout,
                                                    self.vocab_size)

    @property
    def is_full(self) -> bool:
        return self.next_docid >= self.max_docs

    def ingest(self, docs, start_pools=None,
               term_start_pools=None) -> int:
        """Index a batch of documents.

        Args:
          docs: int32[batch, max_len] term ids, padded with -1 (numpy or
            torch).
          start_pools: optional per-occurrence starting pools.
          term_start_pools: optional [vocab] per-term starting pools (SP
            policy table); gathered per occurrence.
        Returns the number of documents indexed.
        """
        dev = self.state.heap.device
        docs = torch.as_tensor(docs, device=dev)
        if not docs.is_signed():
            # uint32 term ids (the reference's journals) hold the same
            # values as int64, which torch compares and gathers
            docs = docs.long()
        batch = docs.shape[0]
        terms, plist, valid = flatten(docs, self.next_docid)
        if term_start_pools is not None:
            start_pools = gather_start_pools(
                torch.as_tensor(term_start_pools, device=dev), terms,
                self.vocab_size)
        self.state = self._ingest(self.state, terms, plist, start_pools,
                                  valid)
        self.next_docid += batch
        return batch

    def memory_slots_used(self) -> int:
        return int(slicepool.memory_slots_used(self.layout, self.state))

    def term_freqs(self) -> np.ndarray:
        return self.state.freq.cpu().numpy()

    def check_health(self) -> None:
        if bool(self.state.overflow):
            raise MemoryError(
                "slice pools exhausted; raise slices_per_pool in the layout")


def gather_start_pools(term_start_pools, terms, vocab_size: int):
    """Per-occurrence starting pools from a per-term SP policy table."""
    return term_start_pools[terms.long().clamp(0, vocab_size - 1)].long()


def flatten(docs, first_docid: int):
    """(batch, L) padded docs -> flat (terms, packed postings, valid):
    int64 terms (0 where padded), int64 postings, bool valid."""
    batch, L = docs.shape
    dev = docs.device
    pos = torch.arange(L, device=dev).clamp(max=post.MAX_POS)
    ids = first_docid + torch.arange(batch, device=dev)
    valid = docs >= 0
    terms = torch.where(valid, docs.long(), 0)
    plist = post.pack(ids[:, None], pos[None, :]).expand(batch, L)
    return terms.reshape(-1), plist.reshape(-1), valid.reshape(-1)


def make_flattener():
    """The reference's factory form of :func:`flatten`."""
    return flatten
