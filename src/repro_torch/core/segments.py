"""Segment lifecycle (paper §3.1): active -> optimized read-only.

Earlybird keeps ~12 segments; at most one is mutable.  When the active
segment fills it is converted to a read-only structure:

  * :func:`freeze_state` walks every term's slice chain (on the state's
    device, all chains in lockstep) and produces a contiguous CSR
    postings store, ascending (chronological) within each term — the
    same bytes as the reference's per-term host walk.
  * :class:`SegmentSet` searches the active segment plus the frozen ones
    and recycles a frozen segment's slices into the next active one.
  * :meth:`SegmentSet.compact` + :class:`CompactionPolicy` merge
    adjacent frozen segments so the frozen count G stays O(log N).

Frozen segments are host-side numpy (uint32 CSR data), like the
reference's; :func:`compress_segment` gap-compresses one with the
``ForBlocks`` block codec (the sharded engine's ``compress``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pointers as ptr_mod
from repro_torch.core import postings as post
from repro_torch.core import slicepool
from repro_torch.core.index import ActiveSegment
from repro_torch.core.pointers import NULL, PoolLayout


@dataclasses.dataclass
class FrozenSegment:
    """Contiguous CSR postings store (ascending chronological per term)."""
    offsets: np.ndarray       # int64[V+1]
    data: np.ndarray          # uint32[total]
    n_docs: int
    doc_base: int = 0
    # per-pool arrays of slice indices the freeze walked — everything the
    # active segment had allocated, ready for slicepool.release_slices.
    freed_slices: Optional[List[np.ndarray]] = None
    # compaction tier: 0 straight from rollover; a merge yields
    # max(tier) + 1.
    tier: int = 0

    @property
    def members(self) -> List["FrozenSegment"]:
        """The CSR segments this segment is made of: itself (a
        ``ShardedFrozenSegment`` lists its shards)."""
        return [self]

    def postings(self, term: int) -> np.ndarray:
        return self.data[self.offsets[term]: self.offsets[term + 1]]

    def docids_desc(self, term: int) -> np.ndarray:
        p = self.postings(term)
        ids = (p >> np.uint32(post.POS_BITS))[::-1]
        return ids[np.concatenate([[True], ids[1:] != ids[:-1]])] \
            if ids.size else ids

    def docid_bounds(self, term: int) -> Tuple[int, int, int]:
        """O(1) per-term summary ``(n_postings, first_docid,
        last_docid)`` (docids as stored, segment-relative)."""
        a, b = int(self.offsets[term]), int(self.offsets[term + 1])
        if a == b:
            return 0, 0, 0
        shift = np.uint32(post.POS_BITS)
        return b - a, int(self.data[a] >> shift), int(self.data[b - 1] >> shift)

    def term_freqs(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    @property
    def total_postings(self) -> int:
        return int(self.offsets[-1])


def freeze_state(layout: PoolLayout, heap, tail, freq, *, n_docs: int,
                 doc_base: int = 0, docid_map=None) -> FrozenSegment:
    """Freeze pool-state tensors into a CSR read-only segment.

    Every live term's chain is walked newest-first, all chains at once
    on the tensors' device (one step per slice of the longest chain).
    The CSR is byte-identical to the reference's per-term walk, and
    ``freed_slices`` lists every (pool, slice) visited in the
    reference's order (term ascending, then newest slice first), which
    fixes the free-list order and with it every later allocation.

    ``docid_map`` (optional) rewrites each posting's docid on the way out;
    positions are preserved.
    """
    heap, tail, freq = (torch.as_tensor(x) for x in (heap, tail, freq))
    dev = heap.device
    tbl = layout.tables(dev)
    pb = layout.pool_bits
    H = heap.shape[0]
    V = tail.shape[0]
    freq = freq.to(dev).long()
    offsets = torch.zeros(V + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(freq, 0)
    terms = torch.nonzero(freq)[:, 0]
    ptr = tail.to(dev).long()[terms]
    act = torch.arange(terms.shape[0], device=dev)
    recs = []
    step = 0
    while act.numel():
        pool, sl, off = ptr_mod.decode(tbl, pb, ptr)
        base = tbl["base"][pool] + sl * tbl["slice_size"][pool]
        recs.append((act, torch.full_like(act, step), pool, sl,
                     base + (pool > 0).long(), base + off))
        nxt = torch.where(pool > 0, heap[base.clamp(max=H - 1)],
                          torch.full_like(base, NULL))
        keep = nxt != NULL
        act, ptr = act[keep], nxt[keep]
        step += 1
    n_total = int(offsets[-1])
    slices: List[np.ndarray] = [np.zeros(0, np.int32)] * layout.num_pools
    if recs:
        t_i, st, pool, sl, first, last = (torch.cat(c) for c in zip(*recs))
        steps = step + 1
        # data: term ascending, oldest slice first, slots ascending
        order = torch.argsort(t_i * steps + (steps - 1 - st))
        lens = (last - first + 1).clamp(min=0)[order]
        starts = first[order]
        rep = torch.repeat_interleave(
            torch.arange(lens.shape[0], device=dev), lens)
        if rep.shape[0] != n_total:
            raise ValueError(
                f"slice chains hold {rep.shape[0]} postings but freq "
                f"sums to {n_total}: corrupt pool state")
        lane0 = torch.cumsum(lens, 0) - lens
        addr = starts[rep] + torch.arange(n_total, device=dev) - lane0[rep]
        data = heap[addr].cpu().numpy().astype(np.uint32)
        # freed slices: term ascending, newest slice first, per pool
        walk = torch.argsort(t_i * steps + st)
        pool_w, sl_w = pool[walk].cpu().numpy(), sl[walk].cpu().numpy()
        slices = [sl_w[pool_w == p].astype(np.int32)
                  for p in range(layout.num_pools)]
    else:
        data = np.zeros(0, np.uint32)
    if docid_map is not None:
        ids = (data >> np.uint32(post.POS_BITS)).astype(np.uint32)
        pos = data & np.uint32(post.MAX_POS)
        data = (docid_map(ids).astype(np.uint32)
                << np.uint32(post.POS_BITS)) | pos
    return FrozenSegment(offsets=offsets.cpu().numpy(), data=data,
                         n_docs=n_docs, doc_base=doc_base,
                         freed_slices=slices)


def freeze(seg: ActiveSegment, doc_base: int = 0) -> FrozenSegment:
    return freeze_state(seg.layout, seg.state.heap, seg.state.tail,
                        seg.state.freq, n_docs=seg.next_docid,
                        doc_base=doc_base)


# ---------------------------------------------------------------------------
# Tiered compaction: merge adjacent frozen segments (LSM/Earlybird style)
# ---------------------------------------------------------------------------
def _adjacent_window(window) -> Tuple[int, int, List[int]]:
    """Validate that ``window`` (oldest -> newest) tiles a contiguous
    docid range and return ``(doc_base, n_docs, per-segment docid
    offsets)``."""
    base = int(window[0].doc_base)
    end = base
    offs: List[int] = []
    for fz in window:
        if int(fz.doc_base) != end:
            raise ValueError(
                f"segments are not doc-range adjacent: doc_base "
                f"{int(fz.doc_base)} != previous range end {end}; "
                f"compaction windows must be contiguous oldest-first")
        offs.append(end - base)
        end += int(fz.n_docs)
    n_docs = end - base
    if n_docs - 1 > post.MAX_DOC:
        raise OverflowError(
            f"merged segment would span {n_docs} docs > the 24-bit "
            f"docid field ({post.MAX_DOC + 1}); compact fewer segments")
    return base, n_docs, offs


def _merge_csr(segs: Sequence["FrozenSegment"], docid_offsets: Sequence[int],
               *, n_docs: int, doc_base: int, tier: int) -> FrozenSegment:
    """Merge CSR stores: per-term streams concatenated in segment (=
    ascending docid) order, each posting's docid rebased by its
    segment's offset inside the merged range."""
    V = len(segs[0].offsets) - 1
    counts = np.zeros(V, np.int64)
    for s in segs:
        if len(s.offsets) - 1 != V:
            raise ValueError(
                f"vocab mismatch: {len(s.offsets) - 1} != {V}")
        counts += np.diff(s.offsets)
    offsets = np.zeros(V + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    data = np.zeros(int(offsets[-1]), np.uint32)
    placed = np.zeros(V, np.int64)   # postings already placed, per term
    for s, off in zip(segs, docid_offsets):
        cnt = np.diff(s.offsets)
        if s.data.size:
            dest0 = offsets[:-1] + placed
            idx = (np.repeat(dest0, cnt) + np.arange(s.data.size)
                   - np.repeat(s.offsets[:-1], cnt))
            data[idx] = s.data + np.uint32(int(off) << post.POS_BITS)
        placed += cnt
    return FrozenSegment(offsets=offsets, data=data, n_docs=n_docs,
                         doc_base=doc_base, freed_slices=None, tier=tier)


def merge_frozen(segs: Sequence[FrozenSegment]) -> FrozenSegment:
    """Merge doc-range-adjacent frozen segments (oldest -> newest) into
    ONE immutable segment: per-term postings in global-docid order,
    tier = max(member tiers) + 1."""
    base, n_docs, offs = _adjacent_window(segs)
    tier = max(int(getattr(s, "tier", 0)) for s in segs) + 1
    return _merge_csr(segs, offs, n_docs=n_docs, doc_base=base, tier=tier)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Geometric tiering: compact whenever ``fanout`` same-tier segments
    accumulate, cascading like a base-``fanout`` counter."""
    fanout: int = 2

    def __post_init__(self):
        if self.fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {self.fanout}")

    def plan(self, tiers: Sequence[int]) -> Optional[Tuple[int, int]]:
        """First (oldest) run of >= fanout adjacent equal-tier segments,
        as ``(start, k=fanout)``, or None at the fixpoint."""
        tiers = list(tiers)
        i = 0
        while i < len(tiers):
            j = i
            while j < len(tiers) and tiers[j] == tiers[i]:
                j += 1
            if j - i >= self.fanout:
                return i, self.fanout
            i = j
        return None


# ---------------------------------------------------------------------------
# FOR / PForDelta-lite block codec for docid gaps
# ---------------------------------------------------------------------------
# No query or ingest path calls the codec: the reference's examples
# (examples/realtime_search*.py) print its byte count as a frozen
# segment's compressed size.  It is kept, byte-equal to the reference's,
# for a compressed-bytes memory metric or an archive codec.
BLOCK = 128


@dataclasses.dataclass
class ForBlocks:
    widths: np.ndarray   # uint8[n_blocks] bits per value
    firsts: np.ndarray   # uint32[n_blocks] first raw value per block
    payload: np.ndarray  # uint64 packed little-endian bit stream
    n: int

    @staticmethod
    def encode(values: np.ndarray) -> "ForBlocks":
        values = values.astype(np.uint64)
        n = len(values)
        n_blocks = max(1, -(-n // BLOCK))
        widths = np.zeros(n_blocks, np.uint8)
        firsts = np.zeros(n_blocks, np.uint32)
        bits: List[Tuple[int, int]] = []  # (value, width) stream
        for b in range(n_blocks):
            chunk = values[b * BLOCK:(b + 1) * BLOCK]
            if chunk.size == 0:
                continue
            firsts[b] = chunk[0]
            gaps = np.diff(chunk.astype(np.int64)).astype(np.uint64)
            w = int(gaps.max()).bit_length() if gaps.size else 0
            widths[b] = w
            bits.extend((int(g), w) for g in gaps)
        total_bits = sum(w for _, w in bits)
        payload = np.zeros((total_bits + 63) // 64 + 1, np.uint64)
        pos = 0
        for v, w in bits:
            if w == 0:
                continue
            word, off = pos >> 6, pos & 63
            payload[word] |= np.uint64((v << off) & 0xFFFFFFFFFFFFFFFF)
            if off + w > 64:
                payload[word + 1] |= np.uint64(v >> (64 - off))
            pos += w
        return ForBlocks(widths, firsts, payload, n)

    def decode(self) -> np.ndarray:
        out = np.zeros(self.n, np.uint64)
        pos = 0
        i = 0
        for b in range(len(self.widths)):
            cnt = min(BLOCK, self.n - b * BLOCK)
            if cnt <= 0:
                break
            out[i] = self.firsts[b]
            w = int(self.widths[b])
            acc = int(self.firsts[b])
            for j in range(1, cnt):
                if w == 0:
                    g = 0
                else:
                    word, off = pos >> 6, pos & 63
                    v = int(self.payload[word]) >> off
                    if off + w > 64:
                        v |= int(self.payload[word + 1]) << (64 - off)
                    g = v & ((1 << w) - 1)
                    pos += w
                acc += g
                out[i + j] = acc
            i += cnt
        return out

    @property
    def compressed_bytes(self) -> int:
        return (self.widths.nbytes + self.firsts.nbytes
                + self.payload.nbytes)


def compress_segment(seg: FrozenSegment) -> Tuple[List[Optional[ForBlocks]], int]:
    """Gap-compress each term's docid stream; returns (codecs, bytes)."""
    codecs: List[Optional[ForBlocks]] = []
    total = 0
    for t in range(len(seg.offsets) - 1):
        p = seg.postings(t)
        if p.size == 0:
            codecs.append(None)
            continue
        c = ForBlocks.encode(p.astype(np.uint64))
        codecs.append(c)
        total += c.compressed_bytes
    return codecs, total


# ---------------------------------------------------------------------------
# Multi-segment search
# ---------------------------------------------------------------------------
class SegmentSet:
    """At most one active segment + N frozen ones (paper §3.1)."""

    def __init__(self, layout: PoolLayout, vocab_size: int,
                 docs_per_segment: int, max_segments: int = 12,
                 bulk_ingest: bool = True,
                 compaction: Optional[CompactionPolicy] = None,
                 device="cuda"):
        self.layout = layout
        self.vocab_size = vocab_size
        self.docs_per_segment = docs_per_segment
        self.max_segments = max_segments
        self.bulk_ingest = bulk_ingest
        self.compaction = compaction
        self.device = str(torch.device(device))
        self.frozen: List[FrozenSegment] = []
        self.n_rollovers = 0
        self.n_compactions = 0
        self.active = self._new_active()
        self._doc_base = 0
        self._hist_freqs: Optional[np.ndarray] = None

    def _new_active(self, state=None) -> ActiveSegment:
        return ActiveSegment(self.layout, self.vocab_size,
                             max_docs=self.docs_per_segment, state=state,
                             bulk_ingest=self.bulk_ingest,
                             device=self.device)

    def ingest(self, docs, **kw) -> None:
        self.active.ingest(docs, **kw)
        if self.active.is_full:
            self.rollover()

    def rollover(self) -> Optional[FrozenSegment]:
        """Freeze the active segment and RECYCLE its slices into the next
        active segment; with a :class:`CompactionPolicy`, same-tier
        frozen segments then cascade-merge.  An EMPTY active segment is
        a no-op returning None."""
        if self.active.next_docid == 0:
            return None
        fz = freeze(self.active, doc_base=self._doc_base)
        self._hist_freqs = fz.term_freqs()
        self.frozen.append(fz)
        self.n_rollovers += 1
        if len(self.frozen) > self.max_segments - 1:
            self.frozen.pop(0)  # oldest segment retired (bounded set)
        self._doc_base += self.active.next_docid
        released = slicepool.release_slices(
            self.layout, self.active.state, fz.freed_slices)
        self.active = self._new_active(state=released)
        self._apply_compaction()
        return fz

    def compact(self, k: int, *, start: int = 0
                ) -> Optional[FrozenSegment]:
        """Merge ``k`` adjacent frozen segments from index ``start`` into
        one; a window of fewer than two segments is a no-op."""
        k = min(int(k), len(self.frozen) - start)
        if k < 2:
            return None
        merged = merge_frozen(self.frozen[start: start + k])
        self.frozen[start: start + k] = [merged]
        self.n_compactions += 1
        return merged

    def _apply_compaction(self) -> None:
        if self.compaction is None:
            return
        while True:
            plan = self.compaction.plan([fz.tier for fz in self.frozen])
            if plan is None:
                return
            self.compact(plan[1], start=plan[0])

    def history_freqs(self) -> np.ndarray:
        """H(t) from the most recent ROLLOVER (paper §7)."""
        if self._hist_freqs is None:
            return np.zeros(self.vocab_size, np.int64)
        return self._hist_freqs.copy()

    def search_term_desc(self, term: int, engine, limit: int) -> np.ndarray:
        """Global docids (descending, newest segment first), stopping once
        ``limit`` docids are collected."""
        plist, n = engine.docids_asc(self.active.state, term)
        ids = (plist.cpu().numpy()[: int(n)][::-1].astype(np.int64)
               + self._doc_base)
        out = [ids]
        total = ids.size
        for fz in reversed(self.frozen):
            if total >= limit:
                break
            ids = fz.docids_desc(term).astype(np.int64) + fz.doc_base
            out.append(ids)
            total += ids.size
        return np.concatenate(out)[:limit]
