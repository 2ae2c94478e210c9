"""Batched query execution over the streaming lifecycle (Earlybird §5).

Three layers, each bit-identical to the per-query oracle route:

  1. **Segment stacking.**  All G frozen segments' per-term compressed
     docid lists are stacked (:class:`FrozenStack` -> ``StackedLists``
     with ``[Q, T, G, ...]`` leaves, pow2-bucketed), so a query batch
     evaluates over EVERY frozen segment in one pass of tensor work.
  2. **Query batching.**  A ``[Q, T]`` term matrix is evaluated over the
     active pool (:func:`make_active_fn`) plus the frozen stack
     (:func:`frozen_merge`; the driving (term0, term1) intersection of
     all Q x G cells is ONE launch of the
     ``segment_intersect_mask_batched`` CUDA kernel), merged with
     :func:`~repro_torch.core.sharded_index.merge_desc` (disjoint
     per-segment docid ranges make the sort a newest-first
     concatenation).
  3. **Top-k early exit.**  :func:`frozen_topk` banks hits
     newest-segment-first and stops consuming older segments once ``k``
     hits are banked; :func:`make_active_topk_fn` banks the driving
     term's newest hits in the active pool.

Scored retrieval ranks the conjunctive hits by the summed quantized
impact ``min(tf, 255)`` of their terms (ties newest first):
:func:`frozen_scored_merge` is the exhaustive evaluation (the driving
(term0, term1) pair of all Q x G cells is ONE launch of the
``scored_intersect_batched`` CUDA kernel), ranked by
:func:`rank_scored`; :func:`frozen_scored_topk` is the block-max WAND
walk that skips whole segments and 128-docid blocks whose score bound
cannot enter the running top-k.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import postings as post
from repro_torch.core import query as q
from repro_torch.core import slicepool
from repro_torch.core.pointers import PoolLayout, U32
from repro_torch.core.sharded_index import merge_desc, merge_desc_scored
from repro_torch.kernels.segment_intersect import (SEG_BLOCK, ScoredStack,
                                                   StackedLists, _pow2,
                                                   decode_scores,
                                                   decode_stacked,
                                                   pack_docids, pack_scored,
                                                   repad_scored,
                                                   repad_stacked,
                                                   stack_packed,
                                                   stack_scored)

INVALID = q.INVALID


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Next power of two >= max(n, floor) — the shared shape-bucketing
    rule (query batches, top-k buffers, stack paddings)."""
    return _pow2(max(int(n), floor))


def _u32_tensor(x, device):
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# Frozen stack: [G, ...] view of the packed segments
# ---------------------------------------------------------------------------
class FrozenStack:
    """Stacked view of an ordered frozen-segment list (oldest -> newest).

    Wraps the lifecycle's ``PackedSegment`` objects (duck-typed:
    ``.packed(t)`` / ``.scored(t)`` / ``.postings_asc(t)`` /
    ``.bounds(t)`` / ``.doc_base``) and caches, per term, the numpy
    ``[G, ...]`` stacks (plain and scored) plus the last-docid and
    max-impact summaries — built once per (stack, term) and
    reused until the next change to the frozen-segment list, which drops
    the whole stack.  Gathers return torch tensors on ``device``.
    """

    def __init__(self, psegs: Sequence, device="cuda"):
        self.psegs = list(psegs)
        self.device = torch.device(device)
        self.doc_bases = np.asarray([p.doc_base for p in self.psegs],
                                    np.uint32)
        self._terms: Dict[int, Tuple[StackedLists, np.ndarray]] = {}
        self._posts: Dict[int, np.ndarray] = {}
        self._empty: Optional[Tuple[StackedLists, np.ndarray]] = None
        # scored: (ScoredStack, lasts, smax) per term — smax is the
        # per-(term, segment) max impact the segment-level skip reads
        self._sterms: Dict[int, Tuple[ScoredStack, np.ndarray,
                                      np.ndarray]] = {}
        self._sempty: Optional[Tuple[ScoredStack, np.ndarray,
                                     np.ndarray]] = None

    @property
    def n_segments(self) -> int:
        return len(self.psegs)

    def _term_stack(self, term: int) -> Tuple[StackedLists, np.ndarray]:
        got = self._terms.get(term)
        if got is None:
            st = stack_packed([p.packed(term) for p in self.psegs])
            lasts = np.zeros(self.n_segments, np.uint32)
            for g, p in enumerate(self.psegs):
                c, _, last = p.bounds(term)
                lasts[g] = last if c else 0
            got = (st, lasts)
            self._terms[term] = got
        return got

    def _empty_stack(self) -> Tuple[StackedLists, np.ndarray]:
        # padding slots of the [Q, T] term matrix gather this: the fold
        # masks them out, and empty stacks keep the buckets minimal.
        if self._empty is None:
            st = stack_packed([pack_docids(np.zeros(0, np.uint32))
                               for _ in self.psegs])
            self._empty = (st, np.zeros(self.n_segments, np.uint32))
        return self._empty

    def _scored_term(self, term: int
                     ) -> Tuple[ScoredStack, np.ndarray, np.ndarray]:
        got = self._sterms.get(term)
        if got is None:
            scs = [p.scored(term) for p in self.psegs]
            st = stack_scored(scs)
            lasts = np.zeros(self.n_segments, np.uint32)
            smax = np.zeros(self.n_segments, np.int32)
            for g, p in enumerate(self.psegs):
                c, _, last = p.bounds(term)
                lasts[g] = last if c else 0
                smax[g] = scs[g].smax
            got = (st, lasts, smax)
            self._sterms[term] = got
        return got

    def _empty_scored(self) -> Tuple[ScoredStack, np.ndarray, np.ndarray]:
        if self._sempty is None:
            st = stack_scored([pack_scored(np.zeros(0, np.uint32),
                                           np.zeros(0, np.int32))
                               for _ in self.psegs])
            self._sempty = (st, np.zeros(self.n_segments, np.uint32),
                            np.zeros(self.n_segments, np.int32))
        return self._sempty

    def _post_stack(self, term: int) -> np.ndarray:
        got = self._posts.get(term)
        if got is None:
            arrs = [np.asarray(p.postings_asc(term), np.uint32)
                    for p in self.psegs]
            width = bucket_pow2(max([a.size for a in arrs] + [1]), 8)
            got = np.full((self.n_segments, width), INVALID, np.uint32)
            for g, a in enumerate(arrs):
                got[g, : a.size] = a
            self._posts[term] = got
        return got

    def gather(self, terms: np.ndarray, n_terms: np.ndarray
               ) -> Tuple[StackedLists, torch.Tensor]:
        """Gather a ``[Q, T]`` term matrix into one stack: ``(StackedLists
        with [Q, T, G, ...] torch leaves, lasts int64[Q, T, G])``, every
        list padded to the batch's shared pow2 (NB, PW) bucket."""
        cells = [[self._term_stack(int(t)) if j < int(n)
                  else self._empty_stack()
                  for j, t in enumerate(row)]
                 for row, n in zip(terms, n_terms)]
        nb = bucket_pow2(max(c[0].n_blocks for row in cells for c in row))
        pw = bucket_pow2(max(c[0].n_words for row in cells for c in row))
        rows = [[repad_stacked(c[0], nb, pw) for c in row] for row in cells]
        leaves = StackedLists(*[
            np.stack([np.stack([getattr(c, f) for c in row])
                      for row in rows])
            for f in StackedLists._fields])
        lasts = np.stack([np.stack([c[1] for c in row]) for row in cells])
        return leaves.to(self.device), _u32_tensor(lasts, self.device)

    def gather_scored(self, terms: np.ndarray, n_terms: np.ndarray
                      ) -> Tuple[ScoredStack, torch.Tensor, torch.Tensor]:
        """Scored counterpart of :meth:`gather`: ``(ScoredStack with [Q,
        T, G, ...] torch leaves, lasts int64[Q, T, G], smax int32[Q, T,
        G])`` — docid stacks plus impact planes, block-max planes and
        the per-(term, segment) max impact."""
        cells = [[self._scored_term(int(t)) if j < int(n)
                  else self._empty_scored()
                  for j, t in enumerate(row)]
                 for row, n in zip(terms, n_terms)]
        nb = bucket_pow2(max(c[0].ids.n_blocks for row in cells
                             for c in row))
        pw = bucket_pow2(max(c[0].ids.n_words for row in cells
                             for c in row))
        rows = [[repad_scored(c[0], nb, pw) for c in row] for row in cells]

        def stack(get):
            return np.stack([np.stack([get(c) for c in row])
                             for row in rows])
        ids = StackedLists(*[stack(lambda c, f=f: getattr(c.ids, f))
                             for f in StackedLists._fields])
        leaves = ScoredStack(ids=ids, swords=stack(lambda c: c.swords),
                             bmax=stack(lambda c: c.bmax))
        lasts = np.stack([np.stack([c[1] for c in row]) for row in cells])
        smax = np.stack([np.stack([c[2] for c in row]) for row in cells])
        return (leaves.to(self.device), _u32_tensor(lasts, self.device),
                torch.from_numpy(smax).to(self.device))

    def gather_postings(self, t1s: np.ndarray, t2s: np.ndarray,
                        n_live: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Positional postings stacks for a phrase batch: ``(int64[Q, G,
        PL], int64[Q, G, PL])`` INVALID-padded ascending (segment-relative
        docid, position) postings; rows >= ``n_live`` gather all-INVALID
        stacks."""
        if n_live is None:
            n_live = len(t1s)
        empty = np.full((self.n_segments, 8), INVALID, np.uint32)
        p1 = [self._post_stack(int(t)) if i < n_live else empty
              for i, t in enumerate(t1s)]
        p2 = [self._post_stack(int(t)) if i < n_live else empty
              for i, t in enumerate(t2s)]
        width = bucket_pow2(max(a.shape[1] for a in p1 + p2))

        def pad(stacks):
            out = np.full((len(stacks), self.n_segments, width), INVALID,
                          np.uint32)
            for i, a in enumerate(stacks):
                out[i, :, : a.shape[1]] = a
            return _u32_tensor(out, self.device)

        return pad(p1), pad(p2)


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------
def _fold_conjunctive(ids_tg, ns_tg, nt, nt_slots, hit01=None):
    """Intersect each cell's term lists: ``ids_tg[..., T, W]`` ascending
    INVALID-padded docids, ``ns_tg[..., T]``, ``nt[...]`` live terms ->
    (asc, n).  ``hit01`` optionally injects the kernel-computed
    membership mask of the driving (term0, term1) pair."""
    cur, n = ids_tg[..., 0, :], ns_tg[..., 0]
    for j in range(1, nt_slots):
        use = j < nt
        if j == 1 and hit01 is not None:
            hit = hit01
        else:
            hit = q.member_asc(cur, ids_tg[..., j, :])
        nxt, nn = q._compact(cur, hit)
        cur = torch.where(use[..., None], nxt, cur)
        n = torch.where(use, nn, n)
    return cur, n


def frozen_merge(active_desc, active_n, lists: StackedLists, n_terms,
                 base: int, *, kind: str, nt_slots: int,
                 kernel: bool = False):
    """Evaluate + merge a query batch over the frozen stack.

    ``active_desc``/``active_n``: the active segment's per-query
    descending SEGMENT-RELATIVE docids, globalised here by ``base`` and
    masked for padding rows (``n_terms == 0``).  ``lists``: ``[Q, T, G,
    ...]`` stack.  Returns globally-descending ``(int64[Q, A + G *
    W_kind], int32[Q])``.

    ``kernel=True`` routes the driving (term0, term1) intersection of
    every (query, segment) pair through ONE launch of
    ``kernels.ops.segment_intersect_mask_batched``; masks are
    bit-identical to the fold's own membership test.
    """
    from repro_torch.kernels import ops
    Q, T, G, _ = lists.firsts.shape
    W = lists.n_blocks * SEG_BLOCK
    ids = decode_stacked(lists)                        # [Q, T, G, W]
    ns = lists.ns                                      # [Q, T, G]
    ids = ids.permute(0, 2, 1, 3)                      # [Q, G, T, W]
    ns = ns.permute(0, 2, 1)
    nt = n_terms[:, None].expand(Q, G)

    if kind == "conjunctive":
        hit01 = None
        if kernel and nt_slots >= 2:
            def rows(t):
                return StackedLists(
                    *[getattr(lists, f)[:, t].reshape(
                        (Q * G,) + getattr(lists, f).shape[3:]).contiguous()
                      for f in StackedLists._fields[:-1]],
                    ns=lists.ns[:, t].reshape(Q * G).contiguous())
            mask = ops.segment_intersect_mask_batched(rows(0), rows(1))
            hit01 = mask.reshape(Q, G, W).bool()
        asc, n_seg = _fold_conjunctive(ids, ns, nt, nt_slots, hit01)
        desc_seg = q.asc_to_desc(asc, n_seg)
    elif kind == "disjunctive":
        slot = (torch.arange(nt_slots, device=ids.device)[None, None, :]
                < nt[..., None])
        flat = torch.where(slot[..., None], ids,
                           torch.full_like(ids, INVALID))
        flat = flat.reshape(Q, G, nt_slots * W)
        asc, n_seg = q.dedup_asc(torch.sort(flat, -1).values)
        desc_seg = q.asc_to_desc(asc, n_seg)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return _merge_parts(active_desc, active_n, desc_seg, n_seg,
                        n_terms > 0, base)


def frozen_phrase_merge(active_desc, active_n, p1, p2, doc_bases, live,
                        base: int):
    """Phrase evaluation over the frozen postings stacks (``int64[Q, G,
    PL]`` ascending packed (docid, pos) postings), merged with the
    active part — the batched counterpart of ``phrase_packed``."""
    PL = p1.shape[-1]
    want = torch.where(p1 != INVALID, (p1 + 1) & U32, p1)
    hit = q.member_asc(want, p2)
    ids = torch.where(hit, post.docid(p1), torch.full_like(p1, INVALID))
    asc, n_seg = q.dedup_asc(torch.sort(ids, -1).values)
    lane = torch.arange(PL, device=p1.device)
    db = torch.as_tensor(np.asarray(doc_bases, np.int64),
                         device=p1.device)[None, :, None]
    gids = torch.where(lane < n_seg[..., None], (asc + db) & U32,
                       torch.full_like(asc, INVALID))
    desc_seg = q.asc_to_desc(gids, n_seg)
    return _merge_parts(active_desc, active_n, desc_seg, n_seg, live > 0,
                        base)


def _merge_parts(active_desc, active_n, desc_seg, n_seg, live, base: int):
    Q, A = active_desc.shape
    G, W = desc_seg.shape[1], desc_seg.shape[2]
    an = torch.where(live, active_n, 0)
    lane_a = torch.arange(A, device=active_desc.device)
    a_glob = torch.where(lane_a < an[:, None], (active_desc + base) & U32,
                         torch.full_like(active_desc, INVALID))
    nseg = torch.where(live[:, None], n_seg, 0)
    lane_w = torch.arange(W, device=desc_seg.device)
    dseg = torch.where(lane_w < nseg[..., None], desc_seg,
                       torch.full_like(desc_seg, INVALID))
    flat = torch.cat([a_glob, dseg.reshape(Q, G * W)], 1)
    return merge_desc(flat), (an + nseg.sum(1)).to(torch.int32)


def finalize(active_desc, active_n, live, base: int):
    """No-frozen-segments path: globalise + mask the active batch."""
    an = torch.where(live > 0, active_n, 0)
    A = active_desc.shape[1]
    lane = torch.arange(A, device=active_desc.device)
    out = torch.where(lane < an[:, None], (active_desc + base) & U32,
                      torch.full_like(active_desc, INVALID))
    return out, an


# ---------------------------------------------------------------------------
# Top-k early exit (newest-first walk over the stack)
# ---------------------------------------------------------------------------
def frozen_topk(active_desc, active_n, lists: StackedLists, n_terms,
                base: int, lasts_doc, k: int, *, nt_slots: int,
                k_pad: int):
    """Bank the newest ``k`` conjunctive hits, consuming segments
    newest-first and STOPPING once every query has ``k`` banked —
    bit-identical to the full evaluation's ``[:k]`` because segments own
    disjoint descending docid ranges.  Per-(term, segment) summaries
    (count, first/last docid) skip segments that cannot contribute.
    Returns ``(desc int64[Q, k_pad], n int32[Q])``."""
    Q, T, G, _ = lists.firsts.shape
    dev = active_desc.device
    an = torch.where(n_terms > 0, active_n, 0).clamp(max=k)
    A = active_desc.shape[1]
    if A >= k_pad:
        aa = active_desc[:, :k_pad]
    else:
        aa = torch.cat([active_desc,
                        torch.full((Q, k_pad - A), INVALID,
                                   dtype=active_desc.dtype, device=dev)], 1)
    lane_k = torch.arange(k_pad, device=dev)
    out = torch.full((Q, k_pad + 1), INVALID, dtype=torch.int64, device=dev)
    out[:, :k_pad] = torch.where(lane_k < an[:, None], (aa + base) & U32,
                                 torch.full_like(aa, INVALID))
    b = an.long()
    slot = torch.arange(nt_slots, device=dev)[None, :] < n_terms[:, None]
    fd = lists.firsts[..., 0]                          # [Q, T, G]
    for i in range(G):
        g = G - 1 - i                                  # newest first
        want = b < k
        if not bool(want.any()):
            break
        ns_g = lists.ns[:, :, g]
        nonempty = (torch.where(slot, ns_g > 0, True).all(1)
                    & (n_terms > 0))
        lo = torch.where(slot, fd[:, :, g], 0).amax(1)
        hi = torch.where(slot, lasts_doc[:, :, g], INVALID - 1).amin(1)
        live_g = nonempty & (lo <= hi) & want
        if not bool(live_g.any()):
            continue
        seg = StackedLists(*[getattr(lists, f)[:, :, g]
                             for f in StackedLists._fields])
        asc, n_g = _fold_conjunctive(decode_stacked(seg), ns_g, n_terms,
                                     nt_slots)
        desc_g = q.asc_to_desc(asc, n_g)
        n_g = torch.where(live_g, n_g, 0).long()
        W = desc_g.shape[1]
        lane = torch.arange(W, device=dev)
        idx = b[:, None] + lane
        idx = torch.where((lane < n_g[:, None]) & (idx < k_pad), idx, k_pad)
        out.scatter_(1, idx, desc_g)
        b = torch.where(want, (b + n_g).clamp(max=k), b)
    return out[:, :k_pad], b.to(torch.int32)


# ---------------------------------------------------------------------------
# Scored retrieval: block-max WAND / MaxScore over the frozen stack
# ---------------------------------------------------------------------------
def _rank_scored(ids, scores):
    """Stable sort of the last axis by (score desc, docid desc), INVALID
    lanes last — ties therefore resolve newest-doc-first.

    The reference sorts on two uint32 keys, ``k1 = 0x7FFFFFFF - score``
    (mod 2**32) and ``k2 = 0xFFFFFFFF - id``, both forced to 0xFFFFFFFF
    on INVALID lanes.  Here the pair is one int64 key, ``(k1 - 2**31) *
    2**32 + k2``, which orders exactly like the pair and stays inside
    the int64 range (INVALID lanes get its maximum), so one stable sort
    gives the reference's permutation."""
    valid = ids != INVALID
    k1 = torch.where(valid, (0x7FFFFFFF - scores.long()) & U32, U32)
    k2 = torch.where(valid, U32 - ids, U32)
    order = torch.sort((k1 - (1 << 31)) * (1 << 32) + k2, dim=-1,
                       stable=True).indices
    return torch.gather(ids, -1, order), torch.gather(scores, -1, order)


def _fold_scored(ids_tg, scs_tg, nt, nt_slots, sc01=None):
    """Scored conjunctive fold over each cell: ``ids_tg[..., T, W]``
    decoded docids + ``scs_tg[..., T, W]`` impact lanes, ``nt[...]`` live
    terms -> (hit bool[..., W], score int32[..., W]) on term 0's lanes.
    ``sc01`` optionally injects the kernel-computed (term0 + term1)
    impact sums (0 = no hit) of the driving pair."""
    cand = ids_tg[..., 0, :].contiguous()
    valid = cand != INVALID
    if sc01 is None:
        hit = valid
        score = scs_tg[..., 0, :]
        start = 1
    else:
        use1 = (nt > 1)[..., None]
        hit = torch.where(use1, sc01 > 0, valid)
        score = torch.where(use1, sc01, scs_tg[..., 0, :])
        start = 2
    W = cand.shape[-1]
    for j in range(start, nt_slots):
        use = (j < nt)[..., None]
        ids_j = ids_tg[..., j, :].contiguous()
        pos = torch.searchsorted(ids_j, cand).clamp_(max=W - 1)
        m = (torch.gather(ids_j, -1, pos) == cand) & valid
        hit = hit & torch.where(use, m, True)
        score = score + torch.where(
            use & m, torch.gather(scs_tg[..., j, :], -1, pos), 0)
    return hit & valid, score


def _merge_parts_scored(active_desc, active_sc, active_n, desc_seg,
                        sc_seg, n_seg, live, base: int):
    Q, A = active_desc.shape
    G, W = desc_seg.shape[1], desc_seg.shape[2]
    an = torch.where(live, active_n, 0)
    alane = torch.arange(A, device=active_desc.device) < an[:, None]
    a_glob = torch.where(alane, (active_desc + base) & U32,
                         torch.full_like(active_desc, INVALID))
    a_sc = torch.where(alane, active_sc, 0)
    nseg = torch.where(live[:, None], n_seg, 0)
    mseg = (torch.arange(W, device=desc_seg.device)
            < nseg[..., None])
    dseg = torch.where(mseg, desc_seg, torch.full_like(desc_seg, INVALID))
    sseg = torch.where(mseg, sc_seg, 0)
    flat = torch.cat([a_glob, dseg.reshape(Q, G * W)], 1)
    flat_sc = torch.cat([a_sc, sseg.reshape(Q, G * W)], 1)
    ids, scs = merge_desc_scored(flat, flat_sc)
    return ids, scs, (an + nseg.sum(1)).to(torch.int32)


def frozen_scored_merge(active_desc, active_sc, active_n, sc: ScoredStack,
                        n_terms, base: int, *, nt_slots: int,
                        kernel: bool = False):
    """FULL scored conjunctive evaluation over the frozen stack (no early
    termination — the exhaustive baseline scored top-k is proven
    bit-identical to).  Returns globally-descending ``(ids int64[Q, A +
    G * W], scores int32[Q, ...], n int32[Q])``; rank by score
    afterwards with :func:`rank_scored`.

    ``kernel=True`` routes the driving (term0, term1) scored
    intersection of every (query, segment) pair through ONE launch of
    ``kernels.ops.scored_intersect_batched`` with skipping disabled
    (th = -1)."""
    from repro_torch.kernels import ops
    lists = sc.ids
    Q, T, G, _ = lists.firsts.shape
    W = lists.n_blocks * SEG_BLOCK
    dev = active_desc.device
    sc01 = None
    if kernel and nt_slots >= 2:
        def flat(x, t):
            return x[:, t].reshape((Q * G,) + x.shape[3:]).contiguous()

        def slot_stack(t):
            st = StackedLists(*[flat(getattr(lists, f), t)
                                for f in StackedLists._fields[:-1]],
                              ns=flat(lists.ns, t))
            return ScoredStack(ids=st, swords=flat(sc.swords, t),
                               bmax=flat(sc.bmax, t))
        out = ops.scored_intersect_batched(
            slot_stack(0), slot_stack(1),
            torch.zeros(Q * G, dtype=torch.int32, device=dev),
            torch.full((Q * G,), -1, dtype=torch.int32, device=dev))
        sc01 = out.reshape(Q, G, W)
    ids = decode_stacked(lists).permute(0, 2, 1, 3)    # [Q, G, T, W]
    scs = decode_scores(sc.swords).permute(0, 2, 1, 3)
    nt = n_terms[:, None].expand(Q, G)
    hit, score = _fold_scored(ids, scs, nt, nt_slots, sc01)
    comp_ids, n_seg = q._compact(ids[..., 0, :], hit)
    comp_sc, _ = q._compact(score, hit, fill=0)
    desc_seg = q.flip_valid(comp_ids, n_seg, INVALID)
    sc_seg = q.flip_valid(comp_sc, n_seg, 0)
    return _merge_parts_scored(active_desc, active_sc, active_n, desc_seg,
                               sc_seg, n_seg, n_terms > 0, base)


def rank_scored(ids, scores, n):
    """Re-rank docid-descending scored rows by (score desc, docid
    desc)."""
    m = torch.arange(ids.shape[1], device=ids.device) < n[:, None]
    ids = torch.where(m, ids, torch.full_like(ids, INVALID))
    scores = torch.where(m, scores, 0)
    ids_s, sc_s = _rank_scored(ids, scores)
    return ids_s, sc_s, n


def finalize_scored(active_desc, active_sc, active_n, live, base: int):
    """No-frozen-segments path: globalise, mask and rank the active batch
    by (score desc, docid desc)."""
    an = torch.where(live > 0, active_n, 0)
    m = (torch.arange(active_desc.shape[1], device=active_desc.device)
         < an[:, None])
    ids = torch.where(m, (active_desc + base) & U32,
                      torch.full_like(active_desc, INVALID))
    scs = torch.where(m, active_sc, 0)
    ids_s, sc_s = _rank_scored(ids, scs)
    return ids_s, sc_s, an


def frozen_scored_topk(active_desc, active_sc, active_n, sc: ScoredStack,
                       n_terms, base: int, lasts_doc, smax, k: int, *,
                       nt_slots: int, k_pad: int):
    """Block-max WAND / MaxScore top-k over the frozen stack.

    Walks segments newest-first keeping a ``k_pad``-wide heap of the
    best (score desc, docid desc) candidates per query.  Three skip
    levels, each justified by an upper bound that cannot beat the heap
    threshold ``th`` (the current k-th best score once ``k`` candidates
    are banked; -1 before, which disables skipping):

      * segment-structural — an empty term list or disjoint first/last
        docid ranges;
      * segment-score — the live terms' summed per-segment max impacts
        ``smax`` are <= th;
      * block-score — a driving-term block whose block max plus the
        other terms' segment maxima is <= th contributes nothing.

    Bit-identical to ranking the full evaluation: a dropped candidate
    scores <= th, and on a tie every incumbent is from a newer segment.
    The walk visits (but mostly skips) every segment.  The loop over
    segments is Python; every query row carries its own threshold,
    heap and counters as tensors, and a segment no row evaluates costs
    no decode.

    Returns ``(ids int64[Q, k_pad], scores int32[Q, k_pad], n int32[Q],
    blocks_skipped int64[Q], blocks_live int64[Q])`` — the counters
    count driving-term blocks of structurally-live segments only."""
    lists = sc.ids
    Q, T, G, NB = lists.firsts.shape
    dev = active_desc.device
    an = torch.where(n_terms > 0, active_n, 0)
    A = active_desc.shape[1]
    m = torch.arange(A, device=dev) < an[:, None]
    a_ids = torch.where(m, (active_desc + base) & U32,
                        torch.full_like(active_desc, INVALID))
    a_sc = torch.where(m, active_sc, 0).to(torch.int32)
    if A < k_pad:
        a_ids = torch.cat([a_ids, torch.full((Q, k_pad - A), INVALID,
                                             dtype=a_ids.dtype,
                                             device=dev)], 1)
        a_sc = torch.cat([a_sc, torch.zeros((Q, k_pad - A),
                                            dtype=torch.int32,
                                            device=dev)], 1)
    hid, hsc = _rank_scored(a_ids, a_sc)
    hid, hsc = hid[:, :k_pad], hsc[:, :k_pad]
    b = an.clamp(max=k).long()
    bskip = torch.zeros(Q, dtype=torch.int64, device=dev)
    blive = torch.zeros(Q, dtype=torch.int64, device=dev)
    tslot = torch.arange(nt_slots, device=dev)
    slot = tslot[None, :] < n_terms[:, None]               # [Q, T]
    other = slot & (tslot[None, :] > 0)
    fd = lists.firsts[..., 0]                              # [Q, T, G]
    blk = torch.arange(NB, device=dev) * SEG_BLOCK
    for i in range(G):
        g = G - 1 - i                                      # newest first
        ns_g = lists.ns[:, :, g]                           # [Q, T]
        nonempty = (torch.where(slot, ns_g > 0, True).all(1)
                    & (n_terms > 0))
        lo = torch.where(slot, fd[:, :, g], 0).amax(1)
        hi = torch.where(slot, lasts_doc[:, :, g], INVALID - 1).amin(1)
        live_g = nonempty & (lo <= hi)
        sm_g = smax[:, :, g].long()
        ub_g = torch.where(slot, sm_g, 0).sum(1)
        th = torch.where(b >= k, hsc[:, max(k - 1, 0)].long(), -1)
        eval_g = live_g & (ub_g > th)
        rest = torch.where(other, sm_g, 0).sum(1)
        nblk0 = (ns_g[:, 0].long() + SEG_BLOCK - 1) // SEG_BLOCK
        blive += torch.where(live_g, nblk0, 0)
        bskip += torch.where(live_g & ~eval_g, nblk0, 0)
        if not bool(eval_g.any()):
            continue
        seg = ScoredStack(
            ids=StackedLists(*[getattr(lists, f)[:, :, g]
                               for f in StackedLists._fields]),
            swords=sc.swords[:, :, g], bmax=sc.bmax[:, :, g])
        ids = decode_stacked(seg.ids)                      # [Q, T, W]
        hit, score = _fold_scored(ids, decode_scores(seg.swords), n_terms,
                                  nt_slots)
        blk_ok = (seg.bmax[:, 0].long() + rest[:, None]) > th[:, None]
        real_blk = blk[None, :] < ns_g[:, :1]
        nskip = (~blk_ok & real_blk).sum(1)
        keep = (hit & torch.repeat_interleave(blk_ok, SEG_BLOCK, dim=1)
                & eval_g[:, None])
        bskip += torch.where(eval_g, nskip, 0)
        cid = torch.where(keep, ids[:, 0], torch.full_like(ids[:, 0],
                                                           INVALID))
        csc = torch.where(keep, score, 0)
        mi, ms = _rank_scored(torch.cat([hid, cid], 1),
                              torch.cat([hsc, csc], 1))
        hid, hsc = mi[:, :k_pad], ms[:, :k_pad]
        b = (b + keep.sum(1)).clamp(max=k)
    lane = torch.arange(k_pad, device=dev)
    return (torch.where(lane < b[:, None], hid, torch.full_like(hid,
                                                               INVALID)),
            torch.where(lane < b[:, None], hsc, 0), b.to(torch.int32),
            bskip, blive)


@functools.lru_cache(maxsize=slicepool.FACTORY_CACHE_SIZE)
def make_active_scored_fn(layout: PoolLayout, max_slices: int,
                          max_len: int, max_query_len: int = 8):
    """A whole scored-conjunctive batch over the ACTIVE pool: the
    engine's batched ``conjunctive_scored_asc``, flipped to descending
    with the score lanes kept doc-aligned.  Returns SEGMENT-RELATIVE
    ``(desc int64[Q, W], scores int32[Q, W], n int32[Q])``."""
    eng = q.make_engine(layout, max_slices, max_len, max_query_len)

    def run(state, terms, n_terms):
        asc, sc, n = eng.conjunctive_scored_asc(state, terms, n_terms)
        return q.asc_to_desc(asc, n), q.flip_valid(sc, n, 0), n

    return run


@functools.lru_cache(maxsize=slicepool.FACTORY_CACHE_SIZE)
def make_active_topk_fn(layout: PoolLayout, max_slices: int, max_len: int,
                        max_query_len: int = 8, k_pad: int = 8):
    """Top-k over the ACTIVE segment: the driving term's postings in the
    materializer's reverse-chronological order (= descending docid) are
    deduped, membership-tested against the other terms' lists, and the
    newest ``k`` hits banked — the same hits, in the same order, as the
    reference's newest-first tile walk and as
    ``QueryEngine.topk_conjunctive``.  Returns ``f(state, terms[Q, T],
    n_terms[Q], k) -> (desc int64[Q, k_pad], n int32[Q])`` with
    SEGMENT-RELATIVE docids; lanes at or past ``n`` are unspecified."""
    eng = q.make_engine(layout, max_slices, max_len, max_query_len)

    def run(state, terms, n_terms, k):
        ids, _ = eng.docids_asc(state, terms)          # [Q, T, max_len]
        plist, total = eng.postings_desc(state, terms[:, 0])
        lane = torch.arange(max_len, device=plist.device)
        d = torch.where(lane < total[:, None], post.docid(plist),
                        torch.full_like(plist, INVALID))
        prev = torch.cat([torch.full_like(d[:, :1], INVALID), d[:, :-1]],
                         1)
        hit = (d != INVALID) & (d != prev)            # dedup positions
        for jj in range(1, max_query_len):
            m = q.member_asc(d, ids[:, jj])
            hit = hit & torch.where((jj < n_terms)[:, None], m, True)
        comp, n_hit = q._compact(d, hit)               # descending hits
        k_eff = torch.where(n_terms > 0, k, 0)
        out = comp[:, :k_pad]
        if out.shape[1] < k_pad:
            out = torch.cat([out, torch.full(
                (out.shape[0], k_pad - out.shape[1]), INVALID,
                dtype=out.dtype, device=out.device)], 1)
        return out, torch.minimum(n_hit, k_eff).to(torch.int32)

    return run


# ---------------------------------------------------------------------------
# Batched active evaluation
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=slicepool.FACTORY_CACHE_SIZE)
def make_active_fn(layout: PoolLayout, max_slices: int, max_len: int,
                   max_query_len: int, kind: str):
    """A whole query batch over the active pool: the batched ``*_asc``
    engine (plain membership — bit-identical to the kernel engine's
    masks).  Returns SEGMENT-RELATIVE descending INVALID-padded lists +
    counts; padding rows are masked downstream."""
    eng = q.make_engine(layout, max_slices, max_len, max_query_len)

    if kind == "phrase":
        def run(state, t1s, t2s):
            asc, n = eng.phrase_asc(state, t1s, t2s)
            return q.asc_to_desc(asc, n), n
    else:
        fn = getattr(eng, f"{kind}_asc")

        def run(state, terms, n_terms):
            asc, n = fn(state, terms, n_terms)
            return q.asc_to_desc(asc, n), n

    return run


# ---------------------------------------------------------------------------
# Deferred host sync (the dispatch/wait split)
# ---------------------------------------------------------------------------
class Pending:
    """A dispatched query batch whose device->host copy is deferred to
    :meth:`wait`.  ``arrays`` are the device tensors; ``finish``
    receives their numpy values and builds the per-query result.
    ``wait`` is idempotent."""

    __slots__ = ("_arrays", "_finish", "_done", "_result")

    def __init__(self, arrays, finish):
        self._arrays = tuple(arrays)
        self._finish = finish
        self._done = False
        self._result = None

    @property
    def done(self) -> bool:
        return self._done

    def wait(self):
        if not self._done:
            host = [a.cpu().numpy() for a in self._arrays]
            self._arrays = ()
            finish, self._finish = self._finish, None
            self._result = finish(*host)
            self._done = True
        return self._result


def pad_query_batch(queries: Sequence[Sequence[int]], max_query_len: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of term tuples to a pow2-bucketed ``[Qb, T]`` matrix
    plus per-row term counts (0 for padding rows)."""
    Qb = bucket_pow2(len(queries))
    terms = np.zeros((Qb, max_query_len), np.int64)
    n_terms = np.zeros(Qb, np.int32)
    for i, row in enumerate(queries):
        row = list(row)
        if not 0 < len(row) <= max_query_len:
            raise ValueError(
                f"query {i} has {len(row)} terms; need 1..{max_query_len}")
        terms[i, : len(row)] = row
        n_terms[i] = len(row)
    return terms, n_terms
