"""Boolean query evaluation over slice-pool postings (paper §3.1, §8).

Earlybird semantics: postings are traversed newest-first; conjunctions
are postings intersections; disjunctions are unions; phrase queries are
intersections with positional constraints; results come back in reverse
chronological order (descending docid).

The paper's linear merge becomes (a) a chain walk that flattens each
term's slice chain into a flat address vector, then (b) vectorised
sorted-set operations (``searchsorted`` membership, or the
``intersect_mask`` CUDA kernel with ``use_kernel=True``).

Internal list representation: ASCENDING int64 tensors of uint32 docids,
deduped, padded at the end with INVALID (0xFFFFFFFF, which sorts above
every docid).  Every set op here takes arbitrary leading batch dims, so
one call evaluates a whole query batch; public results are flipped to
descending at the API edge.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import postings as post
from repro_torch.core import slicepool
from repro_torch.core.pointers import PoolLayout, U32
from repro_torch.kernels.segment_intersect import SCORE_MAX

INVALID = 0xFFFFFFFF
FACTORY_CACHE_SIZE = slicepool.FACTORY_CACHE_SIZE


def _compact(values, keep, fill=INVALID):
    """Stable-compact ``values[..., keep]`` to the front of the last axis;
    pad with ``fill``.  Returns (compacted, count)."""
    n = values.shape[-1]
    idx = torch.cumsum(keep.long(), -1) - 1
    out = torch.full(values.shape[:-1] + (n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    # dropped lanes all land in the spare column n, which is cut off
    out.scatter_(-1, torch.where(keep, idx, n), values)
    return out[..., :n], keep.sum(-1).to(torch.int32)


def flip_valid(xs, n, fill):
    """Reverse the valid prefix of ``xs[..., m]``; pad with ``fill`` past
    ``n[...]``."""
    m = xs.shape[-1]
    lane = torch.arange(m, device=xs.device)
    idx = (n[..., None].long() - 1 - lane).clamp(0, max(m - 1, 0))
    vals = torch.gather(xs, -1, idx.expand(xs.shape))
    return torch.where(lane < n[..., None], vals,
                       torch.full_like(vals, fill))


def desc_to_asc(desc, n):
    """Flip the valid prefix of a descending array; INVALID padding."""
    return flip_valid(desc, n, INVALID)


def asc_to_desc(asc, n):
    return flip_valid(asc, n, INVALID)  # same index reversal


def dedup_asc(xs):
    """Remove duplicates from ascending INVALID-padded ``xs[..., m]``."""
    prev = torch.cat([torch.full(xs.shape[:-1] + (1,), INVALID,
                                 dtype=xs.dtype, device=xs.device),
                      xs[..., :-1]], -1)
    keep = (xs != INVALID) & (xs != prev)
    return _compact(xs, keep)


def member_asc(xs, ys):
    """For each x in xs[..., :], is x present in ascending ys[..., :]?"""
    pos = torch.searchsorted(ys.contiguous(), xs.contiguous())
    pos = pos.clamp_(max=ys.shape[-1] - 1)
    return (torch.gather(ys, -1, pos) == xs) & (xs != INVALID)


def intersect_asc(a, na, b, nb):
    return _compact(a, member_asc(a, b))


def union_asc(a, na, b, nb):
    """Union of two ascending INVALID-padded lists, sized ``|a| + |b|``
    wide so no member is ever truncated."""
    merged = torch.sort(torch.cat([a, b], -1), -1).values
    return dedup_asc(merged)


class QueryEngine(NamedTuple):
    """Query functions bound to a (layout, max_slices, max_len).

    The ``*_asc`` members return the INTERNAL ascending INVALID-padded
    representation and take any leading batch dims (``terms[..., T]``,
    ``n_terms[...]``); the plain members are the public descending API.
    """
    postings_desc: callable     # (state, term) -> (int64[max_len], n)
    docids_asc: callable        # (state, term) -> (int64[max_len], n)
    conjunctive: callable       # (state, terms[max_q], n_terms) -> (desc, n)
    disjunctive: callable       # -> (desc[max_q * max_len], n)
    phrase: callable            # (state, t1, t2) -> (desc ids, n)
    read_all: callable          # (state, terms[max_q], n_terms) -> checksum
    topk_conjunctive: callable  # (state, terms, n_terms, k) -> (desc[k], n)
    conjunctive_asc: callable   # (state, terms, n_terms) -> (asc, n)
    disjunctive_asc: callable   # (state, terms, n_terms) -> (asc, n)
    phrase_asc: callable        # (state, t1, t2) -> (asc ids, n)
    conjunctive_scored_asc: callable  # -> (asc, scores int32, n)


@functools.lru_cache(maxsize=FACTORY_CACHE_SIZE)
def make_engine(layout: PoolLayout, max_slices: int, max_len: int,
                max_query_len: int = 8, *,
                use_kernel: bool = False) -> QueryEngine:
    """Build a query engine.

    ``use_kernel=True`` routes conjunctive intersections through
    ``kernels.ops.intersect_mask`` (the CUDA kernel for CUDA state, its
    plain version on the CPU) instead of the ``searchsorted`` membership
    test; both yield bit-identical masks.  Memoised per (layout,
    max_slices, max_len, max_query_len, use_kernel).
    """
    materialize = slicepool.make_materializer(layout, max_slices, max_len)

    if use_kernel:
        from repro_torch.kernels import ops

        def _intersect(a, na, b, nb):
            mask = ops.intersect_mask(a, b)
            return _compact(a, mask.bool())
    else:
        _intersect = intersect_asc

    def _as_terms(state, terms):
        return torch.as_tensor(terms, device=state.heap.device).long()

    def postings_desc(state, term):
        return materialize(state, _as_terms(state, term))

    def docids_asc(state, term):
        plist, n = materialize(state, _as_terms(state, term))
        ids = post.docid(plist)
        lane = torch.arange(max_len, device=ids.device)
        ids = torch.where(lane < n[..., None], ids,
                          torch.full_like(ids, INVALID))
        asc = desc_to_asc(ids, n)  # ascending docids, may have duplicates
        return dedup_asc(asc)

    def _fold_terms(setop, state, terms, n_terms):
        ids, ns = docids_asc(state, terms)        # [..., T, max_len]
        n_terms = torch.as_tensor(n_terms, device=ids.device)
        acc, na = ids[..., 0, :], ns[..., 0]
        for i in range(1, max_query_len):
            use = i < n_terms
            nxt, nn = setop(acc, na, ids[..., i, :], ns[..., i])
            acc = torch.where(use[..., None], nxt, acc)
            na = torch.where(use, nn, na)
        return acc, na

    def conjunctive_asc(state, terms, n_terms):
        return _fold_terms(_intersect, state, terms, n_terms)

    def disjunctive_asc(state, terms, n_terms):
        # a union GROWS: one flatten + sort + dedup over every live
        # term's whole list equals the pairwise union fold.
        ids, ns = docids_asc(state, terms)        # [..., T, max_len]
        n_terms = torch.as_tensor(n_terms, device=ids.device)
        live = (torch.arange(max_query_len, device=ids.device)
                < n_terms[..., None])
        flat = torch.where(live[..., None], ids,
                           torch.full_like(ids, INVALID))
        flat = flat.reshape(ids.shape[:-2] + (-1,))
        return dedup_asc(torch.sort(flat, -1).values)

    def conjunctive(state, terms, n_terms):
        acc, na = conjunctive_asc(state, terms, n_terms)
        return asc_to_desc(acc, na), na

    def disjunctive(state, terms, n_terms):
        acc, na = disjunctive_asc(state, terms, n_terms)
        return asc_to_desc(acc, na), na

    def phrase_asc(state, t1, t2):
        """Docs where t2 appears at position(t1) + 1, on raw packed
        postings (a posting orders by (docid, position))."""
        p1, n1 = materialize(state, _as_terms(state, t1))
        p2, n2 = materialize(state, _as_terms(state, t2))
        lane = torch.arange(max_len, device=p1.device)
        p1 = torch.where(lane < n1[..., None], p1,
                         torch.full_like(p1, INVALID))
        p2 = torch.where(lane < n2[..., None], p2,
                         torch.full_like(p2, INVALID))
        a1 = desc_to_asc(p1, n1)
        a2 = desc_to_asc(p2, n2)
        want = torch.where(a1 != INVALID, (a1 + 1) & U32, a1)
        hit = member_asc(want, a2)
        ids = torch.where(hit, post.docid(a1), torch.full_like(a1, INVALID))
        return dedup_asc(torch.sort(ids, -1).values)

    def phrase(state, t1, t2):
        asc, n = phrase_asc(state, t1, t2)
        return asc_to_desc(asc, n), n

    def read_all(state, terms, n_terms):
        """End-to-end read of all postings for all query terms — the
        paper's C_T* microbenchmark body; returns a uint32 checksum."""
        plist, _ = materialize(state, _as_terms(state, terms))
        live = (torch.arange(max_query_len, device=plist.device)
                < torch.as_tensor(n_terms, device=plist.device)[..., None])
        sums = plist.sum(-1) & U32
        return torch.where(live, sums, 0).sum(-1) & U32

    def topk_conjunctive(state, terms, n_terms, k):
        desc, n = conjunctive(state, terms, n_terms)
        return desc[..., :k], n.clamp(max=k)

    def conjunctive_scored_asc(state, terms, n_terms):
        """Conjunctive docids plus their summed quantized impacts
        (``min(tf, SCORE_MAX)`` per live term).  A candidate's tf is its
        occurrence count in the term's raw postings: two searchsorted
        bounds over the sorted docid lanes, one term at a time."""
        acc, na = conjunctive_asc(state, terms, n_terms)
        terms = _as_terms(state, terms)
        n_terms = torch.as_tensor(n_terms, device=acc.device)
        live = acc != INVALID
        score = torch.zeros(acc.shape, dtype=torch.int32, device=acc.device)
        lane = torch.arange(max_len, device=acc.device)
        for i in range(max_query_len):
            plist, n = materialize(state, terms[..., i])
            ids = torch.where(lane < n[..., None], post.docid(plist),
                              torch.full_like(plist, INVALID))
            ids = torch.sort(ids, -1).values
            lo = torch.searchsorted(ids, acc)
            hi = torch.searchsorted(ids, acc, right=True)
            imp = (hi - lo).clamp_(max=SCORE_MAX).to(torch.int32)
            use = (i < n_terms)[..., None] & live
            score += torch.where(use, imp, 0)
        return acc, score, na

    return QueryEngine(postings_desc, docids_asc, conjunctive,
                       disjunctive, phrase, read_all, topk_conjunctive,
                       conjunctive_asc, disjunctive_asc, phrase_asc,
                       conjunctive_scored_asc)
