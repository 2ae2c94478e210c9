"""Streaming lifecycle engine (paper §3.1's full loop, closed).

The active segment fills, rolls over into a frozen read-only CSR
segment, its slices return to the pool free lists
(:func:`repro_torch.core.slicepool.release_slices`), and the next
active segment recycles them — so the heap high-water mark is bounded by
ONE segment's demand while queries still see every frozen segment.
Queries span the active pool and all frozen segments:

  * **Active pool** — :mod:`repro_torch.core.query`.
  * **Frozen segments** — each wrapped in a :class:`PackedSegment`:
    per-term GLOBAL docid lists gap-compressed into 128-docid blocks
    (:mod:`repro_torch.kernels.segment_intersect`), with a quantized
    impact plane for scored queries; conjunctions run the fused
    decode+intersect CUDA kernels.
  * **Merge** — every segment owns a disjoint ascending docid range, so
    per-segment descending lists concatenated newest-segment-first ARE
    the global reverse-chronological result.

Queries route through :mod:`repro_torch.core.qexec` by default
(``batched=True``); the per-query host loop (``batched=False``) is the
bit-exactness oracle.  The engine's tensors live on ``device`` ("cuda"
unless the caller asks for the CPU), and the kernels run where the
tensors are.  :class:`LifecycleEngine` is the single-device engine;
:class:`ShardedLifecycleEngine` runs the same shell over the
document-sharded index (:mod:`repro_torch.core.sharded_index`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import postings as post
from repro_torch.core import qexec
from repro_torch.core import query as q
from repro_torch.core import segments as seg_mod
from repro_torch.core import sharded_index as shx
from repro_torch.core import slicepool
from repro_torch.core.pointers import PoolLayout
from repro_torch.kernels.segment_intersect import (SCORE_MAX, PackedList,
                                                   ScoredList,
                                                   attach_scores,
                                                   decode_packed,
                                                   pack_docids)


# ---------------------------------------------------------------------------
# Frozen segments, device-queryable
# ---------------------------------------------------------------------------
class PackedSegment:
    """Query-side view of one frozen segment (single-device or sharded):
    per term, the GLOBAL ascending docid list as a block-gap-compressed
    :class:`PackedList` (numpy leaves), packed lazily on first use and
    cached."""

    def __init__(self, seg):
        self.seg = seg
        self.doc_base = int(seg.doc_base)
        self._packed: Dict[int, PackedList] = {}
        self._post: Dict[int, np.ndarray] = {}
        self._tf: Dict[int, tuple] = {}
        self._scored: Dict[int, ScoredList] = {}

    def docids_asc(self, term: int) -> np.ndarray:
        """Ascending GLOBAL docids of ``term`` in this segment."""
        rel = self.seg.docids_desc(int(term))[::-1]
        return rel.astype(np.int64) + self.doc_base

    def packed(self, term: int) -> PackedList:
        term = int(term)
        got = self._packed.get(term)
        if got is None:
            ids = self.docids_asc(term)
            if ids.size and ids[-1] >= 0xFFFFFFFF:
                raise OverflowError(
                    f"global docid {int(ids[-1])} exceeds the uint32 "
                    f"docid space; reshard or reset doc_base")
            got = pack_docids(ids.astype(np.uint32))
            self._packed[term] = got
        return got

    def postings_asc(self, term: int) -> np.ndarray:
        """Ascending packed (segment-relative docid, position) postings
        — the positional substrate for phrase queries; cached (a
        sharded segment merges its shards' lists)."""
        term = int(term)
        got = self._post.get(term)
        if got is None:
            got = self._post[term] = self.seg.postings(term)
        return got

    def bounds(self, term: int) -> tuple:
        """O(1) (O(S) over a sharded segment's shards) ``(n_postings,
        first_gid, last_gid)`` GLOBAL summary, without forcing a
        pack."""
        c, f, last = self.seg.docid_bounds(int(term))
        if not c:
            return 0, 0, 0
        return c, f + self.doc_base, last + self.doc_base

    def warm(self, terms: Sequence[int]) -> None:
        for t in terms:
            self.packed(t)

    def tf_asc(self, term: int) -> tuple:
        """``(docids int64 asc GLOBAL, tf int64)`` — the per-doc term
        frequency of ``term`` in this segment, from the positional
        postings (one posting per occurrence); cached."""
        term = int(term)
        got = self._tf.get(term)
        if got is None:
            p = self.postings_asc(term)
            rel = (p >> np.uint32(post.POS_BITS)).astype(np.int64)
            ids, tf = np.unique(rel, return_counts=True)
            got = (ids + self.doc_base, tf.astype(np.int64))
            self._tf[term] = got
        return got

    def scored(self, term: int) -> ScoredList:
        """The term's :meth:`packed` list with its quantized-impact
        plane: one ``min(tf, SCORE_MAX)`` per docid lane, the per-block
        max and the list max — the block-max WAND substrate."""
        term = int(term)
        got = self._scored.get(term)
        if got is None:
            _, tf = self.tf_asc(term)
            imp = np.minimum(tf, SCORE_MAX).astype(np.int32)
            got = attach_scores(self.packed(term), imp)
            self._scored[term] = got
        return got


def conjunctive_packed(pseg: PackedSegment, terms: Sequence[int], *,
                       use_kernel: bool = True,
                       device="cuda") -> np.ndarray:
    """Descending GLOBAL docids holding every term, within one frozen
    segment.  The driving intersection of the two smallest lists runs
    ``kernels.ops.segment_intersect_mask`` (the fused decode+intersect
    CUDA kernel for CUDA tensors); further terms fold in with the
    membership test on the already-compacted list."""
    from repro_torch.kernels import ops
    packs = sorted((pseg.packed(t) for t in terms), key=lambda p: p.n)
    if not packs or packs[0].n == 0:
        return np.zeros(0, np.int64)
    a = packs[0].to(device)
    cur = decode_packed(a)                    # ascending, INVALID-padded
    n = a.n
    for i, pb in enumerate(packs[1:]):
        if pb.n == 0:
            return np.zeros(0, np.int64)
        b = pb.to(device)
        if i == 0 and use_kernel:
            mask = ops.segment_intersect_mask(a, b)
            cur, n = q._compact(cur, mask.bool())
        else:
            cur, n = q._compact(cur, q.member_asc(cur, decode_packed(b)))
    return cur.cpu().numpy()[: int(n)][::-1].astype(np.int64)


def disjunctive_packed(pseg: PackedSegment,
                       terms: Sequence[int]) -> np.ndarray:
    """Descending GLOBAL docids holding any term, one frozen segment."""
    lists = [pseg.docids_asc(t) for t in terms]
    out = lists[0]
    for more in lists[1:]:
        out = np.union1d(out, more)
    return out[::-1]


def phrase_packed(pseg: PackedSegment, t1: int, t2: int) -> np.ndarray:
    """Descending GLOBAL docids where ``t2`` occurs at position(t1)+1,
    within one frozen segment."""
    p1 = pseg.postings_asc(t1)
    p2 = pseg.postings_asc(t2)
    if p1.size == 0 or p2.size == 0:
        return np.zeros(0, np.int64)
    want = p1 + np.uint32(1)
    pos = np.minimum(np.searchsorted(p2, want), p2.size - 1)
    hit = p2[pos] == want
    ids = np.unique(p1[hit] >> np.uint32(post.POS_BITS)).astype(np.int64)
    return ids[::-1] + pseg.doc_base


def scored_packed(pseg: PackedSegment, terms: Sequence[int]) -> tuple:
    """Descending ``(docids int64, scores int64)`` of the conjunctive
    scored query within one frozen segment — the pure-numpy oracle.
    Score is the summed quantized impact ``min(tf, SCORE_MAX)`` over
    the query terms."""
    its = [pseg.tf_asc(t) for t in terms]
    ids = its[0][0]
    for more, _ in its[1:]:
        ids = np.intersect1d(ids, more)
    if ids.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    sc = np.zeros(ids.size, np.int64)
    for uids, tf in its:
        pos = np.searchsorted(uids, ids)
        sc += np.minimum(tf[pos], SCORE_MAX)
    return ids[::-1].copy(), sc[::-1].copy()


def _valid_prefix(desc, counts: np.ndarray, cap: Optional[int]):
    """Host copy of the columns of ``desc`` that hold some row's answer:
    results are padded to the stack's pow2 width (up to 2**23 lanes per
    segment), so copying only ``max(counts)`` columns keeps the one
    device-to-host copy of a batch proportional to its answers."""
    width = int(counts.max()) if counts.size else 0
    if cap is not None:
        width = min(width, cap)
    return desc[:, :width].cpu().numpy()


# ---------------------------------------------------------------------------
# Unified engine: active pool + every frozen segment
# ---------------------------------------------------------------------------
# largest conjunctive `limit` routed through the early-exit top-k path
_TOPK_LIMIT_MAX = 4096


@dataclasses.dataclass
class LifecycleStats:
    docs_ingested: int = 0
    rollovers: int = 0
    compactions: int = 0
    high_water_slots: int = 0
    live_slots: int = 0
    scored_blocks_skipped: int = 0
    scored_blocks_live: int = 0
    emergency_rollovers: int = 0
    deferred_batches: int = 0
    shed_batches: int = 0


@dataclasses.dataclass(frozen=True)
class AdmissionController:
    """Graceful degradation under memory pressure: before each batch,
    ``utilization >= rollover_at`` forces an emergency rollover (which
    reclaims the active segment's slices before any pool can overflow),
    and ``utilization >= shed_at`` still afterwards sheds the batch
    (``ingest`` returns False).  ``min_segment_docs`` withholds the
    emergency rollover while the active segment is smaller."""
    rollover_at: float = 0.85
    shed_at: float = 1.0
    compact_k: Optional[int] = None
    min_segment_docs: int = 0

    def __post_init__(self):
        if not (0.0 <= self.rollover_at <= self.shed_at):
            raise ValueError(
                f"need 0 <= rollover_at <= shed_at, got "
                f"rollover_at={self.rollover_at} shed_at={self.shed_at}")
        if self.min_segment_docs < 0:
            raise ValueError(
                f"need min_segment_docs >= 0, got {self.min_segment_docs}")


class _LifecycleBase:
    """Shared shell: frozen-segment tracking, stats, admission, unified
    queries.  Subclasses provide ``self.segments`` (a SegmentSet-like
    with ``ingest``/``frozen``/``active``/``_doc_base``) and the active
    part: ``_active_batch``, ``_active_topk_batch``,
    ``_active_scored_batch`` and ``_active_desc``.

    ``device`` holds every tensor ("cuda" by default; the CPU tests pass
    "cpu", where each kernel's plain version runs).  The batched frozen
    conjunction and the exhaustive scored conjunction run their CUDA
    kernels exactly when the engine is on a CUDA device and
    ``use_kernel``.  ``validate=True`` runs the structural validators
    (:meth:`validate_invariants`) after every rollover and every
    engine-driven compaction.
    """

    def __init__(self, layout: PoolLayout, vocab_size: int, max_slices: int,
                 max_len: int, max_query_len: int, use_kernel: bool,
                 batched: bool, validate: bool,
                 admission: Optional[AdmissionController], device) -> None:
        """The settings both engines share; the subclass then builds
        ``self.segments`` and ``self.engine`` on ``self.device``."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}(device='cuda') needs a CUDA device; "
                f"pass device='cpu' to run the plain versions on the CPU")
        self.layout = layout
        self.vocab_size = vocab_size
        self.max_slices = max_slices
        self.max_len = max_len
        self.max_query_len = max_query_len
        self.use_kernel = use_kernel
        self.batched = batched
        self.validate = validate
        self._packed: List[PackedSegment] = []
        self._qstack: Optional[qexec.FrozenStack] = None
        self._batched_kernel = self.use_kernel and self.device.type == "cuda"
        self.admission = admission
        self.stats = LifecycleStats()

    # -- ingest ----------------------------------------------------------
    def ingest(self, docs) -> bool:
        """Index one arrival batch (int32[batch, L] term ids, -1 padded);
        segments roll over automatically when they fill.  Returns False
        when the :class:`AdmissionController` shed the batch."""
        if self.admission is not None and not self._admit():
            self.stats.shed_batches += 1
            return False
        self.segments.ingest(docs)
        prev = self.stats.rollovers
        self._sync_frozen()
        self.stats.docs_ingested += int(docs.shape[0])
        if self.stats.rollovers != prev:
            self._refresh_memory_stats()
            if self.validate:
                self.validate_invariants()
        return True

    def _utilization(self) -> float:
        return slicepool.pool_utilization(self.layout,
                                          self.segments.active.state)

    def _admit(self) -> bool:
        adm = self.admission
        util = self._utilization()
        if (util >= adm.rollover_at
                and self.segments.active.next_docid
                >= max(1, adm.min_segment_docs)):
            self.segments.rollover()
            if adm.compact_k is not None:
                self.segments.compact(adm.compact_k)
            self._sync_frozen()
            self.stats.emergency_rollovers += 1
            self.stats.deferred_batches += 1
            self._refresh_memory_stats()
            if self.validate:
                self.validate_invariants()
            util = self._utilization()
        return util < adm.shed_at

    def _refresh_memory_stats(self) -> None:
        self.stats.high_water_slots = self.memory_high_water_slots()
        self.stats.live_slots = self.memory_slots_used()

    def validate_invariants(self) -> None:
        """Run the structural validators over the allocator state and
        every frozen segment (:func:`~repro_torch.analysis.invariants.
        check_engine`; the chain walk on the engine's device) and raise
        :class:`~repro_torch.analysis.invariants.InvariantViolation` on
        a broken invariant.  Called at every rollover (scheduled or
        emergency), at engine-driven compaction and after
        ``recovery.restore`` when the engine was built with
        ``validate=True`` — a debugging aid, kept off the production
        ingest path."""
        from repro_torch.analysis import invariants
        invariants.check_engine(self).raise_if_failed()

    def compact(self, k: int):
        """Merge the ``k`` oldest frozen segments and resync the packed
        views; returns the merged segment or None (no-op)."""
        merged = self.segments.compact(k)
        self._sync_frozen()
        if merged is not None and self.validate:
            self.validate_invariants()
        return merged

    def _sync_frozen(self) -> None:
        """Mirror ``segments.frozen`` into packed query-side views; any
        change to the list drops the cached ``FrozenStack``."""
        by_id = {id(p.seg): p for p in self._packed}
        fresh = [by_id.get(id(fz)) or PackedSegment(fz)
                 for fz in self.segments.frozen]
        if [id(p) for p in fresh] != [id(p) for p in self._packed]:
            self._qstack = None
        self._packed = fresh
        self.stats.rollovers = self.segments.n_rollovers
        self.stats.compactions = self.segments.n_compactions

    def _frozen_stack(self) -> Optional[qexec.FrozenStack]:
        if self._qstack is None and self._packed:
            self._qstack = qexec.FrozenStack(self._packed,
                                             device=self.device)
        return self._qstack

    def check_health(self) -> None:
        self.segments.active.check_health()

    @property
    def doc_base(self) -> int:
        return self.segments._doc_base

    @property
    def frozen_packed(self) -> List[PackedSegment]:
        return list(self._packed)

    def memory_slots_used(self) -> int:
        return slicepool.memory_slots_used(self.layout,
                                           self.segments.active.state)

    def memory_high_water_slots(self) -> int:
        return slicepool.memory_high_water_slots(
            self.layout, self.segments.active.state)

    # -- queries: batched qexec path (default) ---------------------------
    def _base_u32(self) -> int:
        base = self.doc_base
        if base + self.segments.active.next_docid >= 0xFFFFFFFF:
            raise OverflowError(
                f"doc_base {base} exceeds the uint32 docid space; "
                f"reshard or reset doc_base")
        return base

    def _stub_active(self, rows: int):
        """An empty active part for ``frozen_only`` evaluation."""
        return (torch.full((rows, 1), qexec.INVALID, dtype=torch.int64,
                           device=self.device),
                torch.zeros(rows, dtype=torch.int32, device=self.device))

    def _tensor(self, x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _batch_eval(self, kind: str, queries: Sequence,
                    limit: Optional[int],
                    frozen_only: bool = False) -> List[np.ndarray]:
        return self._batch_eval_async(kind, queries, limit,
                                      frozen_only=frozen_only).wait()

    def _batch_eval_async(self, kind: str, queries: Sequence,
                          limit: Optional[int], *,
                          frozen_only: bool = False) -> qexec.Pending:
        """A whole query batch: one batched active evaluation, one frozen
        stack evaluation; the host copy of the results is deferred to
        ``wait()``."""
        Q = len(queries)
        if Q == 0:
            return qexec.Pending((), lambda: [])
        self._sync_frozen()
        if (kind == "conjunctive" and limit is not None
                and limit <= _TOPK_LIMIT_MAX):
            return self._batch_topk_async(queries, limit,
                                          frozen_only=frozen_only)
        base = self._base_u32()
        stack = self._frozen_stack()
        if kind == "phrase":
            Qb = qexec.bucket_pow2(Q)
            t1 = np.zeros(Qb, np.int64)
            t2 = np.zeros(Qb, np.int64)
            t1[:Q] = [p[0] for p in queries]
            t2[:Q] = [p[1] for p in queries]
            live = self._tensor(np.arange(Qb) < Q, torch.int32)
            ad, an = (self._stub_active(Qb) if frozen_only
                      else self._active_batch(kind, t1, t2))
            if stack is None:
                desc, n = qexec.finalize(ad, an, live, base)
            else:
                p1, p2 = stack.gather_postings(t1, t2, n_live=Q)
                desc, n = qexec.frozen_phrase_merge(
                    ad, an, p1, p2, stack.doc_bases, live, base)
        else:
            terms, n_terms = qexec.pad_query_batch(queries,
                                                   self.max_query_len)
            # trim the term axis to the batch's pow2 bucket
            tb = min(qexec.bucket_pow2(int(n_terms.max()), 1),
                     self.max_query_len)
            ad, an = (self._stub_active(terms.shape[0]) if frozen_only
                      else self._active_batch(kind, terms, n_terms, tb))
            nt = self._tensor(n_terms, torch.int32)
            if stack is None:
                desc, n = qexec.finalize(ad, an, nt, base)
            else:
                lists, _ = stack.gather(terms[:, :tb], n_terms)
                desc, n = qexec.frozen_merge(
                    ad, an, lists, nt, base, kind=kind, nt_slots=tb,
                    kernel=self._batched_kernel)

        def finish(N):
            D = _valid_prefix(desc, N, limit)
            out = [D[i, : int(N[i])].astype(np.int64) for i in range(Q)]
            return out if limit is None else [o[:limit] for o in out]

        return qexec.Pending((n,), finish)

    def _batch_topk(self, queries: Sequence, k: int,
                    frozen_only: bool = False) -> List[np.ndarray]:
        return self._batch_topk_async(queries, k,
                                      frozen_only=frozen_only).wait()

    def _batch_topk_async(self, queries: Sequence, k: int, *,
                          frozen_only: bool = False) -> qexec.Pending:
        Q = len(queries)
        if Q == 0:
            return qexec.Pending((), lambda: [])
        self._sync_frozen()
        k = int(k)
        if k <= 0:
            empty = [np.zeros(0, np.int64) for _ in range(Q)]
            return qexec.Pending((), lambda: empty)
        terms, n_terms = qexec.pad_query_batch(queries, self.max_query_len)
        tb = min(qexec.bucket_pow2(int(n_terms.max()), 1),
                 self.max_query_len)
        base = self._base_u32()
        k_pad = qexec.bucket_pow2(k, floor=8)
        nt = self._tensor(n_terms, torch.int32)
        ad, an = (self._stub_active(terms.shape[0]) if frozen_only
                  else self._active_topk_batch(terms, n_terms, k, k_pad,
                                               tb))
        stack = self._frozen_stack()
        if stack is None:
            desc, n = qexec.finalize(ad, an, nt, base)
        else:
            lists, lasts = stack.gather(terms[:, :tb], n_terms)
            desc, n = qexec.frozen_topk(ad, an, lists, nt, base, lasts, k,
                                        nt_slots=tb, k_pad=k_pad)

        def finish(N):
            D = _valid_prefix(desc, N, k)
            return [D[i, : min(int(N[i]), k)].astype(np.int64)
                    for i in range(Q)]

        return qexec.Pending((n,), finish)

    def conjunctive_batch(self, queries: Sequence[Sequence[int]],
                          limit: Optional[int] = None,
                          frozen_only: bool = False) -> List[np.ndarray]:
        """Batched :meth:`conjunctive`: one list of GLOBAL descending
        docids per query."""
        if not self.batched:
            return [self._unified("conjunctive", t, limit, frozen_only)
                    for t in queries]
        return self._batch_eval("conjunctive", queries, limit, frozen_only)

    def disjunctive_batch(self, queries: Sequence[Sequence[int]],
                          limit: Optional[int] = None,
                          frozen_only: bool = False) -> List[np.ndarray]:
        if not self.batched:
            return [self._unified("disjunctive", t, limit, frozen_only)
                    for t in queries]
        return self._batch_eval("disjunctive", queries, limit, frozen_only)

    def phrase_batch(self, pairs: Sequence[Sequence[int]],
                     limit: Optional[int] = None,
                     frozen_only: bool = False) -> List[np.ndarray]:
        if not self.batched:
            return [self._unified("phrase", p, limit, frozen_only)
                    for p in pairs]
        return self._batch_eval("phrase", pairs, limit, frozen_only)

    def topk_conjunctive(self, terms: Sequence[int], k: int,
                         frozen_only: bool = False) -> np.ndarray:
        """The newest ``k`` docs holding every term — bit-identical to
        ``conjunctive(terms)[:k]``."""
        return self.topk_conjunctive_batch([terms], k, frozen_only)[0]

    def topk_conjunctive_batch(self, queries: Sequence[Sequence[int]],
                               k: int,
                               frozen_only: bool = False
                               ) -> List[np.ndarray]:
        if not self.batched:
            return [self._unified("conjunctive", t, int(k), frozen_only)
                    for t in queries]
        return self._batch_topk(queries, k, frozen_only)

    def dispatch(self, kind: str, queries: Sequence, *,
                 k: Optional[int] = None, limit: Optional[int] = None,
                 frozen_only: bool = False) -> qexec.Pending:
        """Dispatch a query batch WITHOUT waiting for its results; the
        returned :class:`qexec.Pending`'s ``wait()`` yields what the
        synchronous method returns.  ``kind`` is ``conjunctive`` /
        ``disjunctive`` / ``phrase`` (optionally ``limit``-capped),
        ``topk`` (needs ``k``), ``scored`` (:meth:`scored_topk_batch`,
        needs ``k``) or ``scored_full`` (:meth:`scored_full_batch`)."""
        if kind in ("topk", "scored") and k is None:
            raise ValueError(f"kind {kind!r} needs k")
        if not self.batched:
            if kind == "topk":
                res = [self._unified("conjunctive", t, int(k), frozen_only)
                       for t in queries]
            elif kind == "scored":
                res = [self._scored_unified(t, int(k), frozen_only)
                       for t in queries]
            elif kind == "scored_full":
                res = [self._scored_unified(t, k, frozen_only)
                       for t in queries]
            elif kind in ("conjunctive", "disjunctive", "phrase"):
                res = [self._unified(kind, t, limit, frozen_only)
                       for t in queries]
            else:
                raise ValueError(f"unknown query kind {kind!r}")
            return qexec.Pending((), lambda: res)
        if kind == "topk":
            return self._batch_topk_async(queries, int(k),
                                          frozen_only=frozen_only)
        if kind == "scored":
            return self._scored_batch_async(queries, int(k), full=False,
                                            frozen_only=frozen_only)
        if kind == "scored_full":
            return self._scored_batch_async(queries, k, full=True,
                                            frozen_only=frozen_only)
        if kind in ("conjunctive", "disjunctive", "phrase"):
            return self._batch_eval_async(kind, queries, limit,
                                          frozen_only=frozen_only)
        raise ValueError(f"unknown query kind {kind!r}")

    # -- queries: scored retrieval (block-max WAND / MaxScore) -----------
    def scored_topk(self, terms: Sequence[int], k: int) -> tuple:
        """The ``k`` best-scoring docs holding every term, ranked by
        (summed quantized impact desc, docid desc — ties newest first),
        as ``(docids int64[m], scores int64[m])``.  Frozen segments run
        the block-max WAND walk; skip counts accumulate in
        ``stats.scored_blocks_skipped`` / ``scored_blocks_live``.
        Bit-identical to ``scored_full(terms)[:k]``."""
        return self.scored_topk_batch([terms], k)[0]

    def scored_topk_batch(self, queries: Sequence[Sequence[int]],
                          k: int, frozen_only: bool = False
                          ) -> List[tuple]:
        if not self.batched:
            return [self._scored_unified(t, int(k), frozen_only)
                    for t in queries]
        return self._scored_batch(queries, int(k), full=False,
                                  frozen_only=frozen_only)

    def scored_full(self, terms: Sequence[int],
                    k: Optional[int] = None) -> tuple:
        """Exhaustive scored evaluation (no early termination); the
        driving pair of every frozen (query, segment) cell runs the
        ``scored_intersect_batched`` CUDA kernel."""
        return self.scored_full_batch([terms], k)[0]

    def scored_full_batch(self, queries: Sequence[Sequence[int]],
                          k: Optional[int] = None,
                          frozen_only: bool = False) -> List[tuple]:
        if not self.batched:
            return [self._scored_unified(t, k, frozen_only)
                    for t in queries]
        return self._scored_batch(queries, k, full=True,
                                  frozen_only=frozen_only)

    def _scored_batch(self, queries: Sequence, k: Optional[int],
                      full: bool,
                      frozen_only: bool = False) -> List[tuple]:
        return self._scored_batch_async(queries, k, full=full,
                                        frozen_only=frozen_only).wait()

    def _scored_batch_async(self, queries: Sequence, k: Optional[int], *,
                            full: bool,
                            frozen_only: bool = False) -> qexec.Pending:
        Q = len(queries)
        if Q == 0:
            return qexec.Pending((), lambda: [])
        self._sync_frozen()
        if not full:
            if k <= 0:
                empty = [(np.zeros(0, np.int64), np.zeros(0, np.int64))
                         for _ in range(Q)]
                return qexec.Pending((), lambda: empty)
            if k > _TOPK_LIMIT_MAX:
                # a generous cap, not a real top-k: full evaluation +
                # slice beats a pow2(k)-wide heap
                inner = self._scored_batch_async(
                    queries, None, full=True, frozen_only=frozen_only)
                return qexec.Pending(
                    (), lambda: [(i[:k], s[:k]) for i, s in inner.wait()])
        terms, n_terms = qexec.pad_query_batch(queries, self.max_query_len)
        tb = min(qexec.bucket_pow2(int(n_terms.max()), 1),
                 self.max_query_len)
        base = self._base_u32()
        nt = self._tensor(n_terms, torch.int32)
        if frozen_only:
            ad, an = self._stub_active(terms.shape[0])
            asc = torch.zeros((terms.shape[0], 1), dtype=torch.int32,
                              device=self.device)
        else:
            ad, asc, an = self._active_scored_batch(terms, n_terms, tb)
        stack = self._frozen_stack()
        lim = None if k is None else int(k)

        def finish(N, *counts):
            if counts:
                # skip counters ride the deferred copy
                self.stats.scored_blocks_skipped += int(counts[0].sum())
                self.stats.scored_blocks_live += int(counts[1].sum())
            D = _valid_prefix(ids, N, lim)
            S = _valid_prefix(scs, N, lim)
            return [(D[i, : int(N[i])].astype(np.int64)[:lim],
                     S[i, : int(N[i])].astype(np.int64)[:lim])
                    for i in range(Q)]

        if stack is None:
            ids, scs, n = qexec.finalize_scored(ad, asc, an, nt, base)
            return qexec.Pending((n,), finish)
        if full:
            sc, _, _ = stack.gather_scored(terms[:, :tb], n_terms)
            ids, scs, n = qexec.frozen_scored_merge(
                ad, asc, an, sc, nt, base, nt_slots=tb,
                kernel=self._batched_kernel)
            ids, scs, n = qexec.rank_scored(ids, scs, n)
            return qexec.Pending((n,), finish)
        k_pad = qexec.bucket_pow2(k, floor=8)
        sc, lasts, smax = stack.gather_scored(terms[:, :tb], n_terms)
        ids, scs, n, bskip, blive = qexec.frozen_scored_topk(
            ad, asc, an, sc, nt, base, lasts, smax, k, nt_slots=tb,
            k_pad=k_pad)
        return qexec.Pending((n, bskip, blive), finish)

    def _scored_unified(self, terms: Sequence[int],
                        k: Optional[int],
                        frozen_only: bool = False) -> tuple:
        """Per-query host-loop scored oracle (``batched=False``): active
        scores from the batched engine, one numpy :func:`scored_packed`
        per frozen segment, one stable full sort."""
        self._sync_frozen()
        if frozen_only:
            ids = [np.zeros(0, np.int64)]
            scs = [np.zeros(0, np.int64)]
        else:
            tmat, n_terms = qexec.pad_query_batch([tuple(terms)],
                                                  self.max_query_len)
            tb = min(qexec.bucket_pow2(int(n_terms.max()), 1),
                     self.max_query_len)
            ad, asc, an = self._active_scored_batch(tmat, n_terms, tb)
            n0 = int(an[0])
            ids = [ad[0, :n0].cpu().numpy().astype(np.int64)
                   + self.doc_base]
            scs = [asc[0, :n0].cpu().numpy().astype(np.int64)]
        for pseg in reversed(self._packed):   # newest frozen first
            i, s = scored_packed(pseg, terms)
            ids.append(i)
            scs.append(s)
        flat_i = np.concatenate(ids)
        flat_s = np.concatenate(scs)
        order = np.lexsort((-flat_i, -flat_s))  # score desc, docid desc
        flat_i, flat_s = flat_i[order], flat_s[order]
        if k is not None:
            flat_i, flat_s = flat_i[:k], flat_s[:k]
        return flat_i, flat_s

    # -- queries: per-query host-loop oracle (batched=False) -------------
    def _unified(self, kind: str, terms: Sequence[int],
                 limit: Optional[int],
                 frozen_only: bool = False) -> np.ndarray:
        self._sync_frozen()
        parts = [np.zeros(0, np.int64) if frozen_only
                 else self._active_desc(kind, terms)]
        total = len(parts[0])
        for pseg in reversed(self._packed):   # newest frozen first
            # segments own disjoint descending docid ranges: once newer
            # segments fill the limit, older ones cannot contribute.
            if limit is not None and total >= limit:
                break
            if kind == "conjunctive":
                parts.append(conjunctive_packed(
                    pseg, terms, use_kernel=self.use_kernel,
                    device=self.device))
            elif kind == "disjunctive":
                parts.append(disjunctive_packed(pseg, terms))
            else:
                parts.append(phrase_packed(pseg, terms[0], terms[1]))
            total += len(parts[-1])
        out = np.concatenate(parts)
        return out[:limit] if limit is not None else out

    def conjunctive(self, terms: Sequence[int],
                    limit: Optional[int] = None,
                    frozen_only: bool = False) -> np.ndarray:
        """GLOBAL docids holding every term, newest first, across the
        active pool and all frozen segments."""
        if self.batched:
            return self._batch_eval("conjunctive", [tuple(terms)],
                                    limit, frozen_only)[0]
        return self._unified("conjunctive", terms, limit, frozen_only)

    def disjunctive(self, terms: Sequence[int],
                    limit: Optional[int] = None,
                    frozen_only: bool = False) -> np.ndarray:
        if self.batched:
            return self._batch_eval("disjunctive", [tuple(terms)],
                                    limit, frozen_only)[0]
        return self._unified("disjunctive", terms, limit, frozen_only)

    def phrase(self, t1: int, t2: int,
               limit: Optional[int] = None,
               frozen_only: bool = False) -> np.ndarray:
        if self.batched:
            return self._batch_eval("phrase", [(t1, t2)], limit,
                                    frozen_only)[0]
        return self._unified("phrase", (t1, t2), limit, frozen_only)


class LifecycleEngine(_LifecycleBase):
    """Single-device streaming engine: ingest -> rollover -> reclaim,
    with queries spanning the active pool and all frozen segments."""

    def __init__(self, layout: PoolLayout, vocab_size: int,
                 docs_per_segment: int, *, max_slices: int, max_len: int,
                 max_query_len: int = 8, max_segments: int = 12,
                 use_kernel: bool = True,
                 bulk_ingest: bool = True,
                 batched: bool = True,
                 validate: bool = False,
                 compaction: Optional[seg_mod.CompactionPolicy] = None,
                 admission: Optional[AdmissionController] = None,
                 device="cuda"):
        super().__init__(layout, vocab_size, max_slices, max_len,
                         max_query_len, use_kernel, batched, validate,
                         admission, device)
        self.segments = seg_mod.SegmentSet(
            layout, vocab_size, docs_per_segment, max_segments=max_segments,
            bulk_ingest=bulk_ingest, compaction=compaction,
            device=self.device)
        self.engine = q.make_engine(layout, max_slices, max_len,
                                    max_query_len, use_kernel=use_kernel)

    def _active_batch(self, kind: str, *args):
        state = self.segments.active.state
        if kind == "phrase":
            t1, t2 = args
            fn = qexec.make_active_fn(self.layout, self.max_slices,
                                      self.max_len, self.max_query_len,
                                      kind)
            return fn(state, self._tensor(t1), self._tensor(t2))
        terms, n_terms, tb = args
        fn = qexec.make_active_fn(self.layout, self.max_slices,
                                  self.max_len, tb, kind)
        return fn(state, self._tensor(terms[:, :tb]),
                  self._tensor(n_terms, torch.int32))

    def _active_topk_batch(self, terms, n_terms, k: int, k_pad: int,
                           tb: int):
        fn = qexec.make_active_topk_fn(self.layout, self.max_slices,
                                       self.max_len, tb, k_pad)
        return fn(self.segments.active.state, self._tensor(terms[:, :tb]),
                  self._tensor(n_terms, torch.int32), min(k, k_pad))

    def _active_scored_batch(self, terms, n_terms, tb: int):
        fn = qexec.make_active_scored_fn(self.layout, self.max_slices,
                                         self.max_len, tb)
        return fn(self.segments.active.state, self._tensor(terms[:, :tb]),
                  self._tensor(n_terms, torch.int32))

    def _active_desc(self, kind: str, terms: Sequence[int]) -> np.ndarray:
        state = self.segments.active.state
        if kind == "phrase":
            desc, n = self.engine.phrase(state, self._tensor(terms[0]),
                                         self._tensor(terms[1]))
        else:
            padded = np.zeros(self.max_query_len, np.int64)
            padded[: len(terms)] = terms
            desc, n = getattr(self.engine, kind)(
                state, self._tensor(padded),
                self._tensor(len(terms), torch.int32))
        return (desc.cpu().numpy()[: int(n)].astype(np.int64)
                + self.doc_base)


class ShardedLifecycleEngine(_LifecycleBase):
    """Document-sharded streaming engine: the same unified query path
    over :class:`~repro_torch.core.sharded_index.ShardedSegmentSet`
    (per-shard ingest and reclamation, fan-out active queries,
    global-docid frozen segments).  ``mesh`` fixes the shard count and
    must lie on ``device``: :func:`~repro_torch.core.sharded_index.
    make_doc_mesh` stacks every shard in this process,
    :func:`~repro_torch.core.sharded_index.make_rank_mesh` gives this
    process one shard of a ``torch.distributed`` world.  Its answers are
    the single-device engine's, bit for bit.

    On a rank mesh every rank is called with the same arguments in the
    same order (each ingest batch, each query batch, each snapshot) and
    returns the same answers.  Every decision that reads shard state
    comes from a value reduced over the ranks -- admission's pool
    utilization is a max over ``docs``, the slot counts are sums, health
    and validation failures are maxed -- so all ranks make the same
    collective calls; the frozen side is replicated on every rank."""

    def __init__(self, layout: PoolLayout, vocab_size: int,
                 docs_per_segment: int, mesh, *, max_slices: int,
                 max_len: int, max_query_len: int = 8,
                 max_segments: int = 12,
                 use_kernel: bool = True,
                 bulk_ingest: bool = True,
                 batched: bool = True,
                 validate: bool = False,
                 compaction: Optional[seg_mod.CompactionPolicy] = None,
                 admission: Optional[AdmissionController] = None,
                 device="cuda"):
        super().__init__(layout, vocab_size, max_slices, max_len,
                         max_query_len, use_kernel, batched, validate,
                         admission, device)
        if torch.device(mesh.device) != self.device:
            raise ValueError(f"mesh shards live on {mesh.device}, the "
                             f"engine on {self.device}")
        self.segments = shx.ShardedSegmentSet(
            layout, vocab_size, docs_per_segment, mesh,
            max_segments=max_segments, bulk_ingest=bulk_ingest,
            compaction=compaction)
        self.engine = shx.make_sharded_engine(
            layout, mesh, max_slices, max_len, max_query_len,
            use_kernel=use_kernel)

    def _utilization(self) -> float:
        return self.segments.active.pool_utilization()

    def memory_slots_used(self) -> int:
        return self.segments.active.memory_slots_used()

    def memory_high_water_slots(self) -> int:
        return self.segments.active.memory_high_water_slots()

    def _active_batch(self, kind: str, *args):
        """One fan-out over the shards covers the whole query batch; the
        merged output is segment-relative global docids, what the qexec
        merge expects."""
        state = self.segments.active.state
        if kind == "phrase":
            t1, t2 = args
            return self.engine.phrase(state, self._tensor(t1),
                                      self._tensor(t2))
        terms, n_terms, tb = args
        return getattr(self.engine, kind)(
            state, self._tensor(terms[:, :tb]),
            self._tensor(n_terms, torch.int32))

    def _active_topk_batch(self, terms, n_terms, k: int, k_pad: int,
                           tb: int):
        # no early exit over the sharded active pool: the full batched
        # conjunction feeds the frozen walk, which still stops early
        desc, n = self._active_batch("conjunctive", terms, n_terms, tb)
        return desc, n.clamp(max=k)

    def _active_scored_batch(self, terms, n_terms, tb: int):
        return self.engine.conjunctive_scored(
            self.segments.active.state, self._tensor(terms[:, :tb]),
            self._tensor(n_terms, torch.int32))

    def _active_desc(self, kind: str, terms: Sequence[int]) -> np.ndarray:
        state = self.segments.active.state
        if kind == "phrase":
            desc, n = self.engine.phrase(state, self._tensor([terms[0]]),
                                         self._tensor([terms[1]]))
        else:
            padded = np.zeros((1, self.max_query_len), np.int64)
            padded[0, : len(terms)] = terms
            desc, n = getattr(self.engine, kind)(
                state, self._tensor(padded),
                self._tensor([len(terms)], torch.int32))
        return (desc[0].cpu().numpy()[: int(n[0])].astype(np.int64)
                + self.doc_base)
