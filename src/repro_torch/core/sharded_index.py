"""Document-sharded index + batched query engine (Earlybird scale-out).

The paper's production deployment document-partitions the tweet stream
across machines; each partition runs an independent slice-pool allocator
and queries fan out to every partition, whose reverse-chronological hit
lists are merged at the front end (paper §3).  The port runs it on
either of two meshes, through one code path:

  * :func:`make_doc_mesh` stacks every shard in one process on one
    device (row ``s`` of a leading ``[S, ...]`` axis; shard-axis
    collectives are tensor ops on that axis);
  * :func:`make_rank_mesh` gives each process of a ``torch.distributed``
    world one shard, as the reference's ``shard_map`` gives each device
    one: the process's state is a ``[1, ...]`` stack, and the shard-axis
    collectives are ``mesh_all_gather``/``mesh_psum`` over the logical
    ``docs`` axis.  Every rank is called with the same arguments (the
    same global ingest batch, the same query batch) and returns the same
    answers, as the reference's ``out_specs=P()``.

  * **Partitioning.**  Global docid ``d`` lives on shard ``d % S`` with
    shard-local docid ``d // S``.  Round-robin interleave keeps every
    shard's local docids dense and ascending, so the single-shard
    allocator, materializer and set ops run UNCHANGED per shard.
  * **State.**  One :class:`~repro_torch.core.slicepool.PoolState` per
    local shard, stacked on a leading axis
    (:func:`~repro_torch.core.slicepool.init_sharded_state`); the mesh
    fixes the shard count, the local shards and the device.
  * **Ingest.**  Each local shard's ``[B/S, L]`` doc block runs the
    single-device bulk allocator on that shard's row views, so the
    ``bulk_append`` kernel writes the shard's rows in place: one launch
    (and one host sync of the plan) per local shard per arrival batch,
    and no communication.
  * **Query.**  Each local shard evaluates the whole query batch with
    the single-device engine (conjunctions through the
    ``intersect_mask`` kernel, one launch per term fold over all Q
    rows); shard-local ascending lists become global docids
    (``g = local * S + shard``), descending, are gathered over the shard
    axis in shard order and merged with :func:`merge_desc`.  Shards own
    disjoint residue classes, so the merge is duplicate-free and
    bit-identical to the single-device engine.
  * **Rollover / compaction.**  Every shard freezes to its own CSR
    segment with global-within-segment docids on its own device, its
    slices go back on its own free lists, and on a rank mesh the S CSRs
    are then all-gathered (:func:`gather_frozen`), so every rank holds
    the whole :class:`ShardedFrozenSegment`, as the reference's single
    controller does.  :meth:`ShardedSegmentSet.compact` merges segments
    shard by shard, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import postings as post
from repro_torch.core import query as q
from repro_torch.core import segments as seg_mod
from repro_torch.core import slicepool
from repro_torch.core.index import flatten, gather_start_pools
from repro_torch.core.pointers import PoolLayout
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd

INVALID = 0xFFFFFFFF
DOCS_AXIS = coll.RankMesh.axis  # the document-partition axis: "docs"


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------
def make_doc_mesh(n_shards: int, *, device="cuda") -> coll.Mesh:
    """A mesh of ``n_shards`` document shards stacked on ``device``."""
    if int(n_shards) < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    return coll.Mesh(int(n_shards), torch.device(device))


def make_rank_mesh(n_shards: Optional[int] = None, *,
                   rules: Optional[shd.Rules] = None,
                   device="cuda") -> coll.RankMesh:
    """This process's shard of a mesh of ranks, one shard per process
    (the reference's ``make_doc_mesh`` returns the ``(mesh, rules)``
    this stands for).  Without ``rules`` it builds ``host_mesh((n,),
    ("data",))`` over the current world and ``default_rules`` on it
    (``docs -> data``); with ``rules`` the shard count is the product of
    the mesh dims ``docs`` maps to and the shard id is row-major over
    them.  ``device`` holds the shard's state and is the caller's
    choice (``cuda:<local rank>`` for one rank a card, the same card for
    gloo ranks sharing it, ``cpu`` for CPU ranks).  Raises when the
    device is a card and there is none, when the world is smaller than
    the mesh, and when ``rules`` map ``docs`` to no mesh dim."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_rank_mesh(device='cuda') needs a CUDA device; pass "
            "device='cpu' for CPU ranks")
    if rules is None:
        if n_shards is None:
            raise ValueError("make_rank_mesh: give n_shards or rules")
        rules = shd.default_rules(coll.host_mesh((int(n_shards),),
                                                 ("data",)))
    axes = rules.axes(DOCS_AXIS)
    if not axes:
        raise ValueError(
            f"rules table maps {DOCS_AXIS!r} to no mesh axis; the sharded "
            f"index needs a docs-partition axis (see dist.sharding)")
    shape = shd.mesh_shape(rules.mesh)
    names = shd.mesh_axis_names(rules.mesh)
    coord = rules.mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("make_rank_mesh: this rank is not in the mesh")
    n, shard = 1, 0
    for a in axes:
        n *= shape[a]
        shard = shard * shape[a] + int(coord[names.index(a)])
    if n_shards is not None and int(n_shards) != n:
        raise ValueError(f"rules give {n} docs shards, asked for "
                         f"{n_shards}")
    # the global ranks of this rank's docs group, in shard order: the
    # other dims fixed at this rank's coordinate, the docs dims row-major
    ranks, at = rules.mesh.mesh, [int(c) for c in coord]
    peers = []
    for ids in itertools.product(*(range(shape[a]) for a in axes)):
        for a, i in zip(axes, ids):
            at[names.index(a)] = i
        peers.append(int(ranks[tuple(at)]))
    return coll.RankMesh(n, shard, dev, rules, tuple(peers))


# ---------------------------------------------------------------------------
# Docid translation + shard-list merge
# ---------------------------------------------------------------------------
def local_to_global(ids, shard: int, n_shards: int):
    """Map shard-local docids to global (``g = local * S + shard``),
    preserving order and INVALID padding (int64 values)."""
    ids = torch.as_tensor(ids).long()
    return torch.where(ids == INVALID, ids, ids * n_shards + shard)


def engine_max_len(shard_fmax: int) -> int:
    """Per-shard engine list width for an observed max term frequency:
    next power of two (floor 8, matching the kernel's minimum tile)."""
    return 1 << max(int(shard_fmax - 1).bit_length(), 3)


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


# ---------------------------------------------------------------------------
# Sharded active segment (ingest)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedActiveSegment:
    """Document-sharded :class:`~repro_torch.core.index.ActiveSegment`.

    ``state`` leaves carry a leading axis over the mesh's LOCAL shards
    (``[S, ...]`` stacked, ``[1, ...]`` on a rank mesh) on the mesh's
    device; ingest batches must be a multiple of S documents so the
    round-robin partition gives every shard the same local docid range
    (global docids stay those of an unsharded ingest of the same
    stream).  The counts (:meth:`term_freqs`, the slot counts,
    :meth:`pool_utilization`, :meth:`check_health`) are global: on a
    rank mesh they are reduced over the ranks, so each is a collective
    every rank calls."""
    layout: PoolLayout
    vocab_size: int
    mesh: coll.Mesh
    max_docs: int = post.MAX_DOC
    state: slicepool.PoolState = None
    next_docid: int = 0
    bulk_ingest: bool = True

    def __post_init__(self):
        self.num_shards = self.mesh.num_shards
        if self.state is None:
            self.state = slicepool.init_sharded_state(
                self.layout, self.vocab_size, len(self.mesh.local_shards),
                self.mesh.device)
        if self.bulk_ingest:
            self._ingest = slicepool.make_bulk_ingest_fn(
                self.layout, self.vocab_size, str(self.state.heap.device))
        else:
            self._ingest = slicepool.make_ingest_fn(self.layout,
                                                    self.vocab_size)

    @property
    def is_full(self) -> bool:
        return self.next_docid >= self.max_docs

    def ingest(self, docs, term_start_pools=None) -> int:
        """Index ``docs`` (int32[B, L] term ids, -1 padded, B % S == 0):
        doc j (global docid base + j) goes to row j // S of shard
        j % S.  Each local shard's state is updated through its row
        views; on a rank mesh every rank is given the same global batch
        and indexes its own shard's block."""
        S = self.num_shards
        dev = self.state.heap.device
        docs = torch.as_tensor(docs, device=dev)
        if not docs.is_signed():
            docs = docs.long()
        batch, L = docs.shape
        if batch % S:
            raise ValueError(
                f"batch {batch} not a multiple of {S} shards; pad the "
                f"arrival batch (round-robin docid partition needs equal "
                f"shard blocks)")
        if self.next_docid % S:
            raise ValueError(f"next_docid {self.next_docid} is not a "
                             f"multiple of {S} shards")
        by_shard = docs.reshape(batch // S, S, L).transpose(0, 1)
        base_local = self.next_docid // S
        table = (None if term_start_pools is None
                 else torch.as_tensor(term_start_pools, device=dev))
        for i, s in enumerate(self.mesh.local_shards):
            terms, plist, valid = flatten(by_shard[s], base_local)
            start_pools = (None if table is None else
                           gather_start_pools(table, terms, self.vocab_size))
            out = self._ingest(slicepool.shard_view(self.state, i), terms,
                               plist, start_pools, valid)
            # the bulk allocator wrote heap/tail/freq through the views;
            # the leaves it returns new (and all of the scan's) land here
            for old, new in zip(slicepool.shard_view(self.state, i), out):
                if new.data_ptr() != old.data_ptr():
                    old.copy_(new)
        self.next_docid += batch
        return batch

    def term_freqs(self) -> np.ndarray:
        """Global per-term frequency (sum over shards)."""
        return self.mesh.sum(self.state.freq.long().cpu()).numpy()

    def memory_slots_used(self) -> int:
        return self.mesh.combine(
            slicepool.memory_slots_used(self.layout, self.state))

    def memory_high_water_slots(self) -> int:
        return self.mesh.combine(
            slicepool.memory_high_water_slots(self.layout, self.state))

    def shard_slots_used(self) -> np.ndarray:
        return self.mesh.stack(torch.as_tensor(
            slicepool.shard_slots_used(self.layout, self.state))).numpy()

    def pool_utilization(self) -> float:
        """The worst pool of the worst shard (max over the ranks)."""
        return self.mesh.combine(
            slicepool.pool_utilization(self.layout, self.state), "max")

    def check_health(self) -> None:
        """Raises on every rank when any shard's pools overflowed."""
        if self.mesh.combine(bool(self.state.overflow.any()), "max"):
            raise MemoryError(
                "slice pools exhausted on at least one shard; raise "
                "slices_per_pool in the layout")


# ---------------------------------------------------------------------------
# Batched sharded query engine
# ---------------------------------------------------------------------------
class ShardedQueryEngine(NamedTuple):
    """Batched multi-query evaluation over the mesh's local shards of a
    sharded PoolState (every rank of a rank mesh returns the merged
    answer).

    All callables take query BATCHES (leading ``Q`` axis) and return
    ``(desc int64[Q, S * W], n int32[Q])`` — globally-descending docids,
    INVALID-padded, duplicate-free — where ``W`` is the per-shard list
    width: ``max_len`` for conjunctive/phrase and ``T * max_len`` for
    disjunctive over a ``[Q, T]`` term matrix (unions grow past one
    term's list, so they are never truncated to it).  Term matrices may
    be narrower than ``max_query_len``.
    """
    conjunctive: Callable       # (state, terms[Q, T], n_terms[Q])
    disjunctive: Callable       # (state, terms[Q, T], n_terms[Q])
    phrase: Callable            # (state, t1[Q], t2[Q])
    topk_conjunctive: Callable  # (state, terms, n_terms, k) -> ([Q, k], n)
    conjunctive_scored: Callable  # (state, terms, n_terms) ->
                                #   (desc, scores int32, n): quantized
                                #   impact sums, lanes doc-aligned
    num_shards: int
    local: q.QueryEngine        # the per-shard single-device engine


def make_sharded_engine(layout: PoolLayout, mesh: coll.Mesh,
                        max_slices: int, max_len: int,
                        max_query_len: int = 8, *,
                        use_kernel: bool = True) -> ShardedQueryEngine:
    """Build the batched sharded engine.

    ``max_len`` bounds the PER-SHARD materialised list; merged outputs
    are ``S * max_len`` wide.  ``use_kernel`` routes shard-local
    conjunctions through ``kernels.ops.intersect_mask`` (the CUDA
    kernel for CUDA state)."""
    S = mesh.num_shards
    local = q.make_engine(layout, max_slices, max_len, max_query_len,
                          use_kernel=use_kernel)

    def _engine(terms):
        # the engine's term fold is as wide as the batch's term matrix
        # (make_engine is memoised per width)
        return q.make_engine(layout, max_slices, max_len, terms.shape[-1],
                             use_kernel=use_kernel)

    def _fan_out(state, one):
        """Run ``one(shard_state) -> (asc, extra..., n)`` on every local
        shard and gather the globalised descending lists over the shard
        axis, in shard order: returns the gathered ``[Q, S * W]`` lists
        (with any extra lanes flipped alongside) and the summed counts
        (on a rank mesh ``mesh_all_gather`` and ``mesh_psum`` over
        ``docs``, so every rank returns the merged answer)."""
        outs = []
        for i, s in enumerate(mesh.local_shards):
            asc, *extra, n = one(slicepool.shard_view(state, i))
            g = local_to_global(asc, s, S)
            outs.append([q.asc_to_desc(g, n)]
                        + [q.flip_valid(x, n, 0) for x in extra] + [n])
        cols = [torch.stack(c) for c in zip(*outs)]       # [L, Q, ...]
        gathered = [mesh.gather(c, axis=1) for c in cols[:-1]]
        return gathered, mesh.sum(cols[-1])

    def conjunctive(state, terms, n_terms):
        fn = _engine(terms).conjunctive_asc
        (g,), n = _fan_out(state, lambda st: fn(st, terms, n_terms))
        return merge_desc(g), n

    def disjunctive(state, terms, n_terms):
        fn = _engine(terms).disjunctive_asc
        (g,), n = _fan_out(state, lambda st: fn(st, terms, n_terms))
        return merge_desc(g), n

    def phrase(state, t1, t2):
        (g,), n = _fan_out(state, lambda st: local.phrase_asc(st, t1, t2))
        return merge_desc(g), n

    def topk_conjunctive(state, terms, n_terms, k: int):
        desc, n = conjunctive(state, terms, n_terms)
        return desc[:, :k], n.clamp(max=k)

    def conjunctive_scored(state, terms, n_terms):
        # the score lanes travel with their docids through the flip, the
        # gather and the stable merge sort, so lane i of (ids, scores)
        # always refers to one document
        fn = _engine(terms).conjunctive_scored_asc
        (g, gsc), n = _fan_out(state, lambda st: fn(st, terms, n_terms))
        ids, scs = merge_desc_scored(g, gsc)
        return ids, scs, n

    return ShardedQueryEngine(conjunctive, disjunctive, phrase,
                              topk_conjunctive, conjunctive_scored, S,
                              local)


# ---------------------------------------------------------------------------
# Sharded segment lifecycle
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedFrozenSegment:
    """One rollover's worth of per-shard frozen CSR segments.

    Each shard freezes independently (global-within-segment docids baked
    in via ``freeze_state(docid_map=...)``); queries merge per-shard
    descending lists exactly like the live engine does."""
    shards: List[seg_mod.FrozenSegment]
    n_docs: int
    doc_base: int = 0
    # compaction tier, exactly as on FrozenSegment: 0 from rollover,
    # max(member tiers) + 1 after a merge
    tier: int = 0

    @property
    def members(self) -> List[seg_mod.FrozenSegment]:
        """The per-shard CSR segments (global-within-segment docids)."""
        return self.shards

    def postings(self, term: int) -> np.ndarray:
        """Ascending packed (docid, position) postings over all shards
        (disjoint residue classes: a sort, no dedup)."""
        return np.sort(np.concatenate([fz.postings(term)
                                       for fz in self.shards]))

    def docids_desc(self, term: int) -> np.ndarray:
        parts = [fz.docids_desc(term) for fz in self.shards]
        cat = np.concatenate(parts) if parts else np.zeros(0, np.uint32)
        return np.sort(cat)[::-1]  # disjoint residue classes: no dedup

    def docid_bounds(self, term: int):
        """O(S) summary ``(n_postings, first_gid, last_gid)`` over all
        shards (shards store GLOBAL-within-segment docids, so min/max
        across shards bound the merged list)."""
        n, first, last = 0, 0, 0
        for fz in self.shards:
            c, lo, hi = fz.docid_bounds(term)
            if c:
                first = lo if n == 0 else min(first, lo)
                last = hi if n == 0 else max(last, hi)
                n += c
        return n, first, last

    def term_freqs(self) -> np.ndarray:
        return np.sum([fz.term_freqs() for fz in self.shards], axis=0)

    @property
    def total_postings(self) -> int:
        return sum(fz.total_postings for fz in self.shards)

    def compress(self):
        """Per-shard ForBlocks compression; returns (codecs per shard,
        total bytes)."""
        codecs, total = [], 0
        for fz in self.shards:
            c, b = seg_mod.compress_segment(fz)
            codecs.append(c)
            total += b
        return codecs, total


def gather_frozen(mesh, local: List[seg_mod.FrozenSegment]
                  ) -> List[seg_mod.FrozenSegment]:
    """Every shard's frozen CSR, in shard order, from the local ones.

    On a stacked mesh ``local`` is already all of them.  On a rank mesh
    the S host CSRs are all-gathered over ``docs`` from host memory (no
    card copy over gloo): the offsets (``V + 1`` int64, one length for
    all) directly; the data, whose lengths differ, by gathering the
    lengths first and then the data padded to the longest, as int32 bit
    patterns of the uint32 postings, each cut back to its own length.
    The other ranks' members come without ``freed_slices`` (their
    slices went back on their own ranks' free lists)."""
    if len(local) == mesh.num_shards:
        return list(local)
    (own,) = local
    lens = mesh.stack(torch.tensor([own.data.size])).tolist()
    pad = np.zeros((1, max(max(lens), 1)), np.uint32)
    pad[0, : own.data.size] = own.data
    data = mesh.stack(torch.from_numpy(pad.view(np.int32))).numpy()
    data = data.view(np.uint32)
    offs = mesh.stack(torch.from_numpy(
        np.ascontiguousarray(own.offsets[None], np.int64))).numpy()
    return [own if s == mesh.shard else seg_mod.FrozenSegment(
                offsets=offs[s].copy(), data=data[s, : lens[s]].copy(),
                n_docs=own.n_docs, doc_base=own.doc_base,
                freed_slices=None, tier=own.tier)
            for s in range(mesh.num_shards)]


class ShardedSegmentSet:
    """Active sharded segment + frozen per-shard history (paper §3.1)."""

    def __init__(self, layout: PoolLayout, vocab_size: int,
                 docs_per_segment: int, mesh: coll.Mesh,
                 max_segments: int = 12,
                 bulk_ingest: bool = True,
                 compaction: Optional[seg_mod.CompactionPolicy] = None):
        self.layout = layout
        self.vocab_size = vocab_size
        self.mesh = mesh
        self.docs_per_segment = docs_per_segment
        self.max_segments = max_segments
        self.bulk_ingest = bulk_ingest
        self.compaction = compaction
        self.frozen: List[ShardedFrozenSegment] = []
        self.n_rollovers = 0
        self.n_compactions = 0
        self._doc_base = 0
        self._hist_freqs: Optional[np.ndarray] = None
        self.active = self._new_active()
        if docs_per_segment % self.active.num_shards:
            raise ValueError("docs_per_segment must be a multiple of the "
                             "shard count")

    def _new_active(self, state=None) -> ShardedActiveSegment:
        return ShardedActiveSegment(
            self.layout, self.vocab_size, self.mesh,
            max_docs=self.docs_per_segment, state=state,
            bulk_ingest=self.bulk_ingest)

    @property
    def num_shards(self) -> int:
        return self.active.num_shards

    def ingest(self, docs, **kw) -> None:
        self.active.ingest(docs, **kw)
        if self.active.is_full:
            self.rollover()

    def rollover(self) -> Optional[ShardedFrozenSegment]:
        """Freeze every shard of the active segment into its own
        read-only CSR segment with GLOBAL docids (the chain walk on the
        state's device), then recycle: each shard's slices go back on
        that shard's free lists, so the next active segment reuses them.
        An empty active segment is a no-op returning None."""
        if self.active.next_docid == 0:
            return None
        seg = self.active
        S = seg.num_shards
        st = seg.state
        local = [
            seg_mod.freeze_state(
                self.layout, st.heap[i], st.tail[i], st.freq[i],
                n_docs=seg.next_docid // S, doc_base=self._doc_base,
                docid_map=lambda ids, s=s: ids * np.uint32(S) + np.uint32(s))
            for i, s in enumerate(self.mesh.local_shards)
        ]
        fz = ShardedFrozenSegment(gather_frozen(self.mesh, local),
                                  n_docs=seg.next_docid,
                                  doc_base=self._doc_base)
        # H(t): the freqs of THIS rollover, taken before any compaction
        # can merge the segment into a multi-rollover tier
        self._hist_freqs = fz.term_freqs()
        self.frozen.append(fz)
        self.n_rollovers += 1
        if len(self.frozen) > self.max_segments - 1:
            self.frozen.pop(0)  # oldest segment retired (bounded set)
        self._doc_base += seg.next_docid
        released = slicepool.release_slices(
            self.layout, seg.state, [sh.freed_slices for sh in local])
        self.active = self._new_active(state=released)
        self._apply_compaction()
        return fz

    def compact(self, k: int, *, start: int = 0
                ) -> Optional[ShardedFrozenSegment]:
        """Merge ``k`` adjacent frozen segments from ``start`` shard by
        shard: shard ``s`` of the merged segment is the CSR merge of
        every member's shard ``s`` (members store global-within-segment
        docids, so rebasing by each member's offset keeps the residue
        classes).  A window of fewer than two segments is a no-op."""
        k = min(int(k), len(self.frozen) - start)
        if k < 2:
            return None
        window = self.frozen[start: start + k]
        base, n_docs, offs = seg_mod._adjacent_window(window)
        tier = max(int(fz.tier) for fz in window) + 1
        S = len(window[0].shards)
        shards = [
            seg_mod._merge_csr([fz.shards[s] for fz in window], offs,
                               n_docs=n_docs // S, doc_base=base,
                               tier=tier)
            for s in range(S)
        ]
        merged = ShardedFrozenSegment(shards, n_docs=n_docs,
                                      doc_base=base, tier=tier)
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

    def search_term_desc(self, term: int, engine: ShardedQueryEngine,
                         limit: int) -> np.ndarray:
        """Global docids, descending (newest segment first), stopping
        once ``limit`` docids are collected."""
        dev = self.active.state.heap.device
        terms = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        terms[0, 0] = int(term)
        desc, n = engine.conjunctive(
            self.active.state, terms,
            torch.ones(1, dtype=torch.int32, device=dev))
        out = [desc[0, : int(n[0])].cpu().numpy() + self._doc_base]
        total = out[0].size
        for fz in reversed(self.frozen):
            if total >= limit:
                break
            ids = fz.docids_desc(term).astype(np.int64) + fz.doc_base
            out.append(ids)
            total += ids.size
        return np.concatenate(out)[:limit]
