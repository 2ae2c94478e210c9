"""Structural validators for the allocator and segment state.

Usage::

    from repro_torch.analysis import invariants

    rep = invariants.check_pool_state(layout, engine.segments.active.state)
    assert rep.ok, rep.render()
    invariants.check_frozen_segment(fz, layout=layout).raise_if_failed()

    # or let the engine self-check at every rollover:
    eng = LifecycleEngine(..., validate=True)

Each ``check_*`` returns a :class:`Report` (never raises by itself):
``ok`` plus a list of :class:`Violation`\\ s naming the field and the
broken invariant, and a small ``stats`` dict so tests can assert the
validator actually inspected something (e.g. walked > 0 chains).
``Report.raise_if_failed()`` converts failures into
:class:`InvariantViolation` for post-condition use.

The same invariants as the reference package's ``analysis/invariants``,
with the same report fields and stats on the same state:

``check_pool_state``
    Per pool: live-chain slices and free-list entries are DISJOINT and
    together partition ``[0, watermark)``; free entries unique;
    watermark/free_count within capacity; chain pool indices
    non-increasing newest-first along every chain; interior chain
    slices full; per-term chain slot count equals ``freq``; ``tail``
    null iff ``freq`` zero; sticky ``overflow`` has the right shape.
    Accepts stacked ``[S, ...]`` states shard by shard.  Single-pool
    layouts cannot link continuation slices, so there only the tail
    slice is reachable and the partition relaxes to ``live + free <=
    watermark``.  Every chain is walked in lockstep on the state's
    device (one step per slice of the longest chain, as
    :func:`~repro_torch.core.segments.freeze_state` walks them), not
    slice by slice on the host.
``check_frozen_segment``
    CSR offsets monotone int64 with ``offsets[0] == 0`` and
    ``offsets[-1] == len(data)``; per-term packed postings strictly
    increasing; docids within ``[0, n_docs)`` for segment-relative
    docids; ``freed_slices`` unique and within pool capacity; with
    ``scored=`` each impact plane equals ``min(tf, SCORE_MAX)`` of the
    CSR.  (The reference also compares each term's ``docid_bounds``
    with the data; ``FrozenSegment.docid_bounds`` reads those very
    arrays in both packages, so the two agree by construction.)
``check_segment_set``
    Frozen docid ranges tile contiguously oldest-first, the active base
    continues the newest frozen segment, the set stays bounded, and with
    ``fanout=`` the compaction tiers are at the policy's fixpoint.
``check_stacked_lists``
    Byte widths in {1, 2, 4}; ``woffs`` keep every SLAB_WORDS-word
    window in bounds; pad blocks decode to INVALID; valid lanes strictly
    ascending and pad lanes never below the last valid docid; a
    ``ScoredStack``'s planes zero past ``ns``, valid impacts in ``[1,
    SCORE_MAX]`` and each block max equal to its lanes' max.

Where the reference reports one violation per offending term, row or
block, these report the first few one by one and the rest as a count
(the field is the same).  The frozen-segment and stacked-list checks
run in numpy, on the host where the port keeps frozen CSRs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import pointers as ptr_mod
from repro_torch.core.pointers import NULL, PoolLayout

INVALID = 0xFFFFFFFF
_LIST_CAP = 8      # offenders reported one by one before a summary


class InvariantViolation(AssertionError):
    """A structural invariant of the index state does not hold."""


@dataclasses.dataclass(frozen=True)
class Violation:
    check: str     # which check_* produced it
    field: str     # state leaf / structure member at fault
    message: str

    def render(self) -> str:
        return f"[{self.check}] {self.field}: {self.message}"


@dataclasses.dataclass
class Report:
    check: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, field: str, message: str) -> None:
        self.violations.append(Violation(self.check, field, message))

    def add_each(self, field: str, items, message) -> None:
        """One violation per offender (``message(item)``), the first
        :data:`_LIST_CAP` one by one and the rest as a count."""
        items = list(items)
        for it in items[:_LIST_CAP]:
            self.add(field, message(it))
        if len(items) > _LIST_CAP:
            self.add(field, f"... and {len(items) - _LIST_CAP} more like "
                     "the above")

    def render(self) -> str:
        if self.ok:
            return f"[{self.check}] ok ({self.stats})"
        return "\n".join(v.render() for v in self.violations)

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            raise InvariantViolation(self.render())
        return self


def _merge(into: Report, sub: Report, prefix: str) -> None:
    for v in sub.violations:
        into.violations.append(Violation(
            into.check, f"{prefix}{v.field}", v.message))
    for k, n in sub.stats.items():
        into.stats[k] = into.stats.get(k, 0) + n


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# check_pool_state
# ---------------------------------------------------------------------------
def _walk_chains(layout: PoolLayout, heap, ptr, wm):
    """Walk the chains starting at ``ptr`` (one per live term) in
    lockstep on ``heap``'s device.  Returns per-chain host arrays
    ``(slots, oob, cycle, back, notfull)`` and the flat live-slice marks
    (``mark[free_base[p] + slice]``)."""
    dev = heap.device
    tbl = layout.tables(dev)
    P = layout.num_pools
    C = ptr.shape[0]
    wm_t = torch.as_tensor(wm, dtype=torch.int64, device=dev)
    mark = torch.zeros(layout.total_slices, dtype=torch.bool, device=dev)
    slots = torch.zeros(C, dtype=torch.int64, device=dev)
    prev = torch.full((C,), P, dtype=torch.int64, device=dev)
    flags = {k: torch.zeros(C, dtype=torch.bool, device=dev)
             for k in ("oob", "cycle", "back", "notfull")}
    act = torch.arange(C, device=dev)
    max_steps = int(sum(layout.slices_per_pool)) + 1
    step = 0
    while act.numel():
        step += 1
        if step > max_steps:             # cycle or corrupt prev-pointer
            flags["cycle"][act] = True
            break
        pool, sl, off = ptr_mod.decode(tbl, layout.pool_bits, ptr)
        oob = sl >= wm_t[pool]
        flags["oob"][act[oob]] = True
        keep = ~oob
        act, pool, sl, off = act[keep], pool[keep], sl[keep], off[keep]
        flags["back"][act[pool > prev[act]]] = True
        prev[act] = pool
        mark[tbl["free_base"][pool] + sl] = True
        slots[act] += off - (pool > 0).long() + 1
        if step > 1:    # every older slice was full when it was linked
            full = off == tbl["slice_size"][pool] - 1
            flags["notfull"][act[~full]] = True
        base = tbl["base"][pool] + sl * tbl["slice_size"][pool]
        nxt = torch.where(pool > 0, heap[base], torch.full_like(base, NULL))
        live = nxt != NULL
        act, ptr = act[live], nxt[live]
    return (_np(slots), *(_np(flags[k]) for k in
                          ("oob", "cycle", "back", "notfull")),
            _np(mark))


def _check_pool_state_one(layout: PoolLayout, heap, watermark, tail, freq,
                          free_list, free_count, rep: Report) -> None:
    P = layout.num_pools
    V = tail.shape[0]
    caps = np.asarray(layout.slices_per_pool, np.int64)
    fb = np.asarray(layout.free_base, np.int64)
    sizes = np.asarray(layout.slice_sizes, np.int64)
    single_pool = P == 1
    wm = _np(watermark).astype(np.int64)
    fc = _np(free_count).astype(np.int64)
    fl = _np(free_list)

    if tuple(heap.shape) != (layout.total_slots,):
        rep.add("heap", f"shape {tuple(heap.shape)} != "
                f"({layout.total_slots},)")
        return
    if np.any(wm < 0) or np.any(wm > caps):
        rep.add("watermark", f"outside [0, capacity]: {wm} vs {caps}")
        return
    if np.any(fc < 0) or np.any(fc > wm):
        rep.add("free_count",
                f"outside [0, watermark]: {fc} vs watermark {wm}")
        return

    free_sets = []
    for p in range(P):
        entries = fl[fb[p]: fb[p] + fc[p]].astype(np.int64)
        uniq = np.unique(entries)
        if entries.size != uniq.size:
            rep.add("free_list", f"pool {p}: duplicate free entries")
        bad = (entries < 0) | (entries >= wm[p])
        if np.any(bad):
            rep.add("free_list",
                    f"pool {p}: {int(bad.sum())} entries outside the "
                    f"allocated range [0, {wm[p]})")
        free_sets.append(uniq)

    heap = torch.as_tensor(heap)
    dev = heap.device
    tail_t = torch.as_tensor(tail).to(dev).long()
    freq_t = torch.as_tensor(freq).to(dev).long()
    terms = torch.nonzero(freq_t > 0)[:, 0]
    ptr = tail_t[terms]
    null = _np(ptr == NULL)
    terms_h = _np(terms)
    rep.add_each("tail", terms_h[null], lambda t: (
        f"term {int(t)}: freq {int(freq_t[t])} > 0 but tail is NULL"))
    chain_terms = terms_h[~null]
    slots, oob, cycle, back, notfull, mark = _walk_chains(
        layout, heap, ptr[torch.as_tensor(~null, device=dev)], wm)
    rep.add_each("tail", chain_terms[oob], lambda t: (
        f"term {int(t)}: a chain slice lies outside its pool's "
        "allocated range [0, watermark)"))
    rep.add_each("tail", chain_terms[cycle], lambda t: (
        f"term {int(t)}: chain exceeds {int(caps.sum()) + 1} slices — "
        "cycle or corrupt previous-pointer"))
    rep.add_each("tail", chain_terms[back], lambda t: (
        f"term {int(t)}: a larger pool follows a smaller one "
        "newest-first — the §3.3 progression never grows backwards"))
    rep.add_each("tail", chain_terms[notfull], lambda t: (
        f"term {int(t)}: an interior chain slice is not full"))
    f_chain = _np(freq_t)[chain_terms].astype(np.int64)
    want = (((f_chain - 1) % int(sizes[0])) + 1 if single_pool
            else f_chain)
    wrong = ~(oob | cycle) & (slots != want)
    rep.add_each("freq", np.nonzero(wrong)[0], lambda i: (
        f"term {int(chain_terms[i])}: chain holds {int(slots[i])} "
        f"postings but freq {int(f_chain[i])} implies {int(want[i])}"))

    stray = torch.nonzero((freq_t == 0) & (tail_t != NULL))[:1, 0]
    if stray.numel():                    # one is enough; V can be large
        t = int(stray[0])
        rep.add("tail", f"term {t}: freq 0 but tail "
                f"{int(tail_t[t]):#x} != NULL")

    n_live_all = 0
    for p in range(P):
        live = mark[fb[p]: fb[p] + caps[p]]
        ent = free_sets[p]
        ent = ent[(ent >= 0) & (ent < caps[p])]
        inter = ent[live[ent]]
        if inter.size:
            rep.add("free_list",
                    f"pool {p}: {inter.size} slice(s) BOTH live and on "
                    f"the free list (e.g. slice {int(inter.min())}) — "
                    "use-after-free territory")
        n_live, n_free = int(live.sum()), int(free_sets[p].size)
        n_live_all += n_live
        if single_pool:
            if n_live + n_free > int(wm[p]):
                rep.add("watermark",
                        f"pool {p}: live {n_live} + free {n_free} > "
                        f"watermark {int(wm[p])} — slices double-counted")
        elif n_live + n_free != int(wm[p]):
            rep.add("watermark",
                    f"pool {p}: live {n_live} + free {n_free} != "
                    f"watermark {int(wm[p])} — allocated slices leaked "
                    "or double-counted")
    rep.stats["chains_walked"] = rep.stats.get("chains_walked", 0) \
        + int(chain_terms.size)
    rep.stats["live_slices"] = rep.stats.get("live_slices", 0) + n_live_all
    rep.stats["free_slices"] = rep.stats.get("free_slices", 0) \
        + sum(int(s.size) for s in free_sets)
    rep.stats["vocab"] = int(V)


def check_pool_state(layout: PoolLayout, state,
                     shards: Optional[Sequence[int]] = None) -> Report:
    """Validate a :class:`~repro_torch.core.slicepool.PoolState` (single
    ``watermark[P]`` or stacked ``watermark[S, P]``, whose rows are the
    shards ``shards``, by default ``0 .. S-1``); the chain walk runs on
    the state's device."""
    rep = Report(check="pool-state")
    wm = _np(state.watermark)
    ov = _np(state.overflow)
    if wm.ndim == 2:
        S = wm.shape[0]
        if ov.shape != (S,):
            rep.add("overflow", f"sharded state wants bool[{S}], got "
                    f"shape {ov.shape}")
        rep.stats["shards"] = S
        for s, name in enumerate(range(S) if shards is None else shards):
            sub = Report(check=rep.check)
            _check_pool_state_one(layout, state.heap[s], state.watermark[s],
                                  state.tail[s], state.freq[s],
                                  state.free_list[s], state.free_count[s],
                                  sub)
            _merge(rep, sub, f"shard {name}: ")
    else:
        if ov.shape != ():
            rep.add("overflow", f"single state wants a bool scalar, got "
                    f"shape {ov.shape}")
        _check_pool_state_one(layout, state.heap, state.watermark,
                              state.tail, state.freq, state.free_list,
                              state.free_count, rep)
    # overflow being SET is defined allocator behaviour (inserts become
    # no-ops), not a structural violation — only its shape is invariant.
    rep.stats["overflowed"] = int(np.any(ov))
    return rep


# ---------------------------------------------------------------------------
# check_frozen_segment
# ---------------------------------------------------------------------------
def check_frozen_segment(seg, *, layout: Optional[PoolLayout] = None,
                         relative_docids: bool = True,
                         scored=None) -> Report:
    """Validate one :class:`~repro_torch.core.segments.FrozenSegment` CSR.

    ``relative_docids=False`` for segments whose docids legitimately
    exceed ``n_docs`` (shard members of a document-sharded segment).
    ``scored`` takes ``[(term, ScoredList), ...]`` pairs (e.g. from
    ``PackedSegment.scored``) and cross-checks each impact plane against
    the tf derived from the positional CSR."""
    from repro_torch.core import postings as post

    rep = Report(check="frozen-segment")
    offsets = np.asarray(seg.offsets)
    data = np.asarray(seg.data)
    V = offsets.shape[0] - 1
    if offsets.dtype != np.int64:
        rep.add("offsets", f"dtype {offsets.dtype} != int64")
    if offsets.size == 0 or offsets[0] != 0:
        rep.add("offsets", "offsets[0] != 0")
        return rep
    d = np.diff(offsets)
    if np.any(d < 0):
        t = int(np.argmax(d < 0))
        rep.add("offsets", f"non-monotone at term {t}: "
                f"{int(offsets[t])} -> {int(offsets[t + 1])}")
        return rep
    if int(offsets[-1]) != data.size:
        rep.add("offsets", f"offsets[-1] {int(offsets[-1])} != "
                f"len(data) {data.size}")
        return rep

    shift = np.uint32(post.POS_BITS)
    docids = (data >> shift).astype(np.int64)
    live = np.nonzero(d > 0)[0]
    if data.size > 1:
        # each pair (i, i + 1) inside one term's run must strictly
        # increase; the pair before a term's first posting is exempt
        bad = np.diff(data.astype(np.int64)) <= 0
        starts = offsets[live]
        bad[starts[starts > 0] - 1] = False
        terms = np.searchsorted(offsets, np.nonzero(bad)[0],
                                side="right") - 1
        rep.add_each("data", np.unique(terms), lambda t: (
            f"term {int(t)}: packed postings not strictly increasing "
            "(docid/pos order broken)"))
    if relative_docids and data.size:
        if int(docids.max()) >= int(seg.n_docs) or int(docids.min()) < 0:
            rep.add("data", f"docid {int(docids.max())} outside "
                    f"[0, n_docs={int(seg.n_docs)})")
    freed = getattr(seg, "freed_slices", None)
    if freed is not None:
        for p, sl in enumerate(freed):
            sl = np.asarray(sl)
            if sl.size != np.unique(sl).size:
                rep.add("freed_slices", f"pool {p}: duplicate slice — "
                        "would double-release")
            if layout is not None and sl.size and (
                    int(sl.min()) < 0
                    or int(sl.max()) >= layout.slices_per_pool[p]):
                rep.add("freed_slices", f"pool {p}: slice index outside "
                        f"[0, {layout.slices_per_pool[p]})")
    if scored:
        from repro_torch.kernels.segment_intersect import (SCORE_MAX,
                                                           decode_packed,
                                                           decode_scores)
        base = int(getattr(seg, "doc_base", 0))
        n_scored = 0
        for term, sl in scored:
            term = int(term)
            a, b = int(offsets[term]), int(offsets[term + 1])
            uniq, tf = np.unique(docids[a:b], return_counts=True)
            want = np.minimum(tf, SCORE_MAX).astype(np.int64)
            n = int(sl.ids.n)
            n_scored += 1
            if n != uniq.size:
                rep.add("scored", f"term {term}: impact plane holds {n} "
                        f"docids but the CSR holds {uniq.size} unique "
                        "docids")
                continue
            got_ids = _np(decode_packed(sl.ids, "cpu"))[:n].astype(
                np.int64) - base
            if not np.array_equal(got_ids, uniq):
                rep.add("scored", f"term {term}: packed docids disagree "
                        "with the CSR's unique docids — impacts would "
                        "score the wrong documents")
                continue
            got_sc = _np(decode_scores(torch.as_tensor(
                np.asarray(sl.swords).astype(np.int64)))).reshape(-1)[
                :n].astype(np.int64)
            if not np.array_equal(got_sc, want):
                i = int(np.argmax(got_sc != want))
                rep.add("scored", f"term {term}: impact {int(got_sc[i])} "
                        f"at lane {i} != min(tf, SCORE_MAX) = "
                        f"{int(want[i])} from the positional CSR")
        rep.stats["scored_terms_checked"] = n_scored
    rep.stats["terms_checked"] = int(live.size)
    rep.stats["postings"] = int(data.size)
    rep.stats["vocab"] = int(V)
    return rep


# ---------------------------------------------------------------------------
# check_segment_set
# ---------------------------------------------------------------------------
def check_segment_set(segset, *, layout: Optional[PoolLayout] = None,
                      fanout: Optional[int] = None) -> Report:
    """Validate a ``SegmentSet``-shaped object (``frozen`` list +
    ``_doc_base`` + ``max_segments``): frozen docid ranges tile
    contiguously oldest-first, the active base continues the newest
    frozen segment, the set stays bounded; each member segment (each
    shard of a sharded one) is validated too.  ``fanout`` (the engine's ``CompactionPolicy``
    fanout) adds the tier-structure check: tiers non-increasing
    oldest-first and no run of ``fanout`` adjacent same-tier segments."""
    rep = Report(check="segment-set")
    frozen = list(segset.frozen)
    if len(frozen) > int(segset.max_segments) - 1:
        rep.add("frozen", f"{len(frozen)} frozen segments exceed "
                f"max_segments - 1 = {int(segset.max_segments) - 1}")
    prev_end = None
    tiers: List[int] = []
    for i, fz in enumerate(frozen):
        base, n = int(fz.doc_base), int(fz.n_docs)
        if n < 0:
            rep.add("frozen", f"segment {i}: negative n_docs {n}")
        if prev_end is not None and base < prev_end:
            rep.add("frozen", f"segment {i}: doc_base {base} overlaps "
                    f"previous segment's range ending at {prev_end}")
        elif prev_end is not None and base > prev_end:
            rep.add("frozen", f"segment {i}: doc_base {base} leaves a "
                    f"gap after previous range end {prev_end} — frozen "
                    "ranges must tile contiguously")
        prev_end = base + n
        tier = int(getattr(fz, "tier", 0))
        tiers.append(tier)
        if tier < 0:
            rep.add("tier", f"segment {i}: negative tier {tier}")
        for s, sh in enumerate(fz.members):
            # shard members hold global-within-segment docids
            whole = sh is fz
            _merge(rep, check_frozen_segment(
                sh, layout=layout, relative_docids=whole),
                f"segment {i}: " if whole else f"segment {i} shard {s}: ")
    if frozen and int(segset._doc_base) != prev_end:
        rep.add("_doc_base", f"active doc_base {int(segset._doc_base)} "
                f"!= newest frozen end {prev_end} — ranges must tile")
    if fanout is not None and tiers:
        if int(fanout) < 2:
            rep.add("tier", f"fanout {fanout} < 2 is not a geometric "
                    "policy")
        for i in range(1, len(tiers)):
            if tiers[i] > tiers[i - 1]:
                rep.add("tier", f"segment {i}: tier {tiers[i]} exceeds "
                        f"older segment's tier {tiers[i - 1]} — the "
                        "geometric cascade keeps tiers non-increasing "
                        "oldest-first")
        run, run_tier = 0, None
        for i, t in enumerate(tiers):
            run = run + 1 if t == run_tier else 1
            run_tier = t
            if run >= int(fanout):
                rep.add("tier", f"segments {i - run + 1}..{i}: {run} "
                        f"adjacent tier-{t} segments >= fanout "
                        f"{int(fanout)} — the policy fixpoint was not "
                        "reached (G would grow linearly)")
                break
    rep.stats["segments"] = len(frozen)
    rep.stats["max_tier"] = max(tiers) if tiers else 0
    return rep


# ---------------------------------------------------------------------------
# check_stacked_lists
# ---------------------------------------------------------------------------
def check_stacked_lists(s, *, decode: bool = True) -> Report:
    """Validate a :class:`~repro_torch.kernels.segment_intersect.StackedLists`
    (numpy or torch leaves, any leading shape): legal byte widths,
    in-bounds windows, pad blocks decoding to INVALID, ascending valid
    lanes.  A ``ScoredStack`` is accepted too: its docid stack is
    validated identically, then the score planes."""
    from repro_torch.kernels.segment_intersect import (SCORE_MAX,
                                                       SCORE_WORDS,
                                                       SEG_BLOCK,
                                                       SLAB_WORDS,
                                                       StackedLists,
                                                       decode_scores,
                                                       decode_stacked)

    rep = Report(check="stacked-lists")
    swords = bmax = None
    if hasattr(s, "swords"):          # ScoredStack: ids + score planes
        swords = _np(s.swords).astype(np.int64)
        bmax = _np(s.bmax)
        s = s.ids
    firsts = _np(s.firsts).astype(np.int64)
    bws = _np(s.bws)
    woffs = _np(s.woffs).astype(np.int64)
    payload = _np(s.payload).astype(np.int64)
    ns = _np(s.ns)
    NB = firsts.shape[-1]
    PW = payload.shape[-1]
    rows = int(np.prod(firsts.shape[:-1], dtype=np.int64)) \
        if firsts.ndim > 1 else 1
    f2 = firsts.reshape(rows, NB)
    b2 = bws.reshape(rows, NB)
    w2 = woffs.reshape(rows, NB)
    p2 = payload.reshape(rows, PW)
    n2 = ns.reshape(rows).astype(np.int64)

    if not np.isin(b2, (1, 2, 4)).all():
        rep.add("bws", f"byte widths outside {{1,2,4}}: "
                f"{sorted(set(np.unique(b2).tolist()) - {1, 2, 4})}")
    if np.any(n2 < 0) or np.any(n2 > NB * SEG_BLOCK):
        rep.add("ns", f"valid counts outside [0, {NB * SEG_BLOCK}]")
    if np.any(w2 < 0) or np.any(w2 > PW - SLAB_WORDS):
        rep.add("woffs", f"word offsets outside [0, {PW - SLAB_WORDS}] "
                f"— a {SLAB_WORDS}-word block window would overrun the "
                "payload")
        return rep   # decoding would index out of bounds; stop here

    pad = f2 == INVALID
    n_pad_blocks = int(pad.sum())
    r_pad, b_pad = np.nonzero(pad)
    if r_pad.size:
        lane = np.arange(SLAB_WORDS)
        words = p2[r_pad[:, None], w2[r_pad, b_pad][:, None] + lane]
        inside = lane < 32 * b2[r_pad, b_pad][:, None]
        dirty = np.nonzero(np.any((words != 0) & inside, axis=1))[0]
        rep.add_each("payload", dirty, lambda i: (
            f"row {int(r_pad[i])} block {int(b_pad[i])}: pad block gap "
            "plane is non-zero — would decode to non-INVALID ghost "
            "docids"))
    if decode:
        st = StackedLists(*(torch.as_tensor(x) for x in
                            (f2, b2.astype(np.int32), w2.astype(np.int32),
                             p2, n2.astype(np.int32))))
        lanes = _np(decode_stacked(st)).astype(np.int64)
        L = lanes.shape[1]
        j = np.arange(L)
        # valid pairs (j, j + 1) with j + 1 < n must strictly increase
        pair = j[None, :-1] + 1 < n2[:, None]
        asc = np.nonzero(np.any(pair & (np.diff(lanes, axis=1) <= 0),
                                axis=1))[0]
        rep.add_each("payload", asc, lambda r: (
            f"row {int(r)}: decoded valid lanes not strictly ascending"))
        last = np.where(n2 > 0, lanes[np.arange(rows),
                                      np.clip(n2 - 1, 0, L - 1)], -1)
        below = np.nonzero(np.any((j[None, :] >= n2[:, None])
                                  & (lanes < last[:, None]), axis=1))[0]
        rep.add_each("payload", below, lambda r: (
            f"row {int(r)}: pad lane decodes below the last valid docid "
            "— would corrupt the two-pointer walk"))
        lb = lanes.reshape(rows, NB, SEG_BLOCK)
        bad = pad & np.any(lb != INVALID, axis=2)
        if np.any(bad):
            r, b = [int(x[0]) for x in np.nonzero(bad)]
            rep.add("payload", f"row {r} block {b}: pad block decodes "
                    "to non-INVALID lanes")
    if swords is not None:
        if swords.shape[-1] != NB * SCORE_WORDS:
            rep.add("swords", f"score plane width {swords.shape[-1]} != "
                    f"{NB} blocks * {SCORE_WORDS} words")
            return rep
        if bmax.shape[-1] != NB:
            rep.add("bmax", f"block-max width {bmax.shape[-1]} != "
                    f"{NB} blocks")
            return rep
        sc = _np(decode_scores(torch.as_tensor(swords))).reshape(
            rows, NB * SEG_BLOCK).astype(np.int64)
        bm = bmax.reshape(rows, NB).astype(np.int64)
        valid = np.arange(NB * SEG_BLOCK)[None, :] < n2[:, None]
        out_rng = np.nonzero(np.any(valid & ((sc < 1) | (sc > SCORE_MAX)),
                                    axis=1))[0]
        rep.add_each("swords", out_rng, lambda r: (
            f"row {int(r)}: valid-lane impact outside [1, {SCORE_MAX}] — "
            "0 is the no-hit sentinel, so a 0 impact would drop a real "
            "hit"))
        leak = np.nonzero(np.any(~valid & (sc != 0), axis=1))[0]
        rep.add_each("swords", leak, lambda r: (
            f"row {int(r)}: non-zero impact past ns={int(n2[r])} — a pad "
            "lane would leak into the intersection scores"))
        want = sc.reshape(rows, NB, SEG_BLOCK).max(axis=2)
        drift = np.nonzero(np.any(bm != want, axis=1))[0]

        def bmax_msg(r):
            b = int(np.argmax(bm[r] != want[r]))
            rel = "below" if bm[r][b] < want[r][b] else "above"
            return (f"row {int(r)} block {b}: bmax {int(bm[r][b])} {rel} "
                    f"the block's lane max {int(want[r][b])}" + (
                        " — the skip bound would drop docs that belong "
                        "in the top-k" if rel == "below" else ""))
        rep.add_each("bmax", drift, bmax_msg)
        rep.stats["scored_rows"] = rows
    rep.stats["rows"] = rows
    rep.stats["pad_blocks"] = n_pad_blocks
    return rep


def check_engine(engine) -> Report:
    """Whole-engine validation: :func:`check_pool_state` on the active
    allocator plus :func:`check_segment_set` (with the engine's layout
    and compaction fanout) over the frozen side, merged into one report.
    ``validate=True`` engines run it at every rollover — scheduled or
    emergency — after engine-driven compaction, and right after
    ``recovery.restore``: a snapshot that passes its CRCs but encodes a
    structurally broken state must fail here, not at the first wrong
    query result.

    On a rank mesh (:func:`~repro_torch.core.sharded_index.
    make_rank_mesh`) each rank checks its own shard and the replicated
    frozen side, then the failure flag is maxed over the ranks: a
    collective every rank calls, and a failure on one rank fails the
    report on every rank."""
    rep = Report("check_engine")
    mesh = getattr(engine.segments, "mesh", None)
    _merge(rep, check_pool_state(
        engine.layout, engine.segments.active.state,
        None if mesh is None else mesh.local_shards), "active/")
    policy = getattr(engine.segments, "compaction", None)
    _merge(rep, check_segment_set(
        engine.segments, layout=engine.layout,
        fanout=policy.fanout if policy is not None else None),
        "segments/")
    if mesh is not None and mesh.combine(not rep.ok, "max") and rep.ok:
        # one rank's failure fails them all, so none is left waiting in
        # the next collective
        rep.add("ranks", "another rank's shard failed its checks")
    return rep


def check_serve(loop) -> Report:
    """Conservation checks over a :class:`repro_torch.core.serve.ServeLoop`'s
    accounting: every submission is exactly one of rejected / served /
    aborted / still queued / in flight, per-level service counts sum to
    the served total, every rejection carried a positive retry-after,
    and every acked ingest batch is exactly one of applied /
    finally-shed / replay-recovered / still queued.

    On a rank mesh every rank checks its own loop: a follower's stats
    and queue depths are the leader's as of the leader's last plan, so
    after the leader's ``stop()`` every rank checks the leader's
    accounting.  The failure flag is then maxed over the ranks, as in
    :func:`check_engine`: a collective every rank calls, and the same
    verdict on every rank."""
    rep = Report("check_serve")
    s = loop.stats
    accounted = (s.queries_rejected + s.queries_served
                 + s.queries_aborted + loop.pending_queries
                 + loop.in_flight_queries)
    if s.queries_submitted != accounted:
        rep.add("queries", f"submitted {s.queries_submitted} != rejected "
                f"{s.queries_rejected} + served {s.queries_served} + "
                f"aborted {s.queries_aborted} + queued "
                f"{loop.pending_queries} + in-flight "
                f"{loop.in_flight_queries} — a request was silently "
                "dropped (or double-counted)")
    if sum(s.served_by_level) != s.queries_served:
        rep.add("levels", f"per-level counts {s.served_by_level} sum to "
                f"{sum(s.served_by_level)} != served {s.queries_served} "
                "— a response left without reporting its ladder rung")
    if s.rejections_without_retry_after != 0:
        rep.add("backpressure", f"{s.rejections_without_retry_after} "
                "rejection(s) carried no positive retry-after — "
                "backpressure must always tell the producer when to "
                "come back")
    ing = (s.ingest_rejected + s.ingest_applied + s.ingest_shed
           + s.ingest_recovered + loop.pending_ingest)
    if s.ingest_submitted != ing:
        rep.add("ingest", f"submitted {s.ingest_submitted} != rejected "
                f"{s.ingest_rejected} + applied {s.ingest_applied} + "
                f"shed {s.ingest_shed} + recovered {s.ingest_recovered} "
                f"+ queued {loop.pending_ingest} — an acked batch "
                "vanished without a verdict")
    mesh = getattr(loop.engine.segments, "mesh", None)
    if mesh is not None and mesh.combine(not rep.ok, "max") and rep.ok:
        rep.add("ranks", "another rank's loop failed its checks")
    rep.stats["queries_served"] = s.queries_served
    rep.stats["ingest_applied"] = s.ingest_applied
    return rep


__all__ = ["InvariantViolation", "Violation", "Report",
           "check_engine", "check_pool_state", "check_frozen_segment",
           "check_segment_set", "check_serve", "check_stacked_lists"]
