"""Deterministic fault-injection harness for the port's recovery stack.

The recovery contract (:mod:`repro_torch.core.recovery`) makes exactly
two promises: a crash at ANY point loses no acknowledged batch (restore
+ journal replay is bit-identical to the uncrashed engine), and damaged
durable state is LOUD (:class:`~repro_torch.core.recovery.
CorruptSnapshotError`), never silently wrong query results.  This module
turns each row of the fault matrix into a seeded, reproducible
experiment, plan for plan the reference package's ``analysis/faults``:

==================== ====================================================
plan kind            injected fault
==================== ====================================================
crash_after_batch    process dies between a journal append and the next
                     batch (the applied/acked gap at its widest)
crash_mid_rollover   process dies INSIDE a rollover — after freeze,
                     before ``slicepool.release_slices`` finishes
                     reclaiming (the in-memory state is torn; durable
                     state must not care)
crash_mid_compaction process dies inside a cascade merge
                     (``segments._merge_csr``), frozen list half-rewritten
truncate_archive     snapshot file cut short (torn copy, partial write
                     of a NON-atomic writer)
flip_leaf_byte       one payload byte flipped in the snapshot (bit rot,
                     bad DMA, tampering)
drop_journal_tail    COMPLETE journal records missing from the end
                     (deleted tail / restored-from-older-copy file) —
                     parses cleanly, only the ``expect_seq`` durable
                     watermark can catch it
==================== ====================================================

:func:`run_plan` executes one plan end to end on ``device`` — an engine
journaling every batch (WAL append-then-apply), a snapshot at a
configured batch, fault injection, recovery, oracle comparison — and
ASSERTS the contract: crash plans must recover bit-identical
(:func:`~repro_torch.core.recovery.engine_fingerprint` equality plus
conjunctive/disjunctive/phrase/scored_topk result equality against a
never-crashed oracle); corruption plans must raise
``CorruptSnapshotError``.  Everything is derived from ``plan.seed``.

Crash injection patches the two narrow waists every rollover and every
compaction funnel through — ``slicepool.release_slices`` (which
``segments`` calls through the module) and ``segments._merge_csr`` (a
module global of ``segments``) — so a patch on the module bites, raising
:class:`InjectedCrash` mid-operation; the harness then abandons the torn
in-memory engine exactly as a dead process would.  A plan run with
``mesh=`` (:func:`~repro_torch.core.sharded_index.make_doc_mesh`) drives
a ``ShardedLifecycleEngine`` on the mesh's shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import analytical
from repro_torch.core import recovery as rec
from repro_torch.core import segments as seg_mod
from repro_torch.core import slicepool
from repro_torch.core.lifecycle import (AdmissionController, LifecycleEngine,
                                        ShardedLifecycleEngine)
from repro_torch.core.pointers import PoolLayout

CRASH_KINDS = ("crash_after_batch", "crash_mid_rollover",
               "crash_mid_compaction")
CORRUPTION_KINDS = ("truncate_archive", "flip_leaf_byte",
                    "drop_journal_tail")
KINDS = CRASH_KINDS + CORRUPTION_KINDS


class InjectedCrash(RuntimeError):
    """The fault the harness injects to simulate a process dying
    mid-operation.  Deliberately NOT a subclass of anything the engine
    or recovery path catches."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded, fully deterministic fault experiment.

    ``snapshot_at``/``crash_at`` count BATCHES: the snapshot is taken
    after ``snapshot_at`` batches have been applied (seq semantics of
    :func:`repro_torch.core.recovery.snapshot`); crash plans arm the injector
    from batch index ``crash_at`` onward (the mid-rollover /
    mid-compaction trigger fires at the next rollover / cascade merge at
    or after that batch; ``crash_after_batch`` dies right after it).
    """
    kind: str
    seed: int = 0
    n_batches: int = 12
    batch_docs: int = 16
    doc_len: int = 5
    snapshot_at: int = 4
    crash_at: int = 8
    docs_per_segment: int = 48
    compaction_fanout: Optional[int] = 2
    admission_rollover_at: Optional[float] = None
    validate: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not (0 < self.snapshot_at <= self.n_batches):
            raise ValueError("need 0 < snapshot_at <= n_batches")


@dataclasses.dataclass
class FaultResult:
    plan: FaultPlan
    acked: int                  # batches journaled (and thus acked)
    crashed: bool               # an InjectedCrash actually fired
    raised: Optional[str]       # CorruptSnapshotError text, if any
    fingerprint_equal: bool
    queries_equal: bool

    @property
    def recovered(self) -> bool:
        return self.raised is None


# ---------------------------------------------------------------------------
# Deterministic inputs + engine construction
# ---------------------------------------------------------------------------
_Z = (1, 4, 7, 11)
_LAYOUT = PoolLayout(z=_Z, slices_per_pool=(4096, 2048, 512, 64))
_VOCAB = 300
_FMAX = 64


def make_batches(plan: FaultPlan) -> List[np.ndarray]:
    rng = np.random.default_rng(plan.seed)
    return [rng.integers(0, _VOCAB, size=(plan.batch_docs, plan.doc_len),
                         dtype=np.uint32)
            for _ in range(plan.n_batches)]


def make_engine(plan: FaultPlan, mesh=None, *, device="cuda"):
    """A small engine on ``device`` sized so the plan's stream crosses
    several rollovers (and cascade merges when ``compaction_fanout`` is
    set); sharded over ``mesh`` when one is given."""
    kw: Dict[str, Any] = dict(
        max_slices=int(analytical.slices_needed(_Z, _FMAX)) + 1,
        max_len=1 << (_FMAX - 1).bit_length(),
        use_kernel=False, validate=plan.validate,
        compaction=(seg_mod.CompactionPolicy(fanout=plan.compaction_fanout)
                    if plan.compaction_fanout is not None else None),
        admission=(AdmissionController(
            rollover_at=plan.admission_rollover_at)
            if plan.admission_rollover_at is not None else None),
        device=device)
    if mesh is not None:
        return ShardedLifecycleEngine(_LAYOUT, _VOCAB,
                                      plan.docs_per_segment, mesh, **kw)
    return LifecycleEngine(_LAYOUT, _VOCAB, plan.docs_per_segment, **kw)


def query_results(engine) -> Tuple:
    """Deterministic conjunctive/disjunctive/phrase/scored_topk results,
    as nested tuples (comparable with ==).  Term sets are fixed, not
    seeded: the comparison is engine-vs-engine on the SAME plan, so the
    only requirement is coverage of every query family."""
    sets = [(1, 2), (3,), (7, 11, 13), (2, 5)]
    out = []
    for t in sets:
        out.append(tuple(int(d) for d in engine.conjunctive(list(t))))
        out.append(tuple(int(d) for d in engine.disjunctive(list(t))))
    for t1, t2 in ((1, 2), (5, 9)):
        out.append(tuple(int(d) for d in engine.phrase(t1, t2)))
    for t in ((1, 2), (4, 6)):
        ids, scs = engine.scored_topk(list(t), 10)
        out.append((tuple(int(d) for d in ids),
                    tuple(int(s) for s in scs)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Crash injection
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _crash_on(module, name: str):
    """Replace ``module.name`` with a bomb raising :class:`InjectedCrash`
    on entry — the process 'dies' mid-operation, leaving whatever the
    caller already mutated torn."""
    orig = getattr(module, name)

    def bomb(*a, **k):
        raise InjectedCrash(f"injected crash inside {name}")

    setattr(module, name, bomb)
    try:
        yield
    finally:
        setattr(module, name, orig)


_CRASH_SITES = {
    # every rollover (single + sharded) reclaims through this
    "crash_mid_rollover": (slicepool, "release_slices"),
    # every compaction merge (single + sharded) rewrites through this
    "crash_mid_compaction": (seg_mod, "_merge_csr"),
}


@contextlib.contextmanager
def crash_site(kind: str):
    """Arm the crash bomb for ``kind`` (a :data:`CRASH_KINDS` member)
    for the duration of the ``with`` block: the next operation passing
    through the site raises :class:`InjectedCrash`, leaving torn state
    behind exactly like :func:`run_plan`'s crash phase.  The public
    entry point for harnesses that drive their OWN workload — e.g. a
    serving run that crashes an engine mid-serve and then measures
    ``recover()`` + resume."""
    try:
        module, name = _CRASH_SITES[kind]
    except KeyError:
        raise ValueError(f"unknown crash kind {kind!r}; "
                         f"one of {sorted(_CRASH_SITES)}") from None
    with _crash_on(module, name):
        yield


# ---------------------------------------------------------------------------
# Durable-state corruption
# ---------------------------------------------------------------------------
def truncate_file(path: str, *, keep_fraction: float) -> None:
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(1, int(size * keep_fraction)))


def flip_payload_byte(path: str, rng: np.random.Generator) -> int:
    """Flip one byte INSIDE the payload region (past magic + manifest, so
    the damage lands in an array, not the framing) and return its
    offset."""
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    mlen, _ = rec._HDR.unpack_from(blob, len(rec.SNAP_MAGIC))
    start = len(rec.SNAP_MAGIC) + rec._HDR.size + mlen
    off = start + int(rng.integers(0, len(blob) - start))
    blob[off] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return off


def drop_journal_records(path: str, n_drop: int) -> int:
    """Remove the last ``n_drop`` COMPLETE records from a journal by
    truncating at a record boundary — the file still parses cleanly
    (this is NOT a torn tail), only the durable watermark can notice.
    Returns how many records remain."""
    with open(path, "rb") as f:
        blob = f.read()
    hlen, _ = rec._HDR.unpack_from(blob, len(rec.JRNL_MAGIC))
    pos = len(rec.JRNL_MAGIC) + rec._HDR.size + hlen
    bounds = [pos]
    while pos + rec._REC.size <= len(blob):
        body_len, _, _ = rec._REC.unpack_from(blob, pos)
        if pos + rec._REC.size + body_len > len(blob):
            break
        pos += rec._REC.size + body_len
        bounds.append(pos)
    keep = max(0, len(bounds) - 1 - n_drop)
    with open(path, "rb+") as f:
        f.truncate(bounds[keep])
    return keep


def rewrite_leaf(path: str, name: str, fn) -> None:
    """Tamper with one archive leaf and RE-COMPUTE every checksum, so
    the archive still passes all CRC verification: the adversarial probe
    for the validate-after-restore layer (a checksummed-but-structurally
    -broken snapshot must be caught by the invariant validators, not by
    the first wrong query)."""
    meta, arrays = rec.read_archive(path)
    arrays[name] = np.asarray(fn(arrays[name]))
    rec.write_archive(path, meta, list(arrays.items()))


# ---------------------------------------------------------------------------
# The experiment driver
# ---------------------------------------------------------------------------
def run_plan(plan: FaultPlan, workdir: str, *, mesh=None,
             device="cuda") -> FaultResult:
    """Execute one fault plan end to end and ASSERT the recovery
    contract.  Returns the :class:`FaultResult` on success; raises
    ``AssertionError`` (with the plan repr) on any contract violation —
    a recovered engine differing from the oracle, a corruption plan
    recovering silently, or a crash plan failing to recover."""
    batches = make_batches(plan)
    snap = os.path.join(workdir, "snap.bin")
    jrnl = os.path.join(workdir, "journal.bin")
    for p in (snap, jrnl):
        if os.path.exists(p):
            os.remove(p)

    eng = make_engine(plan, mesh, device=device)
    # bootstrap snapshot at seq 0 (production takes one at startup), so
    # a crash BEFORE the configured snapshot point recovers by replaying
    # the whole journal into the empty engine.
    rec.snapshot(eng, snap, seq=0)
    site = _CRASH_SITES.get(plan.kind)
    acked = 0
    crashed = False
    with rec.IngestJournal(jrnl) as journal:
        for i, docs in enumerate(batches):
            journal.append(docs)   # WAL: append (=ack) THEN apply
            acked += 1
            try:
                if site is not None and i >= plan.crash_at:
                    with _crash_on(*site):
                        eng.ingest(docs)
                else:
                    eng.ingest(docs)
            except InjectedCrash:
                crashed = True     # torn in-memory engine, abandoned
                break
            if i + 1 == plan.snapshot_at:
                rec.snapshot(eng, snap, seq=i + 1)
            if plan.kind == "crash_after_batch" and i == plan.crash_at:
                crashed = True
                break
    del eng

    rng = np.random.default_rng(plan.seed + 1)
    if plan.kind == "truncate_archive":
        truncate_file(snap, keep_fraction=float(rng.uniform(0.05, 0.95)))
    elif plan.kind == "flip_leaf_byte":
        flip_payload_byte(snap, rng)
    elif plan.kind == "drop_journal_tail":
        kept = drop_journal_records(jrnl, 1)
        assert kept < acked, (
            f"{plan!r}: dropping a record left {kept} >= {acked} acked "
            f"— plan too short to lose anything")

    raised: Optional[str] = None
    fingerprint_equal = False
    queries_equal = False
    try:
        got = rec.recover(snap, jrnl, mesh=mesh, expect_seq=acked,
                          device=device)
    except rec.CorruptSnapshotError as exc:
        raised = str(exc)
    else:
        oracle = make_engine(plan, mesh, device=device)
        for docs in batches[:acked]:
            oracle.ingest(docs)
        # fingerprints FIRST: scored queries bump stats counters
        fingerprint_equal = (rec.engine_fingerprint(got)
                             == rec.engine_fingerprint(oracle))
        queries_equal = query_results(got) == query_results(oracle)

    result = FaultResult(plan=plan, acked=acked, crashed=crashed,
                         raised=raised,
                         fingerprint_equal=fingerprint_equal,
                         queries_equal=queries_equal)
    if plan.kind in CORRUPTION_KINDS:
        assert result.raised is not None, (
            f"{plan!r}: corrupted durable state recovered WITHOUT a "
            f"CorruptSnapshotError — silent corruption")
    else:
        assert result.recovered, (
            f"{plan!r}: crash recovery raised: {result.raised}")
        assert result.fingerprint_equal, (
            f"{plan!r}: recovered engine is not bit-identical to the "
            f"uncrashed oracle")
        assert result.queries_equal, (
            f"{plan!r}: recovered engine answers queries differently "
            f"from the uncrashed oracle")
    return result


__all__ = ["CORRUPTION_KINDS", "CRASH_KINDS", "KINDS", "FaultPlan",
           "FaultResult", "InjectedCrash", "crash_site",
           "drop_journal_records", "flip_payload_byte", "make_batches",
           "make_engine", "query_results", "rewrite_leaf", "run_plan",
           "truncate_file"]
