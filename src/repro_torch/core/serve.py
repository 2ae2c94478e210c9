"""Overload-resilient serving loop over the port's ``LifecycleEngine``.

The paper's Goldilocks trade-off is ultimately a serving guarantee:
tweets must be searchable immediately *while* queries stay fast — under
bursty, adversarial traffic, not only in a harness that waits for every
call to return.  This module is the layer between raw clients and a
:class:`~repro_torch.core.lifecycle.LifecycleEngine` that makes the
engine's guarantees survive overload, with the reference package's
policy and accounting, decision for decision:

  * **Bounded admission queues, explicit backpressure.**  Ingest and
    query submissions land in capacity-bounded queues; a full queue (or
    an allocator already at critical utilization, for ingest) REJECTS
    the submission with a computed ``retry_after_s`` — never a silent
    drop.  An accepted ingest submission is journaled BEFORE it is
    acknowledged (when a :class:`~repro_torch.core.recovery.IngestJournal`
    is attached), so the ack means durable.
  * **Query coalescing.**  Arrivals pack into the pow2 Q buckets of
    :mod:`repro_torch.core.qexec`; a batch flushes when the bucket fills
    OR a batch-deadline timer expires, so p99 never waits for a full
    bucket under light load.
  * **Graceful degradation.**  An overload gauge — the max of query
    queue depth, :func:`~repro_torch.core.slicepool.pool_utilization`
    and the recent-latency EWMA against the deadline — trips queries
    down an explicit ladder (:data:`DEGRADE_NONE` exhaustive →
    :data:`DEGRADE_EARLY_EXIT` → :data:`DEGRADE_REDUCED_K` →
    :data:`DEGRADE_FROZEN_ONLY`), and every response reports the level
    it was served at.  Each rung is exact against its oracle.
  * **Ingest/query overlap.**  A step dispatches the due query batch
    (:meth:`LifecycleEngine.dispatch`: every kernel and copy that reads
    the index state is enqueued, the device-to-host copy of the results
    deferred to :meth:`qexec.Pending.wait`), then applies one ingest
    batch, and only then waits for the query results.  The ingest's
    ``bulk_append`` writes the active ``heap``/``tail``/``freq`` IN
    PLACE (torch has no buffer donation), which is safe because the
    query's reads were enqueued earlier on the same CUDA stream and its
    ``finish`` reads only its own result tensors, never the state; a
    rollover inside the ingest replaces the frozen stack and the
    tail/freq tensors, and the query keeps the ones it was dispatched
    with.  The ingest plan's one host sync per batch waits for the
    pending query's device work too, so on the card the overlap is of
    host work, not of two streams' kernels.

Shedding discipline: the engine-level
:class:`~repro_torch.core.lifecycle.AdmissionController` shed is this
layer's LAST resort.  The loop rejects un-acked ingest with retry-after
while pressure is building; once a batch is acked (journaled) it is
handed to the engine exactly once — a shed verdict is final and
counted, never retried into the same engine, because a shed-then-retry
would mutate state in a way a single-pass journal replay
(:func:`~repro_torch.core.recovery.recover`) could not reproduce.

**On ranks** (an engine on
:func:`~repro_torch.core.sharded_index.make_rank_mesh`, one shard a
process) every rank builds a loop over its shard's engine, and every
rank must make the same engine calls in the same order.  Shard 0's rank
is the *leader*: it alone holds the queues, the clock, the journal and
the stats, and clients submit there alone (``submit_*`` on another rank
raises).  Each :meth:`ServeLoop.step` on the leader settles everything
read from the clock or the gauge -- force, full or due, the rung, the
groups with their specs and terms, the ingest ``(seq, docs)`` -- into one
plan, broadcast once (``mesh.broadcast``); the other ranks, *followers*,
run :meth:`ServeLoop.follow`, which makes each plan's ``dispatch``,
``ingest`` and ``wait`` calls in the plan's order, and takes the
leader's snapshot and stop plans.  A follower's clock is never read; its
stats mirror the leader's from the plans.  The pool gauge is the
engine's :meth:`pool_utilization` (a max over the ranks), which every
rank reads in the same collective at construction, after each step that
applied a batch and in :meth:`ServeLoop.resume_with`, and which
``submit_ingest`` and the ladder read from there.  On one device and on
the stacked mesh the broadcast is the identity: the same code path.

The reference's ``stable_shapes`` ratchet is left out: eager torch
never recompiles for a new gather shape.  Not to be confused with
``repro_torch.launch.serve``, the paged-KV *model*-serving loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import qexec

# Degradation ladder: every query is served at exactly one level, and
# the response carries it; each rung is exact against its oracle.
DEGRADE_NONE = 0         # exhaustive evaluation, results exact
DEGRADE_EARLY_EXIT = 1   # early-exit top-k at the requested k
DEGRADE_REDUCED_K = 2    # early-exit at k // reduced_k_factor
DEGRADE_FROZEN_ONLY = 3  # frozen segments only (active dispatch skipped)
LEVEL_NAMES = ("exhaustive", "early_exit", "reduced_k", "frozen_only")

QUERY_KINDS = ("conjunctive", "disjunctive", "phrase", "topk", "scored")


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Explicit backpressure: the submission was NOT accepted, nothing
    was enqueued or journaled, and the producer should retry no sooner
    than ``retry_after_s`` from now.  Every rejection carries a positive
    retry-after — a rejection without one would be a silent drop with
    extra steps, and :func:`repro_torch.analysis.invariants.check_serve`
    treats it as an invariant violation."""
    reason: str
    retry_after_s: float


@dataclasses.dataclass
class QueryRequest:
    qid: int
    kind: str                   # one of QUERY_KINDS
    terms: Tuple[int, ...]
    k: int                      # top-k size / degraded result cap
    submitted_s: float          # loop-clock time of acceptance
    deadline_s: float           # absolute loop-clock deadline


@dataclasses.dataclass
class QueryResponse:
    qid: int
    kind: str
    docids: np.ndarray          # GLOBAL docids, result order
    scores: Optional[np.ndarray]  # scored kinds only
    level: int                  # degradation ladder rung served at
    level_name: str
    degraded: bool              # level > 0 (always flagged)
    latency_s: float
    deadline_met: bool


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-loop policy knobs (all times in seconds, loop clock)."""
    max_batch: int = 32            # coalescer bucket (pow2-bucketed)
    batch_wait_s: float = 0.002    # flush timer: max age of oldest req
    query_queue_cap: int = 256
    ingest_queue_cap: int = 64
    default_k: int = 10            # k for requests that don't pass one
    deadline_s: float = 0.25       # default per-query budget
    # overload gauge thresholds: pressure >= degrade_at[i] serves at
    # level i+1 (monotone; below degrade_at[0] is exhaustive service)
    degrade_at: Tuple[float, float, float] = (0.5, 0.75, 0.9)
    reduced_k_factor: int = 4
    latency_alpha: float = 0.2     # recent-latency EWMA weight
    # reject NEW (un-acked) ingest while the worst pool is this full —
    # backpressure before the ack, so the engine-level shed (final,
    # because replay-deterministic) stays the last resort
    ingest_reject_util: float = 0.97

    def __post_init__(self):
        if not (0.0 < self.degrade_at[0] <= self.degrade_at[1]
                <= self.degrade_at[2]):
            raise ValueError(f"degrade_at must be monotone in (0, inf), "
                             f"got {self.degrade_at}")
        if self.max_batch < 1 or self.query_queue_cap < 1 \
                or self.ingest_queue_cap < 1:
            raise ValueError("max_batch and queue capacities must be >= 1")
        if self.reduced_k_factor < 2:
            raise ValueError("reduced_k_factor must be >= 2")


@dataclasses.dataclass
class ServeStats:
    """Loud accounting for everything the loop does — the substrate of
    :func:`repro_torch.analysis.invariants.check_serve`'s conservation
    checks (submitted == rejected + served + still-queued, rejections
    always carry retry-after, per-level counts sum to served)."""
    queries_submitted: int = 0
    queries_rejected: int = 0
    queries_served: int = 0
    served_by_level: List[int] = dataclasses.field(
        default_factory=lambda: [0, 0, 0, 0])
    deadline_misses: int = 0
    flushes_full: int = 0          # bucket filled
    flushes_timer: int = 0         # batch-deadline timer fired
    batches_dispatched: int = 0
    rejections_without_retry_after: int = 0   # invariant: stays 0
    ingest_submitted: int = 0
    ingest_rejected: int = 0       # backpressure before the ack
    ingest_applied: int = 0        # acked + indexed by the live engine
    ingest_shed: int = 0           # acked, engine admission refused (final)
    ingest_recovered: int = 0      # acked, applied via journal replay
    queries_aborted: int = 0       # in flight at a crash (never acked)
    docs_indexed: int = 0
    recoveries: int = 0
    latency_ewma_s: float = 0.0


@dataclasses.dataclass
class Plan:
    """What the leader decided, as every rank runs it: ``op`` is
    ``"step"`` (``groups`` of ``(spec, terms of each query)`` to
    dispatch in order, then ``ingest``'s ``(seq, docs)`` if any),
    ``"snapshot"`` (to ``path`` at ``seq``), ``"resume"`` or ``"stop"``;
    ``report`` is the leader's stats and ``(pending queries, pending
    ingest, in flight, applied seq)`` as it broadcast the plan."""
    op: str
    groups: List[Tuple[tuple, List[Tuple[int, ...]]]] = \
        dataclasses.field(default_factory=list)
    ingest: Optional[Tuple[int, np.ndarray]] = None
    path: Optional[str] = None
    seq: int = 0
    report: Optional[tuple] = None


class ServeLoop:
    """Single-threaded cooperative serving loop: callers ``submit_*``,
    something drives :meth:`step` (a thread, an event loop, a bench's
    while-loop), responses come back from :meth:`take_responses`.

    ``clock`` is injectable (tests pass a manual clock; the default is
    ``time.monotonic``).  ``journal`` (an
    :class:`~repro_torch.core.recovery.IngestJournal`) makes the ingest
    ack durable: append happens inside :meth:`submit_ingest` BEFORE the
    seq is returned, so every acknowledged batch survives a crash and
    :func:`~repro_torch.core.recovery.recover` + :meth:`resume_with`
    restores a bit-identical index.

    On a rank mesh the loop of shard 0's rank leads (:attr:`leads`):
    it alone takes submissions and a journal, and drives :meth:`step`,
    :meth:`snapshot_now` and finally :meth:`stop`; every other rank calls
    :meth:`follow` until the leader stops.  Constructing the loop and
    :meth:`resume_with` are collectives every rank makes.
    """

    def __init__(self, engine, config: Optional[ServeConfig] = None, *,
                 journal=None, clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.config = config if config is not None else ServeConfig()
        self._mesh = getattr(engine.segments, "mesh", None)
        self.leads = self._mesh is None or self._mesh.leads
        if journal is not None and not self.leads:
            raise ValueError("the journal is the leader's (shard 0's "
                             "rank): followers get their batches from its "
                             "plans")
        self.journal = journal
        self.clock = clock
        self.stats = ServeStats()
        # tests pin the ladder rung with this; None = gauge-driven
        self.force_level: Optional[int] = None
        self._query_q: List[QueryRequest] = []
        self._ingest_q: List[Tuple[int, np.ndarray]] = []  # (seq, docs)
        self._responses: List[QueryResponse] = []
        self._next_qid = 0
        self._next_seq = journal.next_seq if journal is not None else 0
        self._applied_seq = self._next_seq  # batches handed to engine
        self._n_in_flight = 0
        # a follower's view of the leader's queues: (queued queries,
        # queued batches, queries in flight) at its last plan
        self._seen = None if self.leads else (0, 0, 0)
        self.refresh_pressure()

    # -- introspection ----------------------------------------------------
    @property
    def pending_queries(self) -> int:
        return len(self._query_q) if self._seen is None else self._seen[0]

    @property
    def in_flight_queries(self) -> int:
        return self._n_in_flight if self._seen is None else self._seen[2]

    @property
    def pending_ingest(self) -> int:
        return len(self._ingest_q) if self._seen is None else self._seen[1]

    @property
    def applied_seq(self) -> int:
        """Count of acked batches already handed to the engine (applied
        or finally shed) — the ``seq`` a snapshot taken now must carry."""
        return self._applied_seq

    def refresh_pressure(self) -> None:
        """Re-read the engine's pool utilization for the gauge and the
        ingest check (on ranks a collective every rank makes).  The loop
        calls it itself wherever it changes the engine; a caller that
        changes the engine outside :meth:`step` calls it after."""
        self._pool_util = self.engine.pool_utilization()

    def pressure_components(self) -> Dict[str, float]:
        """The overload gauge's three inputs, each normalised so 1.0
        means 'at the limit': query queue depth, worst-pool live slice
        utilization, recent latency against the deadline budget."""
        return {
            "queue": len(self._query_q) / self.config.query_queue_cap,
            "pool": self._pool_util,
            "latency": self.stats.latency_ewma_s / self.config.deadline_s,
        }

    def overload_pressure(self) -> float:
        return max(self.pressure_components().values())

    def degradation_level(self,
                          pressure: Optional[float] = None) -> int:
        """Map gauge pressure onto the ladder (``force_level`` pins it
        for tests).  Monotone: higher pressure never degrades less."""
        if self.force_level is not None:
            return int(self.force_level)
        p = self.overload_pressure() if pressure is None else pressure
        level = 0
        for threshold in self.config.degrade_at:
            if p >= threshold:
                level += 1
        return level

    # -- submission (client side) ----------------------------------------
    def _lead(self, what: str) -> None:
        if not self.leads:
            raise RuntimeError(
                f"{what} runs on the leader (shard 0's rank); this rank "
                f"follows the leader's plans with follow()")

    def _retry_after(self, depth: int) -> float:
        """Backpressure hint: roughly the time to drain the current
        queue at the recently observed service rate (latency EWMA per
        ``max_batch``-wide flush), floored at one batch timer so it is
        always positive."""
        per_req = max(self.stats.latency_ewma_s,
                      self.config.batch_wait_s) / self.config.max_batch
        return max(self.config.batch_wait_s, depth * per_req)

    def _reject(self, reason: str, depth: int, is_query: bool) -> Rejected:
        r = Rejected(reason, self._retry_after(depth))
        if r.retry_after_s <= 0.0:
            self.stats.rejections_without_retry_after += 1
        if is_query:
            self.stats.queries_rejected += 1
        else:
            self.stats.ingest_rejected += 1
        return r

    def submit_query(self, kind: str, terms: Sequence[int], *,
                     k: Optional[int] = None,
                     deadline_s: Optional[float] = None
                     ) -> Union[int, Rejected]:
        """Enqueue one query; returns its qid, or :class:`Rejected` when
        the queue is full.  ``k`` is the top-k size (``topk`` /
        ``scored``) and the degraded-mode result cap for the unlimited
        kinds; ``deadline_s`` is this query's budget from now."""
        self._lead("submit_query")
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; "
                             f"one of {QUERY_KINDS}")
        self.stats.queries_submitted += 1
        if len(self._query_q) >= self.config.query_queue_cap:
            return self._reject("query_queue_full", len(self._query_q),
                                is_query=True)
        now = self.clock()
        budget = self.config.deadline_s if deadline_s is None \
            else float(deadline_s)
        rq = QueryRequest(
            qid=self._next_qid, kind=kind, terms=tuple(int(t) for t in terms),
            k=self.config.default_k if k is None else int(k),
            submitted_s=now, deadline_s=now + budget)
        self._next_qid += 1
        self._query_q.append(rq)
        return rq.qid

    def submit_ingest(self, docs) -> Union[int, Rejected]:
        """Enqueue one arrival batch; returns its durable seq (the ACK —
        once returned, the batch is journaled and survives a crash), or
        :class:`Rejected` when the ingest queue is full or the allocator
        is already critically utilized (``ingest_reject_util``) — the
        un-acked backpressure that keeps the engine's deterministic shed
        a last resort."""
        self._lead("submit_ingest")
        self.stats.ingest_submitted += 1
        if len(self._ingest_q) >= self.config.ingest_queue_cap:
            return self._reject("ingest_queue_full", len(self._ingest_q),
                                is_query=False)
        if self._pool_util >= self.config.ingest_reject_util:
            return self._reject("pool_pressure", len(self._ingest_q),
                                is_query=False)
        docs = np.asarray(docs)
        if self.journal is not None:
            seq = self.journal.append(docs)   # durable BEFORE the ack
        else:
            seq = self._next_seq
        self._next_seq = seq + 1
        self._ingest_q.append((seq, docs))
        return seq

    # -- the serving loop -------------------------------------------------
    def step(self, force: bool = False) -> int:
        """One scheduler iteration: flush the due query batch (device
        dispatch only), dispatch one ingest batch into the gap, then
        sync the query results.  Returns the number of responses
        produced.  ``force=True`` flushes a partial batch regardless of
        the timer (drain/shutdown path).  On ranks the leader's step is
        one plan that every follower runs."""
        self._lead("step")
        now = self.clock()
        level, groups = self._flush_queries(now, force)
        plan = self._broadcast(Plan(
            "step", groups=[(spec, [rq.terms for rq in rqs])
                            for spec, rqs in groups],
            ingest=self._ingest_q[0] if self._ingest_q else None))
        return self._run(plan, [(rqs, level) for _, rqs in groups])

    def follow(self) -> None:
        """A follower's loop: run each plan the leader broadcasts, with
        the leader's engine calls in the leader's order, until the
        leader's :meth:`stop`."""
        if self.leads:
            raise RuntimeError("the leader drives step(); follow() runs on "
                               "the other ranks")
        while True:
            plan = self._broadcast()
            self._run(plan)
            if plan.op == "stop":
                return

    def stop(self) -> None:
        """Release the followers from :meth:`follow` (their stats then
        equal the leader's); nothing on one process."""
        self._lead("stop")
        self._broadcast(Plan("stop"))

    def drain(self, max_steps: int = 100_000) -> List[QueryResponse]:
        """Step (forced) until both queues are empty, then return every
        accumulated response."""
        self._lead("drain")
        steps = 0
        while self._query_q or self._ingest_q:
            self.step(force=True)
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"drain did not converge in "
                                   f"{max_steps} steps")
        return self.take_responses()

    def take_responses(self) -> List[QueryResponse]:
        out, self._responses = self._responses, []
        return out

    # -- durability -------------------------------------------------------
    def snapshot_now(self, path: str) -> None:
        """Durable snapshot at the current applied watermark.  Call
        between steps: the seq recorded is :attr:`applied_seq`, so a
        later ``recover(snapshot, journal)`` replays exactly the acked
        batches this engine had not yet absorbed.  On ranks a plan every
        follower takes."""
        self._lead("snapshot_now")
        self._run(self._broadcast(Plan("snapshot", path=path,
                                       seq=self._applied_seq)))

    def resume_with(self, engine, journal=None) -> None:
        """Reattach after crash recovery: swap in the engine returned by
        :func:`~repro_torch.core.recovery.recover` (and optionally a reopened
        journal) and reconcile the ingest queue.  Every queued batch was
        journaled before its ack, and ``recover`` replays the journal
        through ordinary ingest — so the recovered engine ALREADY
        contains them; they are drained into ``stats.ingest_recovered``
        rather than re-applied (a second apply would double-index).
        Queued queries and accumulated responses survive untouched;
        queries that were IN FLIGHT when the crash escaped :meth:`step`
        lost their device work and are counted ``queries_aborted``
        (queries are never acked, so this loses no promise).  On ranks
        every rank calls it with its own recovered engine (a journal on
        the leader alone), and the followers take the leader's stats."""
        if journal is not None and not self.leads:
            raise ValueError("the journal is the leader's (shard 0's rank)")
        self.engine = engine
        if journal is not None:
            self.journal = journal
        self.stats.recoveries += 1
        self.stats.ingest_recovered += len(self._ingest_q)
        for _, docs in self._ingest_q:
            self.stats.docs_indexed += int(docs.shape[0])
        self._ingest_q.clear()
        self._applied_seq = self._next_seq
        self.stats.queries_aborted += self._n_in_flight
        self._n_in_flight = 0
        self._broadcast(Plan("resume"))
        self.refresh_pressure()

    # -- internals --------------------------------------------------------
    def _broadcast(self, plan: Optional[Plan] = None) -> Plan:
        """The leader's ``plan`` with its report, on every rank (the
        identity on one process); a follower mirrors the report."""
        if self.leads:
            plan.report = (self.stats, (len(self._query_q),
                                        len(self._ingest_q),
                                        self._n_in_flight,
                                        self._applied_seq))
        if self._mesh is not None:
            plan = self._mesh.broadcast(plan)
        if not self.leads:
            self.stats, (*seen, self._applied_seq) = plan.report
            self._seen = tuple(seen)
        return plan

    def _run(self, plan: Plan, waiting=None) -> int:
        """Make ``plan``'s engine calls; the leader collects the
        responses of ``waiting``'s ``(requests, level)`` per group, a
        follower only waits.  Returns the responses produced."""
        if plan.op == "snapshot":
            from repro_torch.core import recovery as rec
            rec.snapshot(self.engine, plan.path, seq=plan.seq)
        if plan.op != "step":
            return 0
        pending = [self._dispatch_group(spec, terms)
                   for spec, terms in plan.groups]
        if plan.ingest is not None:
            self._dispatch_ingest(*plan.ingest)  # overlaps the waits below
        produced = 0
        for i, pend in enumerate(pending):
            if waiting is None:
                pend.wait()
            else:
                produced += self._collect(pend, *waiting[i])
        if plan.ingest is not None:
            self.refresh_pressure()
        return produced

    def _flush_queries(self, now: float, force: bool):
        """The rung and the coalesced ``(spec, requests)`` groups of the
        due query batch (none when nothing is due)."""
        cfg = self.config
        if not self._query_q:
            return None, []
        full = len(self._query_q) >= cfg.max_batch
        due = (now - self._query_q[0].submitted_s) >= cfg.batch_wait_s
        if not (full or due or force):
            return None, []
        if full:
            self.stats.flushes_full += 1
        else:
            self.stats.flushes_timer += 1
        take = self._query_q[:cfg.max_batch]
        del self._query_q[:cfg.max_batch]
        level = self.degradation_level()
        groups: Dict[tuple, List[QueryRequest]] = {}
        for rq in take:
            groups.setdefault(self._plan(rq, level), []).append(rq)
        self.stats.batches_dispatched += len(groups)
        self._n_in_flight += len(take)
        return level, list(groups.items())

    def _plan(self, rq: QueryRequest, level: int) -> tuple:
        """Execution class for one request at one ladder rung:
        ``(mode, k_or_limit, frozen_only)``.  Requests sharing a class
        coalesce into one engine dispatch."""
        if level == DEGRADE_NONE:
            if rq.kind == "topk":
                return ("conjunctive", None, False)  # full, sliced later
            if rq.kind == "scored":
                return ("scored_full", rq.k, False)
            return (rq.kind, None, False)
        k = rq.k if level == DEGRADE_EARLY_EXIT \
            else max(1, rq.k // self.config.reduced_k_factor)
        frozen_only = level == DEGRADE_FROZEN_ONLY
        if rq.kind in ("topk", "conjunctive"):
            return ("topk", k, frozen_only)
        if rq.kind == "scored":
            return ("scored", k, frozen_only)
        return (rq.kind, k, frozen_only)   # disjunctive/phrase: capped

    def _dispatch_group(self, spec: tuple,
                        queries: List[Tuple[int, ...]]) -> qexec.Pending:
        mode, kk, frozen_only = spec
        if mode in ("topk", "scored", "scored_full"):
            return self.engine.dispatch(mode, queries, k=kk,
                                        frozen_only=frozen_only)
        return self.engine.dispatch(mode, queries, limit=kk,
                                    frozen_only=frozen_only)

    def _dispatch_ingest(self, seq: int, docs: np.ndarray) -> None:
        # peek, ingest, THEN pop: if a crash (fault injection, real bug)
        # escapes mid-ingest the batch stays queued, so resume_with can
        # account for it as replay-recovered instead of losing it.
        ok = self.engine.ingest(docs)
        if not self.leads:
            return
        self._ingest_q.pop(0)
        self._applied_seq = seq + 1
        if ok:
            self.stats.ingest_applied += 1
            self.stats.docs_indexed += int(docs.shape[0])
        else:
            # deterministic admission refusal: final (a retry would make
            # the live decision sequence diverge from a journal replay's
            # single-pass ingest), loud, and counted.
            self.stats.ingest_shed += 1

    def _collect(self, pend: qexec.Pending, rqs: List[QueryRequest],
                 level: int) -> int:
        results = pend.wait()
        done = self.clock()
        for rq, res in zip(rqs, results):
            if isinstance(res, tuple):
                docids, scores = res
            else:
                docids, scores = res, None
            if level == DEGRADE_NONE and rq.kind == "topk":
                docids = docids[: rq.k]
            latency = done - rq.submitted_s
            met = done <= rq.deadline_s
            if not met:
                self.stats.deadline_misses += 1
            a = self.config.latency_alpha
            if self.stats.queries_served == 0:
                self.stats.latency_ewma_s = latency
            else:
                self.stats.latency_ewma_s = \
                    (1.0 - a) * self.stats.latency_ewma_s + a * latency
            self.stats.queries_served += 1
            self.stats.served_by_level[level] += 1
            self._responses.append(QueryResponse(
                qid=rq.qid, kind=rq.kind, docids=docids, scores=scores,
                level=level, level_name=LEVEL_NAMES[level],
                degraded=level > DEGRADE_NONE, latency_s=latency,
                deadline_met=met))
        self._n_in_flight -= len(rqs)
        return len(rqs)


__all__ = ["DEGRADE_NONE", "DEGRADE_EARLY_EXIT", "DEGRADE_REDUCED_K",
           "DEGRADE_FROZEN_ONLY", "LEVEL_NAMES", "QUERY_KINDS",
           "Plan", "QueryRequest", "QueryResponse", "Rejected", "ServeConfig",
           "ServeLoop", "ServeStats"]
