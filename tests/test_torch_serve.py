"""Port vs reference: the overload-resilient search serving loop.

A JAX ``ServeLoop`` and a port ``ServeLoop`` (over engines on the CPU)
get the same submissions under the same injected clock: their responses
(docids, scores, level, deadline met, latency) and their ``ServeStats``
must be equal, under forced rungs and under the natural gauge.  Then
the port's loop alone against the contract: each rung exact against its
oracle, the overlapped step (query dispatch -> ingest -> wait)
bit-identical to a reference engine queried before each ingest,
backpressure with retry-after, shed-is-final, crash under serve ->
``recover`` -> ``resume_with``, and ``check_serve`` catching a lost
request.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis import invariants as jinv
from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import recovery as jrec
from repro.core import serve as jsv
from repro_torch.analysis import faults as tfaults
from repro_torch.analysis import invariants as tinv
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import recovery as trec
from repro_torch.core import serve as tsv

SPP = (256, 96, 24, 6)


class Clock:
    """Manual loop clock: tests own time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _engine(docs_per_segment=96, **kw):
    return tl.LifecycleEngine(
        tp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=SPP), 300,
        docs_per_segment, max_slices=64, max_len=64, use_kernel=False,
        device="cpu", **kw)


def _jengine(docs_per_segment=96, **kw):
    return jl.LifecycleEngine(
        jp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=SPP), 300,
        docs_per_segment, max_slices=64, max_len=64, use_kernel=False, **kw)


def _docs(rng, n, width=6):
    return rng.integers(0, 300, size=(n, width), dtype=np.int64)


def _warm(make):
    eng = make()
    rng = np.random.default_rng(0)
    for _ in range(6):
        assert eng.ingest(_docs(rng, 24))
    assert eng.doc_base > 0 and eng.segments.active.next_docid > 0
    return eng


@pytest.fixture(scope="module")
def warm_engine():
    return _warm(_engine)


def _rung_oracle(eng, kind, terms, k, level, cfg):
    """What a response served at ``level`` must equal (the reference's
    exactness contract per rung), from the engine's exhaustive
    results."""
    kk = k if level <= tsv.DEGRADE_EARLY_EXIT \
        else max(1, k // cfg.reduced_k_factor)
    if kind == "scored":
        ids, scs = eng.scored_full_batch([list(terms)], k=256)[0]
        if level == tsv.DEGRADE_FROZEN_ONLY:
            m = ids < eng.doc_base
            ids, scs = ids[m], scs[m]
        cut = k if level == tsv.DEGRADE_NONE else kk
        return ids[:cut], scs[:cut]
    if kind == "phrase":
        full = eng.phrase(*terms)
    elif kind == "disjunctive":
        full = eng.disjunctive(list(terms))
    else:
        full = eng.conjunctive(list(terms))
    if level == tsv.DEGRADE_FROZEN_ONLY:
        full = full[full < eng.doc_base]
    if level == tsv.DEGRADE_NONE:
        return (full[:k] if kind == "topk" else full), None
    return full[:kk], None


def assert_responses_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(sorted(want, key=lambda r: r.qid),
                    sorted(got, key=lambda r: r.qid)):
        assert (g.qid, g.kind, g.level, g.level_name, g.degraded,
                g.deadline_met) == (w.qid, w.kind, w.level, w.level_name,
                                    w.degraded, w.deadline_met)
        assert g.latency_s == w.latency_s
        np.testing.assert_array_equal(g.docids, np.asarray(w.docids))
        if w.scores is None:
            assert g.scores is None
        else:
            np.testing.assert_array_equal(g.scores, np.asarray(w.scores))


def assert_stats_equal(jloop, tloop):
    assert dataclasses.asdict(tloop.stats) == dataclasses.asdict(jloop.stats)
    for name in ("pending_queries", "in_flight_queries", "pending_ingest",
                 "applied_seq"):
        assert getattr(tloop, name) == getattr(jloop, name), name


# ---------------------------------------------------------------------------
# the two packages' loops under one clock
# ---------------------------------------------------------------------------
_LADDER_QUERIES = [("conjunctive", (5, 9)), ("conjunctive", (12, 3, 44)),
                   ("topk", (5, 9)), ("topk", (17,)),
                   ("disjunctive", (5, 9, 101)), ("phrase", (5, 9)),
                   ("scored", (5, 9)), ("scored", (12, 3))]


def _drive(seed, force_level, cfg_kw):
    """The same seeded schedule of submissions, clock advances and steps
    through a JAX loop and a port loop; returns both loops and their
    responses."""
    loops = []
    for make_eng, sv in ((_jengine, jsv), (_engine, tsv)):
        eng = _warm(make_eng)
        clock = Clock()
        loop = sv.ServeLoop(eng, sv.ServeConfig(**cfg_kw), clock=clock)
        loop.force_level = force_level
        rng = np.random.default_rng(seed)
        out, rejected = [], []
        for _ in range(14):
            for _ in range(int(rng.integers(0, 7))):
                kind, terms = _LADDER_QUERIES[int(rng.integers(0, 8))]
                r = loop.submit_query(kind, terms,
                                      k=int(rng.integers(1, 12)),
                                      deadline_s=float(rng.uniform(0.001,
                                                                   0.05)))
                rejected.append(r if isinstance(r, int) else
                                (r.reason, r.retry_after_s))
            if rng.random() < 0.6:
                r = loop.submit_ingest(_docs(rng, int(rng.integers(8, 40))))
                rejected.append(r if isinstance(r, int) else
                                (r.reason, r.retry_after_s))
            clock.advance(float(rng.uniform(0.0, 0.02)))
            loop.step(force=bool(rng.random() < 0.3))
            out += loop.take_responses()
        out += loop.drain()
        loops.append((loop, out, rejected))
    return loops


@pytest.mark.parametrize("force_level", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_loops_agree_under_the_same_clock(seed, force_level):
    cfg = dict(max_batch=4, query_queue_cap=12, ingest_queue_cap=3,
               deadline_s=0.03, default_k=8)
    (jloop, jout, jrej), (tloop, tout, trej) = _drive(seed, force_level,
                                                      cfg)
    assert trej == jrej
    assert_responses_equal(jout, tout)
    assert_stats_equal(jloop, tloop)
    assert tloop.stats.queries_served > 0
    if force_level is None:
        assert sum(1 for n in tloop.stats.served_by_level if n) >= 2
    want, got = jinv.check_serve(jloop), tinv.check_serve(tloop)
    assert got.ok and want.ok and got.stats == want.stats
    assert tloop.engine.doc_base == jloop.engine.doc_base


def test_gauge_and_retry_after_match(warm_engine):
    jloop = jsv.ServeLoop(_warm(_jengine), jsv.ServeConfig(), clock=Clock())
    tloop = tsv.ServeLoop(warm_engine, tsv.ServeConfig(), clock=Clock())
    for p in (0.0, 0.49, 0.5, 0.74, 0.75, 0.89, 0.9, 2.0):
        assert tloop.degradation_level(p) == jloop.degradation_level(p)
    assert tloop.pressure_components() == jloop.pressure_components()
    for depth in (0, 1, 40, 1000):
        assert tloop._retry_after(depth) == jloop._retry_after(depth)


# ---------------------------------------------------------------------------
# config and submission validation, coalescing
# ---------------------------------------------------------------------------
def test_config_validation():
    for kw in (dict(degrade_at=(0.9, 0.5, 0.95)),
               dict(degrade_at=(0.0, 0.5, 0.9)), dict(max_batch=0),
               dict(reduced_k_factor=1)):
        with pytest.raises(ValueError):
            tsv.ServeConfig(**kw)
    assert dataclasses.asdict(tsv.ServeConfig()) == \
        dataclasses.asdict(jsv.ServeConfig())


def test_unknown_query_kind_raises(warm_engine):
    loop = tsv.ServeLoop(warm_engine, clock=Clock())
    with pytest.raises(ValueError, match="unknown query kind"):
        loop.submit_query("regex", (1, 2))
    with pytest.raises(ValueError, match="needs k"):
        warm_engine.dispatch("topk", [(1, 2)])


def test_flush_on_full_bucket_and_on_timer(warm_engine):
    clock = Clock()
    loop = tsv.ServeLoop(warm_engine, tsv.ServeConfig(
        max_batch=4, batch_wait_s=0.010), clock=clock)
    for _ in range(4):
        loop.submit_query("conjunctive", (5, 9))
    assert loop.step() == 4 and loop.stats.flushes_full == 1
    loop.submit_query("conjunctive", (5, 9))
    clock.advance(0.004)
    assert loop.step() == 0 and loop.pending_queries == 1
    clock.advance(0.007)
    assert loop.step() == 1 and loop.stats.flushes_timer == 1


def test_mixed_kind_flush_coalesces_per_plan(warm_engine):
    loop = tsv.ServeLoop(warm_engine, tsv.ServeConfig(max_batch=8),
                         clock=Clock())
    loop.force_level = 0
    for q in ((5, 9), (12, 3), (7,)):
        loop.submit_query("conjunctive", q)
    loop.submit_query("topk", (5, 9), k=4)
    loop.submit_query("scored", (5, 9), k=4)
    loop.submit_query("phrase", (5, 9))
    assert loop.step(force=True) == 6
    assert loop.stats.batches_dispatched == 3
    tinv.check_serve(loop).raise_if_failed()


# ---------------------------------------------------------------------------
# the ladder: every rung exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_ladder_rung_exactness(warm_engine, level):
    cfg = tsv.ServeConfig(max_batch=16, default_k=8)
    loop = tsv.ServeLoop(warm_engine, cfg, clock=Clock())
    loop.force_level = level
    for kind, terms in _LADDER_QUERIES:
        loop.submit_query(kind, terms, k=8)
    assert loop.step(force=True) == len(_LADDER_QUERIES)
    responses = sorted(loop.take_responses(), key=lambda r: r.qid)
    for (kind, terms), r in zip(_LADDER_QUERIES, responses):
        ids, scs = _rung_oracle(warm_engine, kind, terms, 8, level, cfg)
        np.testing.assert_array_equal(r.docids, ids)
        if scs is None:
            assert r.scores is None
        else:
            np.testing.assert_array_equal(r.scores, scs)
        assert (r.level, r.level_name, r.degraded) == \
            (level, tsv.LEVEL_NAMES[level], level > 0)
    assert loop.stats.served_by_level[level] == len(_LADDER_QUERIES)
    tinv.check_serve(loop).raise_if_failed()


@pytest.mark.parametrize("k", [1, 3, 8, 12])
def test_rung_oracles_match_the_reference(warm_engine, k):
    """The rung oracles themselves agree across the packages."""
    jeng = _warm(_jengine)
    cfg = tsv.ServeConfig()
    for level in range(4):
        for kind, terms in _LADDER_QUERIES:
            g = _rung_oracle(warm_engine, kind, terms, k, level, cfg)
            w = _rung_oracle(jeng, kind, terms, k, level, cfg)
            for gx, wx in zip(g, w):
                if wx is None:
                    assert gx is None
                else:
                    np.testing.assert_array_equal(gx, np.asarray(wx))


def test_deadline_met_and_missed(warm_engine):
    clock = Clock()
    loop = tsv.ServeLoop(warm_engine, tsv.ServeConfig(deadline_s=0.25),
                         clock=clock)
    loop.submit_query("conjunctive", (5, 9), deadline_s=0.05)
    loop.submit_query("conjunctive", (5, 9))
    clock.advance(0.1)
    loop.step(force=True)
    by_qid = {r.qid: r for r in loop.take_responses()}
    assert by_qid[0].deadline_met is False and by_qid[1].deadline_met
    assert loop.stats.deadline_misses == 1
    assert by_qid[0].latency_s == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# the overlapped step
# ---------------------------------------------------------------------------
def test_overlapped_serving_bit_identical_to_reference():
    """Rounds of query dispatch -> ingest -> wait through the port's loop
    against the JAX engine queried before each ingest: every response
    identical, rollovers included."""
    eng, ref = _engine(), _jengine()
    rng = np.random.default_rng(7)
    loop = tsv.ServeLoop(eng, tsv.ServeConfig(max_batch=8), clock=Clock())
    loop.force_level = 0
    queries = [(5, 9), (12, 3), (44, 7, 101), (17,)]
    for rnd in range(6):
        for q in queries:
            loop.submit_query("conjunctive", q)
        loop.submit_query("scored", (5, 9), k=5)
        docs = _docs(rng, 24)
        assert isinstance(loop.submit_ingest(docs), int)
        want = [ref.conjunctive(list(q)) for q in queries]
        want.append(ref.scored_full((5, 9), 5))
        ref.ingest(docs)
        assert loop.step(force=True) == len(queries) + 1
        got = sorted(loop.take_responses(), key=lambda r: r.qid)
        for w, g in zip(want[:-1], got[:-1]):
            np.testing.assert_array_equal(g.docids, np.asarray(w))
        np.testing.assert_array_equal(got[-1].docids, want[-1][0])
        np.testing.assert_array_equal(got[-1].scores, want[-1][1])
    assert loop.stats.ingest_applied == 6 and eng.stats.rollovers >= 1
    assert eng.doc_base == ref.doc_base
    tinv.check_serve(loop).raise_if_failed()


def test_pending_query_holds_no_view_of_the_state(warm_engine):
    """What a dispatched query hands to ``wait()`` is its own result
    tensors: nothing that shares storage with the active heap, tail or
    freq, which the next ingest overwrites in place."""
    st = warm_engine.segments.active.state
    ptrs = {t.untyped_storage().data_ptr() for t in (st.heap, st.tail,
                                                      st.freq)}
    for kind, kw in (("conjunctive", {}), ("disjunctive", {}),
                     ("phrase", {}), ("topk", dict(k=3)),
                     ("scored", dict(k=3)), ("scored_full", dict(k=3))):
        for fo in (False, True):
            pend = warm_engine.dispatch(kind, [(5, 9)], frozen_only=fo,
                                        **kw)
            for a in pend._arrays:
                assert a.untyped_storage().data_ptr() not in ptrs, kind
            pend.wait()


# ---------------------------------------------------------------------------
# backpressure, shedding, durability
# ---------------------------------------------------------------------------
def test_queue_backpressure(warm_engine):
    loop = tsv.ServeLoop(warm_engine, tsv.ServeConfig(query_queue_cap=3),
                         clock=Clock())
    for _ in range(3):
        assert isinstance(loop.submit_query("conjunctive", (5, 9)), int)
    r = loop.submit_query("conjunctive", (5, 9))
    assert isinstance(r, tsv.Rejected)
    assert r.reason == "query_queue_full" and r.retry_after_s > 0
    loop.drain()
    assert isinstance(loop.submit_query("conjunctive", (5, 9)), int)
    loop.drain()
    tinv.check_serve(loop).raise_if_failed()
    eng = _engine()
    rng = np.random.default_rng(1)
    loop = tsv.ServeLoop(eng, tsv.ServeConfig(ingest_queue_cap=2),
                         clock=Clock())
    seqs = [loop.submit_ingest(_docs(rng, 8)) for _ in range(3)]
    assert seqs[:2] == [0, 1] and isinstance(seqs[2], tsv.Rejected)
    assert seqs[2].reason == "ingest_queue_full"
    loop.drain()
    assert loop.stats.ingest_applied == 2 and loop.applied_seq == 2
    tinv.check_serve(loop).raise_if_failed()


def test_pool_pressure_rejects_before_ack(tmp_path):
    wal = str(tmp_path / "wal.bin")
    jrnl = trec.IngestJournal(wal)
    loop = tsv.ServeLoop(_engine(), tsv.ServeConfig(ingest_reject_util=0.0),
                         journal=jrnl, clock=Clock())
    r = loop.submit_ingest(_docs(np.random.default_rng(2), 8))
    assert isinstance(r, tsv.Rejected) and r.reason == "pool_pressure"
    assert r.retry_after_s > 0
    jrnl.close()
    assert trec.read_journal(wal)[1] == []
    tinv.check_serve(loop).raise_if_failed()


def _sym_batches(n_batches, vocab=64):
    out, d = [], 0
    for _ in range(n_batches):
        out.append(np.arange(d, d + vocab, dtype=np.int64)
                   .reshape(vocab, 1) % vocab)
        d += vocab
    return out


def test_shed_is_final_then_retry_succeeds_after_rollover():
    eng = _engine(docs_per_segment=100_000,
                  admission=tl.AdmissionController(
                      rollover_at=0.6, shed_at=0.6, min_segment_docs=10_000))
    loop = tsv.ServeLoop(eng, clock=Clock())
    batches = _sym_batches(5)
    for docs in batches:
        assert isinstance(loop.submit_ingest(docs), int)
        loop.step(force=True)
    assert (loop.stats.ingest_applied, loop.stats.ingest_shed) == (3, 2)
    assert eng.stats.shed_batches == 2 and eng.stats.emergency_rollovers == 0
    tinv.check_serve(loop).raise_if_failed()
    eng.segments.rollover()
    eng._sync_frozen()
    assert isinstance(loop.submit_ingest(batches[0]), int)
    loop.step(force=True)
    assert (loop.stats.ingest_applied, loop.stats.ingest_shed) == (4, 2)
    tinv.check_serve(loop).raise_if_failed()


@pytest.mark.parametrize("crash", ["journal_only", "crash_mid_rollover"])
def test_crash_under_serve_recovers_bit_identical(tmp_path, crash):
    """Acked batches survive the crash: two queued but unapplied batches
    (``journal_only``), or the live engine torn inside a rollover by the
    fault harness's crash site, with queries in flight.  ``recover`` +
    ``resume_with`` give the engine an uncrashed one fed every journaled
    batch would be, and the loop keeps serving and acking."""
    wal, snap = str(tmp_path / "wal.bin"), str(tmp_path / "snap.bin")
    rng = np.random.default_rng(5)
    jrnl = trec.IngestJournal(wal)
    loop = tsv.ServeLoop(_engine(validate=True), journal=jrnl,
                         clock=Clock())
    for i in range(6):
        assert isinstance(loop.submit_ingest(_docs(rng, 24)), int)
        loop.step(force=True)
        if i == 2:
            loop.snapshot_now(snap)
    if crash == "journal_only":
        for _ in range(2):
            assert isinstance(loop.submit_ingest(_docs(rng, 24)), int)
        in_flight = 0
    else:
        loop.submit_query("conjunctive", (5, 9))
        with tfaults.crash_site("crash_mid_rollover"):
            with pytest.raises(tfaults.InjectedCrash):
                for _ in range(10):
                    loop.submit_ingest(_docs(rng, 24))
                    loop.submit_query("topk", (5, 9), k=3)
                    loop.step(force=True)
        in_flight = loop.in_flight_queries
        assert in_flight > 0
    acked = jrnl.next_seq
    pending = loop.pending_ingest
    jrnl.close()

    replayed = []
    recovered = trec.recover(
        snap, wal, expect_seq=acked, device="cpu",
        on_replay=lambda seq, docs, ok: replayed.append(seq))
    aborted0 = loop.stats.queries_aborted
    loop.resume_with(recovered, journal=trec.IngestJournal(wal))
    assert replayed == list(range(3, acked))
    assert loop.pending_ingest == 0 and loop.applied_seq == acked
    assert loop.stats.ingest_recovered == pending >= 1
    assert loop.stats.queries_aborted == aborted0 + in_flight
    oracle = _engine()
    for _, docs in trec.read_journal(wal)[1]:
        oracle.ingest(docs)
    fa, fb = trec.engine_fingerprint(loop.engine), \
        trec.engine_fingerprint(oracle)
    fa.pop("stats"), fb.pop("stats")
    assert fa == fb
    tinv.check_serve(loop).raise_if_failed()
    assert isinstance(loop.submit_ingest(_docs(rng, 24)), int)
    loop.submit_query("conjunctive", (5, 9))
    loop.drain()
    tinv.check_serve(loop).raise_if_failed()


def test_reference_journal_recovers_in_the_port_loop(tmp_path):
    """A JAX loop's snapshot and journal, recovered in the port and
    resumed under a port loop, serve what the reference serves."""
    wal, snap = str(tmp_path / "wal.bin"), str(tmp_path / "snap.bin")
    rng = np.random.default_rng(8)
    jj = jrec.IngestJournal(wal)
    jloop = jsv.ServeLoop(_jengine(), journal=jj, clock=Clock())
    for i in range(5):
        jloop.submit_ingest(_docs(rng, 30))
        jloop.step(force=True)
        if i == 1:
            jloop.snapshot_now(snap)
    acked = jj.next_seq
    jj.close()
    eng = trec.recover(snap, wal, expect_seq=acked, device="cpu")
    tloop = tsv.ServeLoop(eng, clock=Clock())
    for loop in (jloop, tloop):
        loop.force_level = 0
        for kind, terms in _LADDER_QUERIES:
            loop.submit_query(kind, terms, k=6)
        loop.step(force=True)
    assert_responses_equal(jloop.take_responses(), tloop.take_responses())


def test_check_serve_detects_lost_request(warm_engine):
    loop = tsv.ServeLoop(warm_engine, clock=Clock())
    loop.submit_query("conjunctive", (5, 9))
    loop.drain()
    assert tinv.check_serve(loop).ok
    loop.stats.queries_submitted += 1
    rep = tinv.check_serve(loop)
    assert not rep.ok and "silently dropped" in rep.render()
    loop.stats.queries_submitted -= 1
    loop.stats.ingest_submitted += 1
    assert {v.field for v in tinv.check_serve(loop).violations} == \
        {"ingest"}
    loop.stats.ingest_submitted -= 1
    loop.stats.served_by_level[0] += 1
    assert not tinv.check_serve(loop).ok
    loop.stats.served_by_level[0] -= 1
    loop.stats.rejections_without_retry_after = 1
    with pytest.raises(tinv.InvariantViolation):
        tinv.check_serve(loop).raise_if_failed()
